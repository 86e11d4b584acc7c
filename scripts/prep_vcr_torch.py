#!/usr/bin/env python
"""Build VCR finetuning TFRecords with the PyTorch port: the counterpart of
``scripts/prep_vcr.py`` (reference finetune/vcr/prep_data.py) on the data
library's JPEG codec instead of PIL. For each annotation: render the
referenced detection boxes into the image (name-colored,
semi-transparent), pre-render the left-right flip, rewrite detection tags
to text, tokenize the Q/A/R options, and write records in the schema that
``finetune/data.py`` reads. No device work: all of it runs on the host.

Input manifest: jsonl with per-line
  {"id", "image_path" (a JPEG), "boxes": [[x1,y1,x2,y2],...], "names": [...],
   "qa_query": [mixed tokens], "qa_choices": [[...]x4], "qa_label": int,
   "qar_query": [...], "qar_choices": [[...]x4], "qar_label": int}
where mixed tokens are words or detection-index lists (VCR's format).

Usage: python scripts/prep_vcr_torch.py -manifest ann.jsonl -out vcr.tfrecord
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merlot_reserve_tpu_torch.data import tfrecord as T  # noqa: E402
from merlot_reserve_tpu_torch.data.native import (decode_jpeg_native,  # noqa: E402
                                                  encode_jpeg_native)
from merlot_reserve_tpu_torch.finetune.prep_data import (draw_boxes_on_image,  # noqa: E402
                                                         rewrite_detection_tags)
from merlot_reserve_tpu_torch.tokenizer import get_tokenizer  # noqa: E402


def vcr_record(ann: dict, image, encoder=None) -> bytes:
    """One annotation and its decoded [h, w, 3] uint8 image -> the record."""
    enc = encoder or get_tokenizer()
    names = ann.get("names", [])
    img = draw_boxes_on_image(image, ann.get("boxes", []), names)
    feats = {
        "id": T.bytes_feature([ann["id"].encode()]),
        "image": T.bytes_feature([encode_jpeg_native(img, 90)]),
        "image_fliplr": T.bytes_feature([encode_jpeg_native(img[:, ::-1], 90)]),
    }
    for prefix in ("qa", "qar"):
        query = rewrite_detection_tags(ann[f"{prefix}_query"], names)
        feats[f"{prefix}_query"] = T.int64_feature(enc.encode(query).ids)
        for i, choice in enumerate(ann[f"{prefix}_choices"]):
            text = rewrite_detection_tags(choice, names)
            feats[f"{prefix}_choice_{i}"] = T.int64_feature(enc.encode(text).ids)
        feats[f"{prefix}_label"] = T.int64_feature([ann[f"{prefix}_label"]])
    return T.encode_example(feats)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-manifest", required=True)
    ap.add_argument("-out", required=True)
    ap.add_argument("-max_records", type=int, default=0)
    args = ap.parse_args(argv)

    enc = get_tokenizer()
    records = []
    with open(args.manifest) as f:
        for line in f:
            ann = json.loads(line)
            with open(ann["image_path"], "rb") as img_file:
                image = decode_jpeg_native(img_file.read())
            records.append(vcr_record(ann, image, enc))
            if args.max_records and len(records) >= args.max_records:
                break

    T.write_records(args.out, records)
    print(f"wrote {len(records)} records to {args.out}")


if __name__ == "__main__":
    main()
