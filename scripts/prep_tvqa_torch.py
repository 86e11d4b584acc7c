#!/usr/bin/env python
"""Build TVQA finetuning TFRecords with the PyTorch port: the counterpart
of ``scripts/prep_tvqa.py`` (reference finetune/tvqa/prep_data.py:134-338)
on the data library's JPEG codec instead of PIL, with the spectrograms from
``ops.audio.batch_make_spectrogram`` on the card. 7 segments of about 4.667
s centered on the localized QA span: per segment the frame and one
JPEG-quantized [3 x 60, 65] spectrogram (one magic number per record);
subtitles bucketed by midpoint; relative localization tokens prepended to
the query. ``main`` decodes each video with ffmpeg (``preprocess.py``);
``tvqa_record`` takes the decoded arrays. Runs on the CUDA card unless
``--device cpu`` is given.

Input manifest: jsonl with per-line
  {"id", "video_path", "ts_start", "ts_end", "question",
   "answers": [...x5], "label": int,
   "subtitles": [{"word","start","end"}, ...]  (optional)}

Usage: python scripts/prep_tvqa_torch.py -manifest ann.jsonl -out tvqa.tfrecord
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from merlot_reserve_tpu_torch import preprocess as P  # noqa: E402
from merlot_reserve_tpu_torch.data import tfrecord as T  # noqa: E402
from merlot_reserve_tpu_torch.data.native import encode_jpeg_native  # noqa: E402
from merlot_reserve_tpu_torch.finetune.prep_data import (  # noqa: E402
    relative_localization_tokens,
    tvqa_segment_times,
)
from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram  # noqa: E402
from merlot_reserve_tpu_torch.tokenizer import get_tokenizer  # noqa: E402
from merlot_reserve_tpu_torch.utils.subtitles import words_to_segments  # noqa: E402

NUM_SEGMENTS = 7
SEGMENT_LEN = 4.6667
SR = 22050


def segment_times(ann: dict, duration: float):
    return tvqa_segment_times(ann["ts_start"], ann["ts_end"], duration, NUM_SEGMENTS,
                              SEGMENT_LEN)


def tvqa_record(ann: dict, frames, waveform, duration: float, encoder=None,
                device="cuda") -> bytes:
    """One annotation with its video decoded -> the record. ``frames``
    [7, h, w, 3] uint8 are taken at ``segment_times(ann, duration)``'s
    mid_times, ``waveform`` is the whole video's PCM at 22050 Hz."""
    enc = encoder or get_tokenizer()
    seg_times = segment_times(ann, duration)
    # each 4.667 s window padded onto the 5 s, 188-frame grid (the reference
    # resamples the audio instead; padding keeps the hop of the device DSP)
    seg_len_samples = int(SR * 5.0)
    clips = []
    for t in seg_times:
        s0 = int(t["start_time"] * SR)
        wav = np.asarray(waveform[s0:s0 + int(SEGMENT_LEN * SR)], np.float32)
        wav = np.concatenate([wav, np.zeros(max(seg_len_samples - len(wav), 0), np.float32)])
        clips.append(wav[:seg_len_samples])
    specs = batch_make_spectrogram(np.stack(clips), device=device).cpu().numpy()  # [7,3,60,65]
    # one magic number per record (the reference stores one), from the 64
    # mel columns; the planes keep the 65th, the playback speed, because
    # finetune/data.py reads [3 * 60, 65] (the JAX script stores 64)
    magic = 255.0 / max(np.percentile(specs[..., :64], 99), 1.0)
    planes = np.minimum(specs.reshape(NUM_SEGMENTS, 3 * 60, 65) * magic, 255.0).astype(np.uint8)
    subs = words_to_segments(ann.get("subtitles", []), seg_times)
    query_toks = relative_localization_tokens(ann["ts_start"], ann["ts_end"], seg_times, enc) \
        + enc.encode(ann["question"]).ids

    feats = {
        "id": T.bytes_feature([ann["id"].encode()]),
        "magic_number": T.float_feature([float(magic)]),
        "qa_query": T.int64_feature(query_toks),
        "qa_label": T.int64_feature([ann["label"]]),
        "num_frames": T.int64_feature([NUM_SEGMENTS]),
    }
    for i, answer in enumerate(ann["answers"]):
        feats[f"qa_choice_{i}"] = T.int64_feature(enc.encode(answer).ids)
    for i in range(NUM_SEGMENTS):
        feats[f"c{i:02d}/image_encoded"] = T.bytes_feature([encode_jpeg_native(frames[i], 90)])
        feats[f"c{i:02d}/spec_encoded"] = T.bytes_feature([encode_jpeg_native(planes[i], 90)])
        feats[f"c{i:02d}/sub"] = T.int64_feature(enc.encode(subs[i]).ids if subs[i] else [])
    return T.encode_example(feats)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-manifest", required=True)
    ap.add_argument("-out", required=True)
    ap.add_argument("-max_records", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    enc = get_tokenizer()
    records = []
    with open(args.manifest) as f:
        for line in f:
            ann = json.loads(line)
            duration = P.video_duration(ann["video_path"])
            frames = P.extract_frames_from_video(
                ann["video_path"], [t["mid_time"] for t in segment_times(ann, duration)])
            if frames is None:
                print(f"skip {ann['id']}: frame extraction failed")
                continue
            waveform = P.extract_audio_waveform(ann["video_path"], sr=SR)
            records.append(tvqa_record(ann, frames, waveform, duration, enc, device))
            if args.max_records and len(records) >= args.max_records:
                break

    T.write_records(args.out, records)
    print(f"wrote {len(records)} records to {args.out}")


if __name__ == "__main__":
    main()
