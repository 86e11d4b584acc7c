#!/usr/bin/env python
"""EPIC-Kitchens-100 zero-shot action anticipation of the PyTorch port: the
counterpart of ``demo/zero_shot_ek100.py``, its two stages:

stage 1 (extract): for each annotation, 8 observed segments of 2 s ending
at the anticipation boundary go in as audio, then a text segment "My next
action is <|MASK|>"; the MASK hidden state is cached;
stage 2 (eval): rank the 'verb noun' label space of the annotations'
pairs; report top-1/5 verb, noun and action accuracy.

No download path: the weights come from a local checkpoint (``-ckpt``), not
``from_pretrained``. Both stages run on the CUDA card unless ``--device
cpu`` is given.

Usage:
  python demo/zero_shot_ek100_torch.py extract --videos DIR --annotations CSV \
      --out feats.pkl -ckpt CKPT
  python demo/zero_shot_ek100_torch.py eval --feats feats.pkl --annotations CSV \\
      --verb_classes CSV --noun_classes CSV -ckpt CKPT
"""

import argparse
import csv
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GRID = (12, 20)


def load_annotations(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def anticipation_times(ann):
    """The 8 observed 2-s segments ending a second before the action."""
    t_end = float(ann.get("start_frame", 0)) / float(ann.get("fps", 30)) - 1.0
    return [{"start_time": max(t_end - 2.0 * (8 - i), 0.0),
             "end_time": max(t_end - 2.0 * (7 - i), 0.5),
             "mid_time": max(t_end - 2.0 * (7.5 - i), 0.25)} for i in range(8)]


def anticipation_input(segments, device="cuda"):
    """Audio on every segment but the last, which says "My next action
    is<|MASK|>" -> one ``preprocess_video`` output."""
    from merlot_reserve_tpu_torch.preprocess import preprocess_video

    segments = [dict(s, use_text_as_input=False) for s in segments]
    segments[-1].update(text="My next action is<|MASK|>", use_text_as_input=True)
    return preprocess_video(segments, output_grid_size=GRID, device=device)


def evaluate(model, features, ids, annotations, verb_rows, noun_rows):
    """Rank the label space of every (verb, noun) pair in ``annotations``
    ({id: row}) against the cached MASK ``features`` of ``ids`` -> the
    accuracies of ``zero_shot.verb_noun_action_accuracy``."""
    import numpy as np

    from merlot_reserve_tpu_torch.zero_shot import score_label_space, verb_noun_action_accuracy

    verbs = {int(r["id"]): r["key"].replace("-", " ") for r in verb_rows}
    nouns = {int(r["id"]): r["key"].split(":")[0].replace("-", " ") for r in noun_rows}
    pairs = sorted({(int(a["verb_class"]), int(a["noun_class"])) for a in annotations.values()})
    options = [f"{verbs[v]} {nouns[n]}" for v, n in pairs]
    pair_index = {p: i for i, p in enumerate(pairs)}
    logits = score_label_space(model, features, options)
    labels = np.asarray([pair_index[(int(annotations[i]["verb_class"]),
                                     int(annotations[i]["noun_class"]))] for i in ids])
    return verb_noun_action_accuracy(logits, labels, np.asarray([v for v, _ in pairs]),
                                     np.asarray([n for _, n in pairs]))


def _model(args, device):
    from merlot_reserve_tpu_torch.models import PretrainedMerlotReserve
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params

    return PretrainedMerlotReserve.from_params(args.model, pretrained_params(args.ckpt),
                                               image_grid_size=GRID, device=device)


def cmd_extract(args):
    import numpy as np

    from merlot_reserve_tpu_torch.preprocess import video_to_segments_zero_shot
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.zero_shot import extract_mask_features

    device = resolve_device(args.device)
    model = _model(args, device)
    feats, ids, batch = [], [], []
    for ann in load_annotations(args.annotations):
        video_fn = os.path.join(args.videos, ann["video_id"] + ".mp4")
        segments = video_to_segments_zero_shot(video_fn, times=anticipation_times(ann),
                                               device=device)
        batch.append(anticipation_input(segments, device))
        ids.append(ann.get("narration_id", ann["video_id"]))
        if len(batch) == args.batch_size:
            feats.append(extract_mask_features(model, batch))
            batch = []
    if batch:
        feats.append(extract_mask_features(model, batch))
    with open(args.out, "wb") as f:
        pickle.dump({"ids": ids, "features": np.concatenate(feats)}, f)
    print(f"wrote {len(ids)} features to {args.out}")
    return ids


def cmd_eval(args):
    from merlot_reserve_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with open(args.feats, "rb") as f:  # a features file written by extract
        cache = pickle.load(f)
    annotations = {a.get("narration_id", a["video_id"]): a
                   for a in load_annotations(args.annotations)}
    metrics = evaluate(_model(args, device), cache["features"], cache["ids"], annotations,
                       load_annotations(args.verb_classes), load_annotations(args.noun_classes))
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v * 100:.2f}%")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("extract")
    pe.add_argument("--videos", required=True)
    pe.add_argument("--annotations", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--batch_size", type=int, default=8)
    pv = sub.add_parser("eval")
    pv.add_argument("--feats", required=True)
    pv.add_argument("--annotations", required=True)
    pv.add_argument("--verb_classes", required=True)
    pv.add_argument("--noun_classes", required=True)
    for p in (pe, pv):
        p.add_argument("-ckpt", required=True, help="local checkpoint (file or directory)")
        p.add_argument("--model", default="base")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return {"extract": cmd_extract, "eval": cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    main()
