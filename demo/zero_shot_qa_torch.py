#!/usr/bin/env python
"""MSRVTT-QA style zero-shot video QA of the PyTorch port: the counterpart
of ``demo/zero_shot_qa.py``. Questions become statements with a <|MASK|>
slot (a ``{split}_infill.json`` of the reference's rewrites is used as
given; the heuristic rewrite covers questions without a slot), the answer
vocabulary is the top-k train answers, and the vocabulary is ranked
against the MASK hidden state of each video's segments.

No download path: the weights come from a local checkpoint (``-ckpt``), not
``from_pretrained``. ``infer`` runs on the CUDA card unless ``--device
cpu`` is given.

Usage:
  python demo/zero_shot_qa_torch.py build_vocab --train_qa train_qa.json --out vocab.txt
  python demo/zero_shot_qa_torch.py infer --videos DIR --qa val_qa.json --vocab vocab.txt -ckpt CKPT
"""

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GRID = (12, 20)


def build_vocab(qa, top_k: int):
    """The ``top_k`` most common answers of ``qa`` ([{'answer', ...}])."""
    counts = collections.Counter(x["answer"] for x in qa)
    return [w for w, _ in counts.most_common(top_k)]


def answer(model, segments, item, vocab, device="cuda") -> str:
    """The vocabulary entry ranked first for ``item`` over ``segments``:
    its statement as the first segment's text, audio on the rest."""
    import numpy as np

    from merlot_reserve_tpu_torch.preprocess import preprocess_video
    from merlot_reserve_tpu_torch.zero_shot import rank_options, statement_for_qa_item

    segments = [dict(s, use_text_as_input=False) for s in segments]
    segments[0].update(text=statement_for_qa_item(item), use_text_as_input=True)
    video_pre = preprocess_video(segments, output_grid_size=GRID, device=device)
    return vocab[int(np.argmax(rank_options(model, video_pre, vocab)[0]))]


def cmd_build_vocab(args):
    with open(args.train_qa) as f:
        vocab = build_vocab(json.load(f), args.top_k)
    with open(args.out, "w") as f:
        f.write("\n".join(vocab))
    print(f"wrote {len(vocab)} answers to {args.out}")
    return vocab


def cmd_infer(args):
    from merlot_reserve_tpu_torch.models import PretrainedMerlotReserve
    from merlot_reserve_tpu_torch.preprocess import video_to_segments
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with open(args.vocab) as f:
        vocab = [line.strip() for line in f if line.strip()]
    with open(args.qa) as f:
        qa = json.load(f)
    model = PretrainedMerlotReserve.from_params(args.model, pretrained_params(args.ckpt),
                                                image_grid_size=GRID, device=device)
    n_correct = n_total = 0
    for item in qa[:args.limit] if args.limit else qa:
        video_fn = os.path.join(args.videos, f"video{item['video_id']}.mp4")
        try:
            segments = video_to_segments(video_fn, num_segments_max=8, device=device)
        except ValueError as e:  # no audio stream, too short, or frames not decoded
            print(f"skip {video_fn}: {e}")
            continue
        n_correct += int(answer(model, segments, item, vocab, device) == item["answer"])
        n_total += 1
    print(f"accuracy: {n_correct}/{n_total} = {n_correct / max(n_total, 1):.4f}")
    return n_correct, n_total


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    pb = sub.add_parser("build_vocab")
    pb.add_argument("--train_qa", required=True)
    pb.add_argument("--out", required=True)
    pb.add_argument("--top_k", type=int, default=1500)
    pi = sub.add_parser("infer")
    pi.add_argument("--videos", required=True)
    pi.add_argument("--qa", required=True)
    pi.add_argument("--vocab", required=True)
    pi.add_argument("-ckpt", required=True, help="local checkpoint (file or directory)")
    pi.add_argument("--model", default="base")
    pi.add_argument("--limit", type=int, default=0)
    pi.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return {"build_vocab": cmd_build_vocab, "infer": cmd_infer}[args.cmd](args)


if __name__ == "__main__":
    main()
