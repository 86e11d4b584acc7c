#!/usr/bin/env python
"""Batched zero-shot TVQA of the PyTorch port: rank each question's 5
answers with a pretrained checkpoint, no finetuning. The counterpart of
``scripts/zero_shot_tvqa.py``, with its flags: the question + 'answer:' +
MASK statement fused with the subtitles (text stream) and with the audio
(AUDIOSPAN stream), the MASK state through the pretrained joint projection
scoring the span-encoded answers (``finetune.models.MerlotReserveTVQAZeroShot``,
``zero_shot.zero_shot_qa_eval``); the joint prediction ranks the sum of the
two streams' softmaxes. Use ``-grid 18,32`` or ``-grid 24,24`` with a
resolution-adapted checkpoint. Prints the metrics as JSON; ``-out`` writes
the per-example rows. Runs on the CUDA card unless ``--device cpu`` is
given.

Usage: python scripts/zero_shot_tvqa_torch.py large -ckpt CKPT -val_fns 'val*' [-grid 18,32] [-out preds.json]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt", required=True)
    ap.add_argument("-val_fns", required=True)
    ap.add_argument("-grid", default=None, help="H,W (resolution-adapted checkpoints)")
    ap.add_argument("-batch_size", type=int, default=8)
    ap.add_argument("-temperature", type=float, default=100.0)
    ap.add_argument("-out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.finetune.models import MerlotReserveTVQAZeroShot
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.zero_shot import zero_shot_qa_eval

    device = resolve_device(args.device)
    kw = {"output_grid": tuple(int(x) for x in args.grid.split(","))} if args.grid else {}
    cfg = load_config(args.config, **kw).replace_data(lang_seq_len=256, num_segments=7)
    model = MerlotReserveTVQAZeroShot(cfg, device=device)
    params = pretrained_params(args.ckpt, cfg.model.scan_layers)
    batches = finetune_batches(sorted(glob.glob(args.val_fns)), cfg, "tvqa_zero_shot",
                               args.batch_size, is_training=False, repeat=False, return_ids=True)
    metrics, rows = zero_shot_qa_eval(model, params, batches, "tvqa",
                                      temperature=args.temperature,
                                      mesh=config_mesh(cfg, device))
    print(json.dumps(metrics))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return metrics, rows


if __name__ == "__main__":
    main()
