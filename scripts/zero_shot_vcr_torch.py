#!/usr/bin/env python
"""Batched zero-shot VCR of the PyTorch port: rank each task's 4 choices
with a pretrained checkpoint, no finetuning. The counterpart of
``scripts/zero_shot_vcr.py``, with its flags: QA (question + 'answer:
<MASK>') and QA->R (question + 'rationale: <MASK>') statements over the
image, the choices span-encoded as the question's label space
(``finetune.models.MerlotReserveVCRZeroShot``, ``zero_shot.zero_shot_qa_eval``).
Prints the metrics as JSON; ``-out`` writes the per-example rows. Runs on
the CUDA card unless ``--device cpu`` is given.

Usage: python scripts/zero_shot_vcr_torch.py base -ckpt CKPT -val_fns 'val*' [-out preds.json]
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
    ap.add_argument("-batch_size", type=int, default=8)
    ap.add_argument("-out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.finetune.models import MerlotReserveVCRZeroShot
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.zero_shot import zero_shot_qa_eval

    device = resolve_device(args.device)
    cfg = load_config(args.config).replace_data(lang_seq_len=144)
    model = MerlotReserveVCRZeroShot(cfg, device=device)
    params = pretrained_params(args.ckpt, cfg.model.scan_layers)
    batches = finetune_batches(sorted(glob.glob(args.val_fns)), cfg, "vcr_zero_shot",
                               args.batch_size, is_training=False, repeat=False, return_ids=True)
    metrics, rows = zero_shot_qa_eval(model, params, batches, "vcr",
                                      mesh=config_mesh(cfg, device))
    print(json.dumps(metrics))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return metrics, rows


if __name__ == "__main__":
    main()
