#!/usr/bin/env python
"""Validation loss over saved checkpoints, for the PyTorch port: the
counterpart of ``scripts/validate.py``, with its flags. Each checkpoint in
``-ckpt_dir`` (in step order, only every ``-every``-th step if given) is
loaded into one model and replays the held-out TFRecords from the start
(``PretrainLoader(repeat=False, seed=0)``) through ``evaluate_loss``:
``-num_batches`` forward batches, then the contrastive loss once over all
of them, as training's whole-batch denominator. Runs on the CUDA card
unless ``--device cpu`` is given.

Usage: python scripts/validate_torch.py base -ckpt_dir DIR -val_fns 'val*' -num_batches 8 [-every 75000]
"""

import argparse
import glob
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_STEP = re.compile(r"ckpt_(\d+)$")


def checkpoints(ckpt_dir, every=0):
    """(step, path) of every ``ckpt_<step>`` in ``ckpt_dir``, oldest first;
    only steps that divide by ``every`` when it is given."""
    found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*"))
             if (m := _STEP.search(p))]
    return sorted((s, p) for s, p in found if not every or s % every == 0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt_dir", required=True)
    ap.add_argument("-val_fns", required=True)
    ap.add_argument("-num_batches", type=int, default=8)
    ap.add_argument("-batch_size", type=int, default=8)
    ap.add_argument("-every", type=int, default=0,
                    help="only evaluate ckpts whose step is a multiple of this")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.loader import PretrainLoader
    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh, evaluate_loss
    from merlot_reserve_tpu_torch.training.trainer import TrainState
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    files = sorted(glob.glob(args.val_fns))
    mesh = config_mesh(cfg, device)
    model = MerlotReservePretrainer(cfg, device=device)
    # evaluate_loss reads only the model: no optimizer state is allocated
    state = TrainState(model=model, optimizer=None)

    losses = {}
    for step, ckpt in checkpoints(args.ckpt_dir, args.every):
        load_flax_params(model, pretrained_params(ckpt, cfg.model.scan_layers))
        loader = PretrainLoader(files, cfg, batch_size=args.batch_size, seed=0, repeat=False,
                                use_bfloat16=cfg.model.use_bfloat16)
        info = evaluate_loss(cfg, state, loader, num_batches=args.num_batches, mesh=mesh)
        losses[step] = info
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(info.items())
                         if not k.startswith("_"))
        print(f"ckpt step {step}: {parts}", flush=True)
    return losses


if __name__ == "__main__":
    main()
