#!/usr/bin/env python
"""Checkpoint converter of the PyTorch port: the counterpart of
``scripts/convert_checkpoint.py``, with its flags, over the port's
``utils/checkpoint.py``. Reads a flax-msgpack checkpoint written by either
package or by the reference's release and writes a converted one:

  * --to-scan:      restack 'layer_NN' trees into the stacked 'layers'
                    layout (scan_layers=True models);
  * --to-layers:    the inverse, the reference's layout;
  * --no-optimizer: strip the optimizer state (release/finetune convention);
  * --bfloat16:     cast the params to bf16 for inference-only deployments.

It reads and writes files in host memory and computes nothing on a device,
as the JAX script pins itself to the CPU, so it has no ``--device``.

Examples:
  python scripts/convert_checkpoint_torch.py ckpts/ out/ --to-scan
  python scripts/convert_checkpoint_torch.py ckpts/ out/ --to-layers --no-optimizer
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(raw, to_scan=False, to_layers=False, no_optimizer=False, bfloat16=False):
    """The converted checkpoint tree of ``raw`` (a ``load_checkpoint`` tree)."""
    from merlot_reserve_tpu_torch.utils import checkpoint as ckpt

    params = raw["params"]
    if to_scan:
        params = ckpt.stack_layer_params(params)
    elif to_layers:
        params = ckpt.unstack_layer_params(params)
    if bfloat16:
        params = ckpt.f32_to_bf16(params)
    out = dict(raw, params=params)
    if no_optimizer:
        out["opt_state"] = None
    if out.get("step") is None:
        out["step"] = 0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="checkpoint dir (ckpt_* files) or file")
    ap.add_argument("dst", help="output dir")
    ap.add_argument("--step", type=int, default=None,
                    help="which step to convert (default: latest)")
    direction = ap.add_mutually_exclusive_group()
    direction.add_argument("--to-scan", action="store_true",
                           help="layer_NN -> stacked 'layers' leaves")
    direction.add_argument("--to-layers", action="store_true",
                           help="stacked 'layers' -> layer_NN (reference layout)")
    ap.add_argument("--no-optimizer", action="store_true",
                    help="drop optimizer state from the output")
    ap.add_argument("--bfloat16", action="store_true",
                    help="cast float32 params to bfloat16 (inference)")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch.utils import checkpoint as ckpt

    raw = ckpt.load_checkpoint(args.src, step=args.step)
    if raw is None:
        raise SystemExit(f"no checkpoint found under {args.src!r}")
    if not isinstance(raw, dict) or "params" not in raw:
        raise SystemExit("checkpoint does not look like a train state (no 'params' entry)")
    out = convert(raw, args.to_scan, args.to_layers, args.no_optimizer, args.bfloat16)
    path = ckpt.save_checkpoint(out, args.dst)
    n = sum(x.numel() for _, x in ckpt.flat_leaves(out["params"]))
    print(f"wrote step {int(out['step'])} ({n:,d} params) to {args.dst}")
    return path


if __name__ == "__main__":
    main()
