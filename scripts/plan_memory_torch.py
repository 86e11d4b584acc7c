#!/usr/bin/env python
"""Memory planning for the port: will a training layout fit on an 80 GB H100?

Wraps ``merlot_reserve_tpu_torch/parallel/memory.py`` (fit on the port's own
measured peaks on the card) so that batch, remat, ZeRO-1, tp, pp and sp can
be sized before a run. Prints one JSON line per batch size, then the
calibration table (the planner against every measured peak) with
``--calibration``. Needs no card.

Examples:
  python scripts/plan_memory_torch.py base --batch 4 8 16
  python scripts/plan_memory_torch.py large --batch 8 --zero1-dp 8 --tp 2
  python scripts/plan_memory_torch.py soak_longvideo --batch 1 4 --sp 4
  python scripts/plan_memory_torch.py base --calibration
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="config name or YAML path")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4, 8],
                    help="each card's batch (the global batch over dp)")
    ap.add_argument("--remat", action="store_const", const=True, default=None,
                    help="the joint tower's gradient_checkpoint (default: the config's)")
    ap.add_argument("--tower-remat", action="store_const", const=True, default=None,
                    help="the towers' tower_gradient_checkpoint (default: the config's)")
    ap.add_argument("--zero1-dp", type=int, default=1,
                    help="dp ways the masters and moments shard over (ZeRO-1)")
    ap.add_argument("--tp", type=int, default=1, help="Megatron tensor-parallel ways")
    ap.add_argument("--pp", type=int, default=1, help="pipeline stages")
    ap.add_argument("--sp", type=int, default=1,
                    help="ranks the joint sequence splits over across processes")
    ap.add_argument("--sp-impl", default="ring:flash",
                    choices=["ring:flash", "ulysses:flash"],
                    help="how the joint sequence splits over sp")
    ap.add_argument("--dense-joint", action="store_true",
                    help="the joint tower on the dense path (default: flash)")
    ap.add_argument("--hbm-gib", type=float, default=80.0, help="device memory per card")
    ap.add_argument("--calibration", action="store_true",
                    help="also print the planner against the measured peaks")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.parallel import memory

    cfg = load_config(args.config)
    for b in args.batch:
        est = memory.estimate_train_hbm(
            cfg, b, remat=args.remat, zero1_dp=args.zero1_dp, pp=args.pp,
            flash=not args.dense_joint, tp=args.tp, sp=args.sp, tower_remat=args.tower_remat,
            sp_impl=args.sp_impl)
        gib = {k: round(v / memory.GIB, 3) for k, v in est.items() if k != "params"}
        print(json.dumps({"config": args.config, "batch": b, "params": int(est["params"]),
                          "gib": gib, "fits": est["total"] <= args.hbm_gib * memory.GIB}))
    if args.calibration:
        for name, pred, measured in memory.calibration_points():
            print(json.dumps({"point": name, "predicted_gib": round(pred, 3),
                              "measured_gib": measured,
                              "error": round((pred - measured) / measured, 4)}))


if __name__ == "__main__":
    main()
