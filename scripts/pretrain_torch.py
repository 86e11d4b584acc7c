#!/usr/bin/env python
"""Pretraining entry point of the PyTorch port:
``python scripts/pretrain_torch.py base -train_fns "shards/*.tfrecord"``.

The counterpart of ``scripts/pretrain.py``, with its flags. It trains on the
CUDA card unless ``--device cpu`` is given, and never falls back to the CPU.
``--on_device_data`` assembles examples on the card (the loader's workers
only decode bytes), ``--fused_data`` assembles them inside each training
step, ``--on_device_frames`` moves the frame flip, resize, augmentation and
patchify onto the card too (the workers only decode JPEGs); either of the
last two implies the first.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-output_dir", default=None)
    ap.add_argument("-train_fns", default=None,
                    help="glob or {:05d}-style pattern for TFRecord shards")
    ap.add_argument("-num_steps", type=int, default=None)
    ap.add_argument("-batch_size", type=int, default=None,
                    help="override device.batch_size (global batch)")
    ap.add_argument("-seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--on_device_data", action="store_true",
                    help="assemble examples on the card (data/device_builder.py)")
    ap.add_argument("--fused_data", action="store_true",
                    help="assemble examples inside each training step "
                         "(trainer.make_fused_data_train_step); implies --on_device_data")
    ap.add_argument("--on_device_frames", action="store_true",
                    help="frame flip/resize/augment/patchify on the card too "
                         "(ops/vision_train.py); implies --on_device_data")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.loader import input_fn_builder
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

    cfg = load_config(args.config)
    if args.on_device_frames:
        cfg = cfg.replace_data(on_device_frames=True)
    if args.batch_size:
        cfg = cfg.replace_device(batch_size=args.batch_size)

    pattern = args.train_fns or cfg.data.train_fns
    if "{" in pattern:
        files = [pattern.format(i) for i in range(cfg.data.num_train_files)]
    else:
        files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no input files match {pattern!r}")

    on_device = args.on_device_data or args.fused_data or args.on_device_frames
    kw = {"fused": True} if args.fused_data else {}
    if on_device and not args.fused_data:
        kw["device"] = args.device
    loader = input_fn_builder(cfg, files, seed=args.seed, use_bfloat16=cfg.model.use_bfloat16,
                              on_device=on_device, **kw)

    def log_fn(step, metrics):
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                         if not k.startswith("_"))
        print(f"step {step}: {parts}", flush=True)

    run_pretraining(cfg, loader, num_steps=args.num_steps, output_dir=args.output_dir,
                    log_fn=log_fn, device=args.device, seed=args.seed or 0,
                    fused_builder=loader._dev_builder if args.fused_data else None,
                    data_seed=args.seed or 0)


if __name__ == "__main__":
    main()
