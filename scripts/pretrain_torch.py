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

``-distributed`` joins a job of one process per card started by torchrun
(``parallel.distributed.initialize``; ``utils/launch.py`` builds the
commands): the mesh is the config's ``device`` section (dp, tp, sp, pp)
over the job's ranks, each process's loader reads its data-parallel rank's
file shard and its share of the global batch, and the state is ZeRO-1.

    torchrun --nproc_per_node 8 scripts/pretrain_torch.py base -distributed \
        -train_fns "shards/*.tfrecord" -output_dir out

SIGTERM (a preemption) finishes the step in flight, writes the checkpoint
(``ckpt_<step>``; per-rank shards in ``<step>/`` under ``-distributed``)
and ``loader_state.json`` into ``-output_dir`` and exits with 0; the same command then resumes from the
next record (``scripts/profile_torch_soak.py`` drives the soak recipes so).
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
    ap.add_argument("-output_dir", default=None)
    ap.add_argument("-train_fns", default=None,
                    help="glob or {:05d}-style pattern for TFRecord shards")
    ap.add_argument("-num_steps", type=int, default=None)
    ap.add_argument("-batch_size", type=int, default=None,
                    help="override device.batch_size (global batch)")
    ap.add_argument("-seed", type=int, default=None)
    ap.add_argument("-log_every", type=int, default=50,
                    help="print each step's losses this many steps after it (0: as it ends)")
    ap.add_argument("-log_batches", action="store_true",
                    help="print each step's 'batch <step>: records <sha1> built <sha1>': "
                         "digests of the batch as fed and as built (with --fused_data, "
                         "on the card with that step's draws)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-distributed", action="store_true",
                    help="join the torchrun job first (one process per card; NCCL, or gloo "
                         "with --device cpu)")
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
    from merlot_reserve_tpu_torch.parallel import distributed
    from merlot_reserve_tpu_torch.parallel.sharding import data_shard
    from merlot_reserve_tpu_torch.training.pretrain import (batch_digest, config_mesh,
                                                           run_pretraining)

    device = distributed.initialize(args.device) if args.distributed else args.device

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
        kw["device"] = device
    mesh = config_mesh(cfg, device) if args.distributed else None
    host_index, num_hosts = data_shard(mesh)
    loader = input_fn_builder(cfg, files, host_index=host_index, num_hosts=num_hosts,
                              seed=args.seed, use_bfloat16=cfg.model.use_bfloat16,
                              on_device=on_device, **kw)

    def log_fn(step, metrics):
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                         if not k.startswith("_"))
        print(f"step {step}: {parts}", flush=True)

    def log_batch(step, raw, batch):
        print(f"batch {step}: records {batch_digest(raw)} built {batch_digest(batch)}",
              flush=True)

    try:
        state = run_pretraining(
            cfg, loader, num_steps=args.num_steps, output_dir=args.output_dir,
            log_fn=log_fn if distributed.process_index() == 0 else None, device=device,
            seed=args.seed or 0, mesh=mesh, log_every=args.log_every,
            fused_builder=loader._dev_builder if args.fused_data else None,
            data_seed=args.seed or 0,
            on_batch=log_batch if args.log_batches and distributed.process_index() == 0
            else None)
        if distributed.process_index() == 0:  # this process's hand-written kernels
            from merlot_reserve_tpu_torch import kernels

            print(f"stopped at step {state.step}; kernel launches "
                  f"{json.dumps(dict(sorted(kernels.LAUNCHES.items())))}", flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
