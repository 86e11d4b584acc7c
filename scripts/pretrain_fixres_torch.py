#!/usr/bin/env python
"""Resolution adaptation (fixres) of the PyTorch port: continue from a
pretrained checkpoint at the higher grids, lr x0.02 for 75k steps with
warmup 15k and a final lr scale of 0. The counterpart of
``scripts/pretrain_fixres.py``, with its flags.

By default every step carries both grids of ``POSSIBLE_RES``, half the
batch each, from disjoint file shards (the two grids act as 2 x num_hosts
virtual hosts, seeded apart), and the two halves' preds meet in one
contrastive loss (``training.trainer.make_mixed_res_train_step``): the
batch size must divide by 2 x num_hosts. ``-res H,W`` adapts to that one
grid instead. Checkpoints are saved without the optimizer. Runs on the
CUDA card unless ``--device cpu`` is given.

Usage: python scripts/pretrain_fixres_torch.py base -ckpt CKPT -train_fns 'shards/*' -output_dir OUT
"""

import argparse
import dataclasses
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POSSIBLE_RES = [(18, 32), (24, 24)]


def fixres_config(name, grid, num_steps, warmup, lr_scale):
    """``name`` at ``grid``: seq_len the joint length of that grid (lang +
    segments per group x pooled grid), the lr scaled, the schedule's steps
    and warmup, and a final lr scale of 0."""
    from merlot_reserve_tpu_torch import load_config

    cfg = load_config(name, output_grid=tuple(grid))
    cfg = cfg.replace_data(seq_len=cfg.joint_seq_len)
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, learning_rate=cfg.optimizer.learning_rate * lr_scale,
        num_train_steps=num_steps, num_warmup_steps=warmup, final_lr_scale=0.0))


def fixres_loaders(cfgs, files, base_seed, process_index=0, process_count=1, **kw):
    """One loader per grid config. With two configs (mixed mode) each reads
    its own shard of ``files`` (host 2 x process_index + i of 2 x
    process_count, seed ``base_seed + i``) and carries half the batch; with
    one, the process's shard and the whole batch."""
    from merlot_reserve_tpu_torch.data.loader import input_fn_builder

    if len(cfgs) == 1:
        return [input_fn_builder(cfgs[0], files, host_index=process_index,
                                 num_hosts=process_count, seed=base_seed,
                                 use_bfloat16=cfgs[0].model.use_bfloat16, **kw)]
    return [input_fn_builder(c, files, host_index=2 * process_index + i,
                             num_hosts=2 * process_count, seed=base_seed + i,
                             use_bfloat16=c.model.use_bfloat16, **kw)
            for i, c in enumerate(cfgs)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt", required=True)
    ap.add_argument("-train_fns", required=True)
    ap.add_argument("-output_dir", default=None)
    ap.add_argument("-num_steps", type=int, default=75_000)
    ap.add_argument("-warmup", type=int, default=15_000)
    ap.add_argument("-lr_scale", type=float, default=0.02)
    ap.add_argument("-res", default=None,
                    help="H,W: adapt to this single grid only; default trains both "
                         "grids of POSSIBLE_RES jointly (mixed-res)")
    ap.add_argument("-batch_size", type=int, default=None,
                    help="override device.batch_size (global batch, both grids)")
    ap.add_argument("-seed", type=int, default=None, help="loader seed (default: the time)")
    ap.add_argument("-log_every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from merlot_reserve_tpu_torch.data.loader import DeviceFeed
    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh
    from merlot_reserve_tpu_torch.training.trainer import (
        create_train_state, make_mixed_res_train_step, train_step)
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params, save_checkpoint
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params

    device = resolve_device(args.device)
    mixed = args.res is None
    grids = POSSIBLE_RES if mixed else [tuple(int(x) for x in args.res.split(","))]
    cfgs = [fixres_config(args.config, g, args.num_steps, args.warmup, args.lr_scale)
            for g in grids]
    if args.batch_size:
        cfgs = [c.replace_device(batch_size=args.batch_size) for c in cfgs]
    cfg = cfgs[0]

    model = MerlotReservePretrainer(cfg, device=device)
    load_flax_params(model, pretrained_params(args.ckpt, cfg.model.scan_layers))
    state = create_train_state(cfg, model)

    files = sorted(glob.glob(args.train_fns))
    if not files:
        raise SystemExit(f"no input files match {args.train_fns!r}")
    base_seed = int(time.time()) if args.seed is None else args.seed
    narrow = ({"images": torch.bfloat16, "audio_clips": torch.bfloat16}
              if cfg.model.use_bfloat16 else {})
    feeds = [DeviceFeed(loader, device, narrow=narrow)
             for loader in fixres_loaders(cfgs, files, base_seed)]

    mesh = config_mesh(cfg, device)
    if mixed:
        model_b = MerlotReservePretrainer(cfgs[1], device="meta")
        step_fn = make_mixed_res_train_step(cfg, state, model_b, mesh=mesh)
    else:
        def step_fn(state, batch):
            with activate_mesh(mesh):
                return train_step(state, batch)

    logged = []
    for step, step_batches in zip(range(args.num_steps), zip(*feeds)):
        state, metrics = step_fn(state, *step_batches)
        if args.log_every and (step + 1) % args.log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            logged.append((step, metrics))
            parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                             if not k.startswith("_"))
            print(f"step {step + 1}: {parts}", flush=True)
        if args.output_dir and (step + 1) % cfg.device.iterations_per_loop == 0:
            save_checkpoint(state, args.output_dir, no_optimizer=True)
    if args.output_dir:
        save_checkpoint(state, args.output_dir, no_optimizer=True)
    return state, logged


if __name__ == "__main__":
    main()
