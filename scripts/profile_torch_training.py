#!/usr/bin/env python3
"""Where the time of one pretraining step goes, for the PyTorch/CUDA port on
one CUDA card.

Builds the full-width base ``MerlotReservePretrainer`` (``joint_attention_impl
="flash"``, bf16 compute, random weights from a seed) with its optimizer and
the port's dummy batch of 8 examples, takes two warm-up steps, and measures:

* the whole ``train_step`` on the device clock (CUDA events, 3 steps);
* one ``torch.profiler`` trace of two steps, split into parts that add up
  to the step. The parts are ``train_step``'s own ranges (cast, forward,
  backward, grads, optimizer; see ``training/trainer.py``) and, inside the
  forward and the backward, one part per tower (vision, audio, token
  embedding, joint, span) and the rest (stream fusion, pooling, heads,
  loss). A tower's forward is the range that forward hooks put around its
  call; a backward node belongs to the tower whose forward op made it (they
  share a sequence number). Each part gets its host ms (wall time of its
  ranges on the host) and its device ms (the kernels and copies launched
  from inside it; a kernel launched through ctypes, which the profiler ties
  to no host op, goes to its part by name, as ``KERNEL_PARTS`` says). Device
  time launched outside every range is reported as ``outside``;
* from the same trace: the device's busy share of the traced window,
  device ops per step, and the device ops that take the most time.

Run from the root of a checkout: ``python3 scripts/profile_torch_training.py``.
Prints a summary and writes ``chiprun_out/profile_torch_training.json``.
The long-video recipe (``configs/soak_longvideo.yaml``, both remat knobs)
with its joint attention as ``ring:flash`` over 4 virtual sp ranks, on the
dummy batch of 4 examples:
``python3 scripts/profile_torch_training.py --config soak_longvideo --batch 4 --sp 4``
(``--sp 1``, the default, is ``flash`` without a mesh); the record then goes
to ``chiprun_out/profile_torch_training_soak_longvideo_sp4.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from chip_smoke import cuda_time_ms  # noqa: E402

TOWERS = {"vision_encoder": "vision", "audio_encoder": "audio", "token_encoder": "tokens",
          "joint_transformer": "joint", "span_encoder": "span"}
RANGES = ("train_step/", "tower/")
# kernels launched through ctypes, which the profiler ties to no host op:
# their part by kernel name
KERNEL_PARTS = {"adam_update_kernel": "optimizer"}


def _kernel_part(name):
    return next((p for k, p in KERNEL_PARTS.items() if k in name), None)
EVALUATE = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def tower_ranges(model):
    """Runs each tower's forward inside a ``record_function`` range named
    ``tower/<name>``."""
    open_ranges, handles = defaultdict(list), []
    for attr, name in TOWERS.items():
        def enter(module, args, name=name):
            rf = record_function(f"tower/{name}")
            rf.__enter__()
            open_ranges[name].append(rf)

        def leave(module, args, out, name=name):
            open_ranges[name].pop().__exit__(None, None, None)

        module = getattr(model, attr)
        handles += [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _is_annotation(e):
    """A range's own span on the device timeline, not a kernel (``e`` is an
    event or an average of events)."""
    name = e.key if hasattr(e, "key") else e.name
    return getattr(e, "is_user_annotation", False) or name.startswith(RANGES)


def split_step(events, steps):
    """Host and device ms per step for each part of ``train_step``, from a
    trace's ``events()``. Returns ({part: {"host_ms", "device_ms"}}, total
    device ms per step)."""
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # the op that made each autograd node is the last forward op to record
    # its sequence number; the node's tower is that op's tower
    maker = {}
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not any(a.name.startswith(EVALUATE) for a in _ancestors(e)):
            maker[e.sequence_nr] = e

    def tower_of(e):
        return next((a.name[len("tower/"):] for a in _ancestors(e)
                     if a.name.startswith("tower/")), "other")

    node_tower = {}
    for e in cpu:
        if e.name.startswith(EVALUATE):
            node = next((c for c in e.cpu_children if c.name == e.name[len(EVALUATE):]), None)
            seq = node.sequence_nr if node is not None else -1
            node_tower[e.id] = tower_of(maker[seq]) if seq in maker else "other"

    def part_of(e):
        for a in _ancestors(e):
            if a.name.startswith(EVALUATE):
                return "backward/" + node_tower[a.id]
            if a.name.startswith("tower/"):
                return "forward/" + a.name[len("tower/"):]
            if a.name.startswith("train_step/"):
                part = a.name[len("train_step/"):]
                return part + "/other" if part in ("forward", "backward") else part
        return "outside"

    host, device = defaultdict(float), defaultdict(float)
    for e in cpu:
        device[part_of(e)] += sum(k.duration for k in e.kernels
                                  if k.name != e.name and _kernel_part(k.name) is None)
        if e.name.startswith("train_step/"):
            part = e.name[len("train_step/"):]
            host[part + "/other" if part in ("forward", "backward") else part] += e.cpu_time_total
        elif e.name.startswith("tower/"):
            host["forward/" + e.name[len("tower/"):]] += e.cpu_time_total
            host["forward/other"] -= e.cpu_time_total
        elif e.name.startswith(EVALUATE) and not any(
                a.name.startswith(EVALUATE) for a in _ancestors(e.cpu_parent)):
            host["backward/" + node_tower[e.id]] += e.cpu_time_total
            host["backward/other"] -= e.cpu_time_total
    gpu = [e for e in events if e.device_type == DeviceType.CUDA and not _is_annotation(e)]
    for e in gpu:
        if _kernel_part(e.name) is not None:
            device[_kernel_part(e.name)] += e.time_range.elapsed_us()
    total = sum(e.time_range.elapsed_us() for e in gpu)
    device["outside"] += total - sum(device.values())
    parts = {p: {"host_ms": host[p] / 1e3 / steps, "device_ms": device[p] / 1e3 / steps}
             for p in sorted(set(host) | set(device))}
    return parts, total / 1e3 / steps


def trace_steps(state, batch, steps, activities):
    """``steps`` train steps under ``torch.profiler`` with the tower ranges
    on. Returns (profiler, wall ms of the window)."""
    from merlot_reserve_tpu_torch.training.trainer import train_step

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with tower_ranges(state.model), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="base", help="a config of the port's configs/")
    parser.add_argument("--batch", type=int, default=8, help="examples per step")
    parser.add_argument("--sp", type=int, default=1,
                        help="virtual sp ranks of the joint attention's ring:flash (1: flash)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA card", file=sys.stderr)
        return 2
    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
    from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    ring = dict(joint_attention_impl="ring:flash", seq_shard_axis="sp", segment_shard_axis="sp")
    cfg = load_config(args.config, **(ring if args.sp > 1 else {"joint_attention_impl": "flash"}))
    B = args.batch
    model = MerlotReservePretrainer(cfg, device="cuda", seed=0)
    state = create_train_state(cfg, model)
    batch = batch_to_tensors(make_dummy_batch(cfg, B, seed=0), "cuda")
    mesh = make_mesh(sp=args.sp) if args.sp > 1 else None
    with activate_mesh(mesh):
        for _ in range(2):  # warm-up: kernel builds, allocator, cuBLAS handles
            train_step(state, batch)
        torch.cuda.synchronize()
        step_ms = cuda_time_ms(lambda: train_step(state, batch), iters=3, warmup=0)

        steps = 2
        prof, wall_ms = trace_steps(state, batch, steps,
                                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    parts, device_ms = split_step(prof.events(), steps)
    # device-side events only (kernels and copies); CPU ops carry their kernels' time too
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
           and not _is_annotation(e)]
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    attn_bwd = sorted((e for e in ops if "flash_bwd" in e.key),
                      key=lambda e: e.self_device_time_total, reverse=True)
    res = {
        "card": card, "config": args.config, "sp": args.sp,
        "joint_attention_impl": cfg.model.joint_attention_impl, "batch": B,
        "step_ms_device": step_ms,
        "profiled_steps": steps, "profiled_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms * steps / wall_ms,
        "device_ops_per_step": sum(e.count for e in ops) / steps,
        "parts": parts,
        "host_ms_sum_of_parts": sum(p["host_ms"] for p in parts.values()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "top_kernels": [{"name": e.key[:120], "calls_per_step": e.count / steps,
                         "ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "share": e.self_device_time_total / 1e3 / (device_ms * steps)}
                        for e in top],
        "flash_bwd_kernels": [{"name": e.key[:120], "calls_per_step": e.count / steps,
                               "ms_per_step": e.self_device_time_total / 1e3 / steps}
                              for e in attn_bwd],
    }
    print(f"[profile] {card}")
    print(f"[profile] train_step: {step_ms:.2f} ms on the device clock, {args.config}, batch "
          f"{B}, joint attention {cfg.model.joint_attention_impl}" +
          (f" over {args.sp} sp ranks" if mesh else ""))
    print(f"[profile] under the profiler: {wall_ms / steps:.2f} ms per step, device busy "
          f"{100 * res['device_busy_share']:.1f}% ({device_ms:.2f} ms of kernels and copies), "
          f"{res['device_ops_per_step']:.0f} kernels and copies per step")
    print(f"[profile] {'part':18s} {'host ms':>9s} {'device ms':>10s}   (per step)")
    for name, p in sorted(parts.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"[profile] {name:18s} {p['host_ms']:9.2f} {p['device_ms']:10.2f}")
    print(f"[profile] {'sum':18s} {res['host_ms_sum_of_parts']:9.2f} "
          f"{sum(p['device_ms'] for p in parts.values()):10.2f}")
    for k in res["top_kernels"]:
        print(f"[profile]   {k['ms_per_step']:8.3f} ms {100 * k['share']:5.1f}% "
              f"x{k['calls_per_step']:.0f}  {k['name']}")
    for k in res["flash_bwd_kernels"]:  # the attention backward's launches (joint and span)
        print(f"[profile]   attention backward: {k['ms_per_step']:8.3f} ms "
              f"x{k['calls_per_step']:.0f}  {k['name']}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "" if args.config == "base" and mesh is None else f"_{args.config}_sp{args.sp}"
    (out / f"profile_torch_training{name}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
