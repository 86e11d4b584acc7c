#!/usr/bin/env python3
"""The pretraining step as a job of one process over NCCL against the
one-process step, on one CUDA card.

Builds the full-width base ``MerlotReservePretrainer`` (``flash`` attention,
bf16 compute, random weights from a seed) and the port's dummy batch of 8
examples, then, in turns (one process, world 1, world 1, one process),
takes two warm-up steps, times three steps by CUDA events and on the host
clock, and traces one step with ``torch.profiler``: the number of device
kernels, their summed time, and the kernels that take the most time. World
1 is ``training.trainer.create_distributed_train_state`` on the process mesh
of a job of one rank (``parallel.distributed.initialize`` with the
variables set here), the path ``chip_smoke.py`` phase 20 checks for
numbers.

Run from the root of a checkout: ``python3 scripts/profile_torch_distributed.py``.
Prints a summary and writes ``chiprun_out/profile_torch_distributed.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def one_arm(cfg, batch, mesh, label):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh
    from merlot_reserve_tpu_torch.training.trainer import (create_distributed_train_state,
                                                           create_train_state, train_step)

    model = MerlotReservePretrainer(cfg, device="cuda", seed=0)
    state = (create_train_state(cfg, model) if mesh is None
             else create_distributed_train_state(cfg, model, mesh))
    b = batch_to_tensors(batch, "cuda")
    with activate_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for _ in range(2):
            train_step(state, b)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(3):
            train_step(state, b)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        event_ms = start.elapsed_time(end) / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_step(state, b)
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sum(e.count for e in rows)
    kernel_ms = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    print(f"[{label}] {host_ms:.1f} ms host, {event_ms:.1f} ms by events per step; one traced "
          f"step: {kernels} device kernels, {kernel_ms:.1f} ms of kernel time", flush=True)
    for e in top:
        print(f"[{label}]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return {"host_ms": host_ms, "event_ms": event_ms, "kernels": kernels,
            "kernel_ms": kernel_ms,
            "top": [[e.key[:120], e.self_device_time_total / 1e3, e.count] for e in top]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_distributed: needs a CUDA card", file=sys.stderr)
        return 2
    import dataclasses

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.parallel import distributed
    from merlot_reserve_tpu_torch.parallel.mesh import make_mesh

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = load_config("base", joint_attention_impl="flash")
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
    batch = make_dummy_batch(cfg, 8, seed=0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    distributed.initialize("cuda")
    try:
        mesh = make_mesh()
        arms = {}
        for label, m in (("one_process", None), ("world1", mesh), ("world1_again", mesh),
                         ("one_process_again", None)):
            arms[label] = one_arm(cfg, batch, m, label)
    finally:
        distributed.shutdown()
    print(card, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_distributed.json").write_text(
        json.dumps({"card": card, "arms": arms}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
