#!/usr/bin/env python
"""Profile one pretraining step of the PyTorch port and print its device-op
time table: the counterpart of ``scripts/profile_step.py``.

Warms the step up (the kernels build and load) outside the trace, then
traces ONE step under ``utils.profiling.trace`` and aggregates the card's
lanes of the Kineto dump (``lane_filter=DEVICE_LANES``, "gpu": the lanes
Kineto labels "GPU 0", one thread per stream): the top kernels by total
time and the step's device wall time (first kernel start to last kernel
end), printed beside the step's device time by CUDA events (the trace's
wall is longer: the profiler slows the host's launches). On the CPU
(``--device=cpu``, a smoke run) every lane is read.

Usage:
  python scripts/profile_step_torch.py [--config=base] [--batch=1] [--unroll]
                                       [--remat] [--remat_policy=NAME]
                                       [--out=profile_step_torch] [--top=25]
                                       [--device=cuda]
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv

    def flag(name, default=None):
        for a in args:
            if a.startswith(f"--{name}="):
                return a.split("=", 1)[1]
        return default

    config_name = flag("config", "base")
    batch = int(flag("batch", "1"))
    top = int(flag("top", "25"))
    out_dir = flag("out", os.path.join(REPO, "chiprun_out", "profile_step_torch"))
    unroll = "--unroll" in args
    remat = "--remat" in args

    import torch

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.profiling import (DEVICE_LANES, load_trace_events,
                                                          op_time_table, trace, trace_wall_ms)

    device = resolve_device(flag("device", "cuda"))
    cfg = load_config(config_name, gradient_checkpoint=remat,
                      gradient_checkpoint_policy=flag("remat_policy"), scan_layers=not unroll)
    state = create_train_state(cfg, MerlotReservePretrainer(cfg, device=device, seed=0))
    b = batch_to_tensors(make_dummy_batch(cfg, batch_size=batch), device)
    on_card = device.type == "cuda"

    def step():
        _, metrics = train_step(state, b)
        return float(metrics["total"])  # waits for the step

    step()  # warm up: the kernels build and load outside the trace
    event_ms = None
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end)
    with trace(out_dir):
        step()

    lane = DEVICE_LANES if on_card else None
    events = load_trace_events(out_dir)
    wall = trace_wall_ms(events, lane_filter=lane)
    # the step's record_function ranges (train_step/forward, ...) also land
    # on the card's lane, over its kernels: the table leaves them out
    table = op_time_table([e for e in events if not e.name.startswith("train_step/")],
                          lane_filter=lane, top=top)
    print(f"# {'device' if on_card else 'host'} wall (one step): {wall:.1f} ms"
          + (f"; CUDA events {event_ms:.1f} ms" if on_card else "")
          + f"; top {len(table)} ops:", file=sys.stderr)
    for r in table:
        print(f"#  {r['total_ms']:9.3f} ms  x{r['count']:<5d} "
              f"{r['pct']:5.1f}%  {r['name'][:90]}", file=sys.stderr)
    print(json.dumps({"metric": "profiled_step_device_wall_ms", "value": round(wall, 2),
                      "cuda_event_ms": event_ms, "config": config_name, "batch": batch,
                      "scan_layers": not unroll, "remat": remat, "trace_dir": out_dir,
                      "lane_filter": lane, "top_op": table[0]["name"] if table else None,
                      "top": table}))


if __name__ == "__main__":
    main()
