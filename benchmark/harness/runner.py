"""One run of one cell: set-up, the measured window (traced in part with
``trace``), the check against the reference, and the result line."""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from frozen import trace as trace_mod
from harness import checks
from harness.cell import ROOT, Cell
from harness.readers import Context

FORBIDDEN = ("jax", "jaxlib", "flax", "merlot_reserve_tpu")
WINDOW_MARK = "bench/window"
TRACE_PATH = ROOT / ".bench_cache" / "trace" / "window.json"


def forbidden_modules() -> List[str]:
    """The forbidden top-level packages this process has loaded, each
    compared whole (``merlot_reserve_tpu_torch`` is not
    ``merlot_reserve_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Tracer:
    """Profiles the first ``n`` iterations of the window, from a synchronise
    right after the profiler starts to one right before it stops. On the
    card only the card's lanes and the runtime calls are traced (the host's
    ops are not: recording every op would slow the host, which paces these
    cells, and so widen the idle gaps it is read for); on the CPU, the
    host's ops inside one range."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device, self.done = n, device, False
        self.range = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def before(self, i: int) -> None:
        if i:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.start()
        if cuda:
            self._sync()
        else:
            self.range = record_function(WINDOW_MARK)
            self.range.__enter__()

    def after(self, i: int) -> None:
        if i != self.n - 1:
            return
        self._sync()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.prof.stop()
        self.end = time.perf_counter()
        self.done = True

    def window(self) -> trace_mod.Window:
        TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(TRACE_PATH))
        try:
            events = trace_mod.load_events(TRACE_PATH)
        finally:
            TRACE_PATH.unlink(missing_ok=True)
        return trace_mod.window(events, WINDOW_MARK)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device) -> Tuple[Dict[str, Any],
                                                                              List[str]]:
    """-> (the result object, the lines that end standard error)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = cell.driver(seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    tracer: Optional[Tracer] = Tracer(cell.traffic["trace_iterations"], device) if traced else None
    i = 0
    start = time.perf_counter()
    while True:
        if tracer:
            tracer.before(i)
        driver.iterate(i)
        if tracer:
            tracer.after(i)
        i += 1
        now = time.perf_counter()
        elapsed = now - start
        if elapsed >= seconds and (tracer is None or tracer.done):
            break

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    dev: Dict[str, Any] = {"platform": "gpu" if cuda else device.type,
                           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                           "count": 1}
    breakdown = None
    if tracer:
        w = tracer.window()
        # what the host clock gives after the traced iterations, to the end
        # of the window
        host = dict(driver.host_readings(tracer.n), iterations=i - tracer.n,
                    seconds=now - tracer.end)
        ctx = Context(w, driver.work(tracer.n), host)
        values = {name: read(ctx) for name, read in cell.readers.items()}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in values.items()
                   if v is not None}
        dev["busy_s"] = trace_mod.busy_seconds(w)
        dev["window_s"] = w.seconds
        breakdown = {"device_ops": [[n[:96], s] for n, s in trace_mod.device_op_table(w)],
                     "idle_gaps": [[n[:96], s] for n, s in trace_mod.idle_gaps(w)]}
    else:
        values = dict(driver.window_metrics(i, elapsed), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    driver.release()
    numbers = driver.numbers()
    judged = checks.judge(numbers, cell.limits)
    attempted, failed = driver.attempted(i)
    result: Dict[str, Any] = {"correct": checks.passes(judged), "attempted": attempted,
                              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = numbers
    result["checks"] = judged
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in judged.items()]
    return result, lines
