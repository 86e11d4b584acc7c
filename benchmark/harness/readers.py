"""What the per-layer metrics' readers share: the traced window, what the
traced iterations asked of the card (``work``), what the host clock gave
for the rest of the window after them (``host``), and the arithmetic that
turns them into shares. A reader that finds nothing to read returns None
and the metric is left out of the line."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from frozen.trace import Window, busy_seconds

FLASH_FWD = r"\bflash_fwd_(bf16|f32)_kernel\b"
FLASH_BWD = r"\bflash_bwd_(prep|bf16|convert|dq_f32|dkv_f32)_kernel\b"
ADAM_UPDATE = r"\badam_update_kernel\b"


@dataclass
class Context:
    window: Window
    work: Dict[str, float]
    host: Dict[str, Any] = field(default_factory=dict)


def kernel_seconds(ctx: Context, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(e.dur_us for e in ctx.window.device
               if e.cat == "kernel" and rx.search(e.name)) / 1e6


def roofline(ctx: Context, pattern: str, bound: str) -> Optional[float]:
    """The kernels' least possible time (the sum of their launches' bounds)
    as a share (%) of the time the trace gives them."""
    t = kernel_seconds(ctx, pattern)
    if t <= 0 or not ctx.work.get(bound):
        return None
    return 100.0 * ctx.work[bound] / t


def mfu(ctx: Context) -> Optional[float]:
    """The model's FLOPs per second over the window after the traced
    iterations (the profiler is off there), as a share (%) of the card's
    bf16 peak."""
    n, seconds = ctx.host.get("iterations"), ctx.host.get("seconds")
    if not n or not seconds or not ctx.work.get("flops_per_iteration"):
        return None
    return 100.0 * ctx.work["flops_per_iteration"] * n / seconds / ctx.work["peak_flops"]


def latency_percentile_ms(ctx: Context, q: float) -> Optional[float]:
    """The ``q``-th percentile of the requests' latencies (ms) after the
    traced iterations."""
    lat = ctx.host.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=np.float64), q))


def device_idle(ctx: Context) -> Optional[float]:
    """The share (%) of the window with no kernel, copy or memset on the card."""
    if ctx.window.seconds <= 0 or not ctx.window.device:
        return None
    return 100.0 * (1.0 - busy_seconds(ctx.window) / ctx.window.seconds)


def copy_ms_per_iteration(ctx: Context, direction: str) -> Optional[float]:
    """Device milliseconds of the window's copies in ``direction`` (HtoD,
    DtoH) per iteration."""
    spans = [e.dur_us for e in ctx.window.device
             if e.cat == "gpu_memcpy" and direction in e.name]
    if not spans or not ctx.work.get("iterations"):
        return None
    return sum(spans) / 1e3 / ctx.work["iterations"]
