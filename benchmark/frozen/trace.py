"""A profiler trace, read: the events of a Kineto Chrome trace and what the
benchmark takes from them.

``load_events`` follows ``load_trace_events`` of
``merlot_reserve_tpu_torch/utils/profiling.py`` at commit 3f8d0e0 (lanes
named from the process metadata and Kineto's ``process_labels``) and keeps
each event's category, which tells the card's work ("kernel",
"gpu_memcpy", "gpu_memset") from the ranges Kineto projects onto the card's
lanes ("gpu_user_annotation") and from the host's calls ("cuda_runtime",
"cpu_op", "user_annotation").
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_OP_CATEGORIES = ("cpu_op", "user_annotation", "python_function")


@dataclass
class Event:
    name: str
    cat: str
    lane: str
    thread: str
    start_us: float
    dur_us: float
    args: Dict = field(default_factory=dict)

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


def load_events(path) -> List[Event]:
    """Every complete ('X') event of a Chrome trace (plain or gzipped)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    trace_events = raw.get("traceEvents", []) if isinstance(raw, dict) else raw
    pid_names, pid_labels, tid_names = {}, {}, {}
    for ev in trace_events:
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "")
            elif ev.get("name") == "process_labels":
                pid_labels[ev.get("pid")] = ev.get("args", {}).get("labels", "")
            elif ev.get("name") == "thread_name":
                tid_names[(ev.get("pid"), ev.get("tid"))] = ev.get("args", {}).get("name", "")

    def lane(pid):
        name = pid_names.get(pid, str(pid))
        return f"{name} ({pid_labels[pid]})" if pid_labels.get(pid) else name

    out = []
    for ev in trace_events:
        if ev.get("ph") != "X":
            continue
        pid = ev.get("pid")
        out.append(Event(name=ev.get("name", ""), cat=ev.get("cat", ""), lane=lane(pid),
                         thread=tid_names.get((pid, ev.get("tid")), str(ev.get("tid"))),
                         start_us=float(ev.get("ts", 0.0)), dur_us=float(ev.get("dur", 0.0)),
                         args=ev.get("args", {}) or {}))
    return out


@dataclass
class Window:
    """The traced window: its span, the card's events inside it, and the
    host's calls."""

    start_us: float
    end_us: float
    device: List[Event]
    host_calls: List[Event]
    host_ops: List[Event]

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6


SYNC_CALLS = ("cudaDeviceSynchronize",)


def window(events: Sequence[Event], marker: str) -> Window:
    """The traced window. Where the host's ops were traced, it is the host
    range named ``marker`` (a ``record_function`` around the traced
    iterations, which end in a synchronise); where only the card and the
    runtime calls were traced, it runs from the end of the first device
    synchronise to the end of the last (the tracer synchronises right after
    it starts and right before it stops)."""
    marks = [e for e in events if e.name == marker and e.cat == "user_annotation"]
    if marks:
        mark = max(marks, key=lambda e: e.dur_us)
        lo, hi = mark.start_us, mark.end_us
    else:
        syncs = sorted((e for e in events if e.cat == "cuda_runtime" and e.name in SYNC_CALLS),
                       key=lambda e: e.end_us)
        if len(syncs) < 2:
            raise ValueError(f"no range {marker!r} and fewer than two synchronises in the trace")
        lo, hi = syncs[0].end_us, syncs[-1].end_us

    def inside(e):
        return e.end_us > lo and e.start_us < hi

    return Window(lo, hi,
                  [e for e in events if e.cat in DEVICE_CATEGORIES and inside(e)],
                  [e for e in events if e.cat in HOST_CALL_CATEGORIES and inside(e)],
                  [e for e in events if e.cat in HOST_OP_CATEGORIES and inside(e)
                   and e.name != marker])


def busy_intervals(w: Window) -> List[Tuple[float, float]]:
    """The union of the card's events, clipped to the window."""
    spans = sorted((max(e.start_us, w.start_us), min(e.end_us, w.end_us)) for e in w.device)
    merged: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(w: Window) -> float:
    return sum(b - a for a, b in busy_intervals(w)) / 1e6


def idle_gaps(w: Window, top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of the window with nothing on the card, each
    named by what the host was doing: the runtime call that overlaps it
    most, else the innermost host op that does."""
    busy = busy_intervals(w)
    edges = [w.start_us] + [x for ab in busy for x in ab] + [w.end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        out.append((_host_doing(w, a, b), (b - a) / 1e6))
    return out


def _overlap(e: Event, a: float, b: float) -> float:
    return max(0.0, min(e.end_us, b) - max(e.start_us, a))


def _host_doing(w: Window, a: float, b: float) -> str:
    calls = [(e, _overlap(e, a, b)) for e in w.host_calls]
    calls = [c for c in calls if c[1] > 0]
    if calls:
        return max(calls, key=lambda c: c[1])[0].name
    ops = [(e, _overlap(e, a, b)) for e in w.host_ops]
    ops = [c for c in ops if c[1] > 0]
    if ops:
        best = max(c[1] for c in ops)
        return min((c for c in ops if c[1] >= 0.5 * best), key=lambda c: c[0].dur_us)[0].name
    return "host"


def device_op_table(w: Window, top: Optional[int] = 10) -> List[Tuple[str, float]]:
    """The card's operations by summed seconds inside the window."""
    total: Dict[str, float] = {}
    for e in w.device:
        total[e.name] = total.get(e.name, 0.0) + (min(e.end_us, w.end_us)
                                                  - max(e.start_us, w.start_us)) / 1e6
    rows = sorted(total.items(), key=lambda kv: -kv[1])
    return rows[:top] if top else rows
