"""Profiling helpers: the trace context and the trace's op tables over
``torch.profiler``, the compile log, throughput meters and the analytic FLOP
counts behind MFU (the port of the JAX package's ``utils/profiling.py``),
and the peak rates of the CUDA cards the port knows.

``trace(log_dir)`` writes a Chrome trace (Kineto's ``*.pt.trace.json.gz``)
that ``load_trace_events``, ``op_time_table`` and ``trace_wall_ms`` read as
the JAX helpers read a ``jax.profiler`` dump. A Kineto trace names every
process lane "python" and tells them apart by a ``process_labels`` record
("CPU", "GPU 0"): a lane here is the process name with those labels,
"python (GPU 0)", so ``lane_filter=DEVICE_LANES`` ("gpu") selects the
card's lanes: its kernels, copies and memsets, one thread per stream. A
trace without labels (a ``jax.profiler`` dump) keeps the bare process name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Dict, Iterator, Optional

import torch

# the lane filter of the card's lanes in a trace(log_dir) dump
DEVICE_LANES = "gpu"
COMPILE_LOG = logging.getLogger("merlot_reserve_tpu_torch.compiles")
_LOG_COMPILES = False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """A ``torch.profiler`` trace of the block, the CPU and (with a card)
    the card's activity, written to ``log_dir`` as a gzipped Chrome trace
    when the block ends; view it in Perfetto or TensorBoard. Yields the
    profiler (its ``key_averages()`` and the like). The card is synchronised
    before the trace stops, so its work in the block is all in it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir, use_gzip=True))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


@contextlib.contextmanager
def log_compiles(enabled: bool = True) -> Iterator[None]:
    """While on, every compile the port makes is logged at WARNING to the
    ``merlot_reserve_tpu_torch.compiles`` logger (as ``jax_log_compiles``
    logs JAX's): each kernel build or load of ``kernels/build.py`` (name,
    built or cached, seconds) and each ``torch.export`` trace of
    ``export.py``."""
    global _LOG_COMPILES
    prev, _LOG_COMPILES = _LOG_COMPILES, enabled
    try:
        yield
    finally:
        _LOG_COMPILES = prev


def log_compile(kind: str, name: str, how: str, seconds: float) -> None:
    """One compile for ``log_compiles``: ``kind`` (kernel, export), what
    was compiled, how (built, cached, traced) and its seconds."""
    if _LOG_COMPILES:
        COMPILE_LOG.warning("%s %s: %s in %.3f s", kind, name, how, seconds)

# bf16 dense peak FLOP/s by card name (NVIDIA data sheets, without sparsity)
CUDA_PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM5 at its 700 W limit
}


class ThroughputMeter:
    """Rolling it/sec + examples/sec meter (train.py:141-145's loop print,
    structured)."""

    def __init__(self, window: int = 100, batch_size: Optional[int] = None):
        self.window = window
        self.batch_size = batch_size
        self._t0 = time.time()
        self._count = 0

    def step(self) -> Optional[Dict[str, float]]:
        self._count += 1
        if self._count % self.window:
            return None
        dt = time.time() - self._t0
        self._t0 = time.time()
        out = {"it_per_sec": self.window / dt}
        if self.batch_size:
            out["examples_per_sec"] = self.window * self.batch_size / dt
        return out


def log_jsonl(path: str, record: Dict):
    """Append one JSON line (metrics stream consumable by any dashboard)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


# ---------------------------------------------------------------------------
# the trace's device events -> op-time tables (the JAX helpers' results)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceEvent:
    """One complete ('ph'=='X') Chrome-trace event."""

    name: str
    lane: str        # the process lane, e.g. 'python (GPU 0)' or 'python (CPU)'
    thread: str
    start_us: float
    dur_us: float
    args: Dict


def find_trace_files(log_dir: str):
    """All *.trace.json.gz files under a ``trace(log_dir)`` dump, newest
    first (Kineto writes log_dir/<host>_<pid>.<ns>.pt.trace.json.gz)."""
    import glob
    import os

    paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True)
    return sorted(paths, key=os.path.getmtime, reverse=True)


def load_trace_events(log_dir: str):
    """Parse the newest trace dump under ``log_dir`` into TraceEvents.

    Resolves pid/tid metadata ('M' events) to lane and thread names, so
    callers can filter lanes by substring: a lane is its ``process_name``,
    followed by its ``process_labels`` in brackets where the trace has them."""
    import gzip

    paths = find_trace_files(log_dir)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(paths[0], "rt") as f:
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
        out.append(TraceEvent(
            name=ev.get("name", ""), lane=lane(pid),
            thread=tid_names.get((pid, ev.get("tid")), str(ev.get("tid"))),
            start_us=float(ev.get("ts", 0.0)), dur_us=float(ev.get("dur", 0.0)),
            args=ev.get("args", {}) or {}))
    return out


def _filtered(events, lane_filter: Optional[str]):
    if isinstance(events, str):
        events = load_trace_events(events)
    if lane_filter is not None:
        needle = lane_filter.lower()
        events = [e for e in events if needle in e.lane.lower()]
    return events


def op_time_table(events, lane_filter: Optional[str] = None, top: Optional[int] = 20):
    """Aggregate events into a per-op-name table sorted by total time.

    :param events: TraceEvents (or a log_dir string, loaded for you)
    :param lane_filter: case-insensitive substring of the lane name
        (``DEVICE_LANES`` selects the card's lanes; None = all lanes)
    :param top: keep the top-N rows (None = all)
    :returns: list of dicts {name, total_ms, count, mean_us, pct} where
        pct is of the filtered lanes' summed event time.
    """
    agg: Dict[str, list] = {}
    for e in _filtered(events, lane_filter):
        slot = agg.setdefault(e.name, [0.0, 0])
        slot[0] += e.dur_us
        slot[1] += 1
    total_us = sum(v[0] for v in agg.values()) or 1.0
    rows = [{"name": name, "total_ms": dur / 1e3, "count": n, "mean_us": dur / n,
             "pct": 100.0 * dur / total_us} for name, (dur, n) in agg.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top] if top else rows


def trace_wall_ms(events, lane_filter: Optional[str] = None) -> float:
    """Wall-clock span (max end - min start) of the filtered lanes: the
    step's device time when the trace brackets exactly one step."""
    events = _filtered(events, lane_filter)
    if not events:
        return 0.0
    start = min(e.start_us for e in events)
    end = max(e.start_us + e.dur_us for e in events)
    return (end - start) / 1e3


def device_peak_flops(device=None) -> Optional[float]:
    """bf16 dense peak FLOP/s of a CUDA ``device`` (the current card when
    None), or None for a device it does not know (the CPU included)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return CUDA_PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def transformer_layer_flops(seq_len: int, hidden: int, mlp_ratio: int = 4) -> float:
    """Forward matmul FLOPs of one pre-LN transformer layer on seq_len
    tokens: QKV+out projections (8*S*H^2), attention score+mix (4*S^2*H),
    MLP (2 * 2*S*H*rH)."""
    s, h = float(seq_len), float(hidden)
    return 8 * s * h * h + 4 * s * s * h + 2 * 2 * s * h * (mlp_ratio * h)


def encode_flops(cfg, n_videos: int, n_segments: int,
                 include_preprocess: bool = False) -> float:
    """Analytic forward FLOPs of embed_video (modeling.py:806-843 workload):
    vision tower over every segment, audio tower over every subsegment,
    joint transformer per video. Matmul terms only (layernorms/softmax/GELU
    are bandwidth-, not FLOP-, relevant)."""
    m = cfg.model
    h = float(m.hidden_size)
    flops = 0.0

    # vision tower: [n_videos*n_segments] x (CLS + grid tokens)
    s_vit = m.vit_seq_len + 1
    n_seg_total = n_videos * n_segments
    flops += n_seg_total * m.vit_num_layers * transformer_layer_flops(s_vit, h)
    flops += n_seg_total * 2 * m.vit_seq_len * (16 * 16 * 3) * h  # patch embed
    # 2x2 attention pool: one MHA layer over the grid
    flops += n_seg_total * (4 * m.vit_seq_len * h * h
                            + 4 * m.vit_seq_len * (m.vit_seq_len / 4) * h)

    # audio tower: [n_videos*n_segments*3 subsegments] x (CLS + patched frames)
    s_aud = m.audio_seq_length // m.audio_patch_size + 1
    n_sub = n_seg_total * 3
    flops += n_sub * m.audio_num_layers * transformer_layer_flops(s_aud, h)
    flops += n_sub * 2 * (s_aud - 1) * (m.audio_patch_size * 65) * h
    flops += n_sub * (4 * (s_aud - 1) * h * h
                      + 4 * (s_aud - 1) * m.audio_token_length * h)  # attnpool

    # joint transformer: per video, lang + pooled vision tokens
    s_joint = (cfg.data.lang_seq_len
               + n_segments * m.vit_pooled_seq_len)
    flops += n_videos * m.joint_num_layers * transformer_layer_flops(s_joint, h)
    flops += n_videos * 2 * s_joint * h * h  # joint_proj head

    if include_preprocess:
        # mel matmul-DFT: frames [188, n_fft] @ cos/sin [n_fft, n_bins]
        n_fft, n_bins, n_frames = 1536, 769, 188
        flops += n_seg_total * (2 * 2 * n_frames * n_fft * n_bins
                                + 2 * n_frames * n_bins * 64)
    return flops


def pretrain_step_flops(cfg, batch_size: int) -> float:
    """Analytic matmul FLOPs of one full pretraining train step
    (pretrain_model.py:38-258 workload): vision tower over every segment,
    audio tower over every subsegment, span tower over the text-span
    targets, the fused 4-stream joint call, x3 for forward+backward."""
    m, d = cfg.model, cfg.data
    h = float(m.hidden_size)
    B = batch_size
    f = 0.0

    # vision tower over B * num_segments frames (+ patch embed + attnpool)
    n_seg = B * d.num_segments
    s_vit = m.vit_seq_len + 1
    f += n_seg * m.vit_num_layers * transformer_layer_flops(s_vit, h)
    f += n_seg * 2 * m.vit_seq_len * (16 * 16 * 3) * h
    f += n_seg * (4 * m.vit_seq_len * h * h
                  + 4 * m.vit_seq_len * (m.vit_seq_len / 4) * h)

    # audio tower over every subsegment
    s_aud = m.audio_seq_length // m.audio_patch_size + 1
    n_sub = n_seg * d.num_audio_subsegments
    f += n_sub * m.audio_num_layers * transformer_layer_flops(s_aud, h)
    f += n_sub * 2 * (s_aud - 1) * (m.audio_patch_size * 65) * h
    f += n_sub * (4 * (s_aud - 1) * h * h
                  + 4 * (s_aud - 1) * m.audio_token_length * h)

    # span tower over the text-span targets (+CLS)
    n_spans = B * d.num_text_spans_to_include
    f += n_spans * m.span_num_layers * transformer_layer_flops(
        m.text_span_length + 1, h)

    # the ONE fused joint call: per example, num_segment_groups rows each for
    # audio2text/text2audio (x their seq multipliers) + matching + random_text
    rows = B * (d.num_segment_groups * (d.num_audio2text_seqs
                                        + d.num_text2audio_seqs)
                + 1 + d.num_text_seqs)
    f += rows * m.joint_num_layers * transformer_layer_flops(d.seq_len, h)
    f += rows * 2 * d.seq_len * h * h  # joint_proj

    return 3.0 * f  # backward ~= 2x forward for matmul-dominated graphs
