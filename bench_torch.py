#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one CUDA card: video segments per
second from raw media to joint embeddings, the workload of ``bench.py``.

Batches of 8 videos x 8 five-second segments: uint8 frames [180, 320, 3]
and 22050 Hz PCM, made from ``np.random.RandomState(0)`` and put on the card
once, go through the port's front end (``ops.vision`` resize and patchify,
``ops.audio`` log-mel) and ``MerlotReserve.batch_embed_video`` on the base
config at its bf16 compute, with random weights from a seed. Also timed:
the front end alone, and encode alone on pre-patchified inputs of the same
shape. Each of the three is timed in a window of its own, after warmup:
``repeats`` batches back to back between one pair of CUDA events, so a
stall or a host gap between batches counts. ``value`` is the fused
program's segments over its window; the median and range of the batches
inside each window are extra keys.

Prints one JSON line with ``bench.py``'s keys: ``value`` in segments/s,
``mfu`` and ``encode_mfu`` (``utils.profiling.encode_flops`` over the
card's bf16 peak, null for a card the port does not know), ``vs_baseline``
and ``encode_vs_reference`` null (the reference pipeline needs TensorFlow
and the reference checkout), and ``device``: the card's name and power
limit as nvidia-smi gives them. Run from a checkout: ``python3
bench_torch.py [--repeats N]``. It raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_VIDEOS = 8
N_SEG = 8
FRAME_H, FRAME_W = 180, 320
SR = 22050
SAMPLES = SR * 5  # 110250 per segment


def raw_inputs(rng):
    """bench.py's raw batch: frames, PCM, tokens (144 AUDIOSPAN, then
    padding) and their subsegment ids."""
    frames = rng.randint(0, 256, (N_VIDEOS, N_SEG, FRAME_H, FRAME_W, 3), dtype=np.uint8)
    pcm = (0.1 * rng.randn(N_VIDEOS, N_SEG, SAMPLES)).astype(np.float32)
    tokens = np.zeros((N_VIDEOS, 160), np.int32)
    tokens[:, :144] = 5  # AUDIOSPAN
    subseg = np.zeros((N_VIDEOS, 160), np.int32)
    subseg[:, :144] = (np.arange(144) // 6)[None]
    return frames, pcm, tokens, subseg


def card_line(device) -> str:
    """``name, power.limit`` of ``device`` as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "-i", str(device.index),
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_window(fn, repeats: int, warmup: int) -> tuple[float, list[float]]:
    """``fn`` on the CUDA event clock: ``repeats`` calls back to back, as a
    server runs them (the host enqueues the next batch while the card runs
    this one), after ``warmup`` calls. Returns (ms of the whole window,
    [ms of each call]); an event between calls splits the window without
    leaving any of it out."""
    import torch

    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(repeats + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    per_call = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return events[0].elapsed_time(events[-1]), per_call


def front_end(frames, pcm, grid, device):
    """Raw frames [B, S, H, W, 3] and PCM [B, S, samples] -> patches
    [B, S, grid_h * grid_w, 768] and log-mel [B, 3S, 60, 65] on ``device``."""
    from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram
    from merlot_reserve_tpu_torch.ops.vision import batch_preprocess_images

    B, S = frames.shape[:2]
    patches = batch_preprocess_images(frames.reshape(B * S, *frames.shape[2:]), grid,
                                      device=device)
    specs = batch_make_spectrogram(pcm.reshape(B * S, pcm.shape[-1]), device=device)
    return patches.reshape(B, S, *patches.shape[1:]), specs.reshape(B, 3 * S, 60, 65)


def measure(device="cuda", repeats: int = 20, warmup: int = 2, seed: int = 0) -> dict:
    """Run the benchmark on ``device`` (a CUDA card) and return its record."""
    import torch

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.profiling import device_peak_flops, encode_flops

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"bench_torch measures a CUDA card, not {device}")
    cfg = load_config("base")
    model = MerlotReserve(cfg, device=device, seed=seed).eval()
    grid = tuple(cfg.model.output_grid)

    rng = np.random.RandomState(0)
    frames, pcm, tokens, subseg = (torch.from_numpy(a).to(device) for a in raw_inputs(rng))
    images_enc = torch.from_numpy(
        rng.randn(N_VIDEOS, N_SEG, grid[0] * grid[1], 768).astype(np.float32)).to(device)
    audio_enc = torch.from_numpy(
        rng.randn(N_VIDEOS, 3 * N_SEG, 60, 65).astype(np.float32)).to(device)

    def fused():
        return model.batch_embed_video(*front_end(frames, pcm, grid, device), tokens, subseg)

    with torch.inference_mode():
        out = fused()
        norms = out.float().norm(dim=-1)
        if out.shape != (N_VIDEOS, 160, cfg.model.hidden_size) or not bool(
                ((norms - 1).abs() < 1e-2).all()):
            raise RuntimeError(f"bench output {tuple(out.shape)} is not unit-norm rows")
        programs = {"batch": fused, "front_end": lambda: front_end(frames, pcm, grid, device),
                    "encode": lambda: model.batch_embed_video(images_enc, audio_enc, tokens,
                                                              subseg)}
        windows = {name: time_window(fn, repeats, warmup) for name, fn in programs.items()}
    batch_ms, front_ms, encode_ms = (windows[k][0] / repeats
                                     for k in ("batch", "front_end", "encode"))

    segments = N_VIDEOS * N_SEG
    peak = device_peak_flops(device)
    mfu = encode_mfu = None
    if peak:
        mfu = encode_flops(cfg, N_VIDEOS, N_SEG, include_preprocess=True) / (batch_ms / 1e3) / peak
        encode_mfu = encode_flops(cfg, N_VIDEOS, N_SEG) / (encode_ms / 1e3) / peak
    return {
        "metric": "video segments/sec/chip (raw frames+PCM -> joint embeddings, base 12x20)",
        "value": segments / (batch_ms / 1e3),
        "unit": "segments/sec/chip",
        "vs_baseline": None,
        "mfu": mfu,
        "encode_mfu": encode_mfu,
        "encode_vs_reference": None,
        "device": card_line(device),
        "batch_ms": batch_ms,
        "front_end_ms": front_ms,
        "front_end_share": front_ms / batch_ms,
        "encode_ms": encode_ms,
        "encode_segments_per_s": segments / (encode_ms / 1e3),
        "window_ms": {k: w[0] for k, w in windows.items()},
        "median_ms": {k: float(np.median(w[1])) for k, w in windows.items()},
        "ms_range": {k: [min(w[1]), max(w[1])] for k, w in windows.items()},
        "repeats": repeats,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    print(json.dumps(measure(repeats=args.repeats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
