#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the serving path, with nvcc's register,
   shared-memory and spill report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it and a few more, with its time, the
   plain version's, the nearest single PyTorch call's, and its bound;
4. slice: a full-width base model (random weights from a seed) behind
   ``VideoEmbedService`` answers a full batch, an underfilled batch and
   concurrent requests through ``DynamicBatcher``; checks shapes, norms,
   kernel launch counts, and agreement with the plain attention path.

It prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``. Any failed check raises: the exit code is
then nonzero and the last line is not printed. Without a CUDA card it exits
nonzero before doing anything.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain limits on the card: bf16 out is rounded to bf16 and its
# probabilities enter the second product as bf16; f32 differs only in the
# order of f32 sums; lse is compared on valid rows only
TOL = {"bf16": {"out": 8e-3, "lse": 1e-3}, "f32": {"out": 1e-5, "lse": 1e-3}}
MIN_COSINE = 0.995


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    cc = torch.cuda.get_device_capability(0)
    print(f"[device] {name} x{count}, compute capability {cc[0]}.{cc[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    check(cc == (9, 0), f"the kernels are built for sm_90a, card is sm_{cc[0]}{cc[1]}")
    return {"name": name, "count": count, "nvidia_smi": card}


def phase_build():
    from merlot_reserve_tpu_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build(["flash_fwd"])
    out = {}
    for name, b in built.items():
        report = [ln.strip() for ln in b.log.splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[build] {name}: {b.seconds:.2f} s -> {b.path.name}", flush=True)
        for ln in report:
            print(f"[build]   {ln}", flush=True)
        check(b.path.exists(), f"{name} library missing after build")
        out[name] = {"seconds": b.seconds, "ptxas": report}
    print(f"[build] all sources: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def _labels(case, B, L, device):
    """(is_valid, segment_ids) int32 [B, L] for one kernel case."""
    import torch

    valid = torch.ones((B, L), dtype=torch.int32, device=device)
    seg = torch.zeros((B, L), dtype=torch.int32, device=device)
    if case == "serving":
        valid[:, 144:160] = 0  # the entry example: 144 AUDIOSPAN tokens, then PADDING
    elif case == "packed":
        valid[:, 300:320] = 0  # two videos per row, each with padded text
        valid[:, 620:640] = 0
        seg[:, 320:] = 1
    elif case == "ragged":
        g = torch.Generator(device="cpu").manual_seed(1)
        valid = (torch.rand((B, L), generator=g) > 0.1).to(torch.int32).to(device)
    elif case == "long":
        valid[:, 576:640] = 0  # 640 text positions, the last 64 padding, then 1920 image tokens
    return valid, seg


def _needed_work(valid, seg, H, D):
    """Operations and bytes the function needs for these labels: QK^T and PV
    over the attended pairs; rows that see no key average V over all L."""
    v = valid > 0
    pairs = ((v[:, :, None] & v[:, None, :]) & (seg[:, :, None] == seg[:, None, :])).sum()
    blind_rows = (~v).sum()  # a padding row attends nothing and gets mean(V)
    L = valid.shape[1]
    ops = 2 * D * H * int(pairs) + 2 * D * H * (int(pairs) + L * int(blind_rows))
    return ops


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from merlot_reserve_tpu_torch.ops.attention import flash_attention_reference, flash_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    H, D = 12, 64
    cases = [("serving", 8, 640), ("packed", 8, 640), ("ragged", 8, 600), ("long", 2, 2560)]
    results = []
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for case, B, L in cases:
            valid, seg = _labels(case, B, L, dev)
            qkv32 = torch.randn((3, B, L, H, D), generator=g, device=dev)
            row_valid = (valid > 0)[:, None, :].expand(B, H, L)
            for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                q, k, v = qkv32.to(dtype).unbind(0)
                out, lse = flash_forward(q, k, v, valid, seg)
                torch.cuda.synchronize()
                ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(),
                                                             valid, seg)
                err_out = (out.float() - ref_out).abs().max().item()
                err_lse = (lse - ref_lse).abs()[row_valid].max().item()
                check(math.isfinite(err_out) and err_out <= TOL[dname]["out"],
                      f"{case}/{dname} out max abs {err_out} > {TOL[dname]['out']}")
                check(math.isfinite(err_lse) and err_lse <= TOL[dname]["lse"],
                      f"{case}/{dname} lse max abs {err_lse} > {TOL[dname]['lse']}")

                ms = cuda_time_ms(lambda: flash_forward(q, k, v, valid, seg))
                plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, valid, seg),
                                        iters=5)
                mask = ((valid > 0)[:, :, None] & (valid > 0)[:, None, :]
                        & (seg[:, :, None] == seg[:, None, :]))[:, None]
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                sdpa_ms = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
                ops = _needed_work(valid, seg, H, D)
                nbytes = (4 * B * L * H * D * q.element_size()  # q, k, v in, out
                          + 2 * B * L * 4 + B * H * L * 4)       # labels in, lse out
                peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
                r = {"case": case, "dtype": dname, "B": B, "L": L, "H": H, "D": D,
                     "max_abs_err_out": err_out, "max_abs_err_lse_valid": err_lse,
                     "ms": ms, "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
                     "ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
                r["roofline_share"] = r["bound_ms"] / ms
                results.append(r)
                print(f"[kernel] flash_fwd {case:8s} {dname} B={B} L={L}: out err {err_out:.3e} "
                      f"lse err {err_lse:.3e} | {ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} us, "
                      f"sdpa {sdpa_ms * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                      f"by {r['bound_by']}, {100 * r['roofline_share']:.1f}% of it)", flush=True)
                del q, k, v, out, lse, ref_out, ref_lse, mask, qt, kt, vt
            del qkv32
            torch.cuda.empty_cache()
    return results


def make_requests(cfg, n, seed):
    """``n`` preprocessed videos shaped like the serving entry example: 8
    segments of 12x20 patches, 24 audio subsegments, 160 tokens of which the
    first 144 are AUDIOSPAN (odd videos carry text in the last 48) and the
    rest PADDING."""
    import numpy as np

    from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN

    rng = np.random.RandomState(seed)
    n_seg, grid = 8, cfg.model.vit_seq_len
    out = []
    for i in range(n):
        tokens = np.zeros(160, np.int32)
        tokens[:144] = AUDIOSPAN
        if i % 2:
            tokens[96:144] = rng.randint(10, cfg.model.vocab_size, 48)
        subseg = np.zeros(160, np.int32)
        subseg[:144] = np.arange(144) // 6
        out.append({"images": rng.randn(n_seg, grid, 768).astype(np.float32),
                    "audio_clips": rng.randn(3 * n_seg, 60, 65).astype(np.float32),
                    "tokens": tokens, "subseg_idxs": subseg})
    return out


def stack_requests(videos, device):
    """The inputs of ``batch_embed_video`` for ``videos`` (from
    ``make_requests``), stacked and moved to ``device``."""
    import numpy as np
    import torch

    stack = {k: torch.from_numpy(np.stack([np.asarray(v[k]) for v in videos])).to(device)
             for k in videos[0]}
    return (stack["images"], stack["audio_clips"], stack["tokens"].long(),
            stack["subseg_idxs"].long())


def phase_slice(card):
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.ops import attention as attn_ops
    from merlot_reserve_tpu_torch.serving import DynamicBatcher, VideoEmbedService

    cfg = load_config("base", joint_attention_impl="flash")
    check(cfg.model.use_bfloat16, "base config should compute in bf16")
    t0 = time.perf_counter()
    model = MerlotReserve(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] base model ({cfg.model.joint_num_layers}/{cfg.model.vit_num_layers}/"
          f"{cfg.model.audio_num_layers} joint/vit/audio layers, hidden {cfg.model.hidden_size}, "
          f"{n_params / 1e6:.1f}M params) built in {time.perf_counter() - t0:.2f} s", flush=True)
    service = VideoEmbedService(model, batch_size=8, device="cuda")
    full, five, concurrent = make_requests(cfg, 8, 1), make_requests(cfg, 5, 2), make_requests(cfg, 12, 3)
    joint_layers = cfg.model.joint_num_layers

    # the serving path, counted: every launch between the reset and the read
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    outs = [service.embed(full), service.embed(five)]
    with DynamicBatcher(service, max_wait_ms=20.0) as batcher:
        futures = [batcher.submit(vp) for vp in concurrent]
        outs.append(np.stack([f.result(timeout=600) for f in futures]))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    batches = service.stats["batches"]
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"[slice] answered {sum(len(o) for o in outs)} requests in {batches} batches "
          f"(dynamic batch fills {batcher.batch_fills}); kernel launches {launches}", flush=True)
    check(launches.get("flash_fwd", 0) == joint_layers * batches,
          f"flash_fwd launches {launches.get('flash_fwd', 0)} != {joint_layers} x {batches} batches")
    for o, n in zip(outs, (8, 5, 12)):
        check(o.shape == (n, 160, cfg.model.hidden_size), f"output shape {o.shape}")
        check(np.isfinite(o).all(), "non-finite embeddings")
        norms = np.linalg.norm(o, axis=-1)
        check(np.abs(norms - 1).max() < 1e-2, f"row norms off 1 by {np.abs(norms - 1).max()}")

    # kernel path vs the plain flash version on the same inputs, on the card
    def plain_flash(q, k, v, is_valid, segment_ids):
        return attn_ops.flash_attention_reference(q, k, v, is_valid, segment_ids)[0]

    with mock.patch.object(attn_ops, "flash_attention", plain_flash):
        plain = service.embed(full)
    a, b = outs[0].reshape(-1, cfg.model.hidden_size), plain.reshape(-1, cfg.model.hidden_size)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    max_diff = float(np.abs(a - b).max())
    print(f"[slice] kernel vs plain attention path: min row cosine {cos.min():.6f}, "
          f"max abs diff {max_diff:.3e}", flush=True)
    check(cos.min() >= MIN_COSINE, f"kernel vs plain path cosine {cos.min()} < {MIN_COSINE}")

    # steady-state timing at the fixed batch of 8
    host_ms = []
    for _ in range(5):
        t = time.perf_counter()
        service.embed(full)
        host_ms.append((time.perf_counter() - t) * 1e3)
    with torch.inference_mode():
        images, audio, tokens, subseg = stack_requests(full, "cuda")
        device_ms = cuda_time_ms(lambda: model.batch_embed_video(images, audio, tokens, subseg),
                                 iters=5, warmup=1)
    host_med = float(np.median(host_ms))
    res = {"batch": 8, "segments_per_video": 8, "batches_answered": batches,
           "launches": launches, "min_cosine_vs_plain": float(cos.min()),
           "max_abs_diff_vs_plain": max_diff, "service_ms_per_batch_median": host_med,
           "service_ms_per_batch_runs": host_ms, "device_ms_per_batch": device_ms,
           "videos_per_s": 8 / host_med * 1e3, "segments_per_s": 64 / host_med * 1e3,
           "device_videos_per_s": 8 / device_ms * 1e3, "device_segments_per_s": 64 / device_ms * 1e3,
           "max_memory_allocated_bytes": peak_mem}
    print(f"[slice] {card}: {host_med:.2f} ms per batch of 8 through the service "
          f"({res['videos_per_s']:.1f} videos/s, {res['segments_per_s']:.1f} segments/s); "
          f"model alone {device_ms:.2f} ms on the device clock "
          f"({res['device_segments_per_s']:.1f} segments/s); "
          f"peak memory {peak_mem / 2**30:.2f} GiB", flush=True)
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import merlot_reserve_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from a checkout",
              file=sys.stderr)
        return 2

    dev = phase_device()
    build = phase_build()
    kern = phase_kernels()
    sl = phase_slice(dev["nvidia_smi"])

    main_case = next(r for r in kern if r["case"] == "serving" and r["dtype"] == "bf16")
    kernels_line = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "merlot_reserve_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "merlot_reserve_tpu/ops/attention.py:115",
        "launches": sl["launches"].get("flash_fwd", 0),
        "max_abs_err": main_case["max_abs_err_out"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["sdpa_ms"]}]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record = {"device": dev, "build": build, "kernels": kern, "slice": sl,
              "kernels_line": kernels_line}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels_line))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                              "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
