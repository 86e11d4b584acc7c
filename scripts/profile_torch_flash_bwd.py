#!/usr/bin/env python3
"""The port's bf16 flash-attention backward on one CUDA card, taken apart.

Run from the root of a checkout: ``python3 scripts/profile_torch_flash_bwd.py``.

1. builds ``csrc/flash_bwd.cu`` (with nvcc's register and spill report) and
   a variant of it whose fused pass writes no dq (``add_dq_part`` empty),
   built from the same source into ``chiprun_out/`` (it computes wrong dq
   and exists only to be timed);
2. holds ``flash_backward`` against ``flash_attention_backward_reference``
   on small cases (padding, packed, ragged, L 5 and 16, segments meeting at
   multiples of 64, L 600; dO on every row or only on rows that see a key;
   keys with labels of their own), max |err| within 1e-2 of max |ref|;
3. at the training joint (B 48, L 640), span (B 384, L 16) and long (B 8,
   L 2560) shapes, 12 heads: the whole backward (CUDA events around the
   call, as a caller sees it), each launch alone on the device (a CUDA
   graph of 20 calls), the fused pass without its dq output in turns with
   the real one, and SDPA's backward with the same mask.

Prints one line per case and writes ``chiprun_out/profile_torch_flash_bwd.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_time_ms, graph_time_ms  # noqa: E402
from merlot_reserve_tpu_torch.kernels import build  # noqa: E402
from merlot_reserve_tpu_torch.ops import attention as attn  # noqa: E402

REL_TOL = 1e-2
LAUNCHERS = ("flash_bwd_prep", "flash_bwd_bf16", "flash_bwd_convert", "flash_bwd_dq_f32",
             "flash_bwd_dkv_f32")


def build_without_dq(out_dir):
    """csrc/flash_bwd.cu with add_dq_part's reductions removed, as a ctypes
    library with the same launchers."""
    src = (build.CSRC_DIR / "flash_bwd.cu").read_text()
    loop = src.index("  float4* dst = reinterpret_cast<float4*>(dq_tile)")
    end = src.index("\n}\n", loop)
    src = src[:loop] + "  (void)dq; (void)dq_tile; (void)wwarp; (void)lane;" + src[end:]
    cu, so = out_dir / "flash_bwd_without_dq.cu", out_dir / "libflash_bwd_without_dq.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in LAUNCHERS:
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def labels(case, B, L):
    valid = torch.ones((B, L), dtype=torch.int32, device="cuda")
    seg = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    g = torch.Generator().manual_seed(1)
    if case == "padding":
        valid[0, L * 5 // 6:] = 0
        valid[-1, 10:14] = 0
    elif case == "packed":
        seg[:, L // 2:] = 1
        valid[:, L // 2 - 6:L // 2] = 0
    elif case == "seg64":
        seg[:, 128:] = 1
        seg[:, 320:] = 2
    elif case == "ragged":
        valid = (torch.rand((B, L), generator=g) > 0.15).int().cuda()
        seg[:, L // 3:] = 1
    elif case == "span":  # CLS + a span padded after its length
        valid[0, 9:] = 0
        valid[1:, 2:] = 0
    elif case == "entry":  # the serving entry's 144 AUDIOSPAN tokens, then PADDING
        valid[:, 144:160] = 0
    return valid, seg


def inputs(case, B, L, H, dO_on_blind_rows=False, key_labels=False):
    valid, seg = labels(case, B, L)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, B, L, H, 64), generator=g, device="cuda")
    if not dO_on_blind_rows:
        x[3] *= (valid > 0)[:, :, None, None]
    q, k, v, do = x.to(torch.bfloat16).unbind(0)
    k_labels = (None, None)
    if key_labels:
        gk = torch.Generator().manual_seed(3)
        k_labels = ((torch.rand(valid.shape, generator=gk) > 0.3).int().cuda(),
                    torch.randint(0, 2, valid.shape, generator=gk).int().cuda())
    with torch.no_grad():
        out, lse = attn.flash_forward(q, k, v, valid, seg, *k_labels)
    return q, k, v, do, out, lse, valid, seg, k_labels


def check(case, B, L, H, **kw):
    q, k, v, do, out, lse, valid, seg, k_labels = inputs(case, B, L, H, **kw)
    with torch.no_grad():
        got = attn.flash_backward(q, k, v, do, out, lse, valid, seg, *k_labels)
        ref = attn.flash_attention_backward_reference(q.float(), k.float(), v.float(),
                                                      do.float(), out.float(), lse, valid, seg,
                                                      *k_labels)
    rel = {n: (a.float() - r).abs().max().item() / r.abs().max().item()
           for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    print(f"[check] {case} B={B} L={L} {kw}: max |err| / max |ref| "
          f"{ {n: f'{e:.2e}' for n, e in rel.items()} }", flush=True)
    if not all(e <= REL_TOL for e in rel.values()):
        raise RuntimeError(f"{case} {kw}: {rel} above {REL_TOL}")
    return {"case": case, "B": B, "L": L, **kw, "rel_err": rel}


def time_case(case, B, L, H, without_dq):
    q, k, v, do, out, lse, valid, seg, _ = inputs(case, B, L, H)
    mask = ((valid[:, :, None] > 0) & (valid[:, None, :] > 0)
            & (seg[:, :, None] == seg[:, None, :]))[:, None]
    with torch.no_grad():
        stats, acc = attn.flash_bwd_prep(q, k, v, do, out, lse, valid, seg)
        res = {"case": case, "B": B, "L": L, "H": H,
               "backward_us": 1e3 * cuda_time_ms(
                   lambda: attn.flash_backward(q, k, v, do, out, lse, valid, seg)),
               "prep_us": 1e3 * graph_time_ms(
                   lambda: attn.flash_bwd_prep(q, k, v, do, out, lse, valid, seg)),
               "convert_us": 1e3 * graph_time_ms(
                   lambda: attn.flash_bwd_convert(q, k, v, do, acc, valid, seg)),
               "fused_us": [], "fused_without_dq_us": []}

        def fused():
            return attn.flash_bwd_fused(q, k, v, do, stats, acc, valid, seg)

        real = attn._flash_bwd_lib
        for order in ((False, True), (True, False)):  # in turns: A B B A
            for strip in order:
                if strip:
                    attn._flash_bwd_lib = lambda: without_dq
                try:
                    t = 1e3 * graph_time_ms(fused)
                finally:
                    attn._flash_bwd_lib = real
                res["fused_without_dq_us" if strip else "fused_us"].append(t)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    do_t = do.transpose(1, 2)
    res["sdpa_backward_us"] = 1e3 * cuda_time_ms(
        lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True))
    print(f"[time] {case} B={B} L={L}: backward {res['backward_us']:.1f} us (prep "
          f"{res['prep_us']:.1f}, fused {res['fused_us']}, convert {res['convert_us']:.1f} on "
          f"the device alone; fused without its dq output {res['fused_without_dq_us']}); "
          f"SDPA backward {res['sdpa_backward_us']:.1f} us", flush=True)
    return res


def main():
    if not torch.cuda.is_available():
        print("profile_torch_flash_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    built = build.build(["flash_bwd"])["flash_bwd"]
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "bf16_kernel" in ln or "spill" in ln or "registers" in ln]
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)
    without_dq = build_without_dq(out_dir)
    checks = []
    for case, B, L, H in (("padding", 2, 48, 3), ("packed", 2, 130, 3), ("ragged", 2, 200, 3),
                          ("short", 2, 5, 3), ("span", 2, 16, 3), ("seg64", 2, 640, 3),
                          ("ragged", 2, 600, 3), ("ragged", 3, 16, 3)):
        for kw in ({}, {"dO_on_blind_rows": True}, {"key_labels": True}):
            checks.append(check(case, B, L, H, **kw))
    torch.backends.cuda.matmul.allow_tf32 = False
    times = [time_case("entry", 48, 640, 12, without_dq), time_case("span", 384, 16, 12, without_dq),
             time_case("entry", 8, 2560, 12, without_dq)]
    print(f"[profile] {card}", flush=True)
    (out_dir / "profile_torch_flash_bwd.json").write_text(json.dumps(
        {"card": card, "ptxas": ptxas, "checks": checks, "times": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
