#!/usr/bin/env python3
"""Time the bf16 attention forward kernels on one CUDA card on the device
alone (CUDA graphs of 20 calls, ``graph_time_ms``) beside SDPA, at the
shapes the port's paths give them.

Run from the root of a checkout: ``python3 scripts/profile_torch_flash_fwd.py
[--label NAME] [--repeats N]``. Each shape is checked against its plain
version, then the kernel and SDPA are timed in turns, ``--repeats`` times:
  * ``flash_fwd`` at serving B8 L640, the training joint B48 L640 (the
    dummy batch's two videos per row), the long-video B8 L2560 and the span
    tower's B384 L16;
  * ``ring_fwd`` at B8 L2560 n4, B8 L640 n2 and B48 L640 n4, against SDPA
    over the full L.
To compare two versions on one card, run the script from two checkouts in
turns in one chip call (A, B, B, A). Prints one line per shape and writes
``chiprun_out/profile_torch_flash_fwd[_LABEL].json`` with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (_attn_mask, _labels, _ring_labels, check, graph_time_ms,  # noqa: E402
                        phase_device)

RING_SHAPES = (("long_video", 4, 8, 2560), ("tail", 2, 8, 640), ("persistent", 4, 48, 640))


def _fwd_cases(device):
    """(case, is_valid, segment_ids) of the flash forward's shapes."""
    import torch

    joint_valid = torch.ones((48, 640), dtype=torch.int32, device=device)
    joint_valid[:, 288:320] = 0  # two videos of 320 rows, the last 32 of each padding
    joint_valid[:, 608:] = 0
    joint_seg = (torch.arange(640, device=device) >= 320).to(torch.int32)[None].repeat(48, 1)
    span_valid = torch.ones((384, 16), dtype=torch.int32, device=device)
    span_valid[::2, 9:] = 0
    return (("serving", *_labels("serving", 8, 640, device)),
            ("train_joint", joint_valid, joint_seg),
            ("long_video", *_ring_labels("long_video", 8, 2560, device)),
            ("train_span", span_valid, torch.zeros_like(span_valid)))


def main():
    import torch
    import torch.nn.functional as F

    from merlot_reserve_tpu_torch.ops import attention as attn_ops
    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops

    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default="")
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    dev = phase_device()
    g = torch.Generator(device="cuda").manual_seed(0)
    record = {"device": dev, "label": args.label, "flash_fwd": [], "ring_fwd": []}
    tag = f"[{args.label}] " if args.label else ""

    def timed(res, kernel, sdpa):
        res["graph_ms"], res["sdpa_graph_ms"] = [], []
        for _ in range(args.repeats):
            res["graph_ms"].append(graph_time_ms(kernel))
            res["sdpa_graph_ms"].append(graph_time_ms(sdpa))
        return (f"{[round(x * 1e3, 1) for x in res['graph_ms']]} us on the device alone, "
                f"sdpa {[round(x * 1e3, 1) for x in res['sdpa_graph_ms']]} us")

    with torch.inference_mode():
        for case, valid, seg in _fwd_cases("cuda"):
            B, L = valid.shape
            q, k, v = torch.randn((B, L, 3, 12, 64), generator=g, device="cuda").to(
                torch.bfloat16).unbind(2)
            ref, _ = attn_ops.flash_attention_reference(q, k, v, valid, seg)
            out, _ = attn_ops.flash_forward(q, k, v, valid, seg)
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= 8e-3 * max(1.0, ref.float().abs().max().item()),
                  f"flash_fwd {case}: err {err}")
            mask = _attn_mask(valid, seg)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res = {"case": case, "B": B, "L": L, "max_abs_err": err}
            msg = timed(res, lambda: attn_ops.flash_forward(q, k, v, valid, seg),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            record["flash_fwd"].append(res)
            print(f"{tag}[fwd] {case:11s} B={B} L={L}: {msg}", flush=True)
            del q, k, v, ref, out, mask, qt, kt, vt

        for case, n, B, L in RING_SHAPES:
            valid, seg = _ring_labels(case, B, L, "cuda")
            q, k, v = torch.randn((B, L, 3, 12, 64), generator=g, device="cuda").to(
                torch.bfloat16).unbind(2)
            ref = ring_ops.ring_attention_reference(q.float(), k.float(), v.float(), valid,
                                                    seg, n)
            out = ring_ops.ring_fwd(q, k, v, valid, seg, n)
            err = (out.float() - ref).abs().max().item()
            check(err <= 1e-2 * ref.abs().max().item(), f"ring_fwd {case}: err {err}")
            mask = _attn_mask(valid, seg)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res = {"case": case, "n": n, "B": B, "L": L, "max_abs_err": err}
            msg = timed(res, lambda: ring_ops.ring_fwd(q, k, v, valid, seg, n),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            record["ring_fwd"].append(res)
            print(f"{tag}[ring] {case:11s} n={n} B={B} L={L}: {msg} over the full L", flush=True)
            del q, k, v, ref, out, mask, qt, kt, vt

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = f"profile_torch_flash_fwd{'_' + args.label if args.label else ''}.json"
    (out_dir / name).write_text(json.dumps(record, indent=1))
    print(dev["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
