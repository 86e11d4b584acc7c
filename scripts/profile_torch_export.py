#!/usr/bin/env python3
"""What an exported serving program costs against the live model, and what
the ``flash_fwd`` operator's dispatch costs, for the PyTorch/CUDA port on
one CUDA card.

Builds the full-width base model (bf16, random weights from a seed, rounded
to f16 as the artifact stores them) and a batch of 8 of the entry's videos,
writes the artifact with ``export.export_serving_artifact``, loads it with
``export.load_serving_artifact``, and measures on the inputs already on the
card:

* in ROUNDS rounds, the variants in turn in each, each variant's host time
  per call (CALLS calls, each synchronised after its timed enqueue) and
  device time (CUDA events over 5 calls): the live ``batch_embed_video``;
  the exported program as ``ExportedVideoService`` calls it; the same
  program through ``torch.export.load(...).module()``, which checks every
  input on every call;
* the exported program's graph nodes by operator, and ``flash_fwd``
  launches per call of each variant;
* the host cost of one ``flash_fwd`` launch at the serving shape (B8 L640,
  12 heads of 64, bf16) through the operator (``flash_forward``) and
  through the launcher the operator wraps (``_flash_forward_cuda``):
  DISPATCH_BURSTS bursts of DISPATCH_BURST calls, the two in turn, each
  burst timed on the host clock after a synchronisation (a burst stays
  within the card's launch queue, so the host never waits on the card).

Run from the root of a checkout: ``python3 scripts/profile_torch_export.py``.
Prints a summary and writes ``chiprun_out/profile_torch_export.json``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import cuda_time_ms, make_requests, stack_requests  # noqa: E402

CALLS = 30
ROUNDS = 3
DISPATCH_BURST = 200
DISPATCH_BURSTS = 50


def _nodes(program):
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def _timed(fn):
    host = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return {"host_ms_median": float(np.median(host)), "host_ms_min": min(host),
            "host_ms_max": max(host), "device_ms": cuda_time_ms(fn, iters=5, warmup=1)}


def _dispatch_us(launchers, cfg):
    """Host µs per launch of each of ``launchers`` on the serving shape:
    the median and range over the bursts."""
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (8, 640, cfg.hidden_size // 64, 64)
    q, k, v = (torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    is_valid = torch.ones(shape[:2], dtype=torch.int32, device="cuda")
    segment_ids = torch.zeros(shape[:2], dtype=torch.int32, device="cuda")
    per_burst = {name: [] for name in launchers}
    with torch.inference_mode():
        for fn in launchers.values():  # warm: the library loaded, the allocator's blocks cached
            fn(q, k, v, is_valid, segment_ids, None, None)
        for _ in range(DISPATCH_BURSTS):
            for name, fn in launchers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DISPATCH_BURST):
                    fn(q, k, v, is_valid, segment_ids, None, None)
                per_burst[name].append((time.perf_counter() - t0) * 1e6 / DISPATCH_BURST)
        torch.cuda.synchronize()
    return {name: {"us_median": float(np.median(t)), "us_min": min(t), "us_max": max(t),
                   "calls": DISPATCH_BURST * DISPATCH_BURSTS} for name, t in per_burst.items()}


def main():
    if not torch.cuda.is_available():
        print("profile_torch_export: needs a CUDA card", file=sys.stderr)
        return 2
    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.export import export_serving_artifact, load_serving_artifact
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.ops import attention
    from merlot_reserve_tpu_torch.utils.weights import flax_tensors_from_state_dict

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = load_config("base")
    model = MerlotReserve(cfg, device="cuda", seed=0).eval()
    with torch.no_grad():  # the artifact's f16 parameters, so that every variant agrees
        for p in model.parameters():
            p.copy_(p.half().float())
    tree = flax_tensors_from_state_dict({k: p.detach() for k, p in model.named_parameters()})
    videos = make_requests(cfg, 8, 1)
    inputs = stack_requests(videos, "cuda")
    res = {"card": card, "variants": {}, "flash_fwd_per_call": {}}
    with tempfile.TemporaryDirectory(prefix="profile_torch_export_") as tmp:
        export_serving_artifact(MerlotReserve(cfg, device="meta"), tree, videos[0], tmp,
                                batch_size=8, num_options=64)
        svc = load_serving_artifact(tmp)
        program = torch.export.load(os.path.join(tmp, "embed_video.pt2"))
    checked = program.module()
    variants = {
        "live": lambda: model.batch_embed_video(*inputs),
        "exported": lambda: svc.embed_program(*svc.params, *inputs),
        "exported_input_checks": lambda: checked(*svc.params, *inputs),
    }
    with torch.inference_mode():
        reference = variants["live"]().float()
        for name, fn in variants.items():
            kernels.LAUNCHES.clear()
            out = fn().float()
            torch.cuda.synchronize()
            res["flash_fwd_per_call"][name] = kernels.LAUNCHES.get("flash_fwd", 0)
            res["variants"][name] = {"max_abs_diff_vs_live": float((out - reference).abs().max()),
                                     "rounds": []}
        for _ in range(ROUNDS):
            for name, fn in variants.items():
                res["variants"][name]["rounds"].append(_timed(fn))
    res["nodes"] = dict(_nodes(program))
    res["dispatch"] = _dispatch_us({"operator": attention.flash_forward,
                                    "launcher": attention._flash_forward_cuda}, cfg.model)
    for name, r in res["variants"].items():
        rounds = r["rounds"]
        print(f"[export profile] {card}: {name}: host ms per round, median (min-max) of "
              f"{CALLS}: " + "; ".join(f"{t['host_ms_median']:.2f} ({t['host_ms_min']:.2f}-"
                                       f"{t['host_ms_max']:.2f})" for t in rounds)
              + f"; device ms {[round(t['device_ms'], 2) for t in rounds]}; flash_fwd "
              f"{res['flash_fwd_per_call'][name]} per call; max abs diff vs live "
              f"{r['max_abs_diff_vs_live']:.3e}")
    top = sorted(res["nodes"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[export profile] exported: {sum(res['nodes'].values())} graph nodes; most: {top}")
    for name, d in res["dispatch"].items():
        print(f"[export profile] {card}: flash_fwd B8 L640 through the {name}: "
              f"{d['us_median']:.2f} us host per launch, median of {DISPATCH_BURSTS} bursts of "
              f"{DISPATCH_BURST} ({d['us_min']:.2f}-{d['us_max']:.2f})")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_export.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
