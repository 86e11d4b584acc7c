#!/usr/bin/env python3
"""Where the time of one serving batch goes, for the PyTorch/CUDA port on
one CUDA card.

Builds the full-width base model (``joint_attention_impl="flash"``, bf16,
random weights from a seed) behind ``VideoEmbedService(batch_size=8)`` and
measures, after a warm-up batch of the entry's videos (8 segments each, or
``--segments``; ``--sp N`` runs the joint attention as the ring kernel over
N virtual sequence-parallel ranks of the card, ``joint_attention_impl=
"ring:rdma"`` under ``activate_mesh(make_mesh(sp=N))``):

* per-tower device time (CUDA events): vision tower, audio tower, and the
  joint part (fusion + joint transformer + projection) of one batch;
* the whole ``batch_embed_video`` on the device clock (the service time
  on the host clock is ``chip_smoke.py``'s, a median of 5 calls);
* under ``torch.profiler`` over three service calls: device operations
  (kernels and copies) per batch, the device's busy share of the
  wall-clock window, and the device operations that take the most time.

Run from the root of a checkout: ``python3 scripts/profile_torch_serving.py``
(the long-video serving: ``--segments 40 --sp 4``). Prints a summary and
writes ``chiprun_out/profile_torch_serving[_seg<S>][_sp<N>].json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import cuda_time_ms, make_requests, stack_requests  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--segments", type=int, default=8, help="segments per video")
    parser.add_argument("--sp", type=int, default=1,
                        help="virtual sp ranks of the ring kernel (1: the flash kernel)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA card", file=sys.stderr)
        return 2
    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
    from merlot_reserve_tpu_torch.serving import VideoEmbedService

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    if args.sp > 1:
        cfg = load_config("base", joint_attention_impl="ring:rdma", seq_shard_axis="sp")
    else:
        cfg = load_config("base", joint_attention_impl="flash")
    model = MerlotReserve(cfg, device="cuda", seed=0)
    service = VideoEmbedService(model, batch_size=8, device="cuda")
    videos = make_requests(cfg, 8, 1, n_seg=args.segments)
    with contextlib.ExitStack() as stack:  # the mesh is active in this thread throughout
        if args.sp > 1:
            stack.enter_context(activate_mesh(make_mesh(sp=args.sp)))
        return measure(args, card, cfg, model, service, videos)


def measure(args, card, cfg, model, service, videos):
    from torch.profiler import ProfilerActivity, profile

    from merlot_reserve_tpu_torch import kernels

    service.embed(videos)  # warm-up: kernel build, allocator, cuBLAS handles

    H = cfg.model.hidden_size
    with torch.inference_mode():
        images, audio, tokens, subseg = stack_requests(videos, "cuda")
        B, S, P, pp3 = images.shape
        imgs_flat, audio_flat = images.reshape(B * S, P, pp3), audio.reshape(-1, 60, 65)
        imgs_enc = model.vision_encoder(imgs_flat)["seq_attnpool"].reshape(B, S * P // 4, H)
        audio_enc = model.audio_encoder(audio_flat)["seq_attnpool"].reshape(B, 3 * S, 6, H)

        def joint():
            mm = model.prepare_multimodal_inputs(
                tokens=tokens, token_segment_idx=subseg // 3, vision_input=imgs_enc,
                audio_pointers=subseg, audio_spans=audio_enc)
            return model._project(model._run_joint(mm)["seq"], tokens.shape[1])

        parts = {
            "vision_tower_ms": cuda_time_ms(lambda: model.vision_encoder(imgs_flat), 5, 1),
            "audio_tower_ms": cuda_time_ms(lambda: model.audio_encoder(audio_flat), 5, 1),
            "joint_ms": cuda_time_ms(joint, 5, 1),
            "batch_embed_video_ms": cuda_time_ms(
                lambda: model.batch_embed_video(images, audio, tokens, subseg), 5, 1),
        }

    calls = 3
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            service.embed(videos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels and copies); CPU ops carry their kernels' time too
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    res = {
        "card": card, **parts,
        "profiled_calls": calls, "profiled_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ops_per_batch": launches / calls,
        "segments": args.segments, "sp": args.sp,
        "joint_attention_impl": cfg.model.joint_attention_impl,
        "kernel_launches": dict(kernels.LAUNCHES),
        "top_kernels": [{"name": e.key[:120], "calls_per_batch": e.count / calls,
                         "ms_per_batch": e.self_device_time_total / 1e3 / calls,
                         "share": e.self_device_time_total / 1e3 / device_ms} for e in top],
    }
    print(f"[profile] {card}; {args.segments} segments per video, joint attention "
          f"{cfg.model.joint_attention_impl!r}" + (f" over sp={args.sp}" if args.sp > 1 else "")
          + f"; kernel launches over {calls} calls {res['kernel_launches']}")
    for k, v in parts.items():
        print(f"[profile] {k}: {v:.3f}")
    print(f"[profile] under the profiler: {wall_ms / calls:.2f} ms per service call, device busy "
          f"{100 * res['device_busy_share']:.1f}% ({device_ms / calls:.2f} ms of kernels), "
          f"{res['device_ops_per_batch']:.0f} kernels and copies per batch")
    for k in res["top_kernels"]:
        print(f"[profile]   {k['ms_per_batch']:8.3f} ms {100 * k['share']:5.1f}% "
              f"x{k['calls_per_batch']:.0f}  {k['name']}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = (f"_seg{args.segments}" if args.segments != 8 else "") + (
        f"_sp{args.sp}" if args.sp > 1 else "")
    (out / f"profile_torch_serving{tag}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
