#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port (``flash_fwd``, ``flash_bwd``,
   ``ring_fwd``, ``adam_update``), one nvcc each, all started together,
   with nvcc's register, shared-memory and spill report, and beside them
   the host data library (``csrc/merlot_native.cc``, g++);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and a few more, with its time, the plain version's,
   the nearest single PyTorch call's, and its bound: the flash forward
   (timed with SDPA by events and on the device alone from CUDA graphs),
   then the backward (in bf16 three launches: prep, the fused wgmma pass,
   convert; in f32 the scalar dq and dk/dv kernels);
4. slice: a full-width base model (random weights from a seed) behind
   ``VideoEmbedService`` answers a full batch, an underfilled batch and
   concurrent requests through ``DynamicBatcher``; checks shapes, norms,
   kernel launch counts, and agreement with the plain attention path;
5. train: a full-width base ``MerlotReservePretrainer`` (random weights
   from a seed) takes a few steps through ``run_pretraining`` on the
   port's dummy batch of 8 examples; checks finite losses near ln N at
   step 0, 16 launches of the forward and of each backward launch per
   step, a falling loss on the
   repeated batch, and the kernel path's losses and gradients against the
   plain path's, in bf16 as trained and in an f32 copy of the model (with
   the bf16 paths against the f32 plain path, each the mean over 5
   batches at the seed's weights, and the gradient at the vision tower's
   outputs); times the step on both
   clocks, and traces one step through ``utils.profiling.trace``: the
   card's lanes' wall time (``trace_wall_ms``) beside the CUDA-event time,
   and the top kernels;
6. kernels at the training shapes: the forward and backward again, on the labels
   the training step gave the joint (48 rows of 640) and span (384 rows of
   16) attention;
7. ring kernels: the ring kernel (``csrc/ring_fwd.cu``, n virtual ranks on
   the card) against the plain ring, in bf16 and f32, at n = 2, 3, 4 and 8,
   at the long-video shape and with more ring members than fit on the card
   at once, on label cases that cross the shards; the flash forward with
   keys labelled apart from the queries; the ring's and SDPA's times on
   both clocks, and at the long-video shape the bound, the flash forward
   over the full sequence (also checked and timed as a forward case) and
   the plain ring;
8. sequence-parallel serving: a full-width base model with
   ``joint_attention_impl="ring:rdma"`` behind ``VideoEmbedService`` under
   ``activate_mesh(make_mesh(sp=4))`` answers batches of 8 long videos (40
   segments, joint L 2560), and the entry's 8-segment videos at sp = 2;
   checks ring launches, agreement with the ``flash`` path, and times both;
   then the first long batch through ``DynamicBatcher`` under the caller's
   mesh (its dispatcher thread runs the batch in the submitter's context):
   12 ring launches per batch, no ``flash_fwd``, the service's answer;
9. raw media: the front end (``ops.vision`` resize and patchify,
   ``ops.audio`` log-mel) on the card against the same functions on the
   CPU, at the bench's raw batch and at frames that downscale and upscale,
   the log-mel also against an f64 numpy oracle, once more with the global
   TF32 flags on (the output must not change); embeddings from raw media
   against ``batch_embed_video`` on the front end's own output; then the
   zero-shot path (raw frames and PCM, ``preprocess_video`` with a
   ``<|MASK|>`` prompt, ``rank_options``, ``extract_mask_features``,
   ``score_label_space`` over five options tokenized by the port's BPE)
   with a full-width base model, counted, against the same weights under
   ``attention_impl="xla"``; 4 ``flash_fwd`` launches per label-space call;
   ``flash_fwd`` against its plain version at each shape and with the
   labels this path gave it (B 5 L 16, B 1 and 2 L 640); last,
   ``bench_torch.py``'s measurement, printed as its own JSON line;
10. long-video training: the ``soak_longvideo`` recipe at full base widths
   (80 segments, seq_len 2560, both remat knobs) on the port's dummy batch
   of 4 examples takes 3 steps through ``run_pretraining`` twice: with
   ``joint_attention_impl="ring:flash"``, ``seq_shard_axis`` and
   ``segment_shard_axis`` "sp" under ``make_mesh(sp=4)``, and with
   ``flash`` and no mesh. Checks finite losses near ln N at step 0, a
   falling loss, ``flash_fwd`` and each backward launch per step as worked
   out from the config (the ring's n x n launches per joint layer, and
   the recompute's), no ``ring_fwd``, and the two paths' step-0 losses and
   gradients against each other beside the flash path's spread against
   itself; times both, and one step at batch 1 with the remat knobs off
   and on for peak memory;
11. hop kernels: ``flash_fwd`` with key labels and the three-launch
   backward with merged out/lse from outside, at the ring hop's shape (one
   rank's 640 query rows against one visiting shard of 640 keys, the 24
   joint rows of phase 10, its labels), against their plain versions, with
   times, bounds and SDPA over the same pair;
12. optimizer kernel: ``adam_update`` (``csrc/adam_update.cu``, one launch
   per update) against the plain per-tensor loop on the base model's
   parameters, 3 updates of each chain (pretraining; finetuning, with the
   anchor), bit for bit in p, mu and nu, and its decode of all 65536 bf16
   codes against ``torch.pow``; device and host ms per update and launches
   of both, and the bound; then the same for the f32-moment mode
   (``use_bfloat16_adam`` off, optax's ``scale_by_adam``; every bit), and 3
   base steps of f32 Adam through ``run_pretraining``, counted;
13. pretraining with checkpoints: ``run_pretraining`` at phase 5's shape
   with an ``output_dir``, 4 steps saving every 2, then a resumed run to
   6: ``ckpt_2`` and ``ckpt_4`` written, the restored state against the
   saved one bit for bit (parameters through f16), the resumed losses
   against two uninterrupted runs, an asynchronous save against an update
   made right after it; the loop's blocked ms per save, write seconds,
   file bytes, step ms on both clocks;
14. finetuning: ``ckpt_4``'s parameters into the VCR (no audio tower) and
   TVQA heads at the scripts' shapes (VCR batch 8, joint 64 rows of 288;
   TVQA batch 4, joint 40 rows of 676), the first gradient through the
   kernels against the plain path in an f32 copy, then 3 VCR and 2 TVQA
   steps (one with ``scan_minibatch``): initial losses near ln N, the
   flash and update launches per step worked out from the config, step ms,
   examples/s and peaks; then ``flash_fwd`` and the backward against their
   plain versions at those two joint shapes and labels, with times,
   bounds and SDPA;
15. data to the device: the data library's JPEG codec (libjpeg, or nvJPEG
   where libjpeg is absent) against known pixels; a synthetic corpus of
   16 records at the base shapes, written by the port into a temporary
   directory; ``run_pretraining`` at full base width, batch 8, 7 steps
   through each of two feeds, both through a ``DeviceFeed`` (pinned
   buffers, a side stream): the host-assembled ``PretrainLoader`` on
   threads, and the fused step on raw batches with frames augmented on the
   card (dummy batches are phase 5's feed, the loader on spawned processes
   feeds phase 18's steps); finite step-0 losses near ln N, the kernels'
   launches per step as worked out from the config; step ms on both
   clocks, examples/s, the busy share under the profiler, the H2D bytes
   and ms per step, peaks; the builder's device ms and launches per batch;
   then the card's ``build_batch`` against the CPU's on one batch with the
   same draws;
16. fixres: phase 13's ``ckpt_4`` into the mixed-resolution step
   (``make_mixed_res_train_step``) at the two grids of
   ``scripts/pretrain_fixres_torch.py`` (18x32 and 24x24, joint 24 rows of
   1312 at each), full base width and depth, 4 examples per grid: the
   forward and the backward against their plain versions at that joint
   shape with both grids' labels, with times, bounds and SDPA; 3 steps with
   32 launches of the forward and of each backward launch and one
   ``adam_update`` per step, finite step-0 losses near ln N, step ms on both
   clocks, examples/s and the peak; the kernel path's gradient against the
   plain path's in bf16 at full depth (the towers recomputed in the
   backward, so that the plain path fits) and in f32 at 2 layers per tower;
   then
   2 steps of ``scripts/pretrain_fixres_torch.py`` on two shards of
   synthetic records (a checkpoint after each) and
   ``scripts/validate_torch.py`` over those checkpoints, each against
   ``evaluate_loss`` called directly;
17. downstream: from the fixres checkpoint, ``scripts/finetune_vcr_torch.py``
   (batch 8, 3 steps and a validation pass) and
   ``scripts/finetune_tvqa_torch.py`` (batch 4, 2 steps and a validation
   pass) on 16 synthetic records each, decoded by the data library: step-0
   losses near ln 4 and ln 5, the launches worked out from the steps and
   validation batches, the host's data ms per batch and each step on both
   clocks; then ``zero_shot_qa_eval`` with both rankers over the same
   records in batches of 8 (VCR at 18x32: joint 16 rows of 288; TVQA: 16 rows
   of 676), 16 ``flash_fwd`` per batch, the kernel path's logits and
   predictions against the plain path's, ms per batch and examples/s;
18. created records: 8 synthetic videos of 50-90 s (360x640 frames,
   22050 Hz PCM, timed words sparse enough in places for speeds 2 and 3)
   through ``dataset_creation.process_video_arrays`` (segments/s; the
   log-mels, one call per speed on the card, against the CPU), the
   MobileNetV2 embedder and the static-video filter on the card against
   the CPU (ms per 64 frames), ``pack_chunks`` with a random-text stream
   from ``token_blob_iterator`` into ``ShufflingRecordWriter`` shards; the
   records through ``PretrainLoader`` on threads and on spawned processes,
   batch for batch equal, each timed alone, with the device memory each
   worker takes; ``run_pretraining`` at full base width, batch 8, 3 steps
   through a ``DeviceFeed`` from the processes (step-0 losses near ln N,
   the launches per step worked out from the config, step ms on both
   clocks); then the prep scripts' per-annotation functions
   (``prep_vcr_torch.vcr_record``, ``prep_tvqa_torch.tvqa_record``) into
   records that ``finetune_batches`` reads at the synthetic records' shapes.
19. serving artifacts and checkpoint tools: phase 13's ``ckpt_4`` (or a
   seeded init) into ``export.export_serving_artifact`` on the card at full
   base width (batch 8, 64 options); ``load_serving_artifact`` in a fresh
   process, which must import no ``models`` module, serves 8 and 3
   requests and the label space: the exported programs against the live
   ``VideoEmbedService`` and ``embed_text_spans_only`` on the same
   parameters, ``flash_fwd`` launches per exported call (12 per batch, the
   span tower's 4 per label space), ms per exported batch on both clocks
   beside the live service's; ``scripts/convert_checkpoint_torch.py``
   --to-layers then --to-scan, bit for bit; ``scripts/vcr_leaderboard_torch.py``
   with phase 17's finetuned VCR state on phase 17's records and on 16
   records of ``prep_vcr_torch.vcr_record`` with leaderboard ids (4 rows).
20. distributed: the base pretraining step (batch 8, ``flash``, 3 steps)
   through ``run_pretraining`` as a job of one process over NCCL
   (``parallel.distributed``; ZeRO-1 on, every collective issued) against
   the one-process path run twice: steps 1-2's losses bit for bit, step 3's
   and the f32 params, mu and nu after it within the one-process runs'
   own distance (``DIST_LOSS_TOL``, ``DIST_STATE_FACTOR``), launches per
   step, the comm audit per step, both clocks; world 1's state saved
   through the per-rank sharded writer (``sharded_manager``, async) and
   read back, the resumed state bit for bit; two
   processes on the one card (``--rank-worker``): which backend takes
   them, and where gloo takes a layout's collectives, dp 2 and tp 2 held
   against world 1's losses; the memory planner against the measured peaks.
21. soak: the ``soak_fused_r5`` recipe (full base widths, batch 2, the
   fused data step with frames on the card, ``scan_layers`` off) through
   ``scripts/pretrain_torch.py`` on a structured synthetic corpus, with a
   real SIGTERM partway and a restart: the preempted process exits with 0
   after writing its checkpoint and the loader's sidecar, the restart
   resumes at the next step from the next record (against an uninterrupted
   loader) and runs 2 steps, every loss finite, steps 0-10 at the batch-2 signatures, the
   kernels' launches per step in both processes.
22. ring across processes: every rank a process of its own on the one card
   (``distributed.initialize(device="cuda:0")``, gloo; the card time-slices
   the processes' contexts): the flag round trip between two processes over
   buffers opened by CUDA IPC; the ring kernel's mode across processes
   (``ring:rdma`` on a process mesh) at B 8 L 640 n 2 (bf16, f32) and B 8
   L 2560 n 4, each rank's shard bit for bit the virtual-rank kernel's rows
   and within the ring tolerance of the plain ring, by TMA and by 16-byte
   stores; phase 8's long-video batch through ``VideoEmbedService`` under
   process meshes of sp 2 and sp 4, 12 launches per rank per batch, against
   phase 8's embeddings; at sp 4 the same batch again with rank 1 six
   seconds late (past the 5 s a ring kernel waits on a neighbour): the
   joint tower's host barrier holds the others, no rank traps, each rank's
   embeddings are bit for bit its undelayed answer and its first joint
   layer's shard the virtual-rank kernel's; every time labelled
   time-sliced.
23. large serving: phase 4 on the large config (hidden 1024, 16 heads of
   64, 24 joint and 24 vision layers; random weights from seed 0) at batch
   8, joint L 640: 24 ``flash_fwd`` per batch, against the plain path.
24. large zero-shot at the demos' default: a large model's seeded weights
   written as msgpack and read by ``PretrainedMerlotReserve.from_params(
   "large", ..., image_grid_size=(18, 32))``; phase 9's zero-shot path on
   synthetic raw segments at joint L 1312, counted, against the plain
   path; ms per call and the load seconds.
25. large pretraining: two arms of 3 ``train_step``s (batch 4 without
   remat; batch 8 with both remat knobs): step 0 against the plain path at
   phase 5's bf16 limits, finite losses near ln N, launches and one
   ``adam_update`` per step, both clocks, each peak beside the memory
   planner's.
26. large finetuning at the recipes' batch 32 from phase 25's weights: VCR
   at 18x32 and TVQA, the whole batch tried first and ``scan_minibatch``
   where it does not fit; step-0 loss near ln N, launches per step, both
   clocks, the peak and the joint rows.
27. kernels at 16 heads: the forward at the large serving (B 8 L 640) and
   zero-shot (B 1 L 1312) shapes and labels, the forward and backward at
   the large pretraining's joint (B 48 L 640), bf16 and f32, against their
   plain versions with times, bounds and SDPA.
28. pod readiness: ``scripts/pod_readiness_torch.py`` (base, 8 rows a dp
   rank) runs rank 0 of dp8 and both pipeline stages of dp2 x pp2 x tp2,
   each a stand-in rank of its job on torch's fake process group, 2 steps
   each: the launches per step, each peak beside the memory planner's, and
   dp8's drop below phase 5's one-card peak beside 7/8 of the masters' and
   moments' bytes.

Each phase's seconds are printed as ``[time]`` lines.

It prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``. Any failed check raises: the exit code is
then nonzero and the last line is not printed. Without a CUDA card it exits
nonzero before doing anything.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import threading
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
# backward kernels vs plain, max |err| over max |plain| of each of dq, dk,
# dv, with dO 0 on rows that see no key as in the model (so the valid rows
# set the scale): in bf16 p and ds enter their products as bf16 and the
# outputs are rounded to bf16; f32 differs only in the order of f32 sums
BWD_REL_TOL = {"bf16": 1e-2, "f32": 1e-4}
# the training step, kernel path vs plain path (same weights, batch and
# draws). In bf16: each head's loss within TRAIN_LOSS_TOL; the cosine of
# the whole gradient (every tensor, concatenated) at least TRAIN_MIN_COSINE;
# per tensor at least TRAIN_MIN_TENSOR_COSINE outside the vision tower.
# The vision tower's own gradient is not held in bf16: at random init the
# heads sit at ln N and that gradient is a cancellation which bf16 rounding
# anywhere in the step turns around, kernels or not (its cosine to the f32
# plain path is 0.298 on the plain bf16 path and 0.299 on the kernel path,
# on an H100 80GB HBM3). It is held three other ways: the gradient reaching
# its pooled tokens from the joint tower (through dq, dk and dv at the
# vision positions) at least TRAIN_MIN_VISION_INPUT_COSINE; against the
# f32 plain path, the kernel bf16 path no farther than the plain bf16 path
# (whole, per tower and at the vision outputs, each path's cosine the mean
# over TRAIN_VS_F32_BATCHES batches at the seed's weights, within
# TRAIN_VS_F32_MARGIN);
# and in an f32 copy of the model, where the kernels agree with their
# plain versions to f32 rounding: each loss within TRAIN_F32_LOSS_TOL and
# every tensor at least TRAIN_F32_MIN_COSINE. The attention-pool key
# biases (ZERO_GRAD) are not held: a bias added to every key of a softmax
# cancels, so their gradient is zero and what the card computes is
# rounding noise
TRAIN_LOSS_TOL = 1e-2
TRAIN_MIN_COSINE = 0.99
TRAIN_MIN_TENSOR_COSINE = 0.98
TRAIN_MIN_VISION_INPUT_COSINE = 0.995
TRAIN_VS_F32_MARGIN = 0.01
# the bf16 paths' cosines to the f32 plain path are held at the seed's
# weights, the same in every run, each the mean over this many batches
# (dummy batches of seeds 0-4). After phase 5's training steps the weights
# differ from run to run (dq's f32 atomics), and with them which bf16 path
# lands nearer f32 on the vision tower's cancelling gradient (kernel minus
# plain from -0.011 to +0.006 across runs on an H100 80GB HBM3); phase 5
# prints, as a reading, this many draws of each path at its trained weights
# to show that repeated draws there agree far more closely than that:
# averaging draws does not steady the check, fixed weights do. At the
# trained weights the vision tower is held in f32 against the plain path
TRAIN_VS_F32_BATCHES = 5
TRAIN_F32_LOSS_TOL = 1e-5
TRAIN_F32_MIN_COSINE = 0.99999
ZERO_GRAD = ("vision_encoder.seq_attnpool.key.bias", "audio_encoder.seq_attnpool.key.bias")
TRAIN_STEPS = 6
TRAIN_BATCH = 8
# the front end on the card vs on the CPU: patches in [0, 1] differ only by
# the order of f32 sums in the resize products; log-mel as the JAX parity
# tests hold it (1e-3 absolute), and against the f64 oracle at
# tests/test_audio_dsp.py's limits
FRONT_PATCH_TOL = 1e-5
FRONT_LOGMEL_TOL = 1e-3
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 2e-3
# the zero-shot path, kernel path vs dense path on the same weights: the
# lowest cosine of a label-space or MASK-feature row, and the largest
# difference of an option's probability. Read on an H100 80GB HBM3 at 700 W:
# 1 - cosine 8.8e-6 (label spaces) and 8.5e-6 (MASK features),
# probabilities 3.25e-3 apart; the limits are about ten and three times those
ZERO_SHOT_MIN_COSINE = 1 - 1e-4
ZERO_SHOT_PROBS_TOL = 1e-2
ZERO_SHOT_OPTIONS = ("cooking pasta in a kitchen", "a dog running on the beach",
                     "playing the guitar", "riding a bike downhill", "painting a wall")


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
    from concurrent.futures import ThreadPoolExecutor

    from merlot_reserve_tpu_torch.data import native
    from merlot_reserve_tpu_torch.kernels import build

    t0 = time.perf_counter()

    def build_native():
        start = time.perf_counter()
        return native.build(), time.perf_counter() - start

    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        data_lib = pool.submit(build_native)
        built = build.build(["flash_fwd", "flash_bwd", "ring_fwd", "adam_update"])
        data_path, data_s = data_lib.result()
    print(f"[build] data library (g++): {data_s:.2f} s -> {data_path.name}, JPEG codec "
          f"{native.jpeg_codec()}", flush=True)
    out = {"merlot_native": {"seconds": data_s, "file": data_path.name,
                             "codec": native.jpeg_codec()}}
    for name, b in built.items():
        report = [ln.strip() for ln in b.log.splitlines()
                  if any(key in ln for key in ("registers", "spill", "Compiling entry",
                                               "Performance Loss", "injected"))]
        print(f"[build] {name}: {b.seconds:.2f} s -> {b.path.name}", flush=True)
        for ln in report:
            print(f"[build]   {ln}", flush=True)
        check(b.path.exists(), f"{name} library missing after build")
        out[name] = {"seconds": b.seconds, "ptxas": report}
    print(f"[build] all sources: {time.perf_counter() - t0:.2f} s", flush=True)
    lib = ctypes.CDLL(str(built["flash_bwd"].path))
    lib.flash_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_bwd_smem_bytes.restype = ctypes.c_size_t
    smem = {f"{n} warpgroups": lib.flash_bwd_smem_bytes(n) for n in (1, 2)}
    print(f"[build] flash_bwd fused pass dynamic shared memory per block: {smem}", flush=True)
    out["flash_bwd"]["fused_smem_bytes"] = smem
    return out


SERVING_CASES = (("serving", 8, 640), ("packed", 8, 640), ("ragged", 8, 600), ("long", 2, 2560))


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


def _pair_counts(valid, seg):
    """(attended pairs, rows that see no key) for these labels."""
    v = valid > 0
    pairs = ((v[:, :, None] & v[:, None, :]) & (seg[:, :, None] == seg[:, None, :])).sum()
    return int(pairs), int((~v).sum())


def _bound(ops, nbytes, dtype):
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _fwd_bound(valid, seg, H, D, dtype, element_size):
    """Bound of the forward, from the products these labels need: q.k and
    p.v over the attended pairs, and for each row that sees no key the mean
    of V over all L keys. Bytes: q, k, v read and out written once, plus the
    labels and lse."""
    B, L = valid.shape
    pairs, blind = _pair_counts(valid, seg)
    ops = 2 * D * H * (2 * pairs + L * blind)
    nbytes = 4 * B * L * H * D * element_size + 2 * B * L * 4 + B * H * L * 4
    bound_ms, bound_by = _bound(ops, nbytes, dtype)
    return {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}


def _bwd_bounds(valid, seg, H, D, dtype, element_size):
    """Bound of the backward as one function ("both": dq, dk and dv), from
    the five products q.k, dO.v, p.dO, ds.q and ds.k over the pairs with
    nonzero p: the attended pairs, plus all L keys of each row that sees no
    key (p = 1 there), except q.k, which those rows skip. Bytes: q, k, v, dO
    read and the gradients written once, plus lse, delta and the labels."""
    B, L = valid.shape
    pairs, blind = _pair_counts(valid, seg)
    ops = 2 * D * H * (pairs + 4 * (pairs + L * blind))
    nbytes = 7 * B * L * H * D * element_size + 2 * B * H * L * 4 + 2 * B * L * 4
    bound_ms, bound_by = _bound(ops, nbytes, dtype)
    return {"both": {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}}


def _attn_mask(valid, seg):
    v = valid > 0
    return ((v[:, :, None] & v[:, None, :]) & (seg[:, :, None] == seg[:, None, :]))[:, None]


def check_fwd(case, valid, seg, H, D, generator, dtypes=("bf16", "f32")):
    """The forward kernel against ``flash_attention_reference`` on the card
    at one shape, in bf16 and f32 (``dtypes``), with its time, the plain
    version's, SDPA's and the bound. The kernel and SDPA are timed twice:
    by CUDA events around calls (``ms``, ``sdpa_ms``: the wrapper's host
    time included when it exceeds the kernel's) and on the device alone,
    from a CUDA graph (``graph_ms``, ``sdpa_graph_ms``). out is held
    relative to its largest value (at least 1): a span row averages 1 to 16
    keys, so its outputs reach several units, not a fraction of one."""
    import torch
    import torch.nn.functional as F

    from merlot_reserve_tpu_torch.ops.attention import flash_attention_reference, flash_forward

    B, L = valid.shape
    mask = _attn_mask(valid, seg)
    row_valid = (valid > 0)[:, None, :].expand(B, H, L)
    results = []
    with torch.inference_mode():
        qkv32 = torch.randn((3, B, L, H, D), generator=generator, device=valid.device)
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            if dname not in dtypes:
                continue
            q, k, v = qkv32.to(dtype).unbind(0)
            out, lse = flash_forward(q, k, v, valid, seg)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(),
                                                         valid, seg)
            err_out = (out.float() - ref_out).abs().max().item()
            scale = max(1.0, ref_out.abs().max().item())
            err_lse = (lse - ref_lse).abs()[row_valid].max().item()
            check(math.isfinite(err_out) and err_out <= TOL[dname]["out"] * scale,
                  f"{case}/{dname} out max abs {err_out} > {TOL[dname]['out']} x {scale}")
            check(math.isfinite(err_lse) and err_lse <= TOL[dname]["lse"],
                  f"{case}/{dname} lse max abs {err_lse} > {TOL[dname]['lse']}")

            def kernel():
                return flash_forward(q, k, v, valid, seg)

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

            ms, sdpa_ms = cuda_time_ms(kernel), cuda_time_ms(sdpa)
            graph_ms, sdpa_graph_ms = graph_time_ms(kernel), graph_time_ms(sdpa)
            plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, valid, seg),
                                    iters=5)
            r = {"case": case, "dtype": dname, "B": B, "L": L, "H": H, "D": D,
                 "max_abs_err_out": err_out, "max_abs_out": scale,
                 "max_abs_err_lse_valid": err_lse, "ms": ms, "graph_ms": graph_ms,
                 "plain_ms": plain_ms, "sdpa_ms": sdpa_ms, "sdpa_graph_ms": sdpa_graph_ms,
                 **_fwd_bound(valid, seg, H, D, dname, q.element_size())}
            r["roofline_share"] = r["bound_ms"] / graph_ms
            results.append(r)
            print(f"[kernel] flash_fwd {case:11s} {dname} B={B} L={L}: out err {err_out:.3e} "
                  f"(max |out| {scale:.2f}) lse err {err_lse:.3e} | {graph_ms * 1e3:.1f} us on "
                  f"the device alone, {ms * 1e3:.1f} us by events (sdpa {sdpa_graph_ms * 1e3:.1f} "
                  f"/ {sdpa_ms * 1e3:.1f} us: {graph_ms / sdpa_graph_ms:.2f}x; plain "
                  f"{plain_ms * 1e3:.1f} us; bound {r['bound_ms'] * 1e3:.2f} us by "
                  f"{r['bound_by']}, {100 * r['roofline_share']:.1f}% of it)", flush=True)
            del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
    del qkv32, mask
    torch.cuda.empty_cache()
    return results


def graph_time_ms(fn, iters=20):
    """Mean device time of ``fn()`` in ms, from CUDA events around replays of
    a CUDA graph of ``iters`` calls: the host's time to enqueue each call is
    not in it (the backward's small passes take less than their wrappers)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def _bwd_launch_bounds(valid, seg, H, D, both):
    """Bounds of the bf16 backward's three launches. prep: dO and out read,
    the row stats and the zeroed f32 dq accumulator written; fused: the five
    products of ``both`` against q, k, v, dO, the stats and the accumulator
    read and dk, dv and the accumulator written once; convert: the
    accumulator read and dq written."""
    B, L = valid.shape
    Lp = -(-L // 64) * 64
    side = B * L * H * D * 2
    acc = B * H * Lp * D * 4
    stats = B * H * Lp * 16
    work = {"flash_bwd_prep": (2 * B * L * H * D, 2 * side + stats + acc),
            "flash_bwd": (both["ops"], 6 * side + stats + 2 * acc + 2 * B * L * 4),
            "flash_bwd_convert": (B * L * H * D, B * H * L * D * 4 + side)}
    out = {}
    for name, (ops, nbytes) in work.items():
        bound_ms, bound_by = _bound(ops, nbytes, "bf16")
        out[name] = {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
    return out


BWD_LAUNCHES = ("flash_bwd_prep", "flash_bwd", "flash_bwd_convert")
BWD_LAUNCHES_F32 = ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")


def check_bwd(case, valid, seg, H, D, generator):
    """The backward against ``flash_attention_backward_reference`` on the card
    at one shape, in bf16 and f32: in bf16 its three launches (prep, the
    fused pass, convert), with prep and convert also held against their own
    plain versions; in f32 the two scalar kernels. Times: the whole backward
    and, in bf16, each launch on the device alone (``graph_time_ms``), the
    plain version, SDPA's backward and the bounds. q, k, v are random and dO
    is random on valid rows and 0 on rows that see no key, as in the model;
    out and lse come from the forward kernel. A padding row has p = 1 for
    every key, so a random dO there would feed dq, dk and dv gradients far
    larger than the valid rows' and set the scale of the check."""
    import torch
    import torch.nn.functional as F

    from merlot_reserve_tpu_torch.ops import attention as attn_ops

    B, L = valid.shape
    mask = _attn_mask(valid, seg)
    results = []
    qkvo32 = torch.randn((4, B, L, H, D), generator=generator, device=valid.device)
    qkvo32[3] *= (valid > 0)[:, :, None, None]
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v, do = qkvo32.to(dtype).unbind(0)
        launch_ms, parts = {}, {}
        with torch.no_grad():
            out, lse = attn_ops.flash_forward(q, k, v, valid, seg)
            grads = attn_ops.flash_backward(q, k, v, do, out, lse, valid, seg)
            torch.cuda.synchronize()
            ref = attn_ops.flash_attention_backward_reference(
                q.float(), k.float(), v.float(), do.float(), out.float(), lse, valid, seg)
            errs = {}
            for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
                err = (a.float() - b).abs().max().item()
                scale = b.abs().max().item()
                errs[name] = {"max_abs_err": err, "max_abs_ref": scale, "rel": err / scale}
                check(math.isfinite(err) and err <= BWD_REL_TOL[dname] * scale,
                      f"bwd {case}/{dname} {name} max abs {err} > {BWD_REL_TOL[dname]} x {scale}")
            del ref, grads
            ms = cuda_time_ms(lambda: attn_ops.flash_backward(q, k, v, do, out, lse, valid, seg))
            if dname == "bf16":
                # prep and convert against their plain versions: lse2 and the
                # labels exactly, delta to f32 summation order, dq bit for bit
                stats, acc = attn_ops.flash_bwd_prep(q, k, v, do, out, lse, valid, seg)
                ref_stats, _ = attn_ops.flash_bwd_prep_reference(do, out, lse, valid, seg)
                torch.cuda.synchronize()
                check(torch.equal(stats[..., 0], ref_stats[..., 0])
                      and torch.equal(stats.view(torch.int32)[..., 2:],
                                      ref_stats.view(torch.int32)[..., 2:])
                      and bool((acc == 0).all()), f"bwd {case} prep: lse2, labels or zeros")
                parts["prep_delta_max_abs_err"] = (stats[..., 1] - ref_stats[..., 1]).abs().max().item()
                check(parts["prep_delta_max_abs_err"]
                      <= 1e-5 * max(1.0, ref_stats[..., 1].abs().max().item()),
                      f"bwd {case} prep delta err {parts['prep_delta_max_abs_err']}")
                acc.normal_(generator=generator)
                dq = attn_ops.flash_bwd_convert(q, k, v, do, acc, valid, seg)
                check(torch.equal(dq, attn_ops.flash_bwd_convert_reference(q, acc)),
                      f"bwd {case} convert differs from its plain version")
                launch_ms = {
                    "flash_bwd_prep": graph_time_ms(
                        lambda: attn_ops.flash_bwd_prep(q, k, v, do, out, lse, valid, seg)),
                    "flash_bwd": graph_time_ms(
                        lambda: attn_ops.flash_bwd_fused(q, k, v, do, stats, acc, valid, seg)),
                    "flash_bwd_convert": graph_time_ms(
                        lambda: attn_ops.flash_bwd_convert(q, k, v, do, acc, valid, seg))}
                parts["launch_plain_ms"] = {
                    "flash_bwd_prep": cuda_time_ms(lambda: attn_ops.flash_bwd_prep_reference(
                        do, out, lse, valid, seg)),
                    "flash_bwd_convert": cuda_time_ms(
                        lambda: attn_ops.flash_bwd_convert_reference(q, acc).contiguous())}
                del stats, acc, ref_stats, dq
            plain_ms = cuda_time_ms(lambda: attn_ops.flash_attention_backward_reference(
                q, k, v, do, out, lse, valid, seg), iters=3, warmup=1)
        # the library yardstick: SDPA's backward (dq, dk, dv in one call) on
        # a saved forward with the same boolean mask; the port never calls it
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        do_t = do.transpose(1, 2)
        sdpa_bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True))
        bounds = _bwd_bounds(valid, seg, H, D, dname, q.element_size())
        if dname == "bf16":
            bounds.update(_bwd_launch_bounds(valid, seg, H, D, bounds["both"]))
        r = {"case": case, "dtype": dname, "B": B, "L": L, "H": H, "D": D, "errors": errs,
             "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
             "bounds": bounds, **parts}
        results.append(r)
        each = ", ".join(f"{n} {t * 1e3:.1f} (bound {bounds[n]['bound_ms'] * 1e3:.1f} by "
                         f"{bounds[n]['bound_by']})" for n, t in launch_ms.items())
        print(f"[kernel] flash_bwd {case:11s} {dname} B={B} L={L}: max abs err (rel) dq "
              f"{errs['dq']['max_abs_err']:.3e} ({errs['dq']['rel']:.2e}) dk "
              f"{errs['dk']['max_abs_err']:.3e} ({errs['dk']['rel']:.2e}) dv "
              f"{errs['dv']['max_abs_err']:.3e} ({errs['dv']['rel']:.2e}) | backward "
              f"{ms * 1e3:.1f} us (bound {bounds['both']['bound_ms'] * 1e3:.1f} by "
              f"{bounds['both']['bound_by']}){'; on the device alone ' + each if each else ''}; "
              f"plain {plain_ms * 1e3:.1f} us, sdpa bwd {sdpa_bwd_ms * 1e3:.1f} us", flush=True)
        del q, k, v, do, out, lse, qt, kt, vt, o, do_t
    del qkvo32, mask
    torch.cuda.empty_cache()
    return results


def phase_kernels(cases, seed, heads=12, backward=True):
    """The three kernels against their plain versions, case by case: each
    case is (name, is_valid, segment_ids) on the card, at ``heads`` heads of
    64 (the base config's 12, the large config's 16); the backward only
    with ``backward``. Returns (forward results, backward results)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    fwd, bwd = [], []
    for case, valid, seg in cases:
        fwd += check_fwd(case, valid, seg, heads, 64, g)
        if backward:
            bwd += check_bwd(case, valid, seg, heads, 64, g)
    return fwd, bwd


def make_requests(cfg, n, seed, n_seg=8):
    """``n`` preprocessed videos shaped like the serving entry example:
    ``n_seg`` segments of 12x20 patches (8 in the entry; 40 for a 200-second
    video), 3 audio subsegments per segment, 160 tokens of which the first
    144 are AUDIOSPAN (odd videos carry text in the last 48) and the rest
    PADDING."""
    import numpy as np

    from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN

    rng = np.random.RandomState(seed)
    grid = cfg.model.vit_seq_len
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


def phase_slice(card, name="base"):
    """A full-width ``name`` model (random weights from seed 0) behind
    ``VideoEmbedService`` at batch 8 (joint L 640): a full batch, an
    underfilled one and 12 concurrent requests through ``DynamicBatcher``;
    shapes, unit rows, one ``flash_fwd`` per joint layer per batch,
    agreement with the plain attention path; both clocks and the peak."""
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.serving import DynamicBatcher, VideoEmbedService

    tag = f"[slice {name}]"
    cfg = load_config(name, joint_attention_impl="flash")
    check(cfg.model.use_bfloat16, f"{name} config should compute in bf16")
    t0 = time.perf_counter()
    model = MerlotReserve(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag} {name} model ({cfg.model.joint_num_layers}/{cfg.model.vit_num_layers}/"
          f"{cfg.model.audio_num_layers} joint/vit/audio layers, hidden {cfg.model.hidden_size}, "
          f"{cfg.model.num_heads} heads, {n_params / 1e6:.1f}M params) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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
    print(f"{tag} answered {sum(len(o) for o in outs)} requests in {batches} batches "
          f"(dynamic batch fills {batcher.batch_fills}); kernel launches {launches}", flush=True)
    check(launches.get("flash_fwd", 0) == joint_layers * batches,
          f"flash_fwd launches {launches.get('flash_fwd', 0)} != {joint_layers} x {batches} batches")
    for o, n in zip(outs, (8, 5, 12)):
        check(o.shape == (n, 160, cfg.model.hidden_size), f"output shape {o.shape}")
        check(np.isfinite(o).all(), "non-finite embeddings")
        norms = np.linalg.norm(o, axis=-1)
        check(np.abs(norms - 1).max() < 1e-2, f"row norms off 1 by {np.abs(norms - 1).max()}")

    # kernel path vs the plain flash version on the same inputs, on the card
    with _plain_attention():
        plain = service.embed(full)
    a, b = outs[0].reshape(-1, cfg.model.hidden_size), plain.reshape(-1, cfg.model.hidden_size)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    max_diff = float(np.abs(a - b).max())
    print(f"{tag} kernel vs plain attention path: min row cosine {cos.min():.6f}, "
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
    res = {"config": name, "heads": cfg.model.num_heads, "params": n_params,
           "batch": 8, "segments_per_video": 8, "batches_answered": batches,
           "launches": launches, "min_cosine_vs_plain": float(cos.min()),
           "max_abs_diff_vs_plain": max_diff, "service_ms_per_batch_median": host_med,
           "service_ms_per_batch_runs": host_ms, "device_ms_per_batch": device_ms,
           "videos_per_s": 8 / host_med * 1e3, "segments_per_s": 64 / host_med * 1e3,
           "device_videos_per_s": 8 / device_ms * 1e3, "device_segments_per_s": 64 / device_ms * 1e3,
           "max_memory_allocated_bytes": peak_mem}
    print(f"{tag} {card}: {host_med:.2f} ms per batch of 8 through the service "
          f"({res['videos_per_s']:.1f} videos/s, {res['segments_per_s']:.1f} segments/s); "
          f"model alone {device_ms:.2f} ms on the device clock "
          f"({res['device_segments_per_s']:.1f} segments/s); "
          f"peak memory {peak_mem / 2**30:.2f} GiB", flush=True)
    return res


@contextlib.contextmanager
def _recorded_labels():
    """Yields a dict that each flash attention call made inside fills with
    the (is_valid, segment_ids) it got, int32, by (B, L): the first call of
    each shape."""
    import torch

    from merlot_reserve_tpu_torch.ops import attention as attn_ops

    seen = {}
    original = attn_ops.flash_attention

    def record(q, k, v, is_valid, segment_ids):
        seen.setdefault(tuple(q.shape[:2]),
                        (is_valid.to(torch.int32), segment_ids.to(torch.int32)))
        return original(q, k, v, is_valid, segment_ids)

    with mock.patch.object(attn_ops, "flash_attention", record):
        yield seen


def _capture_labels(model, batch):
    """The (is_valid, segment_ids) each flash attention call of one no-grad
    forward of ``model`` on ``batch`` gets, by sequence length: the joint
    tower's (L 640) and the span tower's (L 16)."""
    import torch

    with torch.no_grad(), _recorded_labels() as seen:
        model(batch)
    by_length = {}
    for (_, L), labels in seen.items():  # in call order: the first of each length
        by_length.setdefault(L, labels)
    return by_length


@contextlib.contextmanager
def _vision_output_grads(model, towers=("vision_encoder",)):
    """Yields a dict that a backward through ``model`` fills with the f32
    gradient reaching the two outputs of each of ``towers`` (by default the
    vision tower): 'cls' (from the contrastive heads) and 'seq_attnpool'
    (from the joint tower); another tower's keys carry its name first
    ('audio_encoder.cls', ...)."""
    store, handles = {}, []
    for tower in towers:
        prefix = "" if tower == "vision_encoder" else f"{tower}."

        def hook(module, args, out, prefix=prefix):
            for key in ("cls", "seq_attnpool"):
                out[key].register_hook(
                    lambda g, key=prefix + key: store.__setitem__(key, g.float()))

        handles.append(getattr(model, tower).register_forward_hook(hook))
    try:
        yield store
    finally:
        for handle in handles:
            handle.remove()


def _agreement(grads_a, grads_b):
    """Cosines of two gradients, dicts of tensors by parameter name: of the
    whole, of each tower (the name's first part) as one vector, and of each
    tensor."""
    sums = {}
    for name, a in grads_a.items():
        a, b = a.double(), grads_b[name].double()
        sums[name] = [float((a * b).sum()), float((a * a).sum()), float((b * b).sum())]

    def cosine(names):
        ab, aa, bb = (sum(sums[n][i] for n in names) for i in range(3))
        return ab / (math.sqrt(aa * bb) + 1e-30)

    towers = {}
    for name in grads_a:
        towers.setdefault(name.split(".")[0], []).append(name)
    return {"whole": cosine(list(grads_a)),
            "towers": {t: cosine(names) for t, names in sorted(towers.items())},
            "tensors": {n: cosine([n]) for n in grads_a}}


def _compare_paths(run_a, run_b, label):
    """Two paths' (loss terms, gradients, gradients at the vision tower's
    outputs) of one step: ``_agreement`` of the gradients, the loss terms'
    differences, the vision outputs' cosines, and the lowest tensor cosine
    held (outside ZERO_GRAD; and outside the vision tower), printed after
    ``label``."""
    (info_a, grads_a, vis_a), (info_b, grads_b, vis_b) = run_a, run_b
    res = _agreement(grads_a, grads_b)
    res["loss_diff"] = {k: abs(float(info_a[k]) - float(info_b[k])) for k in info_a}
    res["vision_outputs"] = {k: _agreement({k: vis_a[k]}, {k: vis_b[k]})["whole"]
                             for k in vis_a}
    held = {n: c for n, c in res["tensors"].items() if n not in ZERO_GRAD}
    res["lowest_held"] = min(held.items(), key=lambda kv: kv[1])
    res["lowest_held_outside_vision"] = min(
        ((n, c) for n, c in held.items() if not n.startswith("vision_encoder.")),
        key=lambda kv: kv[1])
    worst = sorted(res["tensors"].items(), key=lambda kv: kv[1])[:6]
    print(f"{label}: loss diffs "
          f"{ {k: f'{v:.2e}' for k, v in res['loss_diff'].items() if not k.startswith('_')} }; "
          f"gradient cosine: whole {res['whole']:.6f}, per tower "
          f"{ {k: round(v, 6) for k, v in res['towers'].items()} }, at the towers' outputs "
          f"{ {k: round(v, 6) for k, v in res['vision_outputs'].items()} }, lowest "
          f"per tensor {[(n, round(c, 5)) for n, c in worst]}", flush=True)
    return res


def _plain_attention():
    """A patch that sends the flash attention to its plain version (on the
    same card), for the plain path of a comparison without grad."""
    from merlot_reserve_tpu_torch.ops import attention as attn_ops

    def plain(q, k, v, is_valid, segment_ids):
        return attn_ops.flash_attention_reference(q, k, v, is_valid, segment_ids)[0]

    return mock.patch.object(attn_ops, "flash_attention", plain)


def _min_row_cos(a, b):
    """The lowest cosine between the rows of two arrays, in f64."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _plain_flash():
    """Patches that send the flash forward and backward to their plain
    versions (on the same card), for the plain path of a comparison."""
    from merlot_reserve_tpu_torch.ops import attention as attn_ops

    return (mock.patch.object(attn_ops, "flash_forward", attn_ops.flash_attention_reference),
            mock.patch.object(attn_ops, "flash_backward",
                              attn_ops.flash_attention_backward_reference))


def _expected_init_losses(cfg, batch_size):
    """ln N per head at init: each side's number of candidates."""
    d = cfg.data
    audio_spans = d.num_segments * d.num_audio_subsegments
    targets = int(audio_spans * d.mask_rate) * d.num_text2audio_seqs
    return {"imgs_to_audio": math.log(batch_size * d.num_segments),
            "text_to_audio": (math.log(batch_size * audio_spans)
                              + math.log(batch_size * targets)) / 2,
            "stuff_to_span": math.log(batch_size * d.num_text_spans_to_include)}


# the kernels that a traced pretraining step must show on the card's lanes
TRACE_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_bf16_kernel", "adam_update_kernel")


def _trace_step(step, card, device_ms):
    """One ``step()`` under ``utils.profiling.trace``: the lanes of the
    Kineto dump, the card's lanes' wall time (``trace_wall_ms`` with
    ``DEVICE_LANES``) beside the CUDA-event ``device_ms``, and their top
    kernels; checks that the hand-written kernels are on those lanes."""
    import tempfile

    import torch

    from merlot_reserve_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            step()
        files = profiling.find_trace_files(log_dir)
        events = profiling.load_trace_events(log_dir)
    lanes = {}
    for e in events:
        lanes.setdefault(e.lane, {}).setdefault(e.thread, 0)
        lanes[e.lane][e.thread] += 1
    wall = profiling.trace_wall_ms(events, profiling.DEVICE_LANES)
    # Kineto projects the step's record_function ranges onto the card's lane
    # too (train_step/forward, ...): rows of their own, over the kernels
    rows = profiling.op_time_table([e for e in events if not e.name.startswith("train_step/")],
                                   profiling.DEVICE_LANES, top=None)
    busy = sum(r["total_ms"] for r in rows)
    print(f"[trace] {card}: one pretraining step under utils.profiling.trace "
          f"({os.path.basename(files[0])}): lanes {lanes}; the card's lanes "
          f"(lane_filter {profiling.DEVICE_LANES!r}) {len(rows)} kernel names, wall "
          f"{wall:.1f} ms, busy {busy:.1f} ms, against {device_ms:.1f} ms by CUDA events; "
          f"top: {[(r['name'][:60], round(r['total_ms'], 2), r['count']) for r in rows[:6]]}",
          flush=True)
    names = " ".join(r["name"] for r in rows)
    check(rows and wall > 0, f"the trace shows no event on a lane matching "
          f"{profiling.DEVICE_LANES!r}: lanes {sorted(lanes)}")
    for kernel in TRACE_KERNELS:
        check(kernel in names, f"the trace's device lanes show no {kernel}")
    return {"file": os.path.basename(files[0]), "lanes": lanes, "wall_ms": wall,
            "busy_ms": busy, "event_ms": device_ms, "top": rows[:20]}


def _bf16_paths_against_f32(cfg):
    """Per part of the gradient (whole, each tower, the vision tower's two
    outputs): the cosine of the kernel bf16 path's and of the plain bf16
    path's gradient to the f32 plain path's, at the seed's weights, for
    each of TRAIN_VS_F32_BATCHES dummy batches (seeds 0, 1, ...) with its
    own draws; {path: [{part: cosine}, ...]}."""
    import torch

    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.training.trainer import loss_and_grads

    model = MerlotReservePretrainer(cfg, device="cuda", seed=0)
    model32 = MerlotReservePretrainer(cfg.replace_model(use_bfloat16=False), device="cuda",
                                      seed=0)
    model32.load_state_dict(model.state_dict())
    d = cfg.data
    spg, rows = d.num_segments_per_group, TRAIN_BATCH * d.num_segment_groups
    g = torch.Generator(device="cuda").manual_seed(5)
    draws = {"kernel_bf16": [], "plain_bf16": []}
    for seed in range(TRAIN_VS_F32_BATCHES):
        batch = batch_to_tensors(make_dummy_batch(cfg, TRAIN_BATCH, seed=seed), "cuda")
        split_at = [model.draw_split_at(rows, spg, g) for _ in range(2)]
        u = torch.rand((TRAIN_BATCH, batch["text_spans"].shape[1]), generator=g, device="cuda")
        gumbel = -torch.log(-torch.log(u))
        got = {}
        for name, m, bf16, plain in (("plain_f32", model32, False, True),
                                     ("kernel_bf16", model, True, False),
                                     ("plain_bf16", model, True, True)):
            with contextlib.ExitStack() as stack:
                if plain:
                    for patch in _plain_flash():
                        stack.enter_context(patch)
                vision_out = stack.enter_context(_vision_output_grads(m))
                _, grads = loss_and_grads(m, batch, use_bfloat16_grads=bf16, split_at=split_at,
                                          gumbel=gumbel)
            got[name] = (grads, vision_out)
        ref_grads, ref_vision = got.pop("plain_f32")
        for name, (grads, vision_out) in got.items():
            r = _agreement(grads, ref_grads)
            draws[name].append({"whole": r["whole"], **r["towers"], **{
                f"vision tower's {k}": _agreement({k: vision_out[k]}, {k: ref_vision[k]})["whole"]
                for k in vision_out}})
        del got, ref_grads, ref_vision
    del model, model32
    torch.cuda.empty_cache()
    return draws


def _bf16_draws_at_trained_weights(model, batch, split_at, gumbel, ref):
    """A reading, not a check: at the weights phase 5 trained (they differ
    from run to run), TRAIN_VS_F32_BATCHES draws of each bf16 path's
    gradient on the same batch and draws, each as its cosine to the f32
    plain path's (``ref``: phase 5's plain_f32 run), whole, on the vision
    tower and at its outputs. Shows how far repeated draws at one run's
    weights spread (the kernel path's dq sums in f32 atomics) beside how
    the paths' order on the vision tower moves between runs."""
    import torch

    from merlot_reserve_tpu_torch.training.trainer import loss_and_grads

    _, ref_grads, ref_vision = ref
    vision = [n for n in ref_grads if n.startswith("vision_encoder.")]
    out = {}
    for name, plain in (("kernel_bf16", False), ("plain_bf16", True)):
        rows = []
        for _ in range(TRAIN_VS_F32_BATCHES):
            with contextlib.ExitStack() as stack:
                if plain:
                    for patch in _plain_flash():
                        stack.enter_context(patch)
                vision_out = stack.enter_context(_vision_output_grads(model))
                _, grads = loss_and_grads(model, batch, use_bfloat16_grads=True,
                                          split_at=split_at, gumbel=gumbel)
            r = _agreement({n: grads[n] for n in vision}, {n: ref_grads[n] for n in vision})
            rows.append({"whole": _agreement(grads, ref_grads)["whole"],
                         "vision_encoder": r["whole"], **{
                             f"vision tower's {k}": _agreement({k: vision_out[k]},
                                                               {k: ref_vision[k]})["whole"]
                             for k in vision_out}})
            del grads, vision_out
        out[name] = {"draws": rows, "spread": {k: max(r_[k] for r_ in rows) -
                                               min(r_[k] for r_ in rows) for k in rows[0]}}
    torch.cuda.empty_cache()
    k, p = (out[n]["draws"] for n in ("kernel_bf16", "plain_bf16"))
    mean = {n: sum(r_["vision_encoder"] for r_ in out[n]["draws"]) / len(out[n]["draws"])
            for n in out}
    print(f"[train] reading at the trained weights, {TRAIN_VS_F32_BATCHES} draws on one batch: "
          f"vision tower's gradient cosine to the f32 plain path, kernel bf16 "
          f"{[round(r_['vision_encoder'], 5) for r_ in k]} (spread "
          f"{out['kernel_bf16']['spread']['vision_encoder']:.2e}), plain bf16 "
          f"{[round(r_['vision_encoder'], 5) for r_ in p]} (spread "
          f"{out['plain_bf16']['spread']['vision_encoder']:.2e}); kernel minus plain "
          f"{mean['kernel_bf16'] - mean['plain_bf16']:+.5f}", flush=True)
    return out


def phase_train(card):
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.training.trainer import loss_and_grads, train_step

    cfg = load_config("base", joint_attention_impl="flash")
    # warmup 1: the first update has lr scale 0, every later one the full
    # lr. lr 1e-5 keeps Adam's first updates (about lr * sign(grad) on
    # every weight) in the first-order regime, so the loss on one repeated
    # batch falls within a few steps
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
    batch = make_dummy_batch(cfg, TRAIN_BATCH, seed=0)
    m, d = cfg.model, cfg.data
    print(f"[train] base pretrainer, hidden {m.hidden_size}, {m.joint_num_layers}/"
          f"{m.vit_num_layers}/{m.audio_num_layers}/{m.span_num_layers} joint/vision/audio/span "
          f"layers; batch {TRAIN_BATCH}, {d.num_segments} segments of {m.output_grid[0]}x"
          f"{m.output_grid[1]} patches, seq_len {d.seq_len}, lang_seq_len {d.lang_seq_len}, "
          f"{d.num_text_spans_to_include} spans drawn per example", flush=True)

    logged, stamps = [], []

    def log_fn(step, metrics):
        stamps.append(time.perf_counter())  # metrics are floats: the step has ended
        logged.append(metrics)

    # the training path, counted: every launch between the reset and the read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = run_pretraining(cfg, itertools.repeat(batch), num_steps=TRAIN_STEPS, log_fn=log_fn,
                            log_every=0, device="cuda", seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    totals = [m_["total"] for m_ in logged]
    print(f"[train] {TRAIN_STEPS} steps, kernel launches {launches}; total loss per step "
          f"{[round(t, 5) for t in totals]}", flush=True)
    per_step = m.joint_num_layers + m.span_num_layers  # every joint and span layer
    for name in ("flash_fwd", *BWD_LAUNCHES):
        check(launches.get(name, 0) == per_step * TRAIN_STEPS,
              f"{name} launches {launches.get(name, 0)} != {per_step} x {TRAIN_STEPS} steps")
    for name in BWD_LAUNCHES_F32:
        check(launches.get(name, 0) == 0, f"the bf16 step launched {name}")
    check(all(math.isfinite(v) for m_ in logged for v in m_.values()), "non-finite loss")
    # an untrained model scores every candidate about equally
    expected = _expected_init_losses(cfg, TRAIN_BATCH)
    for head, ln_n in expected.items():
        check(abs(logged[0][head] - ln_n) < 0.05,
              f"step-0 {head} loss {logged[0][head]} is not near ln N = {ln_n}")
    check(abs(totals[1] - totals[0]) <= 1e-4, "the first update (lr scale 0) changed the loss")
    check(totals[-1] < totals[1], f"loss did not fall on the repeated batch: {totals}")

    # the step on the device clock, on a batch already on the card
    dev_batch = batch_to_tensors(batch, "cuda")
    device_ms = cuda_time_ms(lambda: train_step(state, dev_batch), iters=3, warmup=1)
    traced = _trace_step(lambda: train_step(state, dev_batch), card, device_ms)
    host_med = float(np.median(step_ms[2:]))
    state.optimizer = None  # frees its moments for the f32 model below
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # kernel path vs plain path: the same weights, batch and draws, first in
    # bf16 as trained, then in an f32 copy of the model, where the kernels
    # agree with their plain versions to f32 rounding
    labels = _capture_labels(state.model, dev_batch)
    g = torch.Generator(device="cuda").manual_seed(5)
    spg, rows = d.num_segments_per_group, TRAIN_BATCH * d.num_segment_groups
    split_at = [state.model.draw_split_at(rows, spg, g) for _ in range(2)]
    u = torch.rand((TRAIN_BATCH, batch["text_spans"].shape[1]), generator=g, device="cuda")
    gumbel = -torch.log(-torch.log(u))
    model32 = MerlotReservePretrainer(load_config("base", joint_attention_impl="flash",
                                                  use_bfloat16=False), device="cuda", seed=0)
    model32.load_state_dict(state.model.state_dict())
    runs = {}
    for name, model, bf16, plain in (("kernel_bf16", state.model, True, False),
                                     ("plain_bf16", state.model, True, True),
                                     ("kernel_f32", model32, False, False),
                                     ("plain_f32", model32, False, True)):
        before = dict(kernels.LAUNCHES)
        with contextlib.ExitStack() as stack:
            if plain:
                for patch in _plain_flash():
                    stack.enter_context(patch)
            vision_out = stack.enter_context(_vision_output_grads(model))
            info, grads = loss_and_grads(model, dev_batch, use_bfloat16_grads=bf16,
                                         split_at=split_at, gumbel=gumbel)
        check(plain == (dict(kernels.LAUNCHES) == before),
              f"{name}: the {'plain' if plain else 'kernel'} path launched "
              f"{'a' if plain else 'no'} kernel")
        runs[name] = (info, grads, vision_out)
    peak_compare = torch.cuda.max_memory_allocated()
    del model32

    def compare(a, b):
        return _compare_paths(runs[a], runs[b], f"[train] {a} vs {b}")

    agreement = {"kernel_bf16 vs plain_bf16": compare("kernel_bf16", "plain_bf16"),
                 "kernel_f32 vs plain_f32": compare("kernel_f32", "plain_f32"),
                 "plain_bf16 vs plain_f32": compare("plain_bf16", "plain_f32"),
                 "kernel_bf16 vs plain_f32": compare("kernel_bf16", "plain_f32")}

    trained = _bf16_draws_at_trained_weights(state.model, dev_batch, split_at, gumbel,
                                             runs["plain_f32"])
    del runs
    draws = _bf16_paths_against_f32(cfg)
    bf16, f32 = agreement["kernel_bf16 vs plain_bf16"], agreement["kernel_f32 vs plain_f32"]
    for k in ("imgs_to_audio", "text_to_audio", "stuff_to_span", "total"):
        check(bf16["loss_diff"][k] <= TRAIN_LOSS_TOL,
              f"{k} kernel vs plain {bf16['loss_diff'][k]} > {TRAIN_LOSS_TOL}")
        check(f32["loss_diff"][k] <= TRAIN_F32_LOSS_TOL,
              f"{k} f32 kernel vs plain {f32['loss_diff'][k]} > {TRAIN_F32_LOSS_TOL}")
    check(bf16["whole"] >= TRAIN_MIN_COSINE,
          f"whole-gradient cosine {bf16['whole']} below {TRAIN_MIN_COSINE}")
    low = bf16["lowest_held_outside_vision"]
    check(low[1] >= TRAIN_MIN_TENSOR_COSINE,
          f"gradient cosine of {low[0]} {low[1]} below {TRAIN_MIN_TENSOR_COSINE}")
    pooled = bf16["vision_outputs"]["seq_attnpool"]
    check(pooled >= TRAIN_MIN_VISION_INPUT_COSINE, f"gradient cosine at the vision tower's "
          f"pooled tokens {pooled} below {TRAIN_MIN_VISION_INPUT_COSINE}")
    vs_f32 = {}
    for part in draws["kernel_bf16"][0]:
        got = {name: [d[part] for d in runs_] for name, runs_ in draws.items()}
        mean = {name: sum(v) / len(v) for name, v in got.items()}
        vs_f32[part] = {"draws": got, "mean": mean,
                        "spread": {name: max(v) - min(v) for name, v in got.items()}}
        print(f"[train] {part}: gradient cosine to the f32 plain path at the seed's weights, "
              f"{TRAIN_VS_F32_BATCHES} batches: kernel bf16 "
              f"{[round(c, 5) for c in got['kernel_bf16']]} "
              f"(mean {mean['kernel_bf16']:.5f}, spread "
              f"{vs_f32[part]['spread']['kernel_bf16']:.2e}), plain bf16 "
              f"{[round(c, 5) for c in got['plain_bf16']]} (mean {mean['plain_bf16']:.5f}, "
              f"spread {vs_f32[part]['spread']['plain_bf16']:.2e})", flush=True)
        check(mean["kernel_bf16"] >= mean["plain_bf16"] - TRAIN_VS_F32_MARGIN,
              f"{part}: the kernel bf16 path's mean gradient cosine to the f32 plain path "
              f"{mean['kernel_bf16']} is below the plain bf16 path's {mean['plain_bf16']} by "
              f"more than {TRAIN_VS_F32_MARGIN}")
    low = f32["lowest_held"]
    check(low[1] >= TRAIN_F32_MIN_COSINE,
          f"f32 gradient cosine of {low[0]} {low[1]} below {TRAIN_F32_MIN_COSINE}")
    # at the trained weights, the vision tower through the kernels against
    # the plain path's fixed order, in f32
    for part, c in (("the vision tower", f32["towers"]["vision_encoder"]),
                    *((f"the vision tower's {k}", v) for k, v in f32["vision_outputs"].items())):
        check(c >= TRAIN_F32_MIN_COSINE, f"at the trained weights, f32 gradient cosine of "
              f"{part} {c} below {TRAIN_F32_MIN_COSINE}")

    res = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "launches": launches,
           "losses": logged, "expected_init_losses": expected,
           "step_ms_host": step_ms, "step_ms_host_median": host_med,
           "step_ms_device": device_ms, "examples_per_s": TRAIN_BATCH / host_med * 1e3,
           "device_examples_per_s": TRAIN_BATCH / device_ms * 1e3,
           "max_memory_allocated_bytes": peak_mem,
           "max_memory_allocated_bytes_comparisons": peak_compare,
           "agreement": agreement, "bf16_vs_f32_draws": vs_f32,
           "bf16_vs_f32_draws_trained": trained, "trace": traced,
           "labels": {L: (v.shape[0], int((v > 0).sum()), int(s_.max()))
                      for L, (v, s_) in labels.items()}}
    print(f"[train] {card}: {host_med:.1f} ms per step on the host clock (median of steps "
          f"3-{TRAIN_STEPS}), {device_ms:.1f} ms on the device clock; "
          f"{res['examples_per_s']:.2f} examples/s; peak memory {peak_mem / 2**30:.2f} GiB "
          f"(with the f32 comparison {peak_compare / 2**30:.2f} GiB)", flush=True)
    del state, dev_batch
    torch.cuda.empty_cache()
    return res, labels


# ring kernel vs the plain ring, relative to the plain ring's max |out|:
# bf16 as flash_fwd (bf16 probabilities and output), f32 another order of
# f32 sums
RING_REL_TOL = {"bf16": 1e-2, "f32": 1e-5}
# (case, n ranks, B, L) of the ring kernel checks; "long_video" is the
# slice's shape, "persistent" has 2304 ring members, more than fit at once
RING_CASES = (("tail", 2, 8, 640), ("tail", 4, 8, 640), ("tail", 8, 8, 640),
              ("odd_n", 3, 8, 768), ("packed", 4, 8, 640), ("blind_shard", 4, 8, 640),
              ("segment_pads", 4, 8, 640), ("long_video", 4, 8, 2560),
              ("persistent", 4, 48, 640))
LONG_SEGMENTS = 40
LONG_BATCHES = 3


def _ring_labels(case, B, L, device):
    """(is_valid, segment_ids) int32 [B, L] for one ring kernel case."""
    import torch

    valid = torch.ones((B, L), dtype=torch.int32, device=device)
    seg = torch.zeros((B, L), dtype=torch.int32, device=device)
    if case in ("tail", "odd_n"):
        valid[:, 144:160] = 0  # the entry's PADDING tokens
        valid[:, L - 40:] = 0  # and a padded tail inside the last shard
    elif case == "packed":  # three videos; boundaries inside shards 1 and 3 of 160 rows
        seg[:, 250:] = 1
        seg[:, 500:] = 2
        valid[:, 240:250] = 0
    elif case == "blind_shard":  # every key of rank 1's shard is invalid
        valid[:, 160:320] = 0
    elif case == "segment_pads":  # as prepare_multimodal_inputs pads: valid 0, segment -1
        seg[:, 330:] = 1
        valid[:, 600:] = 0
        seg[:, 600:] = -1
    else:  # "long_video", "persistent": 144 AUDIOSPAN, 16 PADDING, then image tokens
        valid[:, 144:160] = 0
    return valid, seg


def _ring_bounds(valid, seg, n, H, D, element_size):
    """Two bounds of the ring forward. "function": the contract's, each
    input read once and out written once, against the operations these
    labels need (as ``_fwd_bound``). "ring": with the ring's own traffic,
    q and out once, each rank reading all n shards, and n (n - 1) shard
    copies written and read."""
    B, L = valid.shape
    pairs, blind = _pair_counts(valid, seg)
    ops = 2 * D * H * (2 * pairs + L * blind)
    unit = B * L * H * D * element_size  # one of q, k, v, out
    labels = 2 * B * L * 4
    traffic = {"function": 4 * unit + labels,
               "ring": 2 * unit + n * (2 * unit + labels) + 2 * (n - 1) * (2 * unit + labels)}
    out = {}
    for name, nbytes in traffic.items():
        bound_ms, bound_by = _bound(ops, nbytes, "bf16" if element_size == 2 else "f32")
        out[name] = {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def check_ring(case, n, valid, seg, H, D, generator, timed):
    """The ring kernel (n virtual ranks) against ``ring_attention_reference``
    on the card, in bf16 and f32, on q, k, v as the model hands them over
    (strided views of one projection). Held on every row and on valid rows,
    relative to the plain ring's largest |out| there. In bf16 the kernel and
    SDPA over the full L are timed by events (``ms``, ``sdpa_ms``) and on
    the device alone from a CUDA graph (``graph_ms``, ``sdpa_graph_ms``).
    ``timed``: also the plain ring's time, the flash forward's over the full
    L, and the bounds."""
    import torch
    import torch.nn.functional as F

    from merlot_reserve_tpu_torch.ops import attention as attn_ops
    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops

    B, L = valid.shape
    rows = valid > 0
    results = []
    with torch.inference_mode():
        qkv32 = torch.randn((B, L, 3, H, D), generator=generator, device=valid.device)
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q, k, v = qkv32.to(dtype).unbind(2)
            out = ring_ops.ring_fwd(q, k, v, valid, seg, n)
            torch.cuda.synchronize()
            ref = ring_ops.ring_attention_reference(q.float(), k.float(), v.float(), valid,
                                                    seg, n)
            err = (out.float() - ref).abs()
            r = {"case": case, "dtype": dname, "n": n, "B": B, "L": L, "H": H, "D": D,
                 "max_abs_err": err.max().item(), "max_abs_out": ref.abs().max().item(),
                 "max_abs_err_valid": err[rows].max().item(),
                 "max_abs_out_valid": ref[rows].abs().max().item()}
            for key in ("", "_valid"):
                e, scale = r[f"max_abs_err{key}"], r[f"max_abs_out{key}"]
                check(math.isfinite(e) and e <= RING_REL_TOL[dname] * scale,
                      f"ring {case} n={n}/{dname} max abs err{key} {e} > "
                      f"{RING_REL_TOL[dname]} x {scale}")
            msg = ""
            if dname == "bf16":
                mask = _attn_mask(valid, seg)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

                def kernel():
                    return ring_ops.ring_fwd(q, k, v, valid, seg, n)

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

                r["ms"], r["sdpa_ms"] = cuda_time_ms(kernel), cuda_time_ms(sdpa)
                r["graph_ms"], r["sdpa_graph_ms"] = graph_time_ms(kernel), graph_time_ms(sdpa)
                msg = (f" | {r['graph_ms'] * 1e3:.1f} us on the device alone, "
                       f"{r['ms'] * 1e3:.1f} us by events (sdpa over the full L "
                       f"{r['sdpa_graph_ms'] * 1e3:.1f} / {r['sdpa_ms'] * 1e3:.1f} us: "
                       f"{r['graph_ms'] / r['sdpa_graph_ms']:.2f}x)")
                del mask, qt, kt, vt
            if dname == "bf16":
                r["bounds"] = _ring_bounds(valid, seg, n, H, D, q.element_size())
                r["bound_ms"] = r["bounds"]["function"]["bound_ms"]
                r["bound_by"] = r["bounds"]["function"]["bound_by"]
                msg += (f" (bound {r['bound_ms'] * 1e3:.1f} us by {r['bound_by']}, with the "
                        f"ring's traffic {r['bounds']['ring']['bound_ms'] * 1e3:.1f} us by "
                        f"{r['bounds']['ring']['bound_by']})")
            if timed and dname == "bf16":
                r["plain_ms"] = cuda_time_ms(lambda: ring_ops.ring_attention_reference(
                    q, k, v, valid, seg, n), iters=3, warmup=1)
                r["flash_full_ms"] = graph_time_ms(
                    lambda: attn_ops.flash_forward(q, k, v, valid, seg))
                msg += (f" (plain ring {r['plain_ms'] * 1e3:.1f} us, flash_fwd over the full L "
                        f"{r['flash_full_ms'] * 1e3:.1f} us on the device alone)")
            results.append(r)
            print(f"[ring] ring_fwd {case:12s} {dname} n={n} B={B} L={L}: max abs err "
                  f"{r['max_abs_err']:.3e} (max |out| {r['max_abs_out']:.2f}), valid rows "
                  f"{r['max_abs_err_valid']:.3e}{msg}", flush=True)
            del q, k, v, out, ref, err
    del qkv32
    torch.cuda.empty_cache()
    return results


def check_fwd_k_labels(valid, seg, H, D, generator):
    """The flash forward with the keys labelled apart from the queries (a
    ring hop's call) against the plain version, bf16 and f32."""
    import torch

    from merlot_reserve_tpu_torch.ops.attention import flash_attention_reference, flash_forward

    B, L = valid.shape
    g = torch.Generator(device="cpu").manual_seed(4)
    k_valid = (torch.rand((B, L), generator=g) > 0.2).to(torch.int32).to(valid.device)
    k_seg = (torch.arange(L, device=valid.device) >= L // 3).to(torch.int32)[None].expand(B, L)
    k_valid[0] = 0  # batch row 0 sees no key
    results = []
    with torch.inference_mode():
        qkv32 = torch.randn((3, B, L, H, D), generator=generator, device=valid.device)
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q, k, v = qkv32.to(dtype).unbind(0)
            out, _ = flash_forward(q, k, v, valid, seg, k_is_valid=k_valid,
                                   k_segment_ids=k_seg.contiguous())
            ref, _ = flash_attention_reference(q.float(), k.float(), v.float(), valid, seg,
                                               k_valid, k_seg)
            err = (out.float() - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            check(math.isfinite(err) and err <= TOL[dname]["out"] * scale,
                  f"flash_fwd with key labels/{dname} out max abs {err} > "
                  f"{TOL[dname]['out']} x {scale}")
            results.append({"dtype": dname, "B": B, "L": L, "max_abs_err_out": err,
                            "max_abs_out": scale})
            print(f"[ring] flash_fwd with key labels {dname} B={B} L={L}: out err {err:.3e}",
                  flush=True)
    return results


def phase_ring_kernels(seed):
    """The ring kernel's cases, the flash forward with key labels, and the
    flash forward at the long-video shape (B 8, L 2560) in bf16."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    ring = []
    for case, n, B, L in RING_CASES:
        valid, seg = _ring_labels(case, B, L, "cuda")
        ring += check_ring(case, n, valid, seg, 12, 64, g, timed=case == "long_video")
    k_labels = check_fwd_k_labels(*_ring_labels("packed", 8, 640, "cuda"), 12, 64, g)
    long_fwd = check_fwd("long_video", *_ring_labels("long_video", 8, 2560, "cuda"), 12, 64, g,
                         dtypes=("bf16",))
    return ring, k_labels, long_fwd


def _worst_one_minus_cos(a, b, rows):
    """max over the rows ``rows`` (bool [N, L]) of 1 - cos(a, b), [N, L, H]."""
    import numpy as np

    a, b = a[rows].astype(np.float64), b[rows].astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return float((1 - cos).max())


def phase_slice_sp(card):
    """Long videos through the ring: base widths, ``joint_attention_impl=
    "ring:rdma"``, 4 virtual sp ranks on the card, through the service and
    through ``DynamicBatcher`` under the caller's mesh. Returns the record and,
    for the first long batch and the entry batch, the ring path's and the
    flash path's embeddings and the valid rows (phase 22 holds its own
    against them)."""
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
    from merlot_reserve_tpu_torch.serving import DynamicBatcher, VideoEmbedService
    from merlot_reserve_tpu_torch.tokenizer import PADDING

    cfg = load_config("base", joint_attention_impl="ring:rdma", seq_shard_axis="sp")
    model = MerlotReserve(cfg, device="cuda", seed=0)
    service = VideoEmbedService(model, batch_size=8, device="cuda")
    flash_model = MerlotReserve(load_config("base", joint_attention_impl="flash"),
                                device="cuda", seed=0)
    flash_model.load_state_dict(model.state_dict())
    flash_service = VideoEmbedService(flash_model, batch_size=8, device="cuda")
    joint_layers = cfg.model.joint_num_layers
    long_reqs = [make_requests(cfg, 8, 20 + i, n_seg=LONG_SEGMENTS) for i in range(LONG_BATCHES)]
    entry_reqs = make_requests(cfg, 8, 30)
    joint_len = 160 + LONG_SEGMENTS * cfg.model.vit_pooled_seq_len
    print(f"[sp] base model, joint_attention_impl={cfg.model.joint_attention_impl!r}, "
          f"seq_shard_axis={cfg.model.seq_shard_axis!r}; {LONG_BATCHES} batches of 8 videos of "
          f"{LONG_SEGMENTS} segments (joint L {joint_len}) at sp=4, one batch of the entry's "
          f"8-segment videos (L 640) at sp=2", flush=True)

    # the sequence-parallel serving path, counted, once per mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    with activate_mesh(make_mesh(sp=4)):
        long_outs = [service.embed(r) for r in long_reqs]
    torch.cuda.synchronize()
    launches_long = dict(kernels.LAUNCHES)
    peak_long = torch.cuda.max_memory_allocated()
    kernels.LAUNCHES.clear()
    with activate_mesh(make_mesh(sp=2)):
        entry_out = service.embed(entry_reqs)
    torch.cuda.synchronize()
    launches_entry = dict(kernels.LAUNCHES)
    print(f"[sp] kernel launches: long videos at sp=4 {launches_long}; entry videos at sp=2 "
          f"{launches_entry}; peak memory {peak_long / 2**30:.2f} GiB", flush=True)
    for launches, batches in ((launches_long, LONG_BATCHES), (launches_entry, 1)):
        check(launches.get("ring_fwd", 0) == joint_layers * batches,
              f"ring_fwd launches {launches.get('ring_fwd', 0)} != {joint_layers} x {batches}")
        check(launches.get("flash_fwd", 0) == 0, "the joint tower launched flash_fwd under a ring")
    for o in long_outs + [entry_out]:
        check(o.shape == (8, 160, cfg.model.hidden_size), f"output shape {o.shape}")
        check(np.isfinite(o).all(), "non-finite embeddings")
        check(np.abs(np.linalg.norm(o, axis=-1) - 1).max() < 1e-2, "row norms off 1")

    # agreement on valid rows with the flash path (same weights, no mesh).
    # The limit comes from the spread of the plain bf16 path against itself:
    # the ring model with the plain ring in place of the kernel against the
    # flash model with the plain flash attention, s (one attention in f32,
    # summed in two orders, in a model that rounds to bf16 around it). The
    # kernel paths may sit twice that angle apart: 1 - cos <= 4 s
    agreement, arrays = {}, {}
    for name, reqs, sp, kernel_out in (("long", long_reqs[0], 4, long_outs[0]),
                                       ("entry", entry_reqs, 2, entry_out)):
        rows = np.stack([np.asarray(r["tokens"]) != PADDING for r in reqs])
        flash_out = flash_service.embed(reqs)
        with _plain_attention():
            plain_out = flash_service.embed(reqs)
        with activate_mesh(make_mesh(sp=sp)), \
                mock.patch.object(ring_ops, "ring_fwd", ring_ops.ring_attention_reference):
            plain_ring_out = service.embed(reqs)
        a = {"ring_vs_flash": _worst_one_minus_cos(kernel_out, flash_out, rows),
             "flash_vs_plain": _worst_one_minus_cos(flash_out, plain_out, rows),
             "ring_vs_plain": _worst_one_minus_cos(kernel_out, plain_out, rows),
             "plain_ring_vs_plain": _worst_one_minus_cos(plain_ring_out, plain_out, rows),
             "max_abs_diff_ring_vs_flash": float(np.abs(kernel_out - flash_out)[rows].max())}
        a["limit"] = 4 * a["plain_ring_vs_plain"]
        agreement[name] = a
        arrays[name] = {"ring": kernel_out, "flash": flash_out, "rows": rows}
        print(f"[sp] {name}: worst valid-row 1 - cos: ring kernel vs flash kernel path "
              f"{a['ring_vs_flash']:.3e} (limit 4 x {a['plain_ring_vs_plain']:.3e}, the plain "
              f"ring path vs the plain flash path); ring kernel vs plain flash "
              f"{a['ring_vs_plain']:.3e}; flash kernel vs plain flash "
              f"{a['flash_vs_plain']:.3e}; max abs diff ring vs flash "
              f"{a['max_abs_diff_ring_vs_flash']:.3e}", flush=True)
        check(a["ring_vs_flash"] <= a["limit"],
              f"{name}: ring vs flash path 1 - cos {a['ring_vs_flash']} > {a['limit']}")

    # the first long batch again, through DynamicBatcher under the caller's
    # mesh: its dispatcher thread runs the batch in the submitter's context,
    # so the joint tower goes through the ring kernel there too
    kernels.LAUNCHES.clear()
    with activate_mesh(make_mesh(sp=4)):
        with DynamicBatcher(service, max_wait_ms=1000.0) as batcher:
            futures = [batcher.submit(vp) for vp in long_reqs[0]]
            batched = np.stack([f.result(timeout=600) for f in futures])
    torch.cuda.synchronize()
    launches_batcher = dict(kernels.LAUNCHES)
    fills = list(batcher.batch_fills)
    rows = np.stack([np.asarray(r["tokens"]) != PADDING for r in long_reqs[0]])
    batcher_res = {"batch_fills": fills, "launches": launches_batcher,
                   "vs_service": _worst_one_minus_cos(batched, long_outs[0], rows),
                   "same_bits_as_service": bool(np.array_equal(batched, long_outs[0])),
                   "limit": agreement["long"]["limit"]}
    print(f"[sp] 8 long videos through DynamicBatcher under make_mesh(sp=4): batches "
          f"{fills}, launches {launches_batcher}; worst valid-row 1 - cos against the "
          f"service's own answer {batcher_res['vs_service']:.3e} (bit for bit: "
          f"{batcher_res['same_bits_as_service']})", flush=True)
    check(launches_batcher.get("ring_fwd", 0) == joint_layers * len(fills),
          f"the batcher under a mesh: ring_fwd launches {launches_batcher.get('ring_fwd', 0)} "
          f"!= {joint_layers} x {len(fills)} batches")
    check(launches_batcher.get("flash_fwd", 0) == 0,
          "the batcher under a mesh: the joint tower launched flash_fwd")
    check(batcher_res["vs_service"] <= batcher_res["limit"],
          f"the batcher under a mesh: 1 - cos {batcher_res['vs_service']} against the service "
          f"> {batcher_res['limit']}")

    # service time per batch, ring:rdma at sp=4 against flash without a mesh
    times = {}
    for name, svc, mesh in (("ring_rdma_sp4", service, make_mesh(sp=4)),
                            ("flash", flash_service, None)):
        runs = []
        for reqs in long_reqs + long_reqs:
            with activate_mesh(mesh) if mesh is not None else contextlib.nullcontext():
                t = time.perf_counter()
                svc.embed(reqs)
                runs.append((time.perf_counter() - t) * 1e3)
        times[name] = {"service_ms_runs": runs, "service_ms_median": float(np.median(runs))}
        with torch.inference_mode(), (activate_mesh(mesh) if mesh is not None
                                      else contextlib.nullcontext()):
            images, audio, tokens, subseg = stack_requests(long_reqs[0], "cuda")
            times[name]["device_ms"] = cuda_time_ms(
                lambda: svc.model.batch_embed_video(images, audio, tokens, subseg),
                iters=3, warmup=1)
        del images, audio, tokens, subseg
    for name, t in times.items():
        print(f"[sp] {card}: {name}: {t['service_ms_median']:.2f} ms per batch of 8 long "
              f"videos through the service (median of {len(t['service_ms_runs'])}), "
              f"{t['device_ms']:.2f} ms on the device clock", flush=True)
    res = {"joint_len": joint_len, "segments_per_video": LONG_SEGMENTS,
           "batches": LONG_BATCHES, "launches_long_sp4": launches_long,
           "launches_entry_sp2": launches_entry, "max_memory_allocated_bytes": peak_long,
           "agreement": agreement, "batcher": batcher_res, "times": times}
    del model, flash_model, service, flash_service
    torch.cuda.empty_cache()
    return res, arrays


def _oracle_log_mel(y):
    """f64 log-mel of one 5-second clip: scipy's hann, numpy's FFT, the
    port's slaney filters."""
    import numpy as np
    import scipy.signal

    from merlot_reserve_tpu_torch.ops.audio import mel_filterbank

    n_fft, hop = 1536, 588
    ypad = np.pad(y.astype(np.float64), n_fft // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(ypad, n_fft)[::hop]
    power = np.abs(np.fft.rfft(frames * scipy.signal.windows.hann(n_fft), axis=-1)) ** 2
    mel = power @ mel_filterbank(22050, n_fft, 64, 20.0, 11025.0).astype(np.float64)
    log_mel = np.log(mel + 0.1) - np.log(0.1)
    return np.stack([log_mel[s:s + 60] for s in (2, 64, 126)])


def _front_end_on_card(cases, pcm, grid, tf32):
    """The front end on the card with the global TF32 flags set to ``tf32``
    (legacy API, as phase_kernels sets them); checks they are left so."""
    import torch

    from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram
    from merlot_reserve_tpu_torch.ops.vision import batch_preprocess_images

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    out = {name: batch_preprocess_images(x, grid, device="cuda") for name, x in cases.items()}
    out["log_mel"] = batch_make_spectrogram(pcm, device="cuda")
    torch.cuda.synchronize()
    check(torch.backends.cuda.matmul.allow_tf32 == tf32, "the front end changed the TF32 flag")
    return out


def phase_raw_media(card, seed):
    """Raw frames and PCM to embeddings and zero-shot answers on the card."""
    import numpy as np
    import torch

    import bench_torch
    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch import preprocess, zero_shot
    from merlot_reserve_tpu_torch.models import MerlotReserve, PretrainedMerlotReserve
    from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram
    from merlot_reserve_tpu_torch.ops.vision import batch_preprocess_images

    cfg = load_config("base")
    grid = tuple(cfg.model.output_grid)
    rng = np.random.RandomState(0)
    frames, pcm, tokens, subseg = bench_torch.raw_inputs(rng)
    flat_pcm = pcm.reshape(-1, pcm.shape[-1])
    cases = {"bench 180x320": frames.reshape(-1, *frames.shape[2:]),
             "downscale 360x640": rng.randint(0, 256, (4, 360, 640, 3), dtype=np.uint8),
             "upscale 100x150": rng.randint(0, 256, (4, 100, 150, 3), dtype=np.uint8)}

    # 1. the front end: card against CPU and the f64 oracle, TF32 off and on
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    t0 = time.perf_counter()
    card = _front_end_on_card(cases, flat_pcm, grid, tf32=False)
    card_tf32 = _front_end_on_card(cases, flat_pcm, grid, tf32=True)
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    torch.backends.cudnn.allow_tf32 = tf32_before
    front = {}
    for name in card:
        check(torch.equal(card[name], card_tf32[name]),
              f"front end {name} changes with the global TF32 flags")
        if name == "log_mel":
            cpu = batch_make_spectrogram(flat_pcm, device="cpu").numpy()
            tol = FRONT_LOGMEL_TOL
        else:
            cpu = batch_preprocess_images(cases[name], grid, device="cpu").numpy()
            tol = FRONT_PATCH_TOL
        err = float(np.abs(card[name].cpu().numpy() - cpu).max())
        front[name] = {"shape": list(card[name].shape), "max_abs_err_vs_cpu": err}
        check(err <= tol, f"front end {name}: card vs CPU {err} > {tol}")
    oracle_clips = range(0, len(flat_pcm), 9)
    log_mel = card["log_mel"].cpu().numpy()
    for i in oracle_clips:
        ref = _oracle_log_mel(flat_pcm[i])
        check(np.allclose(log_mel[i, ..., :64], ref, rtol=ORACLE_RTOL, atol=ORACLE_ATOL),
              f"log-mel of clip {i} vs the f64 oracle: max |err| "
              f"{np.abs(log_mel[i, ..., :64] - ref).max()}")
    front["log_mel"]["max_abs_err_vs_oracle"] = max(
        float(np.abs(log_mel[i, ..., :64] - _oracle_log_mel(flat_pcm[i])).max())
        for i in oracle_clips)
    print(f"[raw] front end on the card vs the CPU (TF32 on and off alike): "
          + ", ".join(f"{k} {v['max_abs_err_vs_cpu']:.2e}" for k, v in front.items())
          + f"; log-mel vs f64 oracle {front['log_mel']['max_abs_err_vs_oracle']:.2e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 2. embeddings from raw media = batch_embed_video on the front end's output
    model = MerlotReserve(cfg, device="cuda", seed=seed).eval()
    with torch.inference_mode():
        frames_t, pcm_t = torch.from_numpy(frames).cuda(), torch.from_numpy(pcm).cuda()
        tokens_t, subseg_t = torch.from_numpy(tokens).cuda().long(), torch.from_numpy(subseg).cuda().long()
        from_raw = model.batch_embed_video(*bench_torch.front_end(frames_t, pcm_t, grid, "cuda"),
                                           tokens_t, subseg_t)
        patches = card["bench 180x320"].reshape(*frames.shape[:2], -1, 768)
        direct = model.batch_embed_video(patches, card["log_mel"].reshape(
            frames.shape[0], -1, 60, 65), tokens_t, subseg_t)
    check(torch.equal(from_raw, direct), "embeddings from raw media differ from "
          "batch_embed_video on the front end's output")
    norms = from_raw.float().norm(dim=-1)
    check(bool(torch.isfinite(from_raw).all()) and float((norms - 1).abs().max()) < 1e-2,
          "raw-media embeddings are not finite unit rows")

    # 3. the zero-shot path, counted: raw video -> options ranked
    video_frames = [frames[0], np.ascontiguousarray(frames[1, ::-1])]
    waveforms = [pcm[0].reshape(-1), pcm[1].reshape(-1)]
    times = [{"start_time": 5.0 * i, "end_time": 5.0 * (i + 1), "mid_time": 5.0 * i + 2.5}
             for i in range(frames.shape[1])]
    prompts = ["the person is <|MASK|> right now", "<|MASK|> is what happens next"]
    pre = PretrainedMerlotReserve(model)
    span_layers, joint_layers = cfg.model.span_num_layers, cfg.model.joint_num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernels.LAUNCHES.clear()
    with _recorded_labels() as path_labels:
        video_pres = []
        for vf, wav, prompt in zip(video_frames, waveforms, prompts):
            segs = preprocess.segments_from_arrays(vf, wav, times, device="cuda")
            for s in segs[:-1]:
                s["use_text_as_input"] = False
            segs[-1]["text"] = prompt
            video_pres.append(preprocess.preprocess_video(segs, grid, device="cuda"))
        probs = zero_shot.rank_options(pre, video_pres[0], ZERO_SHOT_OPTIONS)
        feats = zero_shot.extract_mask_features(pre, video_pres)
        logits = zero_shot.score_label_space(pre, feats, ZERO_SHOT_OPTIONS)
        torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = 2 * (joint_layers + span_layers)  # rank_options, then features + scores
    print(f"[raw] zero-shot path: 2 raw videos -> preprocess_video -> rank_options, "
          f"extract_mask_features, score_label_space in {path_s:.2f} s; launches {launches}",
          flush=True)
    check(launches.get("flash_fwd", 0) == want,
          f"zero-shot path flash_fwd launches {launches.get('flash_fwd', 0)} != {want}")
    check(probs.shape == (1, len(ZERO_SHOT_OPTIONS)) and np.isfinite(probs).all()
          and abs(float(probs.sum()) - 1) < 1e-5, f"option probabilities {probs}")
    check(logits.shape == (2, len(ZERO_SHOT_OPTIONS)) and np.isfinite(logits).all(),
          f"label-space logits {logits}")
    kernels.LAUNCHES.clear()
    label_space = pre.get_label_space(list(ZERO_SHOT_OPTIONS))
    per_call = dict(kernels.LAUNCHES)
    check(per_call.get("flash_fwd", 0) == span_layers,
          f"one label-space call launched flash_fwd {per_call.get('flash_fwd', 0)} times, "
          f"not {span_layers}")

    # the same weights with every attention dense
    xla_model = MerlotReserve(load_config("base", attention_impl="xla", joint_attention_impl="xla"),
                              device="cuda", seed=seed + 1).eval()
    xla_model.load_state_dict(model.state_dict())
    xla_pre = PretrainedMerlotReserve(xla_model)
    kernels.LAUNCHES.clear()
    xla_label_space = xla_pre.get_label_space(list(ZERO_SHOT_OPTIONS))
    xla_probs = zero_shot.rank_options(xla_pre, video_pres[0], ZERO_SHOT_OPTIONS)
    xla_feats = zero_shot.extract_mask_features(xla_pre, video_pres)
    check(not kernels.LAUNCHES, f"the xla path launched kernels {dict(kernels.LAUNCHES)}")

    agreement = {"label_space_min_cos": _min_row_cos(label_space.float().cpu(),
                                                    xla_label_space.float().cpu()),
                 "mask_features_min_cos": _min_row_cos(feats, xla_feats),
                 "probs_max_abs_diff": float(np.abs(probs - xla_probs).max())}
    print(f"[raw] kernel path vs xla path on the same weights: {agreement}", flush=True)
    check(agreement["label_space_min_cos"] >= ZERO_SHOT_MIN_COSINE
          and agreement["mask_features_min_cos"] >= ZERO_SHOT_MIN_COSINE,
          f"kernel vs xla zero-shot cosine below {ZERO_SHOT_MIN_COSINE}: {agreement}")
    check(agreement["probs_max_abs_diff"] <= ZERO_SHOT_PROBS_TOL,
          f"kernel vs xla option probabilities more than {ZERO_SHOT_PROBS_TOL} apart: "
          f"{agreement}")
    del xla_model, xla_pre, model, pre

    # the kernel at each shape and with the labels this path gave it (the
    # span tower at options x 16, the joint tower at 1 and 2 videos x 640:
    # fewer work items than the card has SMs), against its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    path_fwd = []
    for (B, L), (valid, seg) in sorted(path_labels.items()):
        path_fwd += check_fwd("zero_shot_span" if L == 16 else "zero_shot_joint", valid, seg,
                              cfg.model.num_heads, cfg.model.size_per_head, g, dtypes=("bf16",))
    check(sorted(path_labels) == [(1, 640), (2, 640), (len(ZERO_SHOT_OPTIONS), 16)],
          f"zero-shot path attention shapes {sorted(path_labels)}")
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    torch.backends.cudnn.allow_tf32 = tf32_before

    # 4. the bench
    torch.cuda.empty_cache()
    bench = bench_torch.measure(seed=seed)
    print(json.dumps(bench), flush=True)
    check(bench["value"] > 0 and bench["mfu"] is not None, f"bench record {bench}")
    return {"front_end": front, "launches": launches, "launches_per_label_space": per_call,
            "probs": probs.tolist(), "xla_probs": xla_probs.tolist(),
            "agreement": agreement, "zero_shot_path_s": path_s, "fwd_kernels": path_fwd,
            "bench": bench}


# long-video training (phase 10): the soak_longvideo recipe at full base
# widths, batch LONG_TRAIN_BATCH (the recipe's batch 1 was set for a 16 GB
# chip), with warmup 1 and lr 1e-5 as phase 5; ring:flash over
# LONG_TRAIN_SP virtual ranks against flash without a mesh
LONG_TRAIN_BATCH = 4
LONG_TRAIN_STEPS = 3
LONG_TRAIN_SP = 4
LONG_JOINT_LEN = 2560  # the recipe's seq_len: the joint rows' length
# (name, rank whose queries, shard whose keys) of the hop-shape kernel cases:
# hop 1 of ranks 0 and 1 (the shard from the left neighbour)
HOP_CASES = (("hop r0 k3", 0, 3), ("hop r1 k0", 1, 0))
# remat against no remat on the card: the same ops, but dq's atomics add in
# an order that changes from run to run, so the remat gradient is held to
# the spread of two gradients without remat: 1 - cos (whole and per tower)
# at most REMAT_SPREAD_FACTOR times the spread's, plus REMAT_SPREAD_FLOOR for
# the parts that the atomics do not reach (a zero spread). The forward has
# no atomics: the losses within the spread plus REMAT_LOSS_FLOOR, two f32
# ulps at a loss near 5 (should cuBLAS pick another algorithm for a copy)
REMAT_SPREAD_FACTOR = 4
REMAT_SPREAD_FLOOR = 1e-9
REMAT_LOSS_FLOOR = 1e-6


def _long_train_config(ring, **model):
    import dataclasses as dc

    from merlot_reserve_tpu_torch import load_config

    if ring:
        model = dict(joint_attention_impl="ring:flash", seq_shard_axis="sp",
                     segment_shard_axis="sp", **model)
    cfg = load_config("soak_longvideo", **model)
    return dc.replace(cfg, optimizer=dc.replace(cfg.optimizer, num_warmup_steps=1,
                                                learning_rate=1e-5))


def _expected_long_launches(cfg, n):
    """(flash_fwd, each backward launch) per training step, from the config:
    a joint layer attends once (flash) or n x n times (one launch per rank
    and hop of ring:flash) in the forward, as often again in its recompute
    under gradient_checkpoint, and once per forward launch in the backward;
    a span layer (the span tower's attention is flash on the card; the
    vision and audio towers' is dense) once, again under
    tower_gradient_checkpoint. ring_fwd never: ring:rdma is forward-only."""
    m = cfg.model
    per_joint = n * n if m.joint_attention_impl == "ring:flash" else 1
    fwd = (m.joint_num_layers * per_joint * (2 if m.gradient_checkpoint else 1)
           + m.span_num_layers * (2 if m.tower_gradient_checkpoint else 1))
    return fwd, m.joint_num_layers * per_joint + m.span_num_layers


def phase_train_long(card):
    """Long-video pretraining: the soak_longvideo recipe under ring:flash at
    sp 4 (arm a) and flash without a mesh (arm b), both with both remat
    knobs, and one step at batch 1 with the knobs off and on (arm c)."""
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.training.trainer import (create_train_state, loss_and_grads,
                                                          train_step)

    cfgs = {"ring_flash_sp4": _long_train_config(True), "flash": _long_train_config(False)}
    meshes = {"ring_flash_sp4": make_mesh(sp=LONG_TRAIN_SP), "flash": None}
    cfg = cfgs["ring_flash_sp4"]
    m, d = cfg.model, cfg.data
    batch = make_dummy_batch(cfg, LONG_TRAIN_BATCH, seed=0)
    print(f"[long] soak_longvideo, hidden {m.hidden_size}, {m.joint_num_layers}/"
          f"{m.vit_num_layers}/{m.audio_num_layers}/{m.span_num_layers} joint/vision/audio/span "
          f"layers, gradient_checkpoint {m.gradient_checkpoint}, tower_gradient_checkpoint "
          f"{m.tower_gradient_checkpoint}; batch {LONG_TRAIN_BATCH}, {d.num_segments} segments "
          f"in {d.num_segment_groups} groups, seq_len {d.seq_len}, "
          f"{d.num_text_spans_to_include} spans drawn per example; arms "
          f"{ {k: c.model.joint_attention_impl for k, c in cfgs.items()} }, sp {LONG_TRAIN_SP}",
          flush=True)
    expected = _expected_init_losses(cfg, LONG_TRAIN_BATCH)
    arms = {}
    for name, arm_cfg in cfgs.items():
        logged, stamps = [], []

        def log_fn(step, metrics, logged=logged, stamps=stamps):
            stamps.append(time.perf_counter())  # metrics are floats: the step has ended
            logged.append(metrics)

        # the training path, counted: every launch between the reset and the read
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = run_pretraining(arm_cfg, itertools.repeat(batch), num_steps=LONG_TRAIN_STEPS,
                                log_fn=log_fn, log_every=0, device="cuda", seed=0,
                                mesh=meshes[name])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
        totals = [m_["total"] for m_ in logged]
        fwd, bwd = _expected_long_launches(arm_cfg, LONG_TRAIN_SP if meshes[name] else 1)
        print(f"[long] {name}: {LONG_TRAIN_STEPS} steps, kernel launches {launches} (expected "
              f"per step: flash_fwd {fwd}, each backward launch {bwd}); total loss per step "
              f"{[round(t, 5) for t in totals]}", flush=True)
        check(launches.get("flash_fwd", 0) == fwd * LONG_TRAIN_STEPS,
              f"{name}: flash_fwd launches {launches.get('flash_fwd', 0)} != {fwd} x "
              f"{LONG_TRAIN_STEPS} steps")
        for launch in BWD_LAUNCHES:
            check(launches.get(launch, 0) == bwd * LONG_TRAIN_STEPS,
                  f"{name}: {launch} launches {launches.get(launch, 0)} != {bwd} x "
                  f"{LONG_TRAIN_STEPS} steps")
        for launch in (*BWD_LAUNCHES_F32, "ring_fwd"):
            check(launches.get(launch, 0) == 0, f"{name}: the bf16 step launched {launch}")
        check(all(math.isfinite(v) for m_ in logged for v in m_.values()),
              f"{name}: non-finite loss")
        for head, ln_n in expected.items():
            check(abs(logged[0][head] - ln_n) < 0.05,
                  f"{name}: step-0 {head} loss {logged[0][head]} is not near ln N = {ln_n}")
        check(abs(totals[1] - totals[0]) <= 1e-4,
              f"{name}: the first update (lr scale 0) changed the loss")
        check(totals[-1] < totals[1], f"{name}: loss did not fall on the repeated batch: {totals}")

        # the step on the device clock, on a batch already on the card
        dev_batch = batch_to_tensors(batch, "cuda")
        with activate_mesh(meshes[name]):
            device_ms = cuda_time_ms(lambda: train_step(state, dev_batch), iters=2, warmup=1)
        host_med = float(np.median(step_ms[1:]))
        arms[name] = {"launches": launches, "expected_per_step": {"flash_fwd": fwd,
                                                                   "backward_each": bwd},
                      "losses": logged, "step_ms_host": step_ms, "step_ms_host_median": host_med,
                      "step_ms_device": device_ms,
                      "examples_per_s": LONG_TRAIN_BATCH / host_med * 1e3,
                      "device_examples_per_s": LONG_TRAIN_BATCH / device_ms * 1e3,
                      "max_memory_allocated_bytes": peak}
        print(f"[long] {card}: {name}: {host_med:.1f} ms per step on the host clock (median "
              f"of steps 2-{LONG_TRAIN_STEPS}), {device_ms:.1f} ms on the device clock; "
              f"{arms[name]['examples_per_s']:.3f} examples/s; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del state, dev_batch
        torch.cuda.empty_cache()

    # (a) against (b) at step 0: the same weights, batch and draws; the
    # spread of (b) against itself (dq's atomics) printed beside
    dev_batch = batch_to_tensors(batch, "cuda")
    models = {name: MerlotReservePretrainer(c, device="cuda", seed=0) for name, c in cfgs.items()}
    g = torch.Generator(device="cuda").manual_seed(5)
    spg, rows = d.num_segments_per_group, LONG_TRAIN_BATCH * d.num_segment_groups
    split_at = [models["flash"].draw_split_at(rows, spg, g) for _ in range(2)]
    u = torch.rand((LONG_TRAIN_BATCH, batch["text_spans"].shape[1]), generator=g, device="cuda")
    gumbel = -torch.log(-torch.log(u))
    runs = {}
    for run, name in (("ring_flash_sp4", "ring_flash_sp4"), ("flash", "flash"),
                      ("flash_again", "flash")):
        with contextlib.ExitStack() as stack:
            vision_out = stack.enter_context(_vision_output_grads(models[name]))
            stack.enter_context(activate_mesh(meshes[name]))
            info, grads = loss_and_grads(models[name], dev_batch, use_bfloat16_grads=True,
                                         split_at=split_at, gumbel=gumbel)
        runs[run] = (info, grads, vision_out)
    labels = _capture_labels(models["flash"], dev_batch)
    del models

    def compare(a, b, runs):
        return _compare_paths(runs[a], runs[b], f"[long] {a} vs {b}")

    agreement = {"ring_flash_sp4 vs flash": compare("ring_flash_sp4", "flash", runs),
                 "flash vs flash_again": compare("flash", "flash_again", runs)}
    del runs
    ring = agreement["ring_flash_sp4 vs flash"]
    for k in ("imgs_to_audio", "text_to_audio", "stuff_to_span", "total"):
        check(ring["loss_diff"][k] <= TRAIN_LOSS_TOL,
              f"{k} ring:flash vs flash {ring['loss_diff'][k]} > {TRAIN_LOSS_TOL}")
    check(ring["whole"] >= TRAIN_MIN_COSINE,
          f"ring:flash vs flash whole-gradient cosine {ring['whole']} below {TRAIN_MIN_COSINE}")
    low = ring["lowest_held_outside_vision"]
    check(low[1] >= TRAIN_MIN_TENSOR_COSINE,
          f"ring:flash vs flash gradient cosine of {low[0]} {low[1]} below "
          f"{TRAIN_MIN_TENSOR_COSINE}")
    pooled = ring["vision_outputs"]["seq_attnpool"]
    check(pooled >= TRAIN_MIN_VISION_INPUT_COSINE,
          f"ring:flash vs flash gradient cosine at the vision tower's pooled tokens {pooled} "
          f"below {TRAIN_MIN_VISION_INPUT_COSINE}")
    torch.cuda.empty_cache()

    # (c) one ring:flash step at batch 1 with both remat knobs off and on:
    # the peak memory of each; then the remat gradient against the spread
    # of two gradients without remat (dq's atomics: two identical steps
    # differ on the card; the forward has no atomics, so the losses agree)
    batch1 = batch_to_tensors(make_dummy_batch(cfg, 1, seed=0), "cuda")
    split1 = [draw[:d.num_segment_groups] for draw in split_at]
    gumbel1 = gumbel[:1]
    memory, models, runs = {}, {}, {}
    for remat in (False, True):
        c = _long_train_config(True, gradient_checkpoint=remat, tower_gradient_checkpoint=remat)
        state = create_train_state(c, MerlotReservePretrainer(c, device="cuda", seed=0))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with activate_mesh(meshes["ring_flash_sp4"]):
            state, info = train_step(state, batch1)
        torch.cuda.synchronize()
        key = "remat_on" if remat else "remat_off"
        memory[key] = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                       "resident_bytes": resident, "total": float(info["total"])}
        check(math.isfinite(memory[key]["total"]), f"batch-1 step {key}: non-finite loss")
        # the first update has lr scale 0: the model still holds the seed's weights
        models[key] = state.model
        del state, info
        torch.cuda.empty_cache()
    for run, key in (("remat_off", "remat_off"), ("remat_off_again", "remat_off"),
                     ("remat_on", "remat_on")):
        with contextlib.ExitStack() as stack:
            vision_out = stack.enter_context(_vision_output_grads(models[key]))
            stack.enter_context(activate_mesh(meshes["ring_flash_sp4"]))
            run_info, grads = loss_and_grads(models[key], batch1, use_bfloat16_grads=True,
                                             split_at=split1, gumbel=gumbel1)
        runs[run] = (run_info, grads, vision_out)
    del models
    print(f"[long] {card}: one ring:flash step at batch 1: peak memory "
          f"{ {k: round(v['max_memory_allocated_bytes'] / 2**30, 2) for k, v in memory.items()} }"
          f" GiB (parameters and optimizer state "
          f"{memory['remat_on']['resident_bytes'] / 2**30:.2f} GiB of it)", flush=True)
    spread = compare("remat_off", "remat_off_again", runs)
    remat = compare("remat_on", "remat_off", runs)
    del runs
    agreement["remat_on vs remat_off (batch 1)"] = remat
    agreement["remat_off vs remat_off_again (batch 1)"] = spread
    for k in ("imgs_to_audio", "text_to_audio", "stuff_to_span", "total"):
        check(remat["loss_diff"][k] <= spread["loss_diff"][k] + REMAT_LOSS_FLOOR,
              f"{k}: remat vs no remat {remat['loss_diff'][k]} > the spread "
              f"{spread['loss_diff'][k]} + {REMAT_LOSS_FLOOR}")
    for part in ("whole", *remat["towers"]):
        got = 1 - (remat["whole"] if part == "whole" else remat["towers"][part])
        base = 1 - (spread["whole"] if part == "whole" else spread["towers"][part])
        check(got <= REMAT_SPREAD_FACTOR * base + REMAT_SPREAD_FLOOR,
              f"{part}: remat vs no remat 1 - cos {got} > {REMAT_SPREAD_FACTOR} x the spread "
              f"{base} + {REMAT_SPREAD_FLOOR}")
    return {"batch": LONG_TRAIN_BATCH, "steps": LONG_TRAIN_STEPS, "sp": LONG_TRAIN_SP,
            "expected_init_losses": expected, "arms": arms, "agreement": agreement,
            "batch1_memory": memory,
            "labels": {L: (v.shape[0], int((v > 0).sum()), int(s_.max()))
                       for L, (v, s_) in labels.items()}}, labels


def check_hop(case, valid, seg, rank, shard, n, H, D, generator):
    """One hop of the ring:flash training path at its own shape: the Lloc
    query rows of ``rank`` against the shard of ``shard`` with its own key
    labels, in bf16. The forward (``flash_forward`` with key labels) and the
    three-launch backward (with the rank's merged out and lse from outside,
    here the plain attention of its queries over the whole sequence, as the
    ring's merge gives them) against their plain versions, with their times
    on both clocks, bounds and SDPA over the same pair with the same mask.
    dO is random on valid rows and 0 on the others, as in the model."""
    import torch
    import torch.nn.functional as F

    from merlot_reserve_tpu_torch.ops import attention as attn_ops

    B, L = valid.shape
    lloc = L // n
    rows, keys = slice(rank * lloc, (rank + 1) * lloc), slice(shard * lloc, (shard + 1) * lloc)
    x = torch.randn((4, B, L, H, D), generator=generator, device=valid.device)
    q_all, k_all, v_all, do_all = x.to(torch.bfloat16).unbind(0)
    del x
    q, k, v = q_all[:, rows], k_all[:, keys], v_all[:, keys]  # strided, as the ring's shards
    q_valid, q_seg = valid[:, rows].contiguous(), seg[:, rows].contiguous()
    k_valid, k_seg = valid[:, keys].contiguous(), seg[:, keys].contiguous()
    do = (do_all[:, rows] * (q_valid > 0)[:, :, None, None]).contiguous()
    qf = q.float()
    with torch.no_grad():
        full_out, lse = attn_ops.flash_attention_reference(qf, k_all.float(), v_all.float(),
                                                           q_valid, q_seg, valid, seg)
    out = full_out.to(torch.bfloat16).contiguous()
    del full_out, q_all, do_all
    v_ = (q_valid > 0)[:, :, None] & (k_valid > 0)[:, None, :]
    attended = v_ & (q_seg[:, :, None] == k_seg[:, None, :])
    pairs = int(attended.sum())
    hop_blind = int((~attended.any(-1)).sum())  # rows that see no key of this shard
    padding = int((q_valid == 0).sum())  # lse -1e10: p = 1 on every key in the backward
    mask = attended[:, None]
    elem = 2
    side = B * lloc * H * D * elem
    fwd_bound_ms, fwd_by = _bound(2 * D * H * (2 * pairs + lloc * hop_blind),
                                  4 * side + 4 * B * lloc * 4 + B * H * lloc * 4, "bf16")
    bwd_ops = 2 * D * H * (pairs + 4 * (pairs + lloc * padding))
    bwd_bound_ms, bwd_by = _bound(bwd_ops, 7 * side + 2 * B * H * lloc * 4 + 4 * B * lloc * 4,
                                  "bf16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        # the forward
        hop_out, hop_lse = attn_ops.flash_forward(q, k, v, q_valid, q_seg, k_is_valid=k_valid,
                                                  k_segment_ids=k_seg)
        torch.cuda.synchronize()
        ref_out, ref_lse = attn_ops.flash_attention_reference(qf, k.float(), v.float(), q_valid,
                                                              q_seg, k_valid, k_seg)
        err_out = (hop_out.float() - ref_out).abs().max().item()
        scale = max(1.0, ref_out.abs().max().item())
        row_valid = (q_valid > 0)[:, None, :].expand(B, H, lloc)
        err_lse = (hop_lse - ref_lse).abs()[row_valid].max().item()
        check(math.isfinite(err_out) and err_out <= TOL["bf16"]["out"] * scale,
              f"{case} forward out max abs {err_out} > {TOL['bf16']['out']} x {scale}")
        check(math.isfinite(err_lse) and err_lse <= TOL["bf16"]["lse"],
              f"{case} forward lse max abs {err_lse} > {TOL['bf16']['lse']}")
        del hop_out, hop_lse, ref_out, ref_lse

        def fwd():
            return attn_ops.flash_forward(q, k, v, q_valid, q_seg, k_is_valid=k_valid,
                                          k_segment_ids=k_seg)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        fwd_rec = {"case": case, "dtype": "bf16", "B": B, "L": lloc, "rank": rank,
                   "shard": shard, "max_abs_err_out": err_out, "max_abs_out": scale,
                   "max_abs_err_lse_valid": err_lse, "ms": cuda_time_ms(fwd),
                   "graph_ms": graph_time_ms(fwd), "sdpa_ms": cuda_time_ms(sdpa),
                   "sdpa_graph_ms": graph_time_ms(sdpa),
                   "plain_ms": cuda_time_ms(lambda: attn_ops.flash_attention_reference(
                       q, k, v, q_valid, q_seg, k_valid, k_seg), iters=5),
                   "pairs": pairs, "rows_blind_in_hop": hop_blind, "bound_ms": fwd_bound_ms,
                   "bound_by": fwd_by}

        # the backward, against the merged out and lse
        grads = attn_ops.flash_backward(q, k, v, do, out, lse, q_valid, q_seg, k_valid, k_seg)
        torch.cuda.synchronize()
        ref = attn_ops.flash_attention_backward_reference(qf, k.float(), v.float(), do.float(),
                                                          out.float(), lse, q_valid, q_seg,
                                                          k_valid, k_seg)
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
            err = (a.float() - b).abs().max().item()
            ref_max = b.abs().max().item()
            errs[name] = {"max_abs_err": err, "max_abs_ref": ref_max,
                          "rel": err / max(ref_max, 1e-30)}
            check(math.isfinite(err) and err <= BWD_REL_TOL["bf16"] * ref_max,
                  f"{case} backward {name} max abs {err} > {BWD_REL_TOL['bf16']} x {ref_max}")
        del grads, ref
        stats, acc = attn_ops.flash_bwd_prep(q, k, v, do, out, lse, q_valid, q_seg)
        launch_ms = {
            "flash_bwd_prep": graph_time_ms(
                lambda: attn_ops.flash_bwd_prep(q, k, v, do, out, lse, q_valid, q_seg)),
            "flash_bwd": graph_time_ms(lambda: attn_ops.flash_bwd_fused(
                q, k, v, do, stats, acc, q_valid, q_seg, k_valid, k_seg)),
            "flash_bwd_convert": graph_time_ms(
                lambda: attn_ops.flash_bwd_convert(q, k, v, do, acc, q_valid, q_seg))}
        del stats, acc
        bwd_ms = cuda_time_ms(lambda: attn_ops.flash_backward(q, k, v, do, out, lse, q_valid,
                                                              q_seg, k_valid, k_seg))
        plain_ms = cuda_time_ms(lambda: attn_ops.flash_attention_backward_reference(
            q, k, v, do, out, lse, q_valid, q_seg, k_valid, k_seg), iters=3, warmup=1)
    qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    do_t = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do_t,
                                                           retain_graph=True))
    bwd_rec = {"case": case, "dtype": "bf16", "B": B, "L": lloc, "rank": rank, "shard": shard,
               "errors": errs, "ms": bwd_ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
               "sdpa_bwd_ms": sdpa_bwd_ms, "pairs": pairs, "padding_rows": padding,
               "bound_ms": bwd_bound_ms, "bound_by": bwd_by}
    print(f"[hop] {case} B={B} Lq=Lk={lloc}: forward out err {err_out:.3e} lse err "
          f"{err_lse:.3e} | {fwd_rec['graph_ms'] * 1e3:.1f} us on the device alone, "
          f"{fwd_rec['ms'] * 1e3:.1f} us by events (sdpa {fwd_rec['sdpa_graph_ms'] * 1e3:.1f} / "
          f"{fwd_rec['sdpa_ms'] * 1e3:.1f} us; bound {fwd_bound_ms * 1e3:.1f} us by {fwd_by}); "
          f"backward rel err dq {errs['dq']['rel']:.2e} dk {errs['dk']['rel']:.2e} dv "
          f"{errs['dv']['rel']:.2e} | {bwd_ms * 1e3:.1f} us by events, launches alone "
          f"{ {n_: round(t * 1e3, 1) for n_, t in launch_ms.items()} } us (bound "
          f"{bwd_bound_ms * 1e3:.1f} us by {bwd_by}); plain {plain_ms * 1e3:.1f} us, sdpa bwd "
          f"{sdpa_bwd_ms * 1e3:.1f} us", flush=True)
    del q, k, v, do, out, lse, qt, kt, vt, qg, kg, vg, o, do_t, k_all, v_all, mask
    torch.cuda.empty_cache()
    return fwd_rec, bwd_rec


def phase_hop_kernels(labels, seed):
    """The hop-shape cases (HOP_CASES) on the joint labels that the long-video
    step gave its joint attention."""
    import torch

    valid, seg = labels
    g = torch.Generator(device="cuda").manual_seed(seed)
    fwd, bwd = [], []
    for case, rank, shard in HOP_CASES:
        f, b = check_hop(case, valid, seg, rank, shard, LONG_TRAIN_SP, 12, 64, g)
        fwd.append(f)
        bwd.append(b)
    return fwd, bwd



# ---------------------------------------------------------------------------
# 12. the optimizer's update kernel
# ---------------------------------------------------------------------------

ADAM_UPDATES = 3
ADAM_TIMED = 10
# kernel vs plain loop after ADAM_UPDATES updates of the base model's
# parameters: the aim is the same bits; where the card's pow and the
# kernel's differ, at most 1 ulp of p and of the decoded nu is allowed
ADAM_MAX_ULPS = 1


def _monotone(bits):
    """f32 bit patterns (int32) as integers that count ulps across zero."""
    import torch

    bits = bits.long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _f32_diff(a, b):
    """(elements whose bits differ, the largest distance in ulps)."""
    import torch

    ia, ib = (x.contiguous().view(-1).view(torch.int32) for x in (a, b))
    differ = int((ia != ib).sum())
    return differ, int((_monotone(ia) - _monotone(ib)).abs().max()) if differ else 0


def _adam_chain_config(cfg, chain, moments="bf16"):
    """The chains as their callers set them: pretraining with no warmup (so
    the first updates move), finetuning as scripts/finetune_*.py set it
    (bias correction on, eps 1e-6); f32 moments are optax's scale_by_adam,
    bias correction on."""
    opt = dataclasses.replace(cfg.optimizer, num_warmup_steps=0, learning_rate=1e-3)
    if chain == "finetune":
        opt = dataclasses.replace(opt, do_bias_correction=True, eps=1e-6,
                                  num_train_steps=1000)
    if moments == "f32":
        opt = dataclasses.replace(opt, use_bfloat16_adam=False, do_bias_correction=True)
    return opt


# f32 Adam on a training path: the base step (phase 5's batch, warmup 1,
# lr 1e-5) with use_bfloat16_adam off, this many steps through run_pretraining
ADAM_F32_PATH_STEPS = 3


def _adam_grads(params, generator, update):
    """Seeded f32 gradients, their scale varied over tensors and updates
    (10^0 down to 10^-8) so that nu spans many binades, some exactly 0."""
    import torch

    grads = {}
    for i, (n, p) in enumerate(params.items()):
        g = torch.randn(p.shape, generator=generator, device=p.device)
        g.mul_(10.0 ** -((i + 3 * update) % 9))
        g.view(-1)[::97] = 0.0
        grads[n] = g
    return grads


def phase_adam(card, seed=6):
    """The update kernel against the plain loop on the base model's
    parameter set, for both chains; the exhaustive decode sweep; times."""
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.finetune.train import FINETUNE_DECAY_MIN_SIZE
    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
    from merlot_reserve_tpu_torch.training import optimization as topt
    from merlot_reserve_tpu_torch.training.trainer import weight_decay_names

    cfg = load_config("base")
    model = MerlotReservePretrainer(cfg, device="cuda", seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    decay = {"pretrain": set(weight_decay_names(model)),
             "finetune": set(weight_decay_names(model, FINETUNE_DECAY_MIN_SIZE))}
    del model
    numel = sum(p.numel() for p in start.values())
    out = {"parameters": numel, "tensors": len(start), "chains": {}}
    print(f"[adam] the base pretrainer's {numel} parameters in {len(start)} tensors", flush=True)

    # the decode alone, over every bf16 code
    codes = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16)).cuda() \
        .view(torch.bfloat16)
    k_dec = topt.adam_decode_probe(codes)
    p_dec = topt.unsigned_bfloat16_decode(codes)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(k_dec), torch.isnan(p_dec)
    check(torch.equal(nan_k, nan_p), "decode sweep: NaN where the plain decode has none")
    dec_differ, dec_ulps = _f32_diff(k_dec[~nan_p], p_dec[~nan_p])
    print(f"[adam] decode sweep over 65536 bf16 codes ({int(nan_p.sum())} NaN): "
          f"{dec_differ} differ from torch.pow's, at most {dec_ulps} ulp", flush=True)
    check(dec_ulps <= ADAM_MAX_ULPS, f"decode sweep: {dec_ulps} ulp from torch.pow's")
    out["decode_sweep"] = {"codes": 65536, "differ": dec_differ, "max_ulps": dec_ulps}

    out["chains_f32"] = {}
    for moments, chain in itertools.product(("bf16", "f32"), topt.CHAINS):
        f32 = moments == "f32"
        ocfg = _adam_chain_config(cfg, chain, moments)
        arms = {arm: topt.PretrainOptimizer({n: p.clone() for n, p in start.items()}.items(),
                                            decay[chain], ocfg, chain=chain)
                for arm in ("kernel", "plain")}
        label = f"{chain}{' f32 moments' if f32 else ''}"
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for update in range(ADAM_UPDATES):
            grads = _adam_grads(start, gen, update)
            before = kernels.LAUNCHES["adam_update"]
            arms["kernel"].step(grads)
            check(kernels.LAUNCHES["adam_update"] == before + 1,
                  f"{label}: an update made {kernels.LAUNCHES['adam_update'] - before} launches")
            opt = arms["plain"]
            topt.adam_update_reference(opt.params, grads, opt.mu, opt.nu, opt.decay, ocfg,
                                       opt.count + 1, float(opt.schedule(opt.count)), opt.anchor)
            opt.count += 1
        torch.cuda.synchronize()
        k, p = arms["kernel"], arms["plain"]
        rec = {"decayed_tensors": len(decay[chain]), "updates": ADAM_UPDATES}
        p_differ = p_ulps = mu_differ = nu_differ = nu_ulps = 0
        max_abs_err = max(float((k.params[n] - p.params[n]).abs().max()) for n in start)
        bits = torch.int32 if f32 else torch.int16
        for n in start:
            d, u = _f32_diff(k.params[n], p.params[n])
            p_differ, p_ulps = p_differ + d, max(p_ulps, u)
            mu_differ += int((k.mu[n].view(bits) != p.mu[n].view(bits)).sum())
            nu_differ += int((k.nu[n].view(bits) != p.nu[n].view(bits)).sum())
            d, u = (_f32_diff(k.nu[n], p.nu[n]) if f32 else
                    _f32_diff(topt.unsigned_bfloat16_decode(k.nu[n]),
                              topt.unsigned_bfloat16_decode(p.nu[n])))
            nu_ulps = max(nu_ulps, u)
        moved = sum(int((k.params[n] != start[n]).sum()) for n in start)
        rec.update(max_abs_err=max_abs_err, p_differ=p_differ, p_max_ulps=p_ulps,
                   mu_differ=mu_differ,
                   nu_differ=nu_differ, nu_decoded_max_ulps=nu_ulps, moved=moved)
        print(f"[adam] {label}: after {ADAM_UPDATES} updates, kernel vs plain: p {p_differ} "
              f"differ (max {p_ulps} ulp), mu {mu_differ}, nu {nu_differ} (decoded max "
              f"{nu_ulps} ulp); {moved} of {numel} parameters moved", flush=True)
        check(moved > numel // 2, f"{label}: the updates moved {moved} of {numel} parameters")
        if f32:  # no pow on this path: every bit of p, mu and nu
            check(p_differ == mu_differ == nu_differ == 0,
                  f"{label}: kernel vs plain differ in p {p_differ}, mu {mu_differ}, "
                  f"nu {nu_differ} elements")
        check(p_ulps <= ADAM_MAX_ULPS and nu_ulps <= ADAM_MAX_ULPS,
              f"{label}: kernel vs plain p {p_ulps} ulp, decoded nu {nu_ulps} ulp")
        # next_m reads only the gradient and mu: its bf16 rounding is exact work
        check(mu_differ == 0, f"{label}: mu differs in {mu_differ} elements")

        # times: the kernel by events (one launch of milliseconds), the plain
        # loop on the device alone from a CUDA graph; host ms = enqueue time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ADAM_TIMED):
            k.step(grads)
        host_k = (time.perf_counter() - t0) * 1e3 / ADAM_TIMED
        torch.cuda.synchronize()
        dev_k = cuda_time_ms(lambda: k.step(grads), iters=ADAM_TIMED, warmup=1)

        def plain_update():
            topt.adam_update_reference(p.params, grads, p.mu, p.nu, p.decay, ocfg, 2, 0.5,
                                       p.anchor)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_update()
        host_p = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        dev_p = graph_time_ms(plain_update, iters=2)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            plain_update()
            torch.cuda.synchronize()
        plain_launches = sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA)
        # g and p read, p written; mu and nu read and written (2 bytes each
        # in bf16, 4 in f32); the finetuning chain's bf16 anchor on its
        # masked tensors
        nbytes = numel * (28 if f32 else 20) + (
            2 * sum(start[n].numel() for n in decay[chain]) if chain == "finetune" else 0)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        rec.update(ms=dev_k, host_ms=host_k, plain_ms=dev_p, plain_host_ms=host_p,
                   launches_per_update=1, plain_launches_per_update=plain_launches,
                   bytes=nbytes, bound_ms=bound, bound_by="bytes", library_ms=None)
        print(f"[adam] {label}: kernel {dev_k:.3f} ms on the device, {host_k:.3f} ms host per "
              f"update, 1 launch; plain loop {dev_p:.3f} ms device (graph), {host_p:.2f} ms "
              f"host, {plain_launches} device kernels; bound {bound:.3f} ms ({nbytes} bytes, "
              f"{card})", flush=True)
        out["chains_f32" if f32 else "chains"][chain] = rec
        del arms, k, p, grads
        torch.cuda.empty_cache()
    out["f32_path"] = _adam_f32_path(card)
    return out


def _adam_f32_path(card):
    """The base pretraining step with f32 Adam (``use_bfloat16_adam`` off)
    through ``run_pretraining``, counted: one ``adam_update`` launch per step
    in the kernel's f32-moment mode, f32 moments in the state, finite losses."""
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

    cfg = load_config("base", joint_attention_impl="flash")
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5, use_bfloat16_adam=False,
        do_bias_correction=True))
    batch = make_dummy_batch(cfg, TRAIN_BATCH, seed=0)
    logged = []
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    state = run_pretraining(cfg, itertools.repeat(batch), num_steps=ADAM_F32_PATH_STEPS,
                            log_fn=lambda s_, m_: logged.append(m_), log_every=0,
                            device="cuda", seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    moments = {str(t.dtype) for d in (state.optimizer.mu, state.optimizer.nu)
               for t in d.values()}
    totals = [m_["total"] for m_ in logged]
    print(f"[adam] {card}: f32 Adam through run_pretraining, {ADAM_F32_PATH_STEPS} base steps "
          f"(batch {TRAIN_BATCH}): moments {moments}, totals {totals}, launches {launches}",
          flush=True)
    check(moments == {"torch.float32"}, f"f32 Adam's moments are {moments}")
    check(launches.get("adam_update", 0) == ADAM_F32_PATH_STEPS,
          f"f32 Adam: {launches.get('adam_update', 0)} adam_update launches in "
          f"{ADAM_F32_PATH_STEPS} steps")
    check(all(math.isfinite(v) for m_ in logged for v in m_.values()), "f32 Adam: a non-finite loss")
    del state
    torch.cuda.empty_cache()
    return {"steps": ADAM_F32_PATH_STEPS, "launches": launches, "losses": logged}




# ---------------------------------------------------------------------------
# 13. pretraining with checkpoints and resume
# ---------------------------------------------------------------------------

CKPT_DIR = ROOT / "_smoke_ckpt"  # gitignored; removed at the end of the run
CKPT_STEPS, CKPT_SAVE_EVERY, RESUME_STEPS = 4, 2, 6
# the resumed run's losses at steps 5-6 against two uninterrupted runs: the
# card's backward is not deterministic (dq's atomics), and the resumed run
# starts from parameters rounded to f16 (the checkpoint's format), which
# moves them by up to 2^-11 of each value, about one update at lr 1e-5.
# Held within the two runs' spread or RESUME_LOSS_TOL, whichever is larger
RESUME_LOSS_TOL = 1e-3


def _bits_equal(a, b):
    import torch

    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}
    return torch.equal(a.contiguous().view(view[a.dtype]), b.contiguous().view(view[b.dtype]))


def phase_train_ckpt(card):
    """``run_pretraining`` at the PR 2 shape with an ``output_dir``: 4 steps
    saving every 2, a resumed run to 6, two uninterrupted 6-step runs as its
    yardstick, the restored state against the saved one bit for bit, and
    the asynchronous save against an update made right after it."""
    import shutil

    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
    from merlot_reserve_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = load_config("base", joint_attention_impl="flash")
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
    batch = make_dummy_batch(cfg, TRAIN_BATCH, seed=0)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out_dir = str(CKPT_DIR / "pretrain")

    saves, writes = [], []
    original_save, original_write = ckpt_lib.AsyncCheckpointer.save, ckpt_lib._write

    def timed_save(self, *args, **kw):
        t0 = time.perf_counter()
        original_save(self, *args, **kw)
        saves.append((time.perf_counter() - t0) * 1e3)

    def timed_write(*args, **kw):
        t0 = time.perf_counter()
        path = original_write(*args, **kw)
        writes.append({"s": time.perf_counter() - t0, "bytes": os.path.getsize(path),
                       "file": os.path.basename(path)})
        return path

    def run(num_steps, output_dir=None):
        logged, stamps = [], []

        def log_fn(step, metrics):
            stamps.append(time.perf_counter())
            logged.append((step, metrics["total"]))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_pretraining(cfg, itertools.repeat(batch), num_steps=num_steps,
                                output_dir=output_dir, save_every=CKPT_SAVE_EVERY, log_every=0,
                                log_fn=log_fn, device="cuda", seed=0)
        torch.cuda.synchronize()
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
        return state, logged, step_ms

    with mock.patch.object(ckpt_lib.AsyncCheckpointer, "save", timed_save), \
            mock.patch.object(ckpt_lib, "_write", timed_write):
        kernels.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        state, logged_a, step_ms_a = run(CKPT_STEPS, out_dir)
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        files = sorted(os.listdir(out_dir))
        print(f"[ckpt] {CKPT_STEPS} steps saving every {CKPT_SAVE_EVERY}: {files}; loop "
              f"blocked {[round(s, 2) for s in saves]} ms per async save; writes "
              f"{[(w['file'], round(w['s'], 3), w['bytes']) for w in writes]}", flush=True)
        check({"ckpt_2", "ckpt_4"} <= set(files), f"checkpoints written: {files}")
        check([s for s, _ in logged_a] == list(range(CKPT_STEPS)), f"steps {logged_a}")
        check(launches.get("adam_update", 0) == CKPT_STEPS,
              f"adam_update launches {launches.get('adam_update', 0)} != {CKPT_STEPS}")

        # the saved state read back into a fresh one, bit for bit
        saved = {"params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
                 "mu": {n: t.clone() for n, t in state.optimizer.mu.items()},
                 "nu": {n: t.clone() for n, t in state.optimizer.nu.items()},
                 "count": state.optimizer.count}
        dev_batch = batch_to_tensors(batch, "cuda")
        device_ms = cuda_time_ms(lambda: train_step(state, dev_batch), iters=3, warmup=1)
        del state
        torch.cuda.empty_cache()
        fresh = create_train_state(cfg, MerlotReservePretrainer(cfg, device="cuda", seed=1))
        ckpt_lib.load_checkpoint(out_dir, state=fresh, step=CKPT_STEPS)
        check(fresh.step == CKPT_STEPS and fresh.optimizer.count == saved["count"],
              f"restored step {fresh.step}, count {fresh.optimizer.count}")
        restored = dict(fresh.model.named_parameters())
        for n, p in saved["params"].items():
            check(_bits_equal(restored[n].detach(), p.half().float()),
                  f"restored {n} is not f16 of the saved value")
        for what in ("mu", "nu"):
            theirs = getattr(fresh.optimizer, what)
            for n, t in saved[what].items():
                check(_bits_equal(theirs[n], t), f"restored {what} of {n} differs")

        # the asynchronous save holds the values it was given
        ckpt = ckpt_lib.AsyncCheckpointer()
        before = {n: p.detach().clone() for n, p in fresh.model.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(fresh, str(CKPT_DIR / "async"))
        blocked_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            for p in fresh.model.parameters():
                p.add_(1.0)
        t0 = time.perf_counter()
        ckpt.wait()
        wait_s = time.perf_counter() - t0
        tree = ckpt_lib.load_checkpoint(str(CKPT_DIR / "async"))
        from merlot_reserve_tpu_torch.utils.weights import state_dict_from_flax
        back = state_dict_from_flax(tree["params"])
        for n, p in before.items():
            check(_bits_equal(back[n], p.cpu().half().float()),
                  f"the async save of {n} does not hold the value before the update")
        del fresh, before, back, tree, saved
        torch.cuda.empty_cache()

        # resume to 6 steps, and two uninterrupted 6-step runs
        _, logged_b, step_ms_b = run(RESUME_STEPS, out_dir)
    check([s for s, _ in logged_b] == list(range(CKPT_STEPS, RESUME_STEPS)),
          f"the resumed run logged steps {[s for s, _ in logged_b]}")
    check("ckpt_6" in os.listdir(out_dir),
          "no ckpt_6 after the resumed run")
    refs = [run(RESUME_STEPS)[1] for _ in range(2)]
    spread = [abs(refs[0][i][1] - refs[1][i][1]) for i in range(RESUME_STEPS)]
    for (step, total), i in zip(logged_b, range(CKPT_STEPS, RESUME_STEPS)):
        lo = min(r[i][1] for r in refs)
        hi = max(r[i][1] for r in refs)
        gap = max(lo - total, total - hi, 0.0)
        check(gap <= max(spread[i], RESUME_LOSS_TOL),
              f"resumed step {step} loss {total} is {gap} outside [{lo}, {hi}]")
    res = {"launches": launches, "files": files, "async_save_blocked_ms": saves,
           "writes": writes, "async_check": {"blocked_ms": blocked_ms, "wait_s": wait_s},
           "losses_first": logged_a, "losses_resumed": logged_b,
           "losses_uninterrupted": refs, "uninterrupted_spread": spread,
           "step_ms_host": step_ms_a, "step_ms_host_resumed": step_ms_b,
           "step_ms_device": device_ms, "max_memory_allocated_bytes": peak}
    print(f"[ckpt] {card}: steps {[round(s, 1) for s in step_ms_a]} ms on the host clock "
          f"(saves after steps 2 and 4), {device_ms:.1f} ms on the device clock; the async "
          f"save check blocked {blocked_ms:.2f} ms and wrote in {wait_s:.2f} s; resumed "
          f"losses {[round(t, 6) for _, t in logged_b]} against uninterrupted "
          f"{[[round(t, 6) for _, t in r[CKPT_STEPS:]] for r in refs]}; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return res


# ---------------------------------------------------------------------------
# 14. finetuning from the port's checkpoint
# ---------------------------------------------------------------------------

VCR_BATCH, VCR_STEPS = 8, 3
TVQA_BATCH = 4
FINETUNE_LOSS_TOL = 0.05  # step-0 loss against ln N of an untrained head
# not held in the f32 comparison, as ZERO_GRAD: a logit is proj . h at each
# option's MASK and the loss a softmax over a task's options, so the joint
# tower's last bias gets proj times the sum of (p - y) over each task's
# options, which is 0; what the card computes there is rounding noise
FINETUNE_ZERO_GRAD = ("joint_transformer.final_ln.bias",)


def _finetune_config(task, name="base", **model):
    """The scripts' settings on the ``name`` config: VCR at output_grid
    (18, 32) and lang_seq_len 144 (scripts/finetune_vcr.py), TVQA at
    lang_seq_len 256 and 7 segments at the config's grid
    (scripts/finetune_tvqa.py); bias correction on and eps 1e-6 as both set
    it; lr 1e-5 and no warmup, so the first updates move."""
    from merlot_reserve_tpu_torch import load_config

    if task == "vcr":
        cfg = load_config(name, output_grid=(18, 32), joint_attention_impl="flash", **model)
        cfg = cfg.replace_data(lang_seq_len=144)
    else:
        cfg = load_config(name, joint_attention_impl="flash", **model)
        cfg = cfg.replace_data(lang_seq_len=256, num_segments=7)
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, learning_rate=1e-5, num_warmup_steps=0, num_train_steps=1000,
        do_bias_correction=True, eps=1e-6))


def phase_finetune(card, pretrained_dir):
    """VCR and TVQA heads from the port's pretraining checkpoint: the
    kernel path's first gradient against the plain attention path in an f32
    copy, then steps with launches, losses, times and peaks."""
    import torch

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.data.dummy import (TVQA_NUM_ANSWERS, VCR_NUM_ANSWERS,
                                                     make_dummy_tvqa_batch, make_dummy_vcr_batch)
    from merlot_reserve_tpu_torch.finetune import models as tm
    from merlot_reserve_tpu_torch.finetune import train as tt
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params

    pretrained = load_checkpoint(pretrained_dir, step=CKPT_STEPS)["params"]
    out, labels = {}, {}
    tasks = (("vcr", tm.MerlotReserveVCR, make_dummy_vcr_batch, tt.vcr_loss_fn, VCR_BATCH,
              [False] * VCR_STEPS, math.log(VCR_NUM_ANSWERS)),
             ("tvqa", tm.MerlotReserveTVQA, make_dummy_tvqa_batch, tt.tvqa_loss_fn, TVQA_BATCH,
              [False, True], 2 * math.log(TVQA_NUM_ANSWERS)))
    for task, cls, make_batch, loss_fn, B, scans, ln_n in tasks:
        cfg = _finetune_config(task)
        m = cfg.model
        params = tm.adapt_pretrained_params(pretrained, m.hidden_size, drop_audio=task == "vcr")
        batch = make_batch(cfg, B, seed=0)
        dev_batch = batch_to_tensors(batch, "cuda")
        model = cls(cfg, device="cuda", seed=0)
        load_flax_params(model, params)
        labels[task] = _capture_labels(model, dev_batch)
        L = max(labels[task])

        # the first step's gradient, kernel path against plain path, in f32
        model32 = cls(_finetune_config(task, use_bfloat16=False), device="cuda", seed=0)
        model32.load_state_dict(model.state_dict())
        grads = {}
        for path in ("kernel", "plain"):
            named = {n: p.detach().requires_grad_() for n, p in model32.named_parameters()}
            with contextlib.ExitStack() as stack:
                if path == "plain":
                    for patch in _plain_flash():
                        stack.enter_context(patch)
                loss, _ = loss_fn(model32, named, dev_batch)
                got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
            grads[path] = {n: (torch.zeros_like(p) if g is None else g).float()
                           for (n, p), g in zip(named.items(), got)}
        del model32, named, got
        held = [n for n, g in grads["plain"].items()
                if n not in ZERO_GRAD + FINETUNE_ZERO_GRAD and bool(g.any())]
        agree = _agreement({n: grads["kernel"][n] for n in held},
                           {n: grads["plain"][n] for n in held})
        worst = sorted(agree["tensors"].items(), key=lambda kv: kv[1])[:6]
        lowest = worst[0]
        zero_sum = {n: float(grads["plain"][n].norm() / grads["plain"]["proj.weight"].norm())
                    for n in FINETUNE_ZERO_GRAD}
        print(f"[finetune] {task}: f32 gradient, kernel vs plain: whole {agree['whole']:.7f}, "
              f"per tower { {k: round(v, 7) for k, v in agree['towers'].items()} }, lowest "
              f"per tensor {[(n, round(c, 7)) for n, c in worst]}; not held (norm over "
              f"proj's) {zero_sum}", flush=True)
        del grads
        torch.cuda.empty_cache()
        check(agree["whole"] >= TRAIN_F32_MIN_COSINE and lowest[1] >= TRAIN_F32_MIN_COSINE,
              f"{task}: f32 gradient cosine, whole {agree['whole']}, of {lowest[0]} "
              f"{lowest[1]}, below {TRAIN_F32_MIN_COSINE}")

        state = tt.create_finetune_state(cfg, model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        infos, step_ms, launch_steps = [], [], []
        for scan in scans:
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            state, info = tt.finetune_train_step(state, dev_batch, loss_fn, scan_minibatch=scan)
            infos.append({k: float(v) for k, v in info.items()})  # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launch_steps.append({k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()})
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        loss0 = infos[0]["loss"] if task == "vcr" else \
            infos[0]["loss_audio"] + infos[0]["loss_text"]
        check(all(math.isfinite(v) for i in infos for v in i.values()), f"{task}: non-finite")
        check(abs(loss0 - ln_n) < FINETUNE_LOSS_TOL,
              f"{task}: step-0 loss {loss0} is not near ln N = {ln_n}")
        for scan, counts in zip(scans, launch_steps):
            per_step = m.joint_num_layers * (B if scan else 1)
            for name in ("flash_fwd", *BWD_LAUNCHES):
                check(counts.get(name, 0) == per_step,
                      f"{task}: {name} launches {counts.get(name, 0)} != {per_step} "
                      f"(scan_minibatch={scan})")
            check(counts.get("adam_update", 0) == 1, f"{task}: adam_update launches {counts}")
        # warm steps on the device clock, outside the counted run
        device_ms = cuda_time_ms(lambda: tt.finetune_train_step(state, dev_batch, loss_fn),
                                 iters=2, warmup=1)
        out[task] = {"batch": B, "joint_rows": labels[task][L][0].shape[0], "joint_len": L,
                     "launches": launches, "launches_per_step": launch_steps,
                     "scan_minibatch": scans, "metrics": infos, "expected_init_loss": ln_n,
                     "step_ms_host": step_ms, "step_ms_device": device_ms,
                     "examples_per_s": B / device_ms * 1e3,
                     "max_memory_allocated_bytes": peak,
                     "gradient_f32_kernel_vs_plain": {"whole": agree["whole"],
                                                      "towers": agree["towers"],
                                                      "lowest": lowest}}
        print(f"[finetune] {task}: {B} examples, joint {out[task]['joint_rows']} rows of {L}; "
              f"step-0 loss {loss0:.5f} (ln N {ln_n:.5f}); steps {[round(s, 1) for s in step_ms]}"
              f" ms on the host clock (scan_minibatch {scans}), {device_ms:.1f} ms on the "
              f"device clock warm; {out[task]['examples_per_s']:.2f} examples/s; "
              f"peak {peak / 2**30:.2f} GiB; launches per step {launch_steps[0]}; f32 gradient "
              f"cosine kernel vs plain: whole {agree['whole']:.7f}, lowest {lowest}; {card}",
              flush=True)
        del state, model, dev_batch
        torch.cuda.empty_cache()
    return out, {task: labels[task][max(labels[task])] for task in labels}


# ---------------------------------------------------------------------------
# 15. data to the device: TFRecords to training steps through three feeds
# ---------------------------------------------------------------------------

DATA_BATCH, DATA_STEPS = 8, 7  # the step time: median of steps 3-7
DATA_SHARDS, DATA_RECORDS_PER_SHARD = 2, 8
# step-0 losses of an untrained model on the synthetic corpus: within this
# of ln N (phase 5 holds the dummy batch to 0.05; real frames and text are
# allowed twice that)
DATA_INIT_LOSS_TOL = 0.1
# the JPEG codec against known smooth pixels (gradients plus a constant),
# encoded at quality 90: mean |decoded - known| in levels of 255
JPEG_MEAN_TOL = 3.0
# the card's build_batch against the CPU's on the same raw batch and draws:
# integers exactly; patches in [0, 1] within 2e-6 and the other floats
# within 1e-6 (the resize's products sum in another order; sin and cos of
# its weights may differ in the last bit)
BUILD_IMAGE_TOL, BUILD_FLOAT_TOL = 2e-6, 1e-6
BUILD_COMPARE_BATCH = 2


class _ReplayDraws:
    """The builder's draws taken on the CPU (``BuilderDraws``) and handed to
    a builder on ``device``: both builders see the same numbers."""

    def __init__(self, seed, step, device):
        from merlot_reserve_tpu_torch.data.device_builder import BuilderDraws

        self.cpu = BuilderDraws(seed, step, "cpu")
        self.device = device
        self.step = step

    def __getattr__(self, name):
        fn = getattr(self.cpu, name)

        def call(site, *args):
            args = [a.cpu() if hasattr(a, "cpu") else a for a in args]
            return fn(site, *args).to(self.device)
        return call


def _smooth_pixels(h, w):
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy * 200 // h + 20, xx * 200 // w + 10, (yy + xx) * 100 // (h + w) + 60],
                    -1).astype(np.uint8)


def _check_jpeg():
    """The data library's codec on the card machine: encode and decode of
    known pixels, RGB and grayscale, several decoding threads against one,
    and the decode rate of a 180x320 frame on 1 and 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from merlot_reserve_tpu_torch.data import native

    codec = native.jpeg_codec()
    res = {"codec": codec, "errors": {}}
    img = _smooth_pixels(180, 320)
    for name, pixels in (("rgb", img), ("gray", img[..., 1])):
        data = native.encode_jpeg_native(pixels, 90)
        out = native.decode_jpeg_native(data, 3 if pixels.ndim == 3 else 1)
        check(out.shape == pixels.shape, f"jpeg {name}: decoded {out.shape} != {pixels.shape}")
        err = np.abs(out.astype(np.int64) - pixels)
        res["errors"][name] = {"mean": float(err.mean()), "max": int(err.max()),
                               "bytes": len(data)}
        check(err.mean() <= JPEG_MEAN_TOL, f"jpeg {name} ({codec}): mean error {err.mean()} > "
              f"{JPEG_MEAN_TOL} levels")
    data = native.encode_jpeg_native(img, 90)
    one = native.decode_jpeg_native(data)
    rates = {}
    for threads in (1, 8):
        n = 64 * threads
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            outs = list(pool.map(lambda _: native.decode_jpeg_native(data), range(n)))
            rates[threads] = n / (time.perf_counter() - t0)
        check(all(np.array_equal(o, one) for o in outs),
              f"jpeg: {threads} threads decoded other pixels than one")
    res["decodes_per_s_180x320"] = rates
    print(f"[data] JPEG codec {codec}: mean |error| on known pixels "
          f"{ {k: round(v['mean'], 3) for k, v in res['errors'].items()} } (max "
          f"{ {k: v['max'] for k, v in res['errors'].items()} }); 180x320 decodes/s "
          f"{ {k: round(v, 1) for k, v in rates.items()} } on 1 and 8 threads", flush=True)
    return res


def _device_events(prof):
    """Kernels and copies on the device timeline (not the ranges' spans)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("train_step/", "ProfilerStep"))]


def _busy_ms(events):
    """Device ms covered by at least one event (the union of their spans)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _profile(fn, steps=2):
    """(wall ms per call under the profiler, device events) of ``steps``
    calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    return wall, _device_events(prof)


def phase_data(card, device="cuda"):
    """TFRecords to training steps at full base width: the synthetic corpus
    written by the port, then ``run_pretraining`` through two feeds (the
    host-assembled ``PretrainLoader`` on threads, and the fused step on raw
    batches with frames augmented on the card), each through a
    ``DeviceFeed``; the builder on the card against the CPU. (``device``:
    "cpu" for a rehearsal at tiny widths with the timers patched.)"""
    import tempfile

    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.device_builder import (BuilderDraws, DeviceExampleBuilder,
                                                              stack_raw_examples)
    from merlot_reserve_tpu_torch.data.loader import (DeviceFeed, DevicePretrainLoader,
                                                      PretrainLoader)
    from merlot_reserve_tpu_torch.data.native import read_records_native
    from merlot_reserve_tpu_torch.data.pretrain_pipeline import parse_segment_record
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.training.trainer import make_fused_data_train_step, train_step

    res = {"jpeg": _check_jpeg()}
    cfg = load_config("base", joint_attention_impl="flash")
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
    m, d = cfg.model, cfg.data
    expected = _expected_init_losses(cfg, DATA_BATCH)
    narrow = {"images": torch.bfloat16, "audio_clips": torch.bfloat16}
    per_step = m.joint_num_layers + m.span_num_layers

    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        t0 = time.perf_counter()
        files = [write_synthetic_corpus(os.path.join(tmp, f"shard{i}.tfrecord"), cfg,
                                        num_records=DATA_RECORDS_PER_SHARD, seed=i,
                                        structured=True) for i in range(DATA_SHARDS)]
        res["corpus"] = {"records": DATA_SHARDS * DATA_RECORDS_PER_SHARD,
                         "seconds": time.perf_counter() - t0,
                         "bytes": sum(os.path.getsize(f) for f in files)}
        print(f"[data] corpus: {res['corpus']['records']} records of {d.num_segments} segments "
              f"({res['corpus']['bytes'] / 2**20:.1f} MiB) written in "
              f"{res['corpus']['seconds']:.2f} s", flush=True)
        loader_kw = dict(seed=0, num_workers=8, use_bfloat16=m.use_bfloat16,
                         files_per_cycle=DATA_SHARDS, parallel_reads=DATA_SHARDS,
                         shuffle_buffer=DATA_RECORDS_PER_SHARD)
        # two feeds: the dummy batches are phase 5's step, and the host
        # loader on spawned processes feeds phase 18's steps
        feeds = {
            "host": (PretrainLoader(files, cfg, DATA_BATCH, **loader_kw), None),
            "fused_frames": None,
        }
        fused_loader = DevicePretrainLoader(files, cfg, DATA_BATCH, fused=True,
                                            on_device_frames=True, **loader_kw)
        feeds["fused_frames"] = (fused_loader, fused_loader._dev_builder)

        runs = {}
        for name, (batches, builder) in feeds.items():
            source = iter(batches)  # closed after the run: a pool's workers stop
            feed = DeviceFeed(source, device, narrow=narrow, widen_ints=builder is None)
            last = {}

            def keep(it):
                for b in it:
                    last["batch"] = b
                    yield b

            logged, stamps = [], []

            def log_fn(step, metrics):
                stamps.append(time.perf_counter())  # the metrics are floats: the step ended
                logged.append(metrics)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            state = run_pretraining(cfg, keep(iter(feed)), num_steps=DATA_STEPS, log_fn=log_fn,
                                    log_every=0, device=device, seed=0, fused_builder=builder,
                                    data_seed=0)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            if hasattr(source, "close"):
                source.close()
            peak = torch.cuda.max_memory_allocated()
            step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
            check(len(logged) == DATA_STEPS, f"{name}: {len(logged)} steps of {DATA_STEPS}")
            check(all(math.isfinite(v) for m_ in logged for v in m_.values()),
                  f"{name}: non-finite loss")
            for head, ln_n in expected.items():
                check(abs(logged[0][head] - ln_n) < DATA_INIT_LOSS_TOL,
                      f"{name}: step-0 {head} loss {logged[0][head]} is not near ln N = {ln_n}")
            for k in ("flash_fwd", *BWD_LAUNCHES):
                check(launches.get(k, 0) == per_step * DATA_STEPS,
                      f"{name}: {k} launches {launches.get(k, 0)} != {per_step} x {DATA_STEPS}")
            check(launches.get("adam_update", 0) == DATA_STEPS,
                  f"{name}: adam_update launches {launches.get('adam_update', 0)}")
            for k in (*BWD_LAUNCHES_F32, "ring_fwd"):
                check(launches.get(k, 0) == 0, f"{name}: launched {k}")

            # the step on the device clock, and (but for the host feed, whose
            # step is the dummy feed's on other numbers) a profiled pair
            batch = last["batch"]
            if builder is None:
                step = lambda: train_step(state, batch)  # noqa: E731
            else:
                fused = make_fused_data_train_step(builder, data_seed=0)
                step = lambda: fused(state, batch)  # noqa: E731
            device_ms = cuda_time_ms(step, iters=2, warmup=1)
            wall, events = _profile(step) if not name.startswith("host") else (None, None)
            copies = feed.copy_ms()
            host_med = float(np.median(step_ms[2:]))
            r = {"launches": launches, "launches_per_step": {k: v / DATA_STEPS
                                                             for k, v in launches.items()},
                 "losses": logged, "step_ms_host": step_ms, "step_ms_host_median": host_med,
                 "step_ms_host_spread": [min(step_ms[2:]), max(step_ms[2:])],
                 "step_ms_device": device_ms, "examples_per_s": DATA_BATCH / host_med * 1e3,
                 "device_examples_per_s": DATA_BATCH / device_ms * 1e3,
                 "profiled_ms_per_step": wall,
                 "busy_share": _busy_ms(events) / 2 / wall if events is not None else None,
                 "device_events_per_step": len(events) / 2 if events is not None else None,
                 "h2d_bytes_per_step": feed.bytes_per_batch, "h2d_pinned": feed.pinned,
                 "h2d_ms": copies, "max_memory_allocated_bytes": peak}
            runs[name] = r
            r["seconds"] = time.perf_counter() - t0
            print(f"[data] {card}: {name} feed ({r['seconds']:.1f} s): {host_med:.1f} ms per step "
                  f"on the host clock "
                  f"(median of steps 3-{DATA_STEPS}, {_spread(step_ms[2:])}; "
                  f"all {[round(t, 1) for t in step_ms]}), "
                  f"{device_ms:.1f} ms on the device clock; {r['examples_per_s']:.2f} examples/s; "
                  + (f"busy {r['busy_share']:.3f} of {wall:.1f} ms under the profiler; "
                     if wall is not None else "") + f"H2D "
                  f"{feed.bytes_per_batch / 1e6:.2f} MB per step, pinned {feed.pinned}, "
                  f"{np.median(copies) if copies else float('nan'):.3f} ms (median); peak "
                  f"{peak / 2**30:.2f} GiB; "
                  f"step-0 losses { {k: round(logged[0][k], 4) for k in expected} }", flush=True)
            if builder is not None:
                # the builder alone, on the last raw batch
                raw = {k: v for k, v in batch.items() if k != "images"}
                build = lambda: builder.build_batch(raw, BuilderDraws(0, 0, device))  # noqa: E731
                r["build_ms_device"] = cuda_time_ms(build, iters=3, warmup=1)
                bwall, bevents = _profile(build)
                r["build_launches_per_batch"] = len(bevents) / 2
                r["build_busy_share"] = _busy_ms(bevents) / 2 / bwall
                r["build_profiled_ms"] = bwall
                vt = lambda: builder._frames(raw, BuilderDraws(0, 0, device))  # noqa: E731
                r["frames_ms_device"] = cuda_time_ms(vt, iters=3, warmup=1)
                print(f"[data] {card}: the builder on a batch of {DATA_BATCH}: "
                      f"{r['build_ms_device']:.2f} ms on the device clock (frames "
                      f"{r['frames_ms_device']:.2f}), {r['build_launches_per_batch']:.0f} "
                      f"device launches per batch, busy {r['build_busy_share']:.3f} of "
                      f"{bwall:.1f} ms under the profiler", flush=True)
                if hasattr(builder, "stats"):
                    r["builder_stats"] = dict(builder.stats)
            del state, batch, step, feed
            torch.cuda.empty_cache()
        res["feeds"] = runs

        # the card's builder against the CPU's on one batch, the same draws
        t0 = time.perf_counter()
        cfg32 = cfg.replace_model(use_bfloat16=False)
        builder = DeviceExampleBuilder(cfg32)
        raws = []
        for record in itertools.islice(read_records_native(files[0]), BUILD_COMPARE_BATCH):
            segs = parse_segment_record(record, d.num_segments)
            raws.append({**builder.host_prepare(segs), **builder.host_prepare_frames(segs)})
        raw = {k: torch.from_numpy(v) for k, v in stack_raw_examples(raws).items()}
        want = builder.build_batch(raw, _ReplayDraws(3, 1, torch.device("cpu")))
        got = builder.build_batch({k: v.to(device) for k, v in raw.items()},
                                  _ReplayDraws(3, 1, torch.device(device)))
        check(got.keys() == want.keys(), "build_batch: the card's keys differ")
        errs = {}
        for k in want:
            g = got[k].cpu()
            check(g.dtype == want[k].dtype and g.shape == want[k].shape,
                  f"build_batch {k}: {g.dtype} {tuple(g.shape)} on the card")
            if g.is_floating_point():
                errs[k] = (g - want[k]).abs().max().item()
                tol = BUILD_IMAGE_TOL if k == "images" else BUILD_FLOAT_TOL
                check(errs[k] <= tol, f"build_batch {k}: card vs CPU {errs[k]} > {tol}")
            else:
                errs[k] = int((g != want[k]).sum())
                check(errs[k] == 0, f"build_batch {k}: {errs[k]} integers differ")
        res["build_card_vs_cpu"] = errs
        print(f"[data] build_batch on the card against the CPU ({time.perf_counter() - t0:.1f} "
              f"s), batch {BUILD_COMPARE_BATCH} at base shapes with frames: max |err| "
              f"{ {k: v for k, v in errs.items() if isinstance(v, float)} }, integers equal",
              flush=True)
    return res


# ---------------------------------------------------------------------------
# 16. fixres: the mixed-resolution step, its kernels, the scripts
# ---------------------------------------------------------------------------

FIXRES_BATCH, FIXRES_STEPS = 8, 3  # the global batch: half at each grid
FIXRES_JOINT_LEN = 1312  # lang 160 + 8 segments x 144 pooled tokens, at both grids
# step-0 losses of the mixed step from phase 13's ckpt_4 (4 updates on
# another batch at the base grid) against ln N of the whole batch: as
# phase 15 allows for losses that are not those of a fresh init
FIXRES_INIT_LOSS_TOL = 0.1
# the f32 comparison of the mixed step's gradient, kernel path vs plain
# path: full width, this many layers in every tower, random weights
FIXRES_F32_LAYERS = 2
FIXRES_SCRIPT_STEPS, FIXRES_SHARD_RECORDS = 2, 4
# validate_torch.py's losses against evaluate_loss called directly on the
# same checkpoint and records: the same kernels on the same inputs
VALIDATE_TOL = 1e-5


def _fixres_configs(**model):
    """scripts/pretrain_fixres_torch.py's two grid configs (POSSIBLE_RES),
    warmup 1, joint attention on the flash kernels."""
    from scripts.pretrain_fixres_torch import POSSIBLE_RES, fixres_config

    return [fixres_config("base", g, num_steps=1000, warmup=1, lr_scale=0.02)
            .replace_model(joint_attention_impl="flash", **model) for g in POSSIBLE_RES]


def _fixres_batches(cfgs, device="cuda"):
    """make_dummy_batch at each grid, FIXRES_BATCH / 2 examples each, on the
    card, images and audio in the compute dtype (as the DeviceFeed gives
    them)."""
    import torch

    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors

    out = []
    for i, c in enumerate(cfgs):
        b = batch_to_tensors(make_dummy_batch(c, FIXRES_BATCH // 2, seed=i), device)
        if c.model.use_bfloat16:
            b.update({k: b[k].to(torch.bfloat16) for k in ("images", "audio_clips")})
        out.append(b)
    return out


def _mixed_draws(model, cfgs, batches, generator):
    """(split_at, gumbel) pairs, one per half, for ``mixed_loss_and_grads``."""
    import torch

    split_at, gumbel = [], []
    for c, b in zip(cfgs, batches):
        d = c.data
        B, spans = b["text_spans"].shape[:2]
        split_at.append([model.draw_split_at(B * d.num_segment_groups, d.num_segments_per_group,
                                             generator) for _ in range(2)])
        u = torch.rand((B, spans), generator=generator, device=generator.device)
        gumbel.append(-torch.log(-torch.log(u)))
    return tuple(split_at), tuple(gumbel)


def _mixed_pair(mixed_loss_and_grads, model, model_b, batches, bf16, draws):
    """The mixed step's (loss terms, gradients) on the kernel path and on the
    plain path, with the launches each made."""
    from merlot_reserve_tpu_torch import kernels

    runs = {}
    for path in ("kernel", "plain"):
        before = dict(kernels.LAUNCHES)
        with contextlib.ExitStack() as stack:
            if path == "plain":
                for patch in _plain_flash():
                    stack.enter_context(patch)
            runs[path] = mixed_loss_and_grads(model, model_b, *batches, bf16, *draws)
        check((path == "plain") == (dict(kernels.LAUNCHES) == before),
              f"mixed step {path} path: launched {'a' if path == 'plain' else 'no'} kernel")
    return runs


def phase_fixres(card, pretrained_dir, device="cuda"):
    """The mixed-resolution step at full base width and depth from phase
    13's ckpt_4: the kernels at its joint shape (B24 L1312, both grids'
    labels), its launches, losses, times and peak, the kernel path's
    gradient against the plain path's (bf16 at full depth, f32 at
    FIXRES_F32_LAYERS), then scripts/pretrain_fixres_torch.py on two shards
    of synthetic records and scripts/validate_torch.py over its checkpoints
    against evaluate_loss called directly. (``device``: "cpu" for a
    rehearsal at tiny widths with the timers patched.)"""
    import tempfile

    import numpy as np
    import torch
    import yaml

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.loader import PretrainLoader
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
    from merlot_reserve_tpu_torch.training.pretrain import evaluate_loss
    from merlot_reserve_tpu_torch.training.trainer import (TrainState, create_train_state,
                                                           make_mixed_res_train_step,
                                                           mixed_loss_and_grads)
    from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint, pretrained_params
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params
    from scripts import pretrain_fixres_torch, validate_torch

    res = {}
    cfgs = _fixres_configs()
    m, d = cfgs[0].model, cfgs[0].data
    ckpt = os.path.join(pretrained_dir, f"ckpt_{CKPT_STEPS}")
    model = MerlotReservePretrainer(cfgs[0], device=device)
    load_flax_params(model, pretrained_params(ckpt))
    model_b = MerlotReservePretrainer(cfgs[1], device="meta")
    batches = _fixres_batches(cfgs, device)
    print(f"[fixres] base pretrainer from {ckpt}, grids {[c.model.output_grid for c in cfgs]}, "
          f"{FIXRES_BATCH // 2} examples each, seq_len {[c.data.seq_len for c in cfgs]}",
          flush=True)

    # the joint attention's labels at each grid, then the kernels at that shape
    labels = [_capture_labels(model, batches[0])]
    with torch.no_grad(), _recorded_labels() as seen:
        torch.func.functional_call(model_b, dict(model.named_parameters()), (batches[1],))
    labels.append({L: lab for (_, L), lab in seen.items()})
    L = max(labels[0])
    check(L == FIXRES_JOINT_LEN and max(labels[1]) == L,
          f"joint lengths {max(labels[0])}, {max(labels[1])} != {FIXRES_JOINT_LEN}")
    res["labels"] = [{n: (v.shape[0], int((v > 0).sum()), int(s.max())) for n, (v, s) in
                      lab.items()} for lab in labels]
    fwd, bwd = (phase_kernels([("fixres_joint_a", *labels[0][L]),
                               ("fixres_joint_b", *labels[1][L])], seed=8)
                if device == "cuda" else ([], []))

    # the counted mixed steps
    state = create_train_state(cfgs[0], model)
    step = make_mixed_res_train_step(cfgs[0], state, model_b)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    infos, step_ms = [], []
    for _ in range(FIXRES_STEPS):
        t0 = time.perf_counter()
        state, info = step(state, *batches)
        infos.append({k: float(v) for k, v in info.items()})  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * (m.joint_num_layers + m.span_num_layers)
    for name in ("flash_fwd", *BWD_LAUNCHES):
        check(launches.get(name, 0) == per_step * FIXRES_STEPS,
              f"mixed step: {name} launches {launches.get(name, 0)} != {per_step} x "
              f"{FIXRES_STEPS}")
    check(launches.get("adam_update", 0) == FIXRES_STEPS,
          f"mixed step: adam_update launches {launches.get('adam_update', 0)}")
    for name in (*BWD_LAUNCHES_F32, "ring_fwd"):
        check(launches.get(name, 0) == 0, f"mixed step launched {name}")
    check(all(math.isfinite(v) for i in infos for v in i.values()), "mixed step: non-finite loss")
    expected = _expected_init_losses(cfgs[0], FIXRES_BATCH)
    for head, ln_n in expected.items():
        check(abs(infos[0][head] - ln_n) < FIXRES_INIT_LOSS_TOL,
              f"mixed step-0 {head} loss {infos[0][head]} is not near ln N = {ln_n}")
    device_ms = cuda_time_ms(lambda: step(state, *batches), iters=2, warmup=1)
    host_med = float(np.median(step_ms[1:]))
    res.update({"batch": FIXRES_BATCH, "steps": FIXRES_STEPS, "launches": launches,
                "launches_per_step": {k: v / FIXRES_STEPS for k, v in launches.items()},
                "losses": infos, "expected_init_losses": expected, "step_ms_host": step_ms,
                "step_ms_host_median": host_med, "step_ms_device": device_ms,
                "examples_per_s": FIXRES_BATCH / host_med * 1e3,
                "device_examples_per_s": FIXRES_BATCH / device_ms * 1e3,
                "max_memory_allocated_bytes": peak})
    print(f"[fixres] {card}: mixed step, {FIXRES_STEPS} steps: {host_med:.1f} ms on the host "
          f"clock (median of steps 2-{FIXRES_STEPS}; all {[round(t, 1) for t in step_ms]}), "
          f"{device_ms:.1f} ms on the device clock; {res['examples_per_s']:.2f} examples/s; "
          f"peak {peak / 2**30:.2f} GiB; launches per step {res['launches_per_step']}; step-0 "
          f"losses { {k: round(infos[0][k], 4) for k in expected} } (ln N "
          f"{ {k: round(v, 4) for k, v in expected.items()} })", flush=True)
    # the kernel path's gradient against the plain path's: bf16 at full
    # depth, on a copy of the model whose towers recompute their layers in
    # the backward (the same gradient; the plain path's f32 scores, 24 x 12
    # x 1312 x 1312, would not fit beside the step's activations)
    remat_cfgs = _fixres_configs(tower_gradient_checkpoint=True)
    model_r = MerlotReservePretrainer(remat_cfgs[0], device=device)
    model_r.load_state_dict(model.state_dict())
    del state, model, step
    torch.cuda.empty_cache()
    model_rb = MerlotReservePretrainer(remat_cfgs[1], device="meta")
    g = torch.Generator(device=device).manual_seed(9)
    draws = _mixed_draws(model_r, cfgs, batches, g)
    runs = _mixed_pair(mixed_loss_and_grads, model_r, model_rb, batches, True, draws)
    agree = _agreement(runs["kernel"][1], runs["plain"][1])
    loss_diff = {k: abs(float(runs["kernel"][0][k]) - float(runs["plain"][0][k]))
                 for k in expected}
    del runs
    check(agree["whole"] >= TRAIN_MIN_COSINE,
          f"mixed step bf16 whole-gradient cosine {agree['whole']} below {TRAIN_MIN_COSINE}")
    for k, v in loss_diff.items():
        check(v <= TRAIN_LOSS_TOL, f"mixed step bf16 {k} kernel vs plain {v} > {TRAIN_LOSS_TOL}")
    res["bf16_kernel_vs_plain"] = {"whole": agree["whole"], "towers": agree["towers"],
                                   "loss_diff": loss_diff}
    del model_r, model_rb, batches
    torch.cuda.empty_cache()

    # ... and in f32 at FIXRES_F32_LAYERS layers per tower, random weights
    depth = {k: FIXRES_F32_LAYERS for k in ("joint_num_layers", "vit_num_layers",
                                            "audio_num_layers", "span_num_layers")}
    cfgs32 = _fixres_configs(use_bfloat16=False, **depth)
    model32 = MerlotReservePretrainer(cfgs32[0], device=device, seed=0)
    model32_b = MerlotReservePretrainer(cfgs32[1], device="meta")
    batches32 = _fixres_batches(cfgs32, device)
    runs = _mixed_pair(mixed_loss_and_grads, model32, model32_b, batches32, False,
                       _mixed_draws(model32, cfgs32, batches32, g))
    held = [n for n in runs["plain"][1] if n not in ZERO_GRAD]
    agree32 = _agreement({n: runs["kernel"][1][n] for n in held},
                         {n: runs["plain"][1][n] for n in held})
    lowest = min(agree32["tensors"].items(), key=lambda kv: kv[1])
    loss_diff32 = {k: abs(float(runs["kernel"][0][k]) - float(runs["plain"][0][k]))
                   for k in expected}
    peak32 = torch.cuda.max_memory_allocated()
    del runs, model32, model32_b, batches32
    torch.cuda.empty_cache()
    check(lowest[1] >= TRAIN_F32_MIN_COSINE,
          f"mixed step f32 gradient cosine of {lowest[0]} {lowest[1]} below "
          f"{TRAIN_F32_MIN_COSINE}")
    for k, v in loss_diff32.items():
        check(v <= TRAIN_F32_LOSS_TOL,
              f"mixed step f32 {k} kernel vs plain {v} > {TRAIN_F32_LOSS_TOL}")
    res["f32_kernel_vs_plain"] = {"layers": FIXRES_F32_LAYERS, "whole": agree32["whole"],
                                  "lowest": lowest, "loss_diff": loss_diff32}
    print(f"[fixres] mixed step gradient, kernel vs plain: bf16 at full depth whole cosine "
          f"{agree['whole']:.6f}, per tower { {k: round(v, 6) for k, v in agree['towers'].items()} }"
          f", loss diffs { {k: f'{v:.2e}' for k, v in loss_diff.items()} }; f32 at "
          f"{FIXRES_F32_LAYERS} layers per tower whole {agree32['whole']:.8f}, lowest tensor "
          f"{lowest}, loss diffs { {k: f'{v:.2e}' for k, v in loss_diff32.items()} }",
          flush=True)

    # the fixres script on two shards, then the validation script over its checkpoints
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fixres_") as tmp:
        t0 = time.perf_counter()
        shards = [write_synthetic_corpus(os.path.join(tmp, f"shard{i}.tfrecord"), cfgs[0],
                                         num_records=FIXRES_SHARD_RECORDS, seed=10 + i,
                                         structured=True) for i in range(2)]
        corpus_s = time.perf_counter() - t0
        # the base config, a checkpoint after every step, the global batch,
        # and the loaders' cycle and shuffle sized to the two small shards
        raw = yaml.safe_load((ROOT / "merlot_reserve_tpu_torch" / "configs" / "base.yaml")
                             .read_text())
        raw["device"].update(iterations_per_loop=1, batch_size=FIXRES_BATCH, n_fns_per_cycle=1,
                             num_parallel_reads=1, shuffle_buffer_size=FIXRES_SHARD_RECORDS)
        raw["model"]["joint_attention_impl"] = "flash"
        cfg_path = os.path.join(tmp, "base_fixres_smoke.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        out_dir = str(CKPT_DIR / "fixres")
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        _, logged = pretrain_fixres_torch.main(
            [cfg_path, "-ckpt", ckpt, "-train_fns", os.path.join(tmp, "shard*.tfrecord"),
             "-output_dir", out_dir, "-num_steps", str(FIXRES_SCRIPT_STEPS), "-warmup", "1",
             "-seed", "0", "-log_every", "1", "--device", device])
        script_s = time.perf_counter() - t0
        script_launches = dict(kernels.LAUNCHES)
        files = sorted(os.listdir(out_dir))
        check(files == [f"ckpt_{s + 1}" for s in range(FIXRES_SCRIPT_STEPS)],
              f"fixres script checkpoints {files}")
        check(load_checkpoint(out_dir)["opt_state"] is None,
              "the fixres script saved its optimizer")
        check([s for s, _ in logged] == list(range(FIXRES_SCRIPT_STEPS))
              and all(math.isfinite(v) for _, i in logged for v in i.values()),
              f"fixres script losses {logged}")
        for name in ("flash_fwd", *BWD_LAUNCHES):
            check(script_launches.get(name, 0) == per_step * FIXRES_SCRIPT_STEPS,
                  f"fixres script: {name} launches {script_launches.get(name, 0)}")

        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        val_args = ["-num_batches", "2", "-batch_size", str(FIXRES_BATCH // 2)]
        losses = validate_torch.main([cfg_path, "-ckpt_dir", out_dir, "-val_fns",
                                      os.path.join(tmp, "shard*.tfrecord"), *val_args,
                                      "--device", device])
        validate_s = time.perf_counter() - t0
        validate_launches = dict(kernels.LAUNCHES)
        check(sorted(losses) == list(range(1, FIXRES_SCRIPT_STEPS + 1)),
              f"validated checkpoints {sorted(losses)}")
        vcfg = load_config(cfg_path)
        vmodel = MerlotReservePretrainer(vcfg, device=device)
        diffs = {}
        for s, info in losses.items():
            load_flax_params(vmodel, pretrained_params(os.path.join(out_dir, f"ckpt_{s}")))
            direct = evaluate_loss(vcfg, TrainState(model=vmodel, optimizer=None),
                                   PretrainLoader(shards, vcfg, FIXRES_BATCH // 2, seed=0,
                                                  repeat=False), num_batches=2)
            diffs[s] = max(abs(direct[k] - info[k]) for k in direct)
            check(diffs[s] <= VALIDATE_TOL,
                  f"validate ckpt_{s}: {info} against evaluate_loss {direct}")
        del vmodel
        torch.cuda.empty_cache()
    res["script"] = {"corpus_s": corpus_s, "seconds": script_s, "losses": logged,
                     "launches": script_launches, "checkpoints": files}
    res["validate"] = {"seconds": validate_s, "losses": losses, "launches": validate_launches,
                       "vs_evaluate_loss": diffs}
    print(f"[fixres] {card}: pretrain_fixres_torch.py, {FIXRES_SCRIPT_STEPS} steps on 2 shards "
          f"of {FIXRES_SHARD_RECORDS} records: {script_s:.1f} s (checkpoint load, loaders, "
          f"steps, a save per step), losses "
          f"{[round(i['total'], 4) for _, i in logged]}; validate_torch.py over {files}: "
          f"{validate_s:.1f} s, totals {[round(v['total'], 4) for v in losses.values()]}, "
          f"against evaluate_loss {diffs}", flush=True)
    return res, fwd, bwd, labels[0][L]


# ---------------------------------------------------------------------------
# 17. downstream: finetuning on records, zero-shot QA
# ---------------------------------------------------------------------------

DOWNSTREAM_RECORDS = 16
VCR_FT_STEPS, TVQA_FT_STEPS = 3, 2
ZERO_SHOT_BATCH = 8
# the rankers' cosine logits, kernel path vs plain path on the same weights
# and records, in bf16 (the joint and span towers on either attention, then
# the projection and a product of unit vectors). Read on an H100 80GB HBM3
# at 700 W: 4.9e-4 (VCR) and 6.1e-4 (TVQA); the limit is about three times
# those. A prediction is held where the plain path's top-two margin exceeds
# twice the limit: a smaller margin may be turned by that error
ZERO_SHOT_LOGIT_TOL = 2e-3


def _held_predictions(kernel_logits, plain_logits):
    """Rows whose prediction the logits' limit cannot flip: the plain path's
    top-two margin above twice ZERO_SHOT_LOGIT_TOL. Returns a bool array."""
    import numpy as np

    top2 = np.sort(plain_logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * ZERO_SHOT_LOGIT_TOL


def phase_downstream(card, ckpt, device="cuda"):
    """From the fixres checkpoint ``ckpt``: scripts/finetune_vcr_torch.py
    (batch 8, 3 steps and a validation pass) and finetune_tvqa_torch.py
    (batch 4, 2 steps and a validation pass) on synthetic records decoded
    by the data library (nvJPEG here), then zero_shot_qa_eval with both
    rankers over 16 records each, kernel path against plain path."""
    import tempfile

    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_finetune_corpus
    from merlot_reserve_tpu_torch.finetune import models as tm
    from merlot_reserve_tpu_torch.finetune import train as tt
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.zero_shot import zero_shot_qa_eval
    from scripts import finetune_tvqa_torch, finetune_vcr_torch

    res = {"finetune": {}, "zero_shot": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_downstream_") as tmp:
        records = {}
        t0 = time.perf_counter()
        for task in ("vcr", "tvqa"):
            records[task] = write_synthetic_finetune_corpus(
                os.path.join(tmp, f"{task}.tfrecord"), load_config("base"), task,
                num_records=DOWNSTREAM_RECORDS, seed=20)
        res["corpus_s"] = time.perf_counter() - t0
        shutil.copy(records["vcr"], CKPT_DIR / "vcr.tfrecord")  # phase 19's leaderboard input

        # finetuning through the scripts, each step timed on both clocks
        original = tt.finetune_train_step
        for task, main, B, steps, expected in (
                ("vcr", finetune_vcr_torch.main, VCR_BATCH, VCR_FT_STEPS,
                 {"loss": math.log(4)}),
                ("tvqa", finetune_tvqa_torch.main, TVQA_BATCH, TVQA_FT_STEPS,
                 {"loss_audio": math.log(5), "loss_text": math.log(5)})):
            events = []

            def timed_step(*args, **kw):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = original(*args, **kw)
                end.record()
                events.append((start, end))
                return out

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            with mock.patch.object(tt, "finetune_train_step", timed_step):
                record = main(["base", "-ckpt", ckpt, "-train_fns", records[task], "-val_fns",
                               records[task], "-ne", "1", "-batch_size", str(B),
                               "-train_size", str(B * steps), "-log_every", "1",
                               "--device", device,
                               # the VCR state, kept for phase 19's leaderboard
                               *(["-output_dir", str(CKPT_DIR / "vcr_finetuned")]
                                 if task == "vcr" else [])])
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            step_device_ms = [a.elapsed_time(b) for a, b in events]
            metrics = [s["metrics"] for s in record["steps"]]
            check(len(metrics) == steps and all(math.isfinite(v) for m_ in metrics
                                                for v in m_.values()),
                  f"finetune {task}: metrics {metrics}")
            for k, ln_n in expected.items():
                check(abs(metrics[0][k] - ln_n) < FINETUNE_LOSS_TOL,
                      f"finetune {task}: step-0 {k} {metrics[0][k]} is not near ln N = {ln_n}")
            val_batches = -(-DOWNSTREAM_RECORDS // B)
            layers = load_config("base").model.joint_num_layers
            check(launches.get("flash_fwd", 0) == layers * (steps + val_batches),
                  f"finetune {task}: flash_fwd launches {launches.get('flash_fwd', 0)} != "
                  f"{layers} x ({steps} steps + {val_batches} validation batches)")
            for name in BWD_LAUNCHES:
                check(launches.get(name, 0) == layers * steps,
                      f"finetune {task}: {name} launches {launches.get(name, 0)}")
            check(launches.get("adam_update", 0) == steps,
                  f"finetune {task}: adam_update launches {launches.get('adam_update', 0)}")
            (evaluation,) = record["evaluations"]
            r = {"batch": B, "steps": steps, "seconds": seconds, "launches": launches,
                 "metrics": metrics, "evaluation": evaluation,
                 "data_ms": [s["data_ms"] for s in record["steps"]],
                 "step_ms_host": [s["step_ms"] for s in record["steps"]],
                 "step_ms_device": step_device_ms, "max_memory_allocated_bytes": peak}
            r["examples_per_s"] = B / float(np.median(r["step_ms_host"][1:])) * 1e3
            res["finetune"][task] = r
            print(f"[downstream] {card}: finetune_{task}_torch.py, batch {B}, {steps} steps "
                  f"and a validation pass over {DOWNSTREAM_RECORDS} records ({seconds:.1f} s "
                  f"with the checkpoint load): data {[round(t, 1) for t in r['data_ms']]} ms "
                  f"per batch on the host, steps {[round(t, 1) for t in r['step_ms_host']]} ms "
                  f"on the host clock and {[round(t, 1) for t in step_device_ms]} ms on the "
                  f"device clock; {r['examples_per_s']:.2f} examples/s; peak "
                  f"{peak / 2**30:.2f} GiB; step-0 { {k: round(metrics[0][k], 5) for k in expected} }"
                  f"; validation {evaluation}; launches {launches}", flush=True)
            torch.cuda.empty_cache()

        # zero-shot QA with both rankers, kernel path against plain path
        params = pretrained_params(ckpt)
        for task, cls, cfg in (
                ("vcr", tm.MerlotReserveVCRZeroShot,
                 load_config("base", output_grid=(18, 32), joint_attention_impl="flash")
                 .replace_data(lang_seq_len=144)),
                ("tvqa", tm.MerlotReserveTVQAZeroShot,
                 load_config("base", joint_attention_impl="flash")
                 .replace_data(lang_seq_len=256, num_segments=7))):
            t0 = time.perf_counter()
            batches = list(finetune_batches([records[task]], cfg, f"{task}_zero_shot",
                                            ZERO_SHOT_BATCH, is_training=False, repeat=False,
                                            return_ids=True))
            data_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
            model = cls(cfg, device=device)
            logits = []
            hook = model.register_forward_hook(lambda mod, args, out: logits.append(
                torch.stack(out, 1) if isinstance(out, tuple) else out))
            zero_shot_qa_eval(model, params, batches, task)  # loads the weights, warms up
            runs = {}
            for path in ("kernel", "plain"):
                logits.clear()
                kernels.LAUNCHES.clear()
                with contextlib.ExitStack() as stack:
                    if path == "plain":
                        for patch in _plain_flash():
                            stack.enter_context(patch)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    metrics, rows = zero_shot_qa_eval(model, None, batches, task)
                    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
                runs[path] = {"metrics": metrics, "rows": rows, "ms_per_batch": ms,
                              "launches": dict(kernels.LAUNCHES),
                              "logits": torch.cat(logits).float().cpu().numpy()}
            hook.remove()
            del model
            torch.cuda.empty_cache()
            k, p = runs["kernel"], runs["plain"]
            per_batch = cfg.model.joint_num_layers + cfg.model.span_num_layers
            check(k["launches"].get("flash_fwd", 0) == per_batch * len(batches),
                  f"zero-shot {task}: flash_fwd launches {k['launches']} != {per_batch} x "
                  f"{len(batches)} batches")
            check(not p["launches"], f"zero-shot {task}: the plain path launched {p['launches']}")
            check(k["metrics"]["n"] == DOWNSTREAM_RECORDS, f"zero-shot {task}: {k['metrics']}")
            err = float(np.abs(k["logits"] - p["logits"]).max())
            check(err <= ZERO_SHOT_LOGIT_TOL,
                  f"zero-shot {task}: logits kernel vs plain {err} > {ZERO_SHOT_LOGIT_TOL}")
            # [examples, (streams or tasks), options]: a prediction per row of each
            held = _held_predictions(k["logits"], p["logits"])
            same = k["logits"].argmax(-1) == p["logits"].argmax(-1)
            check(bool(same[held].all()),
                  f"zero-shot {task}: predictions differ where the margin holds them")
            if task == "tvqa":  # joint: held where both streams are held and agree
                both = held.all(1) & (p["logits"].argmax(-1)[:, 0] == p["logits"].argmax(-1)[:, 1])
                joint = [(a["pred_joint"], b["pred_joint"]) for a, b in zip(k["rows"], p["rows"])]
                check(all(a == b for (a, b), h in zip(joint, both) if h),
                      f"zero-shot tvqa: joint predictions differ where both streams hold")
            r = {"batch": ZERO_SHOT_BATCH, "batches": len(batches), "data_ms_per_batch": data_ms,
                 "ms_per_batch": k["ms_per_batch"], "plain_ms_per_batch": p["ms_per_batch"],
                 "examples_per_s": ZERO_SHOT_BATCH / k["ms_per_batch"] * 1e3,
                 "launches": k["launches"],
                 "flash_fwd_per_batch": k["launches"].get("flash_fwd", 0) / len(batches),
                 "metrics": k["metrics"], "plain_metrics": p["metrics"],
                 "logit_max_abs_err": err, "rows_held": int(held.sum()),
                 "rows": int(held.size), "predictions_equal": int(same.sum())}
            res["zero_shot"][task] = r
            print(f"[downstream] {card}: zero_shot_qa_eval {task}, {DOWNSTREAM_RECORDS} records "
                  f"in batches of {ZERO_SHOT_BATCH}: {r['ms_per_batch']:.1f} ms per batch "
                  f"({r['examples_per_s']:.1f} examples/s; plain path "
                  f"{r['plain_ms_per_batch']:.1f} ms), data {data_ms:.1f} ms per batch on the "
                  f"host; {r['flash_fwd_per_batch']:.0f} flash_fwd per batch; logits kernel vs "
                  f"plain {err:.2e}; predictions equal {r['predictions_equal']} of {r['rows']} "
                  f"({r['rows_held']} held by their margin); metrics {k['metrics']}", flush=True)
    return res


# ---------------------------------------------------------------------------
# 18. created records: raw video arrays and annotations to records, records
# to a training step through the loader's process pool
# ---------------------------------------------------------------------------

CREATED_VIDEOS = 8
CREATED_DURATION = (50.0, 90.0)  # seconds, drawn per video
CREATED_FRAME = (360, 640)
CREATED_SR = 22050
CREATED_SHARDS = 2
CREATED_BATCH, CREATED_STEPS = 8, 6  # the step time: median of steps 2-6
CREATED_LOADER_BATCHES = 10  # compared and timed per loader, after the first
CREATED_LOADER_WINDOW = 5  # the spread: the rate over each 5 of those batches
CREATED_WORKERS = 8
EMBED_FRAMES = 64  # timed on the card
EMBED_CPU_FRAMES = 16  # held against the CPU
# the embedder in true f32 on the card against the CPU: relative to the
# largest feature (convolutions summed in other orders)
EMBED_REL_TOL = 1e-4
# log-mels card vs CPU: FRONT_LOGMEL_TOL absolute; a magic number is 255 over
# a percentile of at least 1, so it moves by at most that much relative
CREATED_MAGIC_RTOL = FRONT_LOGMEL_TOL
PREP_ANNOTATIONS = 4
_WORDS = ("the a we this is that video and then to of in it you so now look here next "
          "cook pasta water pan heat salt stir wait add sauce cheese plate serve eat "
          "good very just make sure".split())


def _created_words(rng, duration):
    """Timed words: dense (about 2.5 a second) with one sparse stretch,
    words 3.1 s apart (windows at speed 2) or 8 s apart (speed 3)."""
    s0 = float(rng.uniform(5.0, duration - 30.0))
    s1, step = s0 + float(rng.uniform(15.0, 25.0)), (3.1, 8.0)[int(rng.integers(2))]
    words, t = [], 0.0
    while t < duration:
        w = _WORDS[int(rng.integers(len(_WORDS)))]
        words.append({"word": w, "start": t, "end": t + float(rng.uniform(0.1, 0.3))})
        t += step if s0 <= t < s1 else float(rng.uniform(0.25, 0.55))
    return words


def _created_videos(rng):
    """CREATED_VIDEOS videos of 50-90 s: 360x640 frames (one per window; a
    drifting gradient with noise, the last video static), PCM, timed words."""
    from merlot_reserve_tpu_torch.dataset_creation.process import split_into_windows

    import numpy as np

    h, w = CREATED_FRAME
    yy, xx = np.mgrid[0:h, 0:w]
    videos = []
    for v in range(CREATED_VIDEOS):
        duration = float(rng.uniform(*CREATED_DURATION))
        words = _created_words(rng, duration)
        n = len(split_into_windows(words, duration))
        frames = np.empty((n, h, w, 3), np.uint8)
        for i in range(n):
            shift = 0 if v == CREATED_VIDEOS - 1 else 37 * i
            base = np.stack([(yy + shift) % 256, (xx * 3 + 2 * shift) % 256,
                             (yy + xx + v * 40) % 256], -1)
            frames[i] = np.clip(base + rng.integers(-8, 9, base.shape), 0, 255)
        t = np.arange(int(CREATED_SR * duration)) / CREATED_SR
        pcm = (0.2 * np.sin(2 * np.pi * 220 * (1 + v) * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        videos.append({"id": f"video{v}", "frames": frames, "pcm": pcm, "words": words,
                       "duration": duration})
    return videos


def _text_corpus(path, rng, docs=48, words=400):
    import gzip

    with gzip.open(path, "wt") as f:
        for i in range(docs):
            text = " ".join(_WORDS[int(j)] for j in rng.integers(len(_WORDS), size=words))
            f.write(json.dumps({"text": f"Document {i}. {text}.",
                                "meta": {"pile_set_name": "Pile-CC"}}) + "\n")


def _same_batch(a, b):
    import numpy as np
    import torch

    if a.keys() != b.keys():
        return False
    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else np.array_equal(a[k], b[k]) for k in a)


def _loader_run(it, n, want=None):
    """The next ``n`` batches of a loader's iterator ``it``, which is closed
    at the end (the workers stop): (batches/s over all ``n``, the rate over
    each ``CREATED_LOADER_WINDOW`` of them, the batches). With ``want``
    each batch is held against its batch there instead of kept."""
    stamps, batches = [time.perf_counter()], []
    for i in range(n):
        b = next(it)
        stamps.append(time.perf_counter())
        if want is None:
            batches.append(b)
        else:
            check(_same_batch(want[i], b), f"created: batch {i + 1} from the processes differs")
    it.close()
    w = CREATED_LOADER_WINDOW
    windows = [w / (stamps[i + w] - stamps[i]) for i in range(0, n - w + 1, w)]
    return n / (stamps[-1] - stamps[0]), windows, batches


def _spread(xs):
    return f"{min(xs):.2f}-{max(xs):.2f}"


def _prep_records(tmp, rng, device):
    """A few synthetic VCR and TVQA annotations through the prep scripts'
    per-annotation functions into records; one batch of each read by
    finetune_batches, against a batch of the synthetic writer's records at
    the same config: the same keys, shapes and dtypes."""
    import numpy as np

    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_finetune_corpus
    from merlot_reserve_tpu_torch.data.tfrecord import write_records
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from scripts.prep_tvqa_torch import tvqa_record
    from scripts.prep_vcr_torch import vcr_record

    h, w = CREATED_FRAME
    out = {}
    t0 = time.perf_counter()
    vcr = []
    for i in range(PREP_ANNOTATIONS):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ann = {"id": f"vcr-{i}", "boxes": [[10, 20, 200, 300], [300, 40, 600, 350]],
               "names": ["person", "dog"], "qa_query": ["Why", "is", [0], "near", [1], "?"],
               "qa_choices": [["Because", [1], "is", "hungry", "."]] * 4, "qa_label": i % 4,
               "qar_query": ["Why", "?"], "qar_choices": [["It", "'s", "late", "."]] * 4,
               "qar_label": (i + 1) % 4}
        vcr.append(vcr_record(ann, img))
    out["vcr_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tvqa = []
    for i in range(PREP_ANNOTATIONS):
        duration = 60.0
        frames = rng.integers(0, 256, (7, h, w, 3), dtype=np.uint8)
        pcm = (0.1 * rng.standard_normal(int(CREATED_SR * duration))).astype(np.float32)
        ann = {"id": f"tvqa-{i}", "ts_start": 10.0 + 5 * i, "ts_end": 16.0 + 5 * i,
               "question": "What is she cooking?", "answers": ["pasta", "rice", "soup",
                                                              "eggs", "bread"],
               "label": i % 5, "subtitles": [{"word": _WORDS[j % len(_WORDS)],
                                              "start": 8.0 + j, "end": 8.4 + j}
                                             for j in range(30)]}
        tvqa.append(tvqa_record(ann, frames, pcm, duration, device=device))
    out["tvqa_s"] = time.perf_counter() - t0
    for task, records in (("vcr", vcr), ("tvqa", tvqa)):
        cfg = _finetune_config(task)
        path = os.path.join(tmp, f"prep_{task}.tfrecord")
        write_records(path, records)
        ref = write_synthetic_finetune_corpus(os.path.join(tmp, f"ref_{task}.tfrecord"), cfg,
                                              task, num_records=PREP_ANNOTATIONS, seed=3)
        got = next(finetune_batches([path], cfg, task, PREP_ANNOTATIONS, repeat=False))
        want = next(finetune_batches([ref], cfg, task, PREP_ANNOTATIONS, repeat=False))
        check(got.keys() == want.keys(), f"prep {task}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            check(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype,
                  f"prep {task} {k}: {got[k].dtype} {got[k].shape} != "
                  f"{want[k].dtype} {want[k].shape}")
            check(np.isfinite(got[k]).all(), f"prep {task} {k}: not finite")
        out[task] = {k: list(v.shape) for k, v in got.items()}
    print(f"[created] prep scripts: {PREP_ANNOTATIONS} VCR records in {out['vcr_s']:.2f} s, "
          f"{PREP_ANNOTATIONS} TVQA records in {out['tvqa_s']:.2f} s (spectrograms on the "
          f"card); finetune_batches reads both at the synthetic records' shapes: VCR "
          f"image {out['vcr']['image']}, TVQA images {out['tvqa']['images']} audio "
          f"{out['tvqa']['audio_clips']}", flush=True)
    return out


def phase_created(card, device="cuda"):
    """Raw video arrays to records and records to the card: 8 synthetic
    videos through ``process_video_arrays`` (log-mels on the card against
    the CPU), the MobileNetV2 embedder and the static-video filter on the
    card against the CPU, ``pack_chunks`` with a random-text stream from
    ``token_blob_iterator`` into ``ShufflingRecordWriter`` shards; the
    records through ``PretrainLoader`` on threads and on spawned processes
    (batch for batch equal, both timed alone, the device memory each worker
    takes), then ``run_pretraining`` at full base width fed by the
    processes; last the prep scripts' per-annotation functions. (``device``:
    "cpu" for a rehearsal at tiny widths with the timers patched.)"""
    import itertools
    import multiprocessing
    import tempfile

    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.loader import DeviceFeed, PretrainLoader
    from merlot_reserve_tpu_torch.data.tfrecord import ShufflingRecordWriter
    from merlot_reserve_tpu_torch.dataset_creation import filters
    from merlot_reserve_tpu_torch.dataset_creation.frame_embedder import MobileNetV2Embedder
    from merlot_reserve_tpu_torch.dataset_creation.process import (chunks_to_record,
                                                                   pack_chunks,
                                                                   process_video_arrays,
                                                                   split_into_windows,
                                                                   window_log_mels,
                                                                   window_waveform)
    from merlot_reserve_tpu_torch.dataset_creation.text_corpus import token_blob_iterator
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.training.trainer import train_step

    res = {}
    rng = np.random.default_rng(18)
    t0 = time.perf_counter()
    videos = _created_videos(rng)
    res["videos"] = {"count": len(videos), "seconds": [v["duration"] for v in videos],
                     "make_s": time.perf_counter() - t0}

    # videos -> chunks on the card, timed; one video again on the CPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = [process_video_arrays(v["frames"], v["pcm"], v["words"], v["duration"],
                                   youtube_id=v["id"], title=f"how to cook {v['id']}",
                                   device=device) for v in videos]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_chunks = sum(len(c) for c in chunks)
    speeds = sorted({c.playback_speed for cs in chunks for c in cs})
    check(speeds == [1, 2, 3], f"created: playback speeds {speeds}, want 1-3")
    res["process"] = {"segments": n_chunks, "seconds": secs, "segments_per_s": n_chunks / secs,
                      "speeds": {s: sum(c.playback_speed == s for cs in chunks for c in cs)
                                 for s in speeds}}
    cpu_chunks = process_video_arrays(videos[0]["frames"], videos[0]["pcm"], videos[0]["words"],
                                      videos[0]["duration"], youtube_id=videos[0]["id"],
                                      title=f"how to cook {videos[0]['id']}", device="cpu")
    for a, b in zip(chunks[0], cpu_chunks):
        check((a.tok_ids, a.tok_start_times, a.playback_speed, a.start_time)
              == (b.tok_ids, b.tok_start_times, b.playback_speed, b.start_time),
              "created: a chunk's tokens differ between the card and the CPU")
        check(abs(a.magic_number - b.magic_number) <= CREATED_MAGIC_RTOL * b.magic_number,
              f"created: magic {a.magic_number} on the card, {b.magic_number} on the CPU")
    mel_err = {}
    for speed in speeds:
        wins = [(v, w) for v in videos for w in split_into_windows(v["words"], v["duration"])
                if w["playback_speed"] == speed][:4]
        wavs = np.stack([window_waveform(v["pcm"], w, CREATED_SR) for v, w in wins])
        mel_err[speed] = float(np.abs(window_log_mels(wavs, speed, CREATED_SR, device)
                                      - window_log_mels(wavs, speed, CREATED_SR, "cpu")).max())
        check(mel_err[speed] <= FRONT_LOGMEL_TOL,
              f"created: log-mel at speed {speed}, card vs CPU {mel_err[speed]}")
    res["process"]["log_mel_card_vs_cpu"] = mel_err
    print(f"[created] {card}: {len(videos)} videos of "
          f"{min(res['videos']['seconds']):.1f}-{max(res['videos']['seconds']):.1f} s "
          f"({CREATED_FRAME[0]}x{CREATED_FRAME[1]} frames) -> {n_chunks} segments "
          f"{res['process']['speeds']} by speed in {secs:.2f} s: "
          f"{res['process']['segments_per_s']:.1f} segments/s; log-mel card vs CPU max "
          f"|err| {mel_err}; a video's chunks on the CPU: same tokens, magic within "
          f"{CREATED_MAGIC_RTOL}", flush=True)

    # the embedder and the static-video filter, card against CPU
    emb = MobileNetV2Embedder(seed=0, device=device)
    emb_cpu = MobileNetV2Embedder({k: v.cpu() for k, v in emb.model.state_dict().items()},
                                  device="cpu")
    pool = np.concatenate([v["frames"] for v in videos])[:EMBED_FRAMES]
    frames_dev = torch.as_tensor(pool).to(device)
    embed_ms = cuda_time_ms(lambda: emb._forward(frames_dev), iters=5, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb(pool)
    embed_host_ms = (time.perf_counter() - t0) * 1e3
    feats = emb(pool[:EMBED_CPU_FRAMES])
    feats_cpu = emb_cpu(pool[:EMBED_CPU_FRAMES])
    emb_err = float(np.abs(feats - feats_cpu).max() / np.abs(feats_cpu).max())
    check(emb_err <= EMBED_REL_TOL, f"created: embedder card vs CPU {emb_err}")
    decisions = []
    for v in videos:
        clip = v["frames"][:EMBED_CPU_FRAMES // 2]
        cos = (filters.mean_pairwise_cosine(emb(clip)), filters.mean_pairwise_cosine(emb_cpu(clip)))
        card_static = filters.is_static_video(clip, frame_embedder=emb)
        check(card_static == filters.is_static_video(clip, frame_embedder=emb_cpu),
              f"created: {v['id']} static-video decisions differ, cosines {cos}")
        decisions.append({"video": v["id"], "static": card_static, "cosine_card": cos[0],
                          "cosine_cpu": cos[1]})
    res["embedder"] = {"ms_per_64_frames_device": embed_ms * EMBED_FRAMES / len(pool),
                       "ms_per_64_frames_host": embed_host_ms * EMBED_FRAMES / len(pool),
                       "card_vs_cpu_rel_err": emb_err, "decisions": decisions}
    print(f"[created] {card}: MobileNetV2 (IEEE f32) {res['embedder']['ms_per_64_frames_device']:.2f} "
          f"ms per {EMBED_FRAMES} frames of {CREATED_FRAME[0]}x{CREATED_FRAME[1]} on the device "
          f"clock, {res['embedder']['ms_per_64_frames_host']:.2f} ms with the copy on the host "
          f"clock; card vs CPU {emb_err:.2e} of the largest feature; static-video decisions "
          f"equal {[d['static'] for d in decisions]}", flush=True)
    del emb, emb_cpu, frames_dev

    cfg = load_config("base", joint_attention_impl="flash")
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_created_") as tmp:
        # chunks -> packed records with a random-text stream -> shuffled shards
        t0 = time.perf_counter()
        corpus = os.path.join(tmp, "pile.jsonl.gz")
        _text_corpus(corpus, rng)
        blobs = itertools.cycle(list(token_blob_iterator([corpus])))
        files = [os.path.join(tmp, f"created{i}.tfrecord") for i in range(CREATED_SHARDS)]
        writers = [ShufflingRecordWriter(f, buffer_size=4, seed=i) for i, f in enumerate(files)]
        n_records = 0
        for group in pack_chunks(iter(chunks)):
            writers[n_records % CREATED_SHARDS].write(
                chunks_to_record(group, [next(blobs) for _ in group]))
            n_records += 1
        for w_ in writers:
            w_.close()
        check(n_records >= CREATED_SHARDS, f"created: {n_records} records")
        res["records"] = {"count": n_records, "seconds": time.perf_counter() - t0,
                          "bytes": sum(os.path.getsize(f) for f in files)}
        print(f"[created] {n_records} records of 16 segments ({res['records']['bytes'] / 2**20:.1f}"
              f" MiB, {CREATED_SHARDS} shuffled shards) in {res['records']['seconds']:.2f} s",
              flush=True)

        # the loader alone: threads, then spawned processes, batch for batch
        kw = dict(seed=0, num_workers=CREATED_WORKERS, use_bfloat16=cfg.model.use_bfloat16,
                  files_per_cycle=CREATED_SHARDS, parallel_reads=CREATED_SHARDS,
                  shuffle_buffer=4)
        it = iter(PretrainLoader(files, cfg, CREATED_BATCH, **kw))
        t0 = time.perf_counter()
        want = [next(it)]
        first_t = time.perf_counter() - t0
        rate_t, windows_t, rest = _loader_run(it, CREATED_LOADER_BATCHES)
        want += rest
        torch.cuda.synchronize()
        free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        it = iter(PretrainLoader(files, cfg, CREATED_BATCH, use_processes=True, **kw))
        t0 = time.perf_counter()
        check(_same_batch(want[0], next(it)), "created: batch 0 from the processes differs")
        first_p = time.perf_counter() - t0
        torch.cuda.synchronize()
        worker_bytes = ((free0 - torch.cuda.mem_get_info()[0])
                        - (torch.cuda.memory_reserved() - reserved0)) / CREATED_WORKERS
        rate_p, windows_p, _ = _loader_run(it, CREATED_LOADER_BATCHES, want=want[1:])
        check(multiprocessing.active_children() == [], "created: loader workers still running")
        del want, rest
        res["loader"] = {"threads": {"first_batch_s": first_t, "batches_per_s": rate_t,
                                     "batches_per_s_by_window": windows_t},
                         "processes": {"first_batch_s": first_p, "batches_per_s": rate_p,
                                       "batches_per_s_by_window": windows_p,
                                       "device_bytes_per_worker": worker_bytes},
                         "workers": CREATED_WORKERS,
                         "batches_equal": CREATED_LOADER_BATCHES + 1}
        print(f"[created] {card}: the loader alone, {CREATED_WORKERS} workers, batch "
              f"{CREATED_BATCH}, {CREATED_LOADER_BATCHES} batches after the first: threads "
              f"{rate_t:.2f} batches/s ({_spread(windows_t)} over each {CREATED_LOADER_WINDOW}; "
              f"first batch {first_t:.2f} s), spawned processes {rate_p:.2f} batches/s "
              f"({_spread(windows_p)}; first batch, with the spawn, {first_p:.2f} s); "
              f"{CREATED_LOADER_BATCHES + 1} batches equal; device memory per worker "
              f"{worker_bytes / 2**20:.1f} MiB", flush=True)

        # training fed by the processes
        expected = _expected_init_losses(cfg, CREATED_BATCH)
        per_step = cfg.model.joint_num_layers + cfg.model.span_num_layers
        narrow = {"images": torch.bfloat16, "audio_clips": torch.bfloat16}
        source = iter(PretrainLoader(files, cfg, CREATED_BATCH, use_processes=True, **kw))
        feed = DeviceFeed(source, device, narrow=narrow)
        last, logged, stamps = {}, [], []

        def keep(batches):
            for b in batches:
                last["batch"] = b
                yield b

        def log_fn(step, metrics):
            stamps.append(time.perf_counter())
            logged.append(metrics)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = run_pretraining(cfg, keep(iter(feed)), num_steps=CREATED_STEPS, log_fn=log_fn,
                                log_every=0, device=device, seed=0)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        source.close()
        peak = torch.cuda.max_memory_allocated()
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
        check(len(logged) == CREATED_STEPS, f"created: {len(logged)} steps")
        check(all(math.isfinite(v) for m_ in logged for v in m_.values()),
              "created: non-finite loss")
        for head, ln_n in expected.items():
            check(abs(logged[0][head] - ln_n) < DATA_INIT_LOSS_TOL,
                  f"created: step-0 {head} loss {logged[0][head]} is not near ln N = {ln_n}")
        for k in ("flash_fwd", *BWD_LAUNCHES):
            check(launches.get(k, 0) == per_step * CREATED_STEPS,
                  f"created: {k} launches {launches.get(k, 0)} != {per_step} x {CREATED_STEPS}")
        check(launches.get("adam_update", 0) == CREATED_STEPS,
              f"created: adam_update launches {launches.get('adam_update', 0)}")
        for k in (*BWD_LAUNCHES_F32, "ring_fwd"):
            check(launches.get(k, 0) == 0, f"created: launched {k}")
        batch = last["batch"]
        device_ms = cuda_time_ms(lambda: train_step(state, batch), iters=2, warmup=1)
        host_med = float(np.median(step_ms[1:]))
        res["train"] = {"launches": launches, "losses": logged, "step_ms_host": step_ms,
                        "step_ms_host_median": host_med,
                        "step_ms_host_spread": [min(step_ms[1:]), max(step_ms[1:])],
                        "step_ms_device": device_ms,
                        "examples_per_s": CREATED_BATCH / host_med * 1e3,
                        "max_memory_allocated_bytes": peak, "h2d_ms": feed.copy_ms(),
                        "seconds": time.perf_counter() - t0}
        print(f"[created] {card}: run_pretraining on the created records, batch "
              f"{CREATED_BATCH}, fed by {CREATED_WORKERS} spawned workers: "
              f"{host_med:.1f} ms per step on the host clock (median of steps 2-"
              f"{CREATED_STEPS}, {_spread(step_ms[1:])}; all {[round(t, 1) for t in step_ms]}), "
              f"{device_ms:.1f} ms on "
              f"the device clock; {res['train']['examples_per_s']:.2f} examples/s; launches "
              f"per step { {k: v / CREATED_STEPS for k, v in launches.items()} }; peak "
              f"{peak / 2**30:.2f} GiB; step-0 losses "
              f"{ {k: round(logged[0][k], 4) for k in expected} }", flush=True)
        del state, batch, feed
        torch.cuda.empty_cache()
        res["prep"] = _prep_records(tmp, rng, device)
    res["launches"] = res["train"]["launches"]
    return res


# ---------------------------------------------------------------------------
# 19. serving artifacts, checkpoint tools and the VCR leaderboard
# ---------------------------------------------------------------------------

EXPORT_BATCH, EXPORT_OPTIONS = 8, 64
# the exported programs against the live model on the same (f16-rounded)
# parameters: the same operations and kernels, so 0 is expected
EXPORT_TOL = 1e-3
# calls timed on each clock, on each side (about 2 s a side at full width)
EXPORT_TIMED = 30
LEADERBOARD_ANNOTS = 4

# Run in a fresh process: load the artifact (no model code), serve 8 and 3
# requests and the label space, count the launches of each call, time the
# exported batch on both clocks; fail if a models module got imported.
# argv: the checkout, the artifact, the directory with requests.npz, the
# device (the card; "cpu" in a rehearsal, where the device clock is not read).
_EXPORTED_SERVER = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from chip_smoke import EXPORT_TIMED, cuda_time_ms, stack_requests
from merlot_reserve_tpu_torch import kernels
from merlot_reserve_tpu_torch.export import load_serving_artifact

art, io, device = sys.argv[2:5]
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
data = np.load(io + "/requests.npz")
fields = ("images", "audio_clips", "tokens", "subseg_idxs")
req = {n: [{k: data[f"{n}_{k}"][i] for k in fields} for i in range(len(data[f"{n}_tokens"]))]
       for n in ("full", "three")}
t0 = time.perf_counter()
svc = load_serving_artifact(art, device=device)
sync()
load_s = time.perf_counter() - t0
outs, launches = {}, {}
for name, call in (("full", lambda: svc.embed(req["full"])),
                   ("three", lambda: svc.embed(req["three"])),
                   ("label", lambda: svc.label_space(data["options"]))):
    kernels.LAUNCHES.clear()
    outs[name] = call()
    sync()
    launches[name] = dict(kernels.LAUNCHES)
host_ms = []
for _ in range(EXPORT_TIMED):
    t = time.perf_counter()
    svc.embed(req["full"])
    host_ms.append((time.perf_counter() - t) * 1e3)
device_ms = None
if device == "cuda":
    with torch.inference_mode():
        inputs = stack_requests(req["full"], device)
        device_ms = cuda_time_ms(lambda: svc.embed_program(*svc.params, *inputs),
                                 iters=EXPORT_TIMED, warmup=1)
np.savez(io + "/exported.npz", **outs)
models = sorted(m for m in sys.modules if m.startswith("merlot_reserve_tpu_torch.models"))
print(json.dumps({"load_s": load_s, "launches": launches, "host_ms": host_ms,
                  "device_ms": device_ms, "models_modules": models}))
if models:
    sys.exit(f"the artifact's loader imported model code: {models}")
"""


def _leaderboard_records(path, rng):
    """LEADERBOARD_ANNOTS annotations written by ``prep_vcr_torch.vcr_record``
    at the leaderboard's 18x32 grid size, the rationale query conditioned on
    each of the 4 answers (ids "test-<n>-cond_<answer>")."""
    from merlot_reserve_tpu_torch.data.tfrecord import write_records
    from scripts.prep_vcr_torch import vcr_record

    say = lambda n: [str(w) for w in rng.choice(_WORDS, n)]
    records = []
    for n in range(LEADERBOARD_ANNOTS):
        image = _smooth_pixels(288, 512)
        for c in range(4):
            ann = {"id": f"test-{n}-cond_{c}", "boxes": [[20, 30, 200, 260]],
                   "names": ["person"], "qa_query": ["Why", "is", [0], "here", "?"],
                   "qa_choices": [say(6) for _ in range(4)], "qa_label": 0,
                   "qar_query": say(8) + ["?"], "qar_choices": [say(8) for _ in range(4)],
                   "qar_label": 0}
            records.append(vcr_record(ann, image))
    write_records(path, records)
    return path


def phase_export(card, pretrained=None, vcr=None, device="cuda"):
    """The serving artifact of a full-width base model (phase 13's
    ``ckpt_4`` in ``pretrained``, or a seeded init): exported on the card,
    loaded and served in a fresh process with no model code, against the
    live ``VideoEmbedService`` and ``embed_text_spans_only``; the launches
    of each exported call; ``convert_checkpoint_torch`` --to-layers then
    --to-scan on the checkpoint, bit for bit; ``vcr_leaderboard_torch``
    with phase 17's finetuned VCR state (``vcr``) on phase 17's records and
    on records of the prep script with leaderboard ids."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.export import export_serving_artifact
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.serving import VideoEmbedService
    from merlot_reserve_tpu_torch.tokenizer import encode_batch_padded
    from merlot_reserve_tpu_torch.utils import checkpoint as ckpt_lib
    from merlot_reserve_tpu_torch.utils.weights import (flax_tensors_from_state_dict,
                                                        load_flax_params)
    from scripts.convert_checkpoint_torch import main as convert_main
    from scripts.vcr_leaderboard_torch import main as leaderboard_main

    cfg = load_config("base")
    m = cfg.model
    res = {"batch": EXPORT_BATCH, "num_options": EXPORT_OPTIONS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        if pretrained is None:  # a seeded init, written as a checkpoint at step 4
            seeded = MerlotReserve(cfg, device=device, seed=0)
            tree = flax_tensors_from_state_dict(dict(seeded.named_parameters()))
            pretrained = os.path.dirname(ckpt_lib.save_checkpoint(
                {"step": torch.tensor(CKPT_STEPS, dtype=torch.int32), "params": tree},
                os.path.join(tmp, "seeded")))
            del seeded, tree
        res["weights"] = pretrained
        params = ckpt_lib.load_checkpoint(pretrained, step=CKPT_STEPS)["params"]
        live = MerlotReserve(cfg, device=device)
        load_flax_params(live, params)
        full, three = make_requests(cfg, EXPORT_BATCH, 40), make_requests(cfg, 3, 41)
        options = encode_batch_padded(ZERO_SHOT_OPTIONS, length=m.text_span_length)

        # export on the card
        art = os.path.join(tmp, "artifact")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manifest = export_serving_artifact(MerlotReserve(cfg, device="meta"), params, full[0],
                                           art, batch_size=EXPORT_BATCH,
                                           num_options=EXPORT_OPTIONS, device=device)
        res["export_s"] = time.perf_counter() - t0
        res["artifact_bytes"] = {f: os.path.getsize(os.path.join(art, f))
                                 for f in sorted(os.listdir(art))}
        check(manifest["platforms"] == [torch.device(device).type],
              f"platforms {manifest['platforms']}")

        # served from a fresh process
        np.savez(os.path.join(tmp, "requests.npz"), options=options,
                 **{f"{n}_{k}": np.stack([v[k] for v in req]) for n, req in
                    (("full", full), ("three", three)) for k in full[0]})
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _EXPORTED_SERVER, str(ROOT), art, tmp,
                               str(torch.device(device).type)],
                              capture_output=True, text=True, timeout=900)
        res["server_process_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"the exported server failed ({proc.returncode}):\n"
                                    f"{proc.stderr[-4000:]}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        with np.load(os.path.join(tmp, "exported.npz")) as f:
            exported = dict(f)

        # the live model on the same parameters, counted
        service = VideoEmbedService(live, batch_size=EXPORT_BATCH, device=device)
        live_out = {"full": service.embed(full), "three": service.embed(three)}
        opts = np.zeros((EXPORT_OPTIONS, m.text_span_length), np.int64)
        opts[:len(options)] = options
        kernels.LAUNCHES.clear()
        with torch.inference_mode():
            live_out["label"] = live.embed_text_spans_only(torch.from_numpy(opts).to(device))[
                :len(options)].float().cpu().numpy()
        torch.cuda.synchronize()
        live_label_launches = dict(kernels.LAUNCHES)
        host_ms = []
        for _ in range(EXPORT_TIMED):
            t = time.perf_counter()
            service.embed(full)
            host_ms.append((time.perf_counter() - t) * 1e3)
        with torch.inference_mode():
            inputs = stack_requests(full, device)
            device_ms = cuda_time_ms(lambda: live.batch_embed_video(*inputs),
                                     iters=EXPORT_TIMED, warmup=1)

        diffs = {k: float(np.abs(exported[k] - live_out[k]).max()) for k in live_out}
        launches = served["launches"]
        print(f"[export] {card}: exported in {res['export_s']:.2f} s "
              f"({sum(res['artifact_bytes'].values())} bytes: {res['artifact_bytes']}); served "
              f"from a fresh process ({res['server_process_s']:.1f} s, loaded in "
              f"{served['load_s']:.2f} s, models modules {served['models_modules']}); launches "
              f"per exported call {launches}, the live label space {live_label_launches}; "
              f"exported vs live max abs diff {diffs}", flush=True)
        for name, n in (("full", EXPORT_BATCH), ("three", 3)):
            check(exported[name].shape == (n, 160, m.hidden_size) and
                  np.isfinite(exported[name]).all(), f"exported {name}: {exported[name].shape}")
            check(launches[name] == {"flash_fwd": m.joint_num_layers},
                  f"exported embed of {n}: launches {launches[name]} != "
                  f"{m.joint_num_layers} flash_fwd")
        check(launches["label"] == live_label_launches == {"flash_fwd": m.span_num_layers},
              f"label space launches: exported {launches['label']}, live {live_label_launches}")
        for k, d in diffs.items():
            check(d <= EXPORT_TOL, f"exported {k} vs live: {d} > {EXPORT_TOL}")
        norms = np.linalg.norm(exported["full"], axis=-1)
        check(np.abs(norms - 1).max() < 1e-2, f"row norms off 1 by {np.abs(norms - 1).max()}")
        res.update(launches_per_call=launches, live_label_launches=live_label_launches,
                   max_abs_diff_vs_live=diffs, server_load_s=served["load_s"],
                   exported_host_ms=served["host_ms"], exported_device_ms=served["device_ms"],
                   live_host_ms=host_ms, live_device_ms=device_ms)
        res["exported_host_ms_median"] = float(np.median(served["host_ms"]))
        res["live_host_ms_median"] = float(np.median(host_ms))
        spread = lambda ms: f"{np.median(ms):.2f} ms host ({min(ms):.2f}-{max(ms):.2f})"
        print(f"[export] {card}: a batch of {EXPORT_BATCH}, median (min-max) of "
              f"{EXPORT_TIMED} calls: exported {spread(served['host_ms'])}, "
              f"{served['device_ms']} ms device; live service {spread(host_ms)}, "
              f"{device_ms:.2f} ms device (each in its own process)", flush=True)
        del live, service
        torch.cuda.empty_cache()

        # the converter: to the reference's layout and back, bit for bit
        t0 = time.perf_counter()
        layers = convert_main([pretrained, os.path.join(tmp, "layers"), "--step",
                               str(CKPT_STEPS), "--to-layers", "--no-optimizer"])
        back = convert_main([layers, os.path.join(tmp, "scan"), "--to-scan"])
        res["convert_s"] = time.perf_counter() - t0
        per_layer = ckpt_lib.load_checkpoint(layers)["params"]
        check("layer_00" in per_layer["joint_transformer"] and
              "layers" not in per_layer["joint_transformer"],
              f"--to-layers: joint_transformer holds {sorted(per_layer['joint_transformer'])}")
        restored = ckpt_lib.load_checkpoint(back)
        check(restored["opt_state"] is None, "--no-optimizer kept the optimizer state")
        got = dict(ckpt_lib.flat_leaves(restored["params"]))
        want = dict(ckpt_lib.flat_leaves(params))
        check(sorted(got) == sorted(want), "--to-layers then --to-scan: other leaves")
        same = [_bits_equal(got[k], want[k]) for k in want]
        check(all(same), f"--to-layers then --to-scan: {same.count(False)} leaves differ")
        print(f"[export] convert_checkpoint_torch --to-layers --no-optimizer then --to-scan: "
              f"{len(same)} leaves back bit for bit ({res['convert_s']:.1f} s)", flush=True)

        # the leaderboard from phase 17's finetuned VCR state
        res["leaderboard"] = {}
        if vcr is None:
            print("[export] no finetuned VCR state: leaderboard not run", flush=True)
            return res
        lb_records = _leaderboard_records(os.path.join(tmp, "test.tfrecord"),
                                          np.random.default_rng(42))
        for name, files, annots in (("phase17_records", str(CKPT_DIR / "vcr.tfrecord"), 1),
                                    ("prep_records", lb_records, LEADERBOARD_ANNOTS)):
            out_csv = os.path.join(tmp, f"{name}.csv")
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            merged = leaderboard_main(["base", "-ckpt", vcr, "-test_fns", files, "-out", out_csv,
                                       "-batch_size", "8", "--device", device])
            seconds = time.perf_counter() - t0
            with open(out_csv) as f:
                cols, *rows = list(csv.reader(f))
            n_records = DOWNSTREAM_RECORDS if annots == 1 else 4 * annots
            batches = -(-n_records // 8)
            lb_launches = dict(kernels.LAUNCHES)
            check(len(rows) == annots == len(merged) and
                  len({r[0] for r in rows}) == len(rows), f"leaderboard {name}: rows {rows}")
            check(len(cols) == 1 + 4 + 4 * (4 if annots > 1 else 1),
                  f"leaderboard {name}: columns {cols}")
            probs = np.asarray([r[1:] for r in rows], np.float64)
            check(np.isfinite(probs).all() and (np.abs(probs[:, :4].sum(1) - 1) < 1e-2).all(),
                  f"leaderboard {name}: answer probabilities {probs[:, :4]}")
            check(lb_launches.get("flash_fwd", 0) == m.joint_num_layers * batches,
                  f"leaderboard {name}: launches {lb_launches}")
            res["leaderboard"][name] = {"rows": len(rows), "columns": len(cols),
                                        "records": n_records, "seconds": seconds,
                                        "launches": lb_launches}
            print(f"[export] vcr_leaderboard_torch on {name} ({n_records} records): "
                  f"{len(rows)} rows x {len(cols)} columns in {seconds:.1f} s (the model load "
                  f"included); launches {lb_launches}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 20: training across processes
# ---------------------------------------------------------------------------

DIST_STEPS = 3
# World 1 against the one-process path. The first two steps see the seed's
# weights (the first update has lr scale 0) and the forward has no atomics:
# their losses are held bit for bit. After the second update the
# one-process path does not repeat itself on the card (dq's f32 atomics in
# the flash backward), so the third step's losses and the state after three
# steps are held against two one-process runs:
#   * each loss term of step 3 within DIST_LOSS_TOL of both. Two runs make a
#     poor spread (1.9e-6 apart once, where the step-3 totals of 12 runs over
#     four calls on an H100 80GB HBM3 at 700 W spanned 6.1e-5); the
#     tolerance is stated instead, and the run checks that it is below a
#     quarter of the total's own step-2 to step-3 change (2.3e-3 there), so
#     a world-1 run that skipped its update fails;
#   * the f32 params, mu and nu (decoded from its cube-root bf16), each on
#     its own: the L2 distance of world 1's from each one-process run's
#     within DIST_STATE_FACTOR times the distance between the two
#     one-process runs (the ratio was 0.99-1.01 for params and mu in two
#     calls), and that limit below the distance the one-process run moved
#     them from where they started (the seed's weights, zero moments; the
#     runs' distance was 14% of it), so that a run that skipped or garbled
#     its updates fails.
DIST_LOSS_TOL = 2e-4
DIST_STATE_FACTOR = 2.0
# two ranks sharing the one card (a probe's verdict decides whether they
# run): losses of the bf16 step against world 1's, each term within this
# (rows split otherwise over the ranks, bf16 compute, sums in bf16 over the
# ranks; 6.1e-5 the most that four runs of each layout showed), which the
# run checks to be below a quarter of world 1's step-2 to step-3 change of
# the total, so that a layout that never updates fails. tp 2 runs with both
# remat knobs (the same numbers: remat recomputes the same operations), so
# that two processes that each hold the full activations fit on the one
# card. A layout runs where the backend took every collective it issues; pp
# and the rings also send
TWO_RANK_LOSS_TOL = 5e-4
TWO_RANK_LAYOUTS = {
    "dp2": (dict(dp=2), {}),
    "tp2": (dict(dp=1, tp=2), dict(gradient_checkpoint=True, tower_gradient_checkpoint=True))}
TWO_RANK_NEEDS = ("all_reduce", "reduce_scatter", "all_gather")
TWO_RANK_OPS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all", "broadcast",
                "send_recv")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job_env(rank, world, port, local_rank=None, local_world=None):
    """torchrun's variables for one rank of a job on this machine."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank if local_rank is None else local_rank),
            "LOCAL_WORLD_SIZE": str(world if local_world is None else local_world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _state_tensors(state):
    """(f32 params, mu, nu) of a train state by entry name: the model's and
    optimizer's, or a sharded optimizer's masters (at world 1 every entry
    whole, under its name)."""
    opt = state.optimizer
    inner = getattr(opt, "inner", None)
    if inner is not None:
        return inner.params, inner.mu, inner.nu
    return dict(state.model.named_parameters()), opt.mu, opt.nu


def _dist_cfg():
    from merlot_reserve_tpu_torch import load_config

    cfg = load_config("base", joint_attention_impl="flash")
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))


def _dist_arm(cfg, batch, mesh):
    """``run_pretraining`` for DIST_STEPS steps under ``mesh`` (None: the
    one-process path): losses, launches, the comm audit per step, both
    clocks, the peak; and the final f32 params, mu and nu on the host."""
    import torch

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.parallel import comm
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.training.trainer import train_step

    logged, stamps, marks = [], [], []
    with comm.recording() as records:
        def log_fn(step, metrics):  # after every step (log_every 0)
            stamps.append(time.perf_counter())
            logged.append(metrics)
            marks.append(len(records))

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = run_pretraining(cfg, itertools.repeat(batch), num_steps=DIST_STEPS,
                                log_fn=log_fn, log_every=0, device="cuda", seed=0, mesh=mesh)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    per_step = [comm.summarize_records(records[a:b])
                for a, b in zip([0] + marks[:-1], marks)]
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    host_med = float(sorted(step_ms[1:])[len(step_ms[1:]) // 2])
    dev_batch = batch_to_tensors(batch, "cuda")
    with activate_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        device_ms = cuda_time_ms(lambda: train_step(state, dev_batch), iters=3, warmup=1)
    final = [{n: t.detach().cpu() for n, t in d.items()} for d in _state_tensors(state)]
    del state
    torch.cuda.empty_cache()
    return {"losses": logged, "launches": launches, "comm": per_step,
            "step_ms_host": step_ms, "step_ms_host_median": host_med,
            "step_ms_device": device_ms, "max_memory_allocated_bytes": peak}, final


def _same_bits(a, b):
    """Whether two name -> tensor dicts hold the same bits."""
    import torch

    def same(x, y):
        view = torch.int32 if x.element_size() == 4 else torch.int16
        return (x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x.view(view), y.view(view)))

    return a.keys() == b.keys() and all(same(a[n], b[n]) for n in a)


def _max_abs(a, b):
    return max((a[n].float() - b[n].float()).abs().max().item() for n in a)


def _l2(a, b=None):
    """The L2 norm over every entry of ``a - b`` (of ``a`` without ``b``), in f64."""
    total = 0.0
    for n, x in a.items():
        d = x.double() if b is None else x.double() - b[n].double()
        total += float(d.square().sum())
    return total ** 0.5


def _run_jobs(jobs, timeout):
    """Jobs of ``python chip_smoke.py --rank-worker`` on this card, all
    started at once: each job (mode, world, extra[, shared]) is ``world``
    ranks with LOCAL_RANK 0 each or (``shared``) the ranks of one node that
    ``distributed.initialize(device="cuda:0")`` puts on the card together.
    Returns, per job, (exit codes, the last JSON line of each rank)."""
    started = []
    for job in jobs:
        mode, world, extra, shared = (*job, False)[:4]
        port = _free_port()
        procs = []
        for rank in range(world):
            local = (rank, world) if shared else (0, 1)
            env = dict(os.environ, **_job_env(rank, world, port, *local))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker", mode,
                 json.dumps(extra)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        started.append(procs)
    deadline = time.time() + timeout
    logs = ROOT / "chiprun_out" / "ranks"
    logs.mkdir(parents=True, exist_ok=True)
    results = []
    for j, procs in enumerate(started):
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed at the time limit]")
        for p in procs:
            if p.poll() is None:
                p.kill()
        for rank, out in enumerate(outs):  # each rank's whole output, for the record
            (logs / f"{jobs[j][0]}_{len(procs)}_job{j}_{rank}.log").write_text(out)
        lines = []
        for p, out in zip(procs, outs):
            found = [x for x in out.strip().splitlines() if x.startswith("{")]
            line = json.loads(found[-1]) if found else {}
            if not found or p.returncode != 0 or "terminate" in out or "killed" in out:
                line["error"] = out[-2000:]
            lines.append(line)
        results.append(([p.returncode for p in procs], lines))
    return results


def _run_ranks(mode, world, extra, timeout, shared=False):
    """One job of ``_run_jobs``: (exit codes, the last JSON line of each rank)."""
    return _run_jobs([(mode, world, extra, shared)], timeout)[0]


def rank_worker(mode, extra):
    """One rank of phase 20's jobs on the one card (``--rank-worker``).

    probe: start a group of ``extra['backend']`` on the card's tensors and
    try each collective the port issues; prints {op: "ok" or the error}.
    train: ``run_pretraining`` of the base config at ``extra['layout']``
    over gloo on the card's tensors, the batch split over dp; rank 0 prints
    the losses, the seconds and its peak. The port's ``initialize`` starts
    NCCL on a card, which refuses two ranks on one device, so the worker
    starts the gloo group and lays out the process mesh itself."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    rank = int(os.environ["RANK"])
    if mode == "probe":
        out = {}
        try:
            kw = {"device_id": torch.device("cuda", 0)} if extra["backend"] == "nccl" else {}
            torch.cuda.set_device(0)
            dist.init_process_group(
                extra["backend"], init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                rank=rank, world_size=2, **kw)
        except Exception as e:  # the verdict is the output
            print(json.dumps({"init": f"{type(e).__name__}: {str(e)[:300]}"}), flush=True)
            return 0
        out["init"] = "ok"
        x = torch.ones(8, dtype=torch.bfloat16, device="cuda") * (rank + 1)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        ops = {"all_reduce": lambda: dist.all_reduce(x.clone()),
               "reduce_scatter": lambda: scatter(torch.empty(4, dtype=x.dtype, device="cuda"),
                                                 x.clone()),
               "all_gather": lambda: gather(torch.empty(16, dtype=x.dtype, device="cuda"),
                                            x.clone()),
               "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x), x.clone()),
               "broadcast": lambda: dist.broadcast(x.clone(), src=0),
               "send_recv": lambda: [w.wait() for w in dist.batch_isend_irecv([
                   dist.P2POp(dist.isend, x.clone(), 1 - rank),
                   dist.P2POp(dist.irecv, torch.empty_like(x), 1 - rank)])]}
        # a line after every op: an op that kills the process (gloo's send of
        # a CUDA tensor can end in std::terminate) leaves the others' verdicts
        print(json.dumps(out), flush=True)
        for name in TWO_RANK_OPS:
            try:
                ops[name]()
                torch.cuda.synchronize()
                out[name] = "ok"
            except Exception as e:
                out[name] = f"{type(e).__name__}: {str(e)[:200]}"
            print(json.dumps(out), flush=True)
        dist.destroy_process_group()
        return 0
    import numpy as np

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.parallel import comm
    from merlot_reserve_tpu_torch.parallel.mesh import Mesh
    from merlot_reserve_tpu_torch.parallel.sharding import local_rows
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=2)
    try:
        axes, model = TWO_RANK_LAYOUTS[extra["layout"]]
        cfg = _dist_cfg()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))
        shape = (1, axes.get("dp", 1), 1, 1, axes.get("tp", 1))  # (dcn, dp, sp, pp, tp)
        devices = np.empty(shape, dtype=object)
        devices.fill(torch.device("cuda", 0))
        mesh = Mesh(devices, ("dcn", "dp", "sp", "pp", "tp"), ranks=np.arange(2).reshape(shape))
        batch = local_rows(mesh, make_dummy_batch(cfg, TRAIN_BATCH, seed=0))
        logged = []
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        with comm.recording() as records:
            run_pretraining(cfg, itertools.repeat(batch), num_steps=DIST_STEPS,
                            log_fn=lambda s, m: logged.append(m), log_every=0,
                            device="cuda", seed=0, mesh=mesh)
        seconds = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({"losses": logged, "seconds": seconds,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "launches": dict(kernels.LAUNCHES),
                              "comm": comm.summarize_records(records)}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _dist_world1(card, cfg, batch, train):
    """Phase 20 (a): world 1 over NCCL against two one-process runs and
    phase 5; (the phase's record, world 1's arm)."""
    import torch

    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
    from merlot_reserve_tpu_torch.parallel import distributed, memory
    from merlot_reserve_tpu_torch.parallel.mesh import make_mesh
    from merlot_reserve_tpu_torch.training.optimization import unsigned_bfloat16_decode

    saved_env = {k: os.environ.get(k) for k in _job_env(0, 1, 0)}
    os.environ.update(_job_env(0, 1, _free_port()))
    try:
        dev = distributed.initialize("cuda")
        check(distributed.backend() == "nccl" and dev == torch.device("cuda", 0),
              f"world 1: backend {distributed.backend()} on {dev}")
        mesh = make_mesh()
        check(mesh.is_process_mesh and mesh.size(mesh.axis_names) == 1,
              f"make_mesh() after initialize: {mesh}")
        arms, finals = {}, {}
        for name, m in (("one_process", None), ("world1_nccl", mesh),
                        ("one_process_again", None)):
            arms[name], finals[name] = _dist_arm(cfg, batch, m)
            print(f"[dist] {card}: {name}: totals "
                  f"{[m_['total'] for m_ in arms[name]['losses']]}, host ms "
                  f"{[round(t, 1) for t in arms[name]['step_ms_host']]}, device "
                  f"{arms[name]['step_ms_device']:.1f} ms, peak "
                  f"{arms[name]['max_memory_allocated_bytes'] / 2**30:.2f} GiB", flush=True)
        torch.cuda.empty_cache()
        sharded = _dist_sharded_resume(card, cfg, batch, mesh)
    finally:
        distributed.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ref, again, dist_arm = arms["one_process"], arms["one_process_again"], arms["world1_nccl"]
    phase5 = [m_["total"] for m_ in train["losses"][:DIST_STEPS]]
    for i in range(DIST_STEPS - 1):  # the seed's weights: bit for bit, phase 5's too
        check(dist_arm["losses"][i] == ref["losses"][i] and
              dist_arm["losses"][i]["total"] == phase5[i],
              f"world 1 step {i} losses {dist_arm['losses'][i]} != the one-process "
              f"{ref['losses'][i]} (phase 5 total {phase5[i]})")
    last = DIST_STEPS - 1
    terms = [k for k in ref["losses"][last] if not k.startswith("_")]
    loss_gap = {k: max(abs(dist_arm["losses"][last][k] - r["losses"][last][k])
                       for r in (ref, again)) for k in terms}
    loss_spread = {k: abs(ref["losses"][last][k] - again["losses"][last][k]) for k in terms}
    step_change = abs(dist_arm["losses"][last - 1]["total"] - dist_arm["losses"][last]["total"])
    check(DIST_LOSS_TOL < step_change / 4,
          f"world 1: the tolerance {DIST_LOSS_TOL} does not tell an update from none (the "
          f"total moved {step_change} from step {last - 1} to {last})")
    for k in terms:
        check(loss_gap[k] <= DIST_LOSS_TOL,
              f"world 1 step {last} {k}: {loss_gap[k]} from the one-process runs beyond "
              f"{DIST_LOSS_TOL} (the two runs {loss_spread[k]} apart)")
    # the state after DIST_STEPS steps, each of params, mu and nu on its own
    start = {n: p.detach().float().cpu() for n, p in
             MerlotReservePretrainer(cfg, device="cuda", seed=0).named_parameters()}
    torch.cuda.empty_cache()
    state = {}
    for i, kind in enumerate(("params", "mu", "nu")):
        one, other, w1 = (finals[a][i] for a in ("one_process", "one_process_again",
                                                 "world1_nccl"))
        if kind == "nu":
            one, other, w1 = ({n: unsigned_bfloat16_decode(t) for n, t in d.items()}
                              for d in (one, other, w1))
        st = {"spread": _l2(one, other), "gap": max(_l2(w1, one), _l2(w1, other)),
              "moved": _l2(one, start) if kind == "params" else _l2(one),
              "max_abs_gap": _max_abs(w1, one), "max_abs_spread": _max_abs(other, one),
              "bit_for_bit": _same_bits(w1, one)}
        limit = DIST_STATE_FACTOR * st["spread"]
        check(limit < st["moved"],
              f"world 1 {kind}: {DIST_STATE_FACTOR} x the one-process runs' distance "
              f"{st['spread']:.4g} is not below the distance they moved {st['moved']:.4g}")
        check(st["gap"] <= limit,
              f"world 1 {kind}: L2 distance {st['gap']:.4g} from the one-process runs beyond "
              f"{DIST_STATE_FACTOR} x their own {st['spread']:.4g}")
        state[kind] = st
        print(f"[dist] {card}: world 1 vs one process, {kind} after {DIST_STEPS} steps: L2 "
              f"{st['gap']:.4g} (limit {limit:.4g}; the two one-process runs {st['spread']:.4g} "
              f"apart; moved {st['moved']:.4g} from the start), max |diff| "
              f"{st['max_abs_gap']:.3g} (one-process runs {st['max_abs_spread']:.3g}), bit for "
              f"bit {st['bit_for_bit']}", flush=True)
    per_step = cfg.model.joint_num_layers + cfg.model.span_num_layers
    for name in ("flash_fwd", *BWD_LAUNCHES):
        check(dist_arm["launches"].get(name, 0) == per_step * DIST_STEPS,
              f"world 1: {name} launches {dist_arm['launches'].get(name, 0)} != "
              f"{per_step} x {DIST_STEPS}")
    check(dist_arm["launches"].get("adam_update", 0) == DIST_STEPS,
          f"world 1: adam_update launches {dist_arm['launches'].get('adam_update', 0)} != "
          f"{DIST_STEPS}")
    audit = dist_arm["comm"][0]
    check(audit.get("all-reduce", {}).get("what", {}).get("grads") == 1 and
          audit["all-reduce"]["what_bytes"]["grads"] == 2 * memory.param_count(cfg),
          f"world 1: the gradients' all-reduce {audit.get('all-reduce')}")
    for i, summary in enumerate(dist_arm["comm"]):
        ops = {op: (v["count"], v["bytes"], v["what"]) for op, v in summary.items()
               if isinstance(v, dict)}
        print(f"[dist] {card}: world 1 step {i} comm audit (op: count, bytes, what): {ops}",
              flush=True)
    print(f"[dist] {card}: world 1 over NCCL vs the one-process path: steps 1-{DIST_STEPS - 1} "
          f"losses bit for bit; step {DIST_STEPS} loss terms within {loss_gap} (the one-process "
          f"runs {loss_spread} apart; the update moved the total {step_change:.3g}); step ms "
          f"host {dist_arm['step_ms_host_median']:.1f} (one process "
          f"{ref['step_ms_host_median']:.1f}, phase 5 {train['step_ms_host_median']:.1f}), "
          f"device {dist_arm['step_ms_device']:.1f} (one process {ref['step_ms_device']:.1f}, "
          f"phase 5 {train['step_ms_device']:.1f})", flush=True)
    return {"arms": arms, "phase5_totals": phase5, "last_step_loss_gap": loss_gap,
            "last_step_loss_spread": loss_spread, "loss_step_change": step_change,
            "state": state, "sharded_checkpoint": sharded}, dist_arm


SHARDED_STEPS = 2  # warmup 1: the second update moves the state


def _dist_sharded_resume(card, cfg, batch, mesh):
    """Phase 20 (a), its checkpoint: the world-1 state after SHARDED_STEPS
    steps saved through the per-rank sharded writer (``sharded_manager``,
    async, its collectives on a gloo group beside NCCL) and read back into a
    fresh world-1 state: the saved state bit for bit (f32 masters, bf16
    moments); the loop's blocked ms, the write and load seconds and the
    bytes. (The msgpack file of the same base state is phase 13's.)"""
    import tempfile

    import torch

    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh
    from merlot_reserve_tpu_torch.training.trainer import (create_distributed_train_state,
                                                           train_step)
    from merlot_reserve_tpu_torch.utils import checkpoint as ck

    def fresh():
        return create_distributed_train_state(
            cfg, MerlotReservePretrainer(cfg, device="cuda", seed=0), mesh)

    state = fresh()
    dev_batch = batch_to_tensors(batch, "cuda")
    with activate_mesh(mesh):
        for _ in range(SHARDED_STEPS):
            state, _ = train_step(state, dev_batch)
    torch.cuda.synchronize()
    res = {}
    with tempfile.TemporaryDirectory() as d:
        sharded_dir = os.path.join(d, "sharded")
        manager = ck.sharded_manager(sharded_dir)
        t0 = time.perf_counter()
        manager.save(state)
        blocked = time.perf_counter() - t0
        manager.close()
        write_s = time.perf_counter() - t0
        step_dir = os.path.join(sharded_dir, str(state.step))
        files = sorted(os.listdir(step_dir))
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in files)
        saved = [{n: t.detach().cpu() for n, t in x.items()} for x in _state_tensors(state)]
        del state
        torch.cuda.empty_cache()
        st = fresh()
        t0 = time.perf_counter()
        ck.load_checkpoint_sharded(sharded_dir, st)
        torch.cuda.synchronize()
        res["sharded_load_s"] = time.perf_counter() - t0
        check(st.step == SHARDED_STEPS and st.optimizer.count == SHARDED_STEPS,
              f"sharded resume: step {st.step}, count {st.optimizer.count}")
        resumed = [{n: t.detach().cpu() for n, t in x.items()} for x in _state_tensors(st)]
        del st
        torch.cuda.empty_cache()
        res.update(blocked_ms=blocked * 1e3, write_s=write_s, files=files, bytes=nbytes)
    for i, kind in enumerate(("params", "mu", "nu")):
        check(_same_bits(resumed[i], saved[i]),
              f"world 1 {kind}: the sharded resume is not the saved state bit for bit")
    print(f"[dist] {card}: world 1's state after {SHARDED_STEPS} steps through the per-rank "
          f"sharded writer ({res['files']}, {res['bytes']} bytes): the loop blocked "
          f"{res['blocked_ms']:.1f} ms, written in {res['write_s']:.2f} s, read back in "
          f"{res['sharded_load_s']:.2f} s; the resume the saved state bit for bit", flush=True)
    return res


def _dist_two_ranks(card, cfg, dist_arm):
    """Phase 20 (b): two ranks on the one card, NCCL and gloo probed; the
    base step at dp 2 and tp 2 where a backend takes them."""
    import torch

    per_step = cfg.model.joint_num_layers + cfg.model.span_num_layers
    probe = {}
    backends = ("nccl", "gloo")
    torch.cuda.empty_cache()
    # the probes and the layouts' jobs side by side on the card (the
    # layouts' seconds are so too); the layouts are held where gloo takes
    # every collective they issue
    jobs = _run_jobs([("probe", 2, {"backend": b}) for b in backends]
                     + [("train", 2, {"layout": layout}) for layout in TWO_RANK_LAYOUTS],
                     timeout=300)
    for backend, (codes, lines) in zip(backends, jobs):
        probe[backend] = {"exit_codes": codes, "ranks": lines}
        print(f"[dist] {card}: two ranks on one card over {backend}: {lines}", flush=True)
    usable = [b for b in backends
              if all(r.get("init") == "ok" and all(r.get(op) == "ok" for op in TWO_RANK_NEEDS)
                     for r in probe[b]["ranks"])]
    res = {"probe": probe, "backends_for_dp_and_tp": usable, "layouts": {}}
    print(f"[dist] {card}: backends that take dp 2 and tp 2 on one card: {usable}", flush=True)
    if "gloo" not in usable:
        return res
    world1 = dist_arm["losses"]
    step_change = abs(world1[-2]["total"] - world1[-1]["total"])
    check(TWO_RANK_LOSS_TOL < step_change / 4,
          f"two ranks: the tolerance {TWO_RANK_LOSS_TOL} does not tell an update from none "
          f"(world 1's total moved {step_change} in its last step)")
    for layout, (codes, lines) in zip(TWO_RANK_LAYOUTS, jobs[len(backends):]):
        check(codes == [0, 0] and "losses" in lines[0],
              f"{layout} on one card over gloo: {codes} {lines}")
        diffs = [max(abs(a[k] - b[k]) for k in b if not k.startswith("_"))
                 for a, b in zip(lines[0]["losses"], world1)]
        check(max(diffs) <= TWO_RANK_LOSS_TOL,
              f"{layout}: losses {diffs} from world 1's beyond {TWO_RANK_LOSS_TOL}")
        # each rank's update is one launch (under ZeRO-1 on its shard);
        # under remat every layer's forward runs again in the backward;
        # the parameters come back as bf16 all-gathers at dp 2
        launches = lines[0]["launches"]
        forwards = 2 if TWO_RANK_LAYOUTS[layout][1] else 1
        check(launches.get("adam_update") == DIST_STEPS and
              launches.get("flash_fwd") == forwards * per_step * DIST_STEPS and
              all(launches.get(n) == per_step * DIST_STEPS for n in BWD_LAUNCHES),
              f"{layout} rank 0 launches {launches}")
        gathers = lines[0]["comm"].get("all-gather", {})
        if TWO_RANK_LAYOUTS[layout][0]["dp"] > 1:
            check(gathers.get("what", {}).get("params", 0) >= DIST_STEPS and
                  lines[0]["comm"]["reduce-scatter"]["dtypes"].get("bfloat16", 0) >=
                  DIST_STEPS, f"{layout}: the ZeRO-1 collectives {lines[0]['comm']}")
        res["layouts"][layout] = dict(lines[0], loss_diffs=diffs)
        print(f"[dist] {card}: {layout}, two ranks on one card over gloo: totals "
              f"{[m_['total'] for m_ in lines[0]['losses']]}, max loss diff to world 1 "
              f"{max(diffs):.3g} (limit {TWO_RANK_LOSS_TOL}; world 1's last step moved the "
              f"total {step_change:.3g}), {lines[0]['seconds']:.1f} s beside the other jobs",
              flush=True)
    return res


def phase_distributed(card, train, long, fixres):
    """Phase 20: training across processes. (a) world 1 over NCCL: the base
    step, batch 8, through ``run_pretraining`` on a process mesh of one
    rank (ZeRO-1 on, every collective issued), against the one-process path
    of phase 5 run here twice more: the losses of each step, the f32 params
    and the moments after the last (see DIST_LOSS_TOL); launches per step;
    the comm audit per step; both clocks. (b) two ranks on the one card:
    which backend takes them (a probe of every collective the port issues,
    NCCL and gloo), and where one does, the base step at dp 2 and tp 2
    against world 1's losses. (c) the memory planner against the peaks of
    phases 5, 10, 16 and (a)."""
    import torch

    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.parallel import memory

    cfg = _dist_cfg()
    batch = make_dummy_batch(cfg, TRAIN_BATCH, seed=0)
    res = {}
    res["world1"], dist_arm = _dist_world1(card, cfg, batch, train)
    torch.cuda.empty_cache()
    res["two_ranks"] = _dist_two_ranks(card, cfg, dist_arm)

    # (c) the planner against the card
    from scripts.pretrain_fixres_torch import POSSIBLE_RES, fixres_config

    long_cfg = _long_train_config(True)
    fx = [fixres_config("base", g, num_steps=1000, warmup=1, lr_scale=0.02) for g in POSSIBLE_RES]
    mixed = memory.estimate_train_hbm(fx[0], FIXRES_BATCH // 2)
    rows = {
        "base_b8 (phase 5)": (memory.estimate_train_hbm(cfg, TRAIN_BATCH)["total"],
                              train["max_memory_allocated_bytes"]),
        "base_b8 world 1 (phase 20)": (memory.estimate_train_hbm(cfg, TRAIN_BATCH)["total"],
                                       dist_arm["max_memory_allocated_bytes"]),
        "fixres_b8 (phase 16)": (mixed["total"] + memory.estimate_train_hbm(
            fx[1], FIXRES_BATCH // 2)["activation_bytes"], fixres["max_memory_allocated_bytes"]),
        "longvideo_b4 ring:flash (phase 10)": (
            memory.estimate_train_hbm(long_cfg, LONG_TRAIN_BATCH)["total"],
            long["arms"]["ring_flash_sp4"]["max_memory_allocated_bytes"]),
        "longvideo_b4 flash (phase 10)": (
            memory.estimate_train_hbm(_long_train_config(False), LONG_TRAIN_BATCH)["total"],
            long["arms"]["flash"]["max_memory_allocated_bytes"]),
    }
    for layout, run in res["two_ranks"]["layouts"].items():  # rank 0 of each
        axes, model = TWO_RANK_LAYOUTS[layout]
        remat = bool(model)
        rows[f"base_b8 {layout} rank 0 (phase 20)"] = (memory.estimate_train_hbm(
            cfg, TRAIN_BATCH // axes["dp"], zero1_dp=axes["dp"], tp=axes.get("tp", 1),
            remat=remat, tower_remat=remat)["total"], run["peak_bytes"])
    res["planner"] = {k: {"predicted_gib": p / 2**30, "measured_gib": m / 2**30,
                          "error": (p - m) / m} for k, (p, m) in rows.items()}
    for k, v in res["planner"].items():
        print(f"[dist] {card}: planner {k}: predicted {v['predicted_gib']:.2f} GiB, "
              f"max_memory_allocated {v['measured_gib']:.2f} GiB ({100 * v['error']:+.1f}%)",
              flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 21: the soak recipe through the script, with a real preemption
# ---------------------------------------------------------------------------

SOAK_CONFIG = "soak_fused_r5"
# the recipe's lr and warmup (1e-4, 100 steps) with its cosine cut to this
# many steps, no fewer than the warmup; the full 1200-step runs are
# scripts/profile_torch_soak.py's
SOAK_STEPS = 100
SOAK_SIGNAL_AFTER = 40  # SIGTERM once the first process has logged this step
SOAK_LOG_EVERY = 10     # the script's metrics delay
SOAK_RECORDS = 16       # per shard, 4 shards (the recipe's num_train_files)
SOAK_INIT_STEPS = 11    # steps 0-10 sit at the batch-2 signatures ...
SOAK_INIT_TOL = 0.05    # ... within phase 5's limit
# the resumed run against the uninterrupted one at steps n and n + 1 (the
# trackers' f32 losses): no farther than SOAK_RESUME_FACTOR times the
# largest gap, over every loss term, between the preempted process and the
# uninterrupted run over the SOAK_SPREAD_STEPS steps before n, where both
# ran unbroken. Two runs are not bit for bit on the card (dq's f32
# atomics), and the gap grows with the steps (an H100 80GB HBM3: 0 at
# steps 0-5, up to 0.004-0.012 on the total by step 50); the resume adds
# the checkpoint's f16 round trip of the f32 masters to it
SOAK_RESUME_FACTOR = 2
SOAK_SPREAD_STEPS = 10
SOAK_REFERENCE_EXTRA = 2  # the resumed process goes this many steps past the preemption
# the uninterrupted run, started beside the preempted process, stops here:
# past any step the preempted process can stop at plus SOAK_REFERENCE_EXTRA
# (it stops about SOAK_LOG_EVERY + 2 steps after SOAK_SIGNAL_AFTER)
SOAK_REFERENCE_STEPS = 64
SOAK_TIMEOUT = 600


def phase_soak(card):
    """Phase 21: ``soak_fused_r5`` at full base widths, batch 2, the fused
    data step with frames on the card, ``scan_layers`` off, through
    ``scripts/pretrain_torch.py -log_batches`` on a structured synthetic
    corpus, driven by ``scripts/profile_torch_soak.preempt_and_resume``:
    SIGTERM to the process once it logs step SOAK_SIGNAL_AFTER; it must
    exit with 0 after writing ``ckpt_<n>`` and ``loader_state.json``; the
    same command resumes at step n and stops at n + SOAK_REFERENCE_EXTRA
    (the schedule stays the recipe's, cut to SOAK_STEPS); beside both, from
    the start, an uninterrupted run of the same command to step
    SOAK_REFERENCE_STEPS. Checks: every
    batch digest (the records as fed and the batch the card built from them
    with that step's draws) of both processes the uninterrupted run's bit
    for bit, the resumed process's first one at step n; its loss terms at
    n and n + 1 within SOAK_RESUME_FACTOR times the two runs' own spread
    before n (see SOAK_RESUME_FACTOR); every loss finite;
    steps 0-10 at the batch-2 signatures (ln 96, ln 48, ln 32) within
    SOAK_INIT_TOL; the sidecar at 2n records; and each process's kernel
    launches per step."""
    import re
    import tempfile

    import yaml

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
    from scripts.profile_torch_soak import (RECIPES, parse_log, preempt_and_resume, run_process,
                                            tracked_losses)

    work = Path(tempfile.mkdtemp(prefix="smoke_soak_"))
    try:
        raw = yaml.safe_load((ROOT / "merlot_reserve_tpu_torch" / "configs" /
                              f"{SOAK_CONFIG}.yaml").read_text())
        raw["optimizer"]["num_train_steps"] = SOAK_STEPS
        (work / "soak.yaml").write_text(yaml.safe_dump(raw))
        cfg = load_config(str(work / "soak.yaml")).replace_device(batch_size=2)
        m, o = cfg.model, cfg.optimizer
        check(not m.scan_layers and m.hidden_size == 768 and m.joint_num_layers == 12,
              f"the soak recipe's model: {m}")
        t0 = time.perf_counter()
        files = [str(work / f"fold{i:05d}.tfrecord") for i in range(cfg.data.num_train_files)]
        for i, f in enumerate(files):
            write_synthetic_corpus(f, cfg, num_records=SOAK_RECORDS, seed=i, structured=True)
        corpus_s = time.perf_counter() - t0

        def command(out, steps):
            return [sys.executable, str(ROOT / "scripts" / "pretrain_torch.py"),
                    str(work / "soak.yaml"), "-train_fns", str(work / "fold{:05d}.tfrecord"),
                    "-output_dir", str(out), "-num_steps", str(steps), "-seed", "0",
                    "-log_every", str(SOAK_LOG_EVERY), "-log_batches",
                    "--device", "cuda"] + RECIPES[SOAK_CONFIG]["flags"]

        cmd = command(work / "out", SOAK_STEPS)
        print(f"[soak] {card}: {SOAK_CONFIG} (lr {o.learning_rate}, warmup "
              f"{o.num_warmup_steps}, cosine over {SOAK_STEPS} steps), batch 2, "
              f"{len(files)} x {SOAK_RECORDS} structured records ({corpus_s:.1f} s): "
              f"{' '.join(cmd[2:])}", flush=True)
        # the uninterrupted run of the same command, to SOAK_REFERENCE_STEPS,
        # beside the preempted and then the resumed process; the resumed
        # process stops SOAK_REFERENCE_EXTRA steps after its start
        reference = {}
        straight = command(work / "straight", SOAK_REFERENCE_STEPS)
        thread = threading.Thread(target=lambda: reference.update(
            result=run_process(straight, timeout=SOAK_TIMEOUT)))
        thread.start()
        try:
            run = preempt_and_resume(
                cmd, str(work / "out"), SOAK_SIGNAL_AFTER, SOAK_TIMEOUT,
                resume_cmd=lambda n: command(work / "out", n + SOAK_REFERENCE_EXTRA))
        finally:
            thread.join()
        n, sidecar = run["stopped"], run["sidecar"]
        check(run["checkpoints"] == [n] and SOAK_SIGNAL_AFTER < n < SOAK_STEPS,
              f"after the SIGTERM: checkpoints {run['checkpoints']}")
        check(sidecar.get("records_consumed") == 2 * n,
              f"the sidecar at step {n}: {sidecar}")
        ref_steps = n + SOAK_REFERENCE_EXTRA
        check(ref_steps <= SOAK_REFERENCE_STEPS, f"the preempted process stopped at step {n}, "
              f"past the uninterrupted run's {SOAK_REFERENCE_STEPS} - {SOAK_REFERENCE_EXTRA}")
        check("result" in reference, "the uninterrupted process did not finish")
        code, third, third_s, _ = reference["result"]
        check(code == 0, f"the uninterrupted process: exit {code}: {third[-2000:]}")
        (l1, _, o1), (l2, _, o2), (_, _, o3) = (parse_log(t) for t in
                                                 (run["first"], run["second"], third))
        b1, b2, b3 = o1["batches"], o2["batches"], o3["batches"]
        check(sorted(b1) == list(range(n)) and sorted(b3) == list(range(SOAK_REFERENCE_STEPS))
              and sorted(b2) == list(range(n, ref_steps)),
              f"batch digests logged: preempted {sorted(b1)[-3:]}, resumed "
              f"{sorted(b2)[:3]}..., uninterrupted {sorted(b3)[-3:]}")
        for s in range(ref_steps):
            got = b1[s] if s < n else b2[s]
            check(got == b3[s], f"step {s}: the {'preempted' if s < n else 'resumed'} "
                  f"process's batch (records, built) {got} is not the uninterrupted run's "
                  f"{b3[s]}")
        got, want = tracked_losses(str(work / "out")), tracked_losses(str(work / "straight"))
        check(sorted(got) == list(range(ref_steps))
              and sorted(want) == list(range(SOAK_REFERENCE_STEPS)),
              f"tracked steps: {sorted(set(range(ref_steps)) - set(got))} missing, "
              f"uninterrupted {sorted(want)[-3:]}")
        gaps = {s: {h: abs(got[s][h] - want[s][h]) for h in want[s]} for s in range(ref_steps)}
        spread = max(v for s in range(n - SOAK_SPREAD_STEPS, n) for v in gaps[s].values())
        resume_gap = max(v for s in range(n, ref_steps) for v in gaps[s].values())
        shown = range(n - SOAK_SPREAD_STEPS, ref_steps)
        print(f"[soak] {card}: loss gaps to the uninterrupted run, steps {shown[0]}-{shown[-1]}: "
              f"{ {s: {h: f'{v:.2e}' for h, v in gaps[s].items()} for s in shown} }", flush=True)
        check(resume_gap <= SOAK_RESUME_FACTOR * spread,
              f"soak: the resumed run's loss terms at steps {n}-{ref_steps - 1} lie {resume_gap} "
              f"from the uninterrupted run's, beyond {SOAK_RESUME_FACTOR} x the {spread} the two "
              f"runs differed by at steps {n - SOAK_SPREAD_STEPS}-{n - 1}")
        losses = {**{k: v for k, v in l1.items() if k < n}, **l2}
        check(sorted(losses) == list(range(ref_steps)),
              f"steps logged: {sorted(set(range(ref_steps)) - set(losses))} missing")
        check(all(math.isfinite(v) for x in losses.values() for v in x.values()),
              "a non-finite soak loss")
        expected = _expected_init_losses(cfg, 2)
        init_gap = {h: max(abs(losses[k][h] - ln_n) for k in range(SOAK_INIT_STEPS))
                    for h, ln_n in expected.items()}
        for head, gap in init_gap.items():
            check(gap <= SOAK_INIT_TOL, f"soak steps 0-{SOAK_INIT_STEPS - 1} {head}: {gap} from "
                  f"ln N = {expected[head]} beyond {SOAK_INIT_TOL}")
        # the kernels of each process: every step's joint and span layers,
        # one update a step
        launches = []
        per_layer = m.joint_num_layers + m.span_num_layers
        for text, steps in ((run["first"], n), (run["second"], ref_steps - n),
                            (third, SOAK_REFERENCE_STEPS)):
            found = re.search(r"kernel launches (\{.*\})", text)
            check(found is not None, "the script printed no kernel launches")
            counts = json.loads(found.group(1))
            check(counts.get("adam_update") == steps and all(
                counts.get(k) == per_layer * steps for k in ("flash_fwd", *BWD_LAUNCHES)),
                f"{steps} soak steps made {counts}")
            launches.append(counts)
        windows = {f"{a}-{a + 10}": {h: sum(losses[k][h] for k in range(a, min(a + 10,
                                                                               ref_steps)))
                                     / (min(a + 10, ref_steps) - a) for h in expected}
                   for a in range(0, ref_steps, 10)}
        res = {"config": SOAK_CONFIG, "steps": SOAK_STEPS, "steps_run": ref_steps,
               "preempted_at": n,
               "first_s": run["first_s"], "exit_after_signal_s": run["exit_s"],
               "second_s": run["second_s"], "uninterrupted_s": third_s,
               "write_s": o1.get("write_s"), "load_s": o2.get("load_s"),
               "peak_gib": [o1.get("peak_gib"), o2.get("peak_gib")], "loader_state": sidecar,
               "resume_gap": resume_gap, "spread_before": spread, "loss_gaps": gaps,
               "init_gap": init_gap, "expected_init_losses": expected,
               "windows": windows, "batch_digests_checked": ref_steps,
               "launches": {"preempted": launches[0], "resumed": launches[1],
                            "uninterrupted": launches[2]},
               "corpus_s": corpus_s}
        print(f"[soak] {card}: SIGTERM after step {SOAK_SIGNAL_AFTER}'s log; stopped at step "
              f"{n} ({run['exit_s']:.1f} s after the signal, exit 0, {run['first_s']:.1f} s in "
              f"all), checkpoint written in {o1.get('write_s')} s; resumed at step {n} (loaded "
              f"in {o2.get('load_s')} s), to step {ref_steps} ({run['second_s']:.1f} s); "
              f"the uninterrupted run to step {SOAK_REFERENCE_STEPS} ({third_s:.1f} s, beside "
              f"both): batch digests "
              f"(records and the card's build) of steps 0-{ref_steps - 1} bit for bit, loss "
              f"terms at steps {n}-{ref_steps - 1} within {resume_gap:.2e} (the runs "
              f"{spread:.2e} apart before {n}); steps 0-10 within {init_gap} of {expected}; peak "
              f"{res['peak_gib']} GiB; the sidecar {sidecar['records_consumed']} records",
              flush=True)
        print(f"[soak] {card}: 10-step means "
              f"{ {k: {h: round(v, 4) for h, v in w.items()} for k, w in windows.items()} }",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 22: the ring kernel across processes
# ---------------------------------------------------------------------------

RING_PROBE_ROUNDS = 200
# (label case, n processes, B, L, dtype) of the ring kernel's mode across
# processes: the long-video serving shape and the n = 2 shape of phase 7
RING_PROCS_CASES = (("packed", 2, 8, 640, "bf16"), ("long_video", 4, 8, 2560, "bf16"),
                    ("packed", 2, 8, 640, "f32"))
RING_PROCS_TIMED = 10  # launches timed by events in each process
RING_PROCS_SERVE = (2, 4)  # sp of the long-video serving runs
RING_PROCS_BATCHES = 2  # batches served at each sp: the first counted and compared
RING_PROCS_TIMEOUT = 300
# (sp, rank, seconds): in the serving run at this sp, this rank sleeps this
# long before a batch that the others start at once, longer than a ring
# kernel waits on a neighbour (RING_TIMEOUT_NS, 5 s) before it traps
RING_PROCS_DELAY = (4, 1, 6.0)
TIME_SLICED = ("time-sliced on one card: the processes' CUDA contexts take turns on the one "
               "H100 (about 2.25 ms each on an H100 80GB HBM3 at 700 W), so these times are "
               "no rate of the kernel")


def ring_worker(mode, extra):
    """One process of phase 22's jobs (``--rank-worker ring``), all on
    cuda:0 through ``distributed.initialize(device="cuda:0")`` (gloo).

    ``extra["probe"]``: the flag round trip, ``ring_ipc_pingpong`` on two
    buffers opened by CUDA IPC. Else the ring kernel's mode across
    processes on each of ``extra["cases"]`` (this rank's shard of seeded
    inputs through ``sequence_parallel_attention(impl="rdma")``, against the
    virtual-rank ``ring_fwd`` and the plain ring over the whole inputs, the
    16-byte store route on the same inputs, times by events), then the
    long-video batch through ``VideoEmbedService`` under a process mesh of
    each sp in ``extra["serve"]`` (rank 0 saves the embeddings into
    ``extra["out"]``). Prints one JSON line."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops
    from merlot_reserve_tpu_torch.parallel import distributed
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
    from merlot_reserve_tpu_torch.serving import VideoEmbedService

    distributed.initialize(device="cuda:0", timeout_s=RING_PROCS_TIMEOUT)
    rank = distributed.process_index()
    out = {"rank": rank, "backend": distributed.backend(), "cases": {}, "serve": {}}
    t0 = time.perf_counter()

    def say(what):  # where each rank got to, in its log
        print(f"[rank {rank} +{time.perf_counter() - t0:.1f} s] {what}", flush=True)

    try:
        if "probe" in extra:
            out["probe"] = _ipc_probe(rank, extra["probe"])
            return 0
        sizes = sorted({c[1] for c in extra["cases"]} | set(extra["serve"]))
        meshes = {n: make_mesh(sp=n, ranks=range(n)) for n in sizes}  # collectively
        for case, n, B, L, dname in extra["cases"]:
            if meshes[n].coords is not None:
                key = f"{case} {dname} n{n} B{B} L{L}"
                _in_step(meshes[n])
                say(key)
                out["cases"][key] = _ring_procs_case(meshes[n], case, n, B, L, dname, say)
        cfg = load_config("base", joint_attention_impl="ring:rdma", seq_shard_axis="sp")
        model = service = None
        for n in extra["serve"]:
            if meshes[n].coords is None:
                continue
            if model is None:
                model = MerlotReserve(cfg, device="cuda", seed=0)
                service = VideoEmbedService(model, batch_size=8, device="cuda")
            reqs = [make_requests(cfg, 8, 20 + i, n_seg=LONG_SEGMENTS)
                    for i in range(RING_PROCS_BATCHES)]
            _in_step(meshes[n])
            say(f"serve sp {n}")
            epochs = {k: r.epoch for k, r in ring_ops._PEER_RINGS.items()}  # the rings it uses
            torch.cuda.synchronize()
            kernels.LAUNCHES.clear()
            with activate_mesh(meshes[n]):
                first = service.embed(reqs[0])
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            host_ms = []
            for r in reqs:
                t = time.perf_counter()
                with activate_mesh(meshes[n]):
                    service.embed(r)
                host_ms.append((time.perf_counter() - t) * 1e3)
            with torch.inference_mode(), activate_mesh(meshes[n]):
                inputs = stack_requests(reqs[0], "cuda")
                device_ms = cuda_time_ms(lambda: model.batch_embed_video(*inputs), iters=2,
                                         warmup=1)
            if rank == 0:
                np.save(Path(extra["out"]) / f"serve_sp{n}.npy", first)
            out["serve"][n] = {"launches": launches, "host_ms": host_ms,
                               "device_ms": device_ms,
                               "peak_bytes": torch.cuda.max_memory_allocated(),
                               "routes": sorted({r.route for k, r in ring_ops._PEER_RINGS.items()
                                                 if r.epoch != epochs.get(k)})}
            sp, late_rank, seconds = extra["delay"]
            if n == sp:
                out["serve"][n]["delayed"] = _delayed_batch(meshes[n], service, reqs[0], first,
                                                            late_rank, seconds, say)
    finally:
        distributed.shutdown()
        print(json.dumps(out), flush=True)
    return 0


def _in_step(mesh):
    """A barrier of the mesh's ranks. A ring kernel that waits on a
    neighbour busy with other work for longer than RING_TIMEOUT_NS traps:
    each case and each serving run starts with its ranks in step (the ranks
    of an sp 2 case run it while the others wait here for the next)."""
    import torch.distributed as dist

    dist.barrier(group=mesh.group(mesh.axis_names))


def _delayed_batch(mesh, service, reqs, first, late_rank, seconds, say):
    """Phase 22 (d), in each process: rank ``late_rank`` sleeps ``seconds``
    before the batch ``reqs``, which the other ranks start at once; the
    joint tower's host barrier holds them until it comes. Returns this
    rank's launches and barriers in the batch, whether its embeddings are
    bit for bit its undelayed answer ``first``, and whether the first joint
    layer's ring output on its shard is bit for bit the virtual-rank
    kernel's rows over the ranks' gathered inputs."""
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops
    from merlot_reserve_tpu_torch.parallel import comm
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh

    rank, n = mesh.axis_index("sp"), mesh.size("sp")
    seen = []
    launch = ring_ops.PeerRing.launch

    def keep_first(ring, q, k, v, is_valid, segment_ids):
        out = launch(ring, q, k, v, is_valid, segment_ids)
        if not seen:
            seen.append([x.contiguous() for x in (q, k, v, is_valid, segment_ids, out)])
        return out

    _in_step(mesh)
    if rank == late_rank:
        say(f"sleeps {seconds} s before its batch")
        time.sleep(seconds)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    with mock.patch.object(ring_ops.PeerRing, "launch", keep_first), activate_mesh(mesh), \
            comm.recording() as records:
        late = service.embed(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    say(f"the delayed batch ended after {wall_s:.1f} s")
    launches = dict(kernels.LAUNCHES)
    q, k, v, valid, seg, got = seen[0]
    whole = [comm.all_gather(x, mesh, "sp", 1) for x in (q, k, v, valid, seg)]
    lloc = q.shape[1]
    virtual = ring_ops.ring_fwd(*whole, n)[:, rank * lloc:(rank + 1) * lloc].contiguous()
    return {"late_rank": late_rank, "seconds": seconds, "wall_s": wall_s,
            "launches": launches, "barriers": sum(r["op"] == "barrier" for r in records),
            "same_bits_as_undelayed": bool(np.array_equal(late, first)),
            "first_layer_same_bits_as_virtual": torch.equal(got.view(torch.int16),
                                                            virtual.view(torch.int16))}


def _ipc_probe(rank, rounds):
    """Two ranks' buffers (ring_ipc_alloc, exchanged over the job's group,
    opened by ring_ipc_open), then ``rounds`` round trips of the flag, the
    kernel launched cooperatively as the ring kernels are."""
    import torch
    import torch.distributed as dist

    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops

    lib = ring_ops._ring_lib()
    own, peer = ctypes.c_void_p(), ctypes.c_void_p()
    handle = ctypes.create_string_buffer(lib.ring_ipc_handle_size())
    check(lib.ring_ipc_alloc(8192, ctypes.byref(own), handle) == 0, "probe: ring_ipc_alloc")
    handles = [None, None]
    dist.all_gather_object(handles, handle.raw)
    err = lib.ring_ipc_open(ctypes.create_string_buffer(handles[1 - rank], len(handle.raw)),
                            ctypes.byref(peer))
    check(err == 0, f"probe: cudaIpcOpenMemHandle failed with cudaError_t {err}")
    dist.barrier()
    times = torch.zeros(rounds + 1, dtype=torch.int64, device="cuda")
    bad = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    err = lib.ring_ipc_pingpong(own, peer, rank, rounds, ring_ops.RING_TIMEOUT_NS,
                                times.data_ptr(), bad.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    dist.barrier()
    lib.ring_ipc_close(peer)
    dist.barrier()
    lib.ring_ipc_free(own)
    t = times.tolist()
    return {"launch": err, "bad_words": int(bad.item()), "rounds": rounds, "host_s": host_s,
            "device_ns": t[0], "round_trip_us": t[0] / rounds / 1e3,
            "first_sends_ns": t[1:6]}


def _ring_procs_case(mesh, case, n, B, L, dname, say):
    """This rank's shard through ``sequence_parallel_attention`` under the
    process mesh (one counted launch), against the virtual-rank kernel and
    the plain ring over the whole inputs; then the 16-byte store route."""
    import torch

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.ops import ring_attention as ring_ops

    H, D = 12, 64
    dtype = torch.bfloat16 if dname == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(9)  # the same inputs in every process
    valid, seg = _ring_labels(case, B, L, "cuda")
    r, lloc = mesh.axis_index("sp"), L // n
    rows = slice(r * lloc, (r + 1) * lloc)
    res = {"rank": r}
    with torch.inference_mode():
        q, k, v = torch.randn((B, L, 3, H, D), generator=g, device="cuda").to(dtype).unbind(2)
        shard = [x[:, rows] for x in (q, k, v)]  # strided, as the model hands them over
        labels = [x[:, rows].contiguous() for x in (valid, seg)]
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        got = ring_ops.sequence_parallel_attention(mesh, *shard, *labels, impl="rdma")
        torch.cuda.synchronize()
        say("the entry call's launch ended")
        res["launches"] = dict(kernels.LAUNCHES)
        ring = ring_ops.peer_ring(mesh, "sp", shard[0])
        res["route"] = ring.route
        virtual = ring_ops.ring_fwd(q, k, v, valid, seg, n)[:, rows]
        bits = torch.int16 if dname == "bf16" else torch.int32
        res["same_as_virtual"] = torch.equal(got.view(bits), virtual.contiguous().view(bits))
        res["max_abs_diff_virtual"] = (got.float() - virtual.float()).abs().max().item()
        plain = ring_ops.ring_attention_reference(q.float(), k.float(), v.float(), valid, seg,
                                                  n)[:, rows]
        err = (got.float() - plain).abs()
        ok = labels[0] > 0
        res.update(max_abs_err=err.max().item(), max_abs_out=plain.abs().max().item(),
                   max_abs_err_valid=err[ok].max().item(),
                   max_abs_out_valid=plain[ok].abs().max().item())
        say("the virtual-rank kernel and the plain ring ended")
        ring.peer_store = True
        stored = ring.launch(*shard, *labels)
        res["stores_route"] = ring.route
        ring.peer_store = False
        torch.cuda.synchronize()
        res["stores_same"] = torch.equal(stored.view(bits), got.view(bits))
        res["ms"] = cuda_time_ms(lambda: ring.launch(*shard, *labels),
                                 iters=RING_PROCS_TIMED, warmup=2)
        res["epoch"] = ring.epoch
    del q, k, v, shard, virtual, plain, err
    torch.cuda.empty_cache()
    return res


def phase_ring_procs(card, sp, sp_arrays, joint_layers):
    """Phase 22: the ring kernel across processes, every process on the one
    card (time-sliced). (a) The flag round trip between two processes
    (``ring_ipc_pingpong``): both finish, every payload word arrives. (b)
    The kernel's mode across processes at RING_PROCS_CASES: each rank's
    shard bit for bit the virtual-rank kernel's rows of the same inputs, and
    within RING_REL_TOL of the plain ring; the 16-byte store route bit for
    bit the TMA route; one counted launch per entry call; the route each
    took; times by events in each process. (c) Phase 8's long-video batch
    (8 videos of 40 segments, joint L 2560) through ``VideoEmbedService``
    under a process mesh at sp 2 and sp 4: ``joint_layers`` launches of the
    kernel per batch in every rank, no ``flash_fwd`` in the joint tower,
    rank 0's embeddings against phase 8's (the virtual-rank ring) and its
    flash path within phase 8's limit; both clocks. Every time here is
    labelled TIME_SLICED."""
    import tempfile

    import numpy as np

    codes, lines = _run_ranks("ring", 2, {"probe": RING_PROBE_ROUNDS}, timeout=180,
                              shared=True)
    check(codes == [0, 0] and all("probe" in x for x in lines),
          f"the flag round trip across two processes: {codes} {lines}")
    probe = [x["probe"] for x in lines]
    for p in probe:
        check(p["launch"] == 0 and p["bad_words"] == 0,
              f"the flag round trip: launch {p['launch']}, {p['bad_words']} payload words wrong")
    print(f"[ring procs] {card}: two processes on one card, buffers opened by CUDA IPC: "
          f"{RING_PROBE_ROUNDS} round trips of the flag with 1024 words each way in "
          f"{probe[0]['device_ns'] / 1e6:.2f} ms ({probe[0]['round_trip_us']:.1f} us each; "
          f"{TIME_SLICED}); backend {lines[0]['backend']}", flush=True)

    work = Path(tempfile.mkdtemp(prefix="smoke_ring_procs_"))
    try:
        world = max(max(c[1] for c in RING_PROCS_CASES), max(RING_PROCS_SERVE))
        extra = {"cases": RING_PROCS_CASES, "serve": RING_PROCS_SERVE, "out": str(work),
                 "delay": RING_PROCS_DELAY}
        codes, lines = _run_ranks("ring", world, extra, timeout=RING_PROCS_TIMEOUT, shared=True)
        check(codes == [0] * world and all("cases" in x and "error" not in x for x in lines),
              f"the ring across processes: exit codes {codes}: {lines}")
        cases = {}
        for case, n, B, L, dname in RING_PROCS_CASES:
            key = f"{case} {dname} n{n} B{B} L{L}"
            ranks = [x["cases"][key] for x in lines[:n]]
            for r in ranks:
                check(r["launches"].get("ring_fwd_procs") == 1 and "ring_fwd" not in r["launches"],
                      f"{key} rank {r['rank']}: launches {r['launches']}")
                check(r["same_as_virtual"],
                      f"{key} rank {r['rank']}: not the virtual-rank kernel's rows bit for bit "
                      f"(max abs diff {r['max_abs_diff_virtual']})")
                check(r["stores_same"], f"{key} rank {r['rank']}: the 16-byte store route "
                                        "differs from the TMA route")
                for sfx in ("", "_valid"):
                    e, scale = r[f"max_abs_err{sfx}"], r[f"max_abs_out{sfx}"]
                    check(math.isfinite(e) and e <= RING_REL_TOL[dname] * scale,
                          f"{key} rank {r['rank']}: max abs err{sfx} {e} > "
                          f"{RING_REL_TOL[dname]} x {scale}")
            cases[key] = {"ranks": ranks, "max_abs_err": max(r["max_abs_err"] for r in ranks),
                          "routes": sorted({r["route"] for r in ranks}),
                          "ms_by_rank": [r["ms"] for r in ranks]}
            print(f"[ring procs] {card}: {key} in {n} processes: every rank's shard bit for bit "
                  f"the virtual-rank kernel's; max abs err to the plain ring "
                  f"{cases[key]['max_abs_err']:.3e}; route {cases[key]['routes']}, the 16-byte "
                  f"stores bit for bit the same; ms per launch by rank "
                  f"{[round(m, 3) for m in cases[key]['ms_by_rank']]} ({TIME_SLICED})",
                  flush=True)

        serve = {}
        phase8 = sp_arrays["long"]
        rows = phase8["rows"]
        limit = sp["agreement"]["long"]["limit"]
        for n in RING_PROCS_SERVE:
            got = np.load(work / f"serve_sp{n}.npy")
            check(got.shape == phase8["ring"].shape and np.isfinite(got).all(),
                  f"sp {n}: embeddings {got.shape}, finite {np.isfinite(got).all()}")
            per_rank = [x["serve"][str(n)] for x in lines[:n]]
            for i, r in enumerate(per_rank):
                check(r["launches"].get("ring_fwd_procs") == joint_layers
                      and r["launches"].get("flash_fwd", 0) == 0
                      and r["launches"].get("ring_fwd", 0) == 0,
                      f"sp {n} rank {i}: launches per batch {r['launches']}")
            a = {"vs_virtual_ring": _worst_one_minus_cos(got, phase8["ring"], rows),
                 "vs_flash": _worst_one_minus_cos(got, phase8["flash"], rows),
                 "max_abs_diff_vs_virtual_ring": float(np.abs(got - phase8["ring"])[rows].max()),
                 "limit": limit}
            for k in ("vs_virtual_ring", "vs_flash"):
                check(a[k] <= limit, f"sp {n}: 1 - cos {k} {a[k]} > phase 8's limit {limit}")
            serve[n] = {"agreement": a, "ranks": per_rank,
                        "host_ms_rank0": per_rank[0]["host_ms"],
                        "device_ms_rank0": per_rank[0]["device_ms"]}
            if n == RING_PROCS_DELAY[0]:
                late = [r["delayed"] for r in per_rank]
                for i, r in enumerate(late):
                    check(r["barriers"] == 1 and r["launches"].get("ring_fwd_procs") ==
                          joint_layers and r["same_bits_as_undelayed"]
                          and r["first_layer_same_bits_as_virtual"],
                          f"sp {n} rank {i}, rank {RING_PROCS_DELAY[1]} {RING_PROCS_DELAY[2]} s "
                          f"late: {r}")
                serve[n]["delayed"] = late
                print(f"[ring procs] {card}: the same batch at sp {n} with rank "
                      f"{RING_PROCS_DELAY[1]} starting {RING_PROCS_DELAY[2]} s late (a ring "
                      f"kernel traps after 5 s of waiting, RING_TIMEOUT_NS): no rank trapped; one "
                      f"barrier and {joint_layers} ring launches per rank; every rank's "
                      f"embeddings bit for bit its undelayed answer and its first joint layer's "
                      f"shard bit for bit the virtual-rank kernel's; batch wall s by rank "
                      f"{[round(r['wall_s'], 2) for r in late]}", flush=True)
            print(f"[ring procs] {card}: 8 long videos (joint L {sp['joint_len']}) "
                  f"at sp {n} in {n} processes: {joint_layers} ring launches per rank per batch; "
                  f"worst valid-row 1 - cos vs phase 8's virtual ring {a['vs_virtual_ring']:.3e}, "
                  f"vs its flash path {a['vs_flash']:.3e} (limit {limit:.3e}); rank 0 "
                  f"{[round(t, 1) for t in per_rank[0]['host_ms']]} ms per batch on the host "
                  f"clock, {per_rank[0]['device_ms']:.1f} ms by events; routes "
                  f"{per_rank[0]['routes']} ({TIME_SLICED})", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"probe": probe, "cases": cases, "serve": serve, "clock": TIME_SLICED}


# ---------------------------------------------------------------------------
# phases 23-27: the large configuration (hidden 1024, 16 heads of 64, 24
# joint and 24 vision layers)
# ---------------------------------------------------------------------------

LARGE_HEADS = 16
LARGE_ZERO_SHOT_GRID = (18, 32)  # demo/demo_video_torch.py's default --grid
LARGE_ZERO_SHOT_LEN = 1312  # 160 tokens + 8 segments x 144 pooled tokens at 18x32
LARGE_ZERO_SHOT_TIMED = 3  # calls timed of each zero-shot function
# (arm, batch, both remat knobs) of the pretraining arms: batch 4 without
# remat (the planner's 48.97 GiB; batch 6 68.69 and batch 8 88.41 GiB) and
# batch 8 with gradient_checkpoint and tower_gradient_checkpoint (17.38 GiB)
LARGE_TRAIN_ARMS = (("b4", 4, False), ("b8_remat", 8, True))
LARGE_TRAIN_STEPS = 3
# step 0 through the kernels against the plain path, as phase 5 holds base,
# with the audio tower held as phase 5 holds the vision tower: at large and
# random init its bf16 gradient is a cancellation too, which bf16 rounding
# anywhere in the step turns (its cosine to the f32 plain path 0.944 on the
# plain bf16 path and 0.946 on the kernel path, its CLS projection's bias
# -0.170 and -0.181; the vision tower's 0.766 and 0.744 at batch 8; H100
# 80GB HBM3, 700 W), and one draw's order of the two paths there is noise.
# So in bf16: every tensor outside the two modality towers
# (LARGE_BF16_UNHELD) at TRAIN_MIN_TENSOR_COSINE, the gradient at each
# tower's pooled tokens (from the joint tower) at
# TRAIN_MIN_VISION_INPUT_COSINE; against the f32 plain path, the whole
# gradient and the gradient at each tower's two outputs no farther from it
# on the kernel path than on the plain bf16 path (TRAIN_VS_F32_MARGIN); and
# in an f32 copy (arm LARGE_F32_ARM) every tensor, the towers' too, at
# TRAIN_F32_MIN_COSINE
LARGE_BF16_UNHELD = ("vision_encoder", "audio_encoder")
LARGE_F32_ARM = "b4"
LARGE_FINETUNE_BATCH = 32  # scripts/finetune_{vcr,tvqa}_torch.py's -batch_size
LARGE_FINETUNE_STEPS = 1  # a scanned step of 32 examples takes seconds


def _counted_steps(step, n):
    """``n`` calls of ``step()``, a training step that updates its state in
    place and returns (state, metrics), each timed on the host clock and by
    CUDA events: (metrics as floats, host ms, device ms, kernel launches),
    one entry per call."""
    import torch

    from merlot_reserve_tpu_torch import kernels

    infos, host_ms, device_ms, per_step = [], [], [], []
    for _ in range(n):
        before = dict(kernels.LAUNCHES)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        _, info = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        infos.append({k: float(v) for k, v in info.items()})
        per_step.append({k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()})
    return infos, host_ms, device_ms, per_step


def phase_large_zero_shot(card, seed):
    """Phase 24: the demos' zero-shot path at large. A large model's seeded
    weights written as a msgpack checkpoint (``save_checkpoint``, f16) and
    read back by ``PretrainedMerlotReserve.from_params("large", ...,
    image_grid_size=(18, 32))`` (bit for bit through f16); then phase 9's
    zero-shot path on synthetic raw segments (``segments_from_arrays``,
    ``preprocess_video`` at 18x32: joint L 1312): ``rank_options`` (the
    mask-infilling ranking), ``extract_mask_features`` and
    ``score_label_space``, counted, against the plain attention path on
    the same weights; ms per call, the load seconds. Returns the record and
    the joint tower's labels at B 1 L 1312."""
    import numpy as np
    import torch

    import bench_torch
    from merlot_reserve_tpu_torch import kernels, load_config, preprocess, zero_shot
    from merlot_reserve_tpu_torch.models import MerlotReserve, PretrainedMerlotReserve
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params, save_checkpoint
    from merlot_reserve_tpu_torch.utils.weights import flax_tensors_from_state_dict

    cfg = load_config("large")
    m = cfg.model
    ckpt_dir = str(CKPT_DIR / "large")
    model = MerlotReserve(cfg, device="cuda", seed=seed)
    t0 = time.perf_counter()
    path = save_checkpoint({"step": 0, "params": flax_tensors_from_state_dict(
        dict(model.named_parameters()), m.size_per_head)}, ckpt_dir)
    write_s, nbytes = time.perf_counter() - t0, os.path.getsize(path)
    written = {n: p.detach().half() for n, p in model.named_parameters()}  # the file's values
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre = PretrainedMerlotReserve.from_params("large", pretrained_params(ckpt_dir),
                                              image_grid_size=LARGE_ZERO_SHOT_GRID,
                                              device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = dict(pre.model.named_parameters())
    check(loaded.keys() == written.keys()
          and all(torch.equal(loaded[n], written[n].float()) for n in written),
          "the large checkpoint did not read back as written (through f16)")
    del written
    print(f"[large zero-shot] {sum(p.numel() for p in loaded.values()) / 1e6:.1f}M parameters "
          f"written as msgpack ({nbytes} bytes) in {write_s:.2f} s, read by from_params at "
          f"{LARGE_ZERO_SHOT_GRID[0]}x{LARGE_ZERO_SHOT_GRID[1]} in {load_s:.2f} s, bit for bit "
          f"through f16", flush=True)

    rng = np.random.RandomState(seed)
    frames, pcm, _, _ = bench_torch.raw_inputs(rng)
    times = [{"start_time": 5.0 * i, "end_time": 5.0 * (i + 1), "mid_time": 5.0 * i + 2.5}
             for i in range(frames.shape[1])]
    prompts = ["the person is <|MASK|> right now", "<|MASK|> is what happens next"]

    def video_pres():
        out = []
        for vf, wav, prompt in zip(frames[:2], pcm[:2], prompts):
            segs = preprocess.segments_from_arrays(vf, wav.reshape(-1), times, device="cuda")
            for s_ in segs[:-1]:
                s_["use_text_as_input"] = False
            segs[-1]["text"] = prompt
            out.append(preprocess.preprocess_video(segs, LARGE_ZERO_SHOT_GRID, device="cuda"))
        return out

    def path(pres):
        probs = zero_shot.rank_options(pre, pres[0], ZERO_SHOT_OPTIONS)
        feats = zero_shot.extract_mask_features(pre, pres)
        logits = zero_shot.score_label_space(pre, feats, ZERO_SHOT_OPTIONS)
        return probs, feats, logits

    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    with _recorded_labels() as path_labels:
        pres = video_pres()
        probs, feats, logits = path(pres)
        torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = 2 * (m.joint_num_layers + m.span_num_layers)  # rank_options, features + scores
    check(launches.get("flash_fwd", 0) == want,
          f"large zero-shot path: flash_fwd launches {launches.get('flash_fwd', 0)} != {want}")
    shapes = sorted(path_labels)
    check(shapes == [(1, LARGE_ZERO_SHOT_LEN), (2, LARGE_ZERO_SHOT_LEN),
                     (len(ZERO_SHOT_OPTIONS), m.text_span_length + 1)],
          f"large zero-shot path attention shapes {shapes}")
    check(probs.shape == (1, len(ZERO_SHOT_OPTIONS)) and np.isfinite(probs).all()
          and abs(float(probs.sum()) - 1) < 1e-5, f"option probabilities {probs}")
    check(logits.shape == (2, len(ZERO_SHOT_OPTIONS)) and np.isfinite(logits).all(),
          f"label-space logits {logits}")
    kernels.LAUNCHES.clear()
    label_space = pre.get_label_space(list(ZERO_SHOT_OPTIONS))
    per_label_space = dict(kernels.LAUNCHES)
    check(per_label_space.get("flash_fwd", 0) == m.span_num_layers,
          f"one label-space call launched flash_fwd {per_label_space.get('flash_fwd', 0)} "
          f"times, not {m.span_num_layers}")

    def timed(fn):
        runs = []
        for _ in range(LARGE_ZERO_SHOT_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        return runs

    ms = {"rank_options": timed(lambda: zero_shot.rank_options(pre, pres[0],
                                                               ZERO_SHOT_OPTIONS)),
          "extract_mask_features": timed(lambda: zero_shot.extract_mask_features(pre, pres)),
          "get_label_space": timed(lambda: pre.get_label_space(list(ZERO_SHOT_OPTIONS)))}

    # the plain attention path on the same weights and inputs
    kernels.LAUNCHES.clear()
    with _plain_attention():
        plain_probs, plain_feats, _ = path(pres)
        plain_label_space = pre.get_label_space(list(ZERO_SHOT_OPTIONS))
    check(not kernels.LAUNCHES, f"the plain path launched kernels {dict(kernels.LAUNCHES)}")

    agreement = {"label_space_min_cos": _min_row_cos(label_space.float().cpu(),
                                                    plain_label_space.float().cpu()),
                 "mask_features_min_cos": _min_row_cos(feats, plain_feats),
                 "probs_max_abs_diff": float(np.abs(probs - plain_probs).max())}
    print(f"[large zero-shot] {card}: 2 raw videos of 8 segments at "
          f"{LARGE_ZERO_SHOT_GRID[0]}x{LARGE_ZERO_SHOT_GRID[1]} (joint L "
          f"{LARGE_ZERO_SHOT_LEN}) -> preprocess_video, rank_options, extract_mask_features, "
          f"score_label_space in {path_s:.2f} s; launches {launches}; ms per call "
          f"{ {k: [round(t, 1) for t in v] for k, v in ms.items()} }; kernel vs plain path "
          f"{agreement}", flush=True)
    check(agreement["label_space_min_cos"] >= ZERO_SHOT_MIN_COSINE
          and agreement["mask_features_min_cos"] >= ZERO_SHOT_MIN_COSINE,
          f"large zero-shot: kernel vs plain cosine below {ZERO_SHOT_MIN_COSINE}: {agreement}")
    check(agreement["probs_max_abs_diff"] <= ZERO_SHOT_PROBS_TOL,
          f"large zero-shot: option probabilities more than {ZERO_SHOT_PROBS_TOL} apart: "
          f"{agreement}")
    res = {"grid": list(LARGE_ZERO_SHOT_GRID), "joint_len": LARGE_ZERO_SHOT_LEN,
           "checkpoint_bytes": nbytes, "write_s": write_s, "load_s": load_s,
           "launches": launches, "launches_per_label_space": per_label_space,
           "path_s": path_s, "ms_per_call": ms, "probs": probs.tolist(),
           "agreement": agreement, "shapes": [list(x) for x in shapes]}
    labels = path_labels[(1, LARGE_ZERO_SHOT_LEN)]
    del pre, loaded
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return res, labels


def phase_large_train(card):
    """Phase 25: ``MerlotReservePretrainer`` at large through ``train_step``
    on the dummy batch, warmup 1 and lr 1e-5 as phase 5, in two arms
    (LARGE_TRAIN_ARMS). Each: step 0 through the kernels against the plain
    attention path (same weights, batch and draws; phase 5's limits, see
    LARGE_BF16_UNHELD),
    then LARGE_TRAIN_STEPS steps: finite losses, step 0 near ln N, the
    kernels' launches per step from the config, one ``adam_update`` a step,
    step ms on both clocks, the peak beside ``estimate_train_hbm``'s.
    Returns the record, the joint tower's labels at the last arm's batch
    and that arm's trained model (its optimizer dropped)."""
    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import kernels, load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.models.pretrainer import (MerlotReservePretrainer,
                                                           batch_to_tensors)
    from merlot_reserve_tpu_torch.parallel import memory
    from merlot_reserve_tpu_torch.training.trainer import (create_train_state, loss_and_grads,
                                                          train_step)

    res = {}
    for arm, B, remat in LARGE_TRAIN_ARMS:
        cfg = load_config("large", joint_attention_impl="flash", gradient_checkpoint=remat,
                          tower_gradient_checkpoint=remat)
        cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
        m, d = cfg.model, cfg.data
        batch = make_dummy_batch(cfg, B, seed=0)
        dev_batch = batch_to_tensors(batch, "cuda")
        model = MerlotReservePretrainer(cfg, device="cuda", seed=0)
        print(f"[large train] {arm}: large pretrainer ({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"parameters, {m.num_heads} heads), batch {B}, remat {remat}", flush=True)

        # step 0: the kernel path against the plain path, the same draws, in
        # bf16 and in an f32 copy of the model (both remat knobs on, which
        # change no number, so that f32 fits)
        g = torch.Generator(device="cuda").manual_seed(5)
        split_at = [model.draw_split_at(B * d.num_segment_groups, d.num_segments_per_group, g)
                    for _ in range(2)]
        u = torch.rand((B, batch["text_spans"].shape[1]), generator=g, device="cuda")
        gumbel = -torch.log(-torch.log(u))
        model32 = MerlotReservePretrainer(cfg.replace_model(
            use_bfloat16=False, gradient_checkpoint=True, tower_gradient_checkpoint=True),
            device="meta").to_empty(device="cuda")
        model32.load_state_dict(model.state_dict())
        runs = {}
        paths = (("kernel_bf16", model, True, False), ("plain_bf16", model, True, True),
                 *((("kernel_f32", model32, False, False),) if arm == LARGE_F32_ARM else ()),
                 ("plain_f32", model32, False, True))
        for name, net, bf16, plain in paths:
            before = dict(kernels.LAUNCHES)
            with contextlib.ExitStack() as stack:
                if plain:
                    for patch in _plain_flash():
                        stack.enter_context(patch)
                vision_out = stack.enter_context(_vision_output_grads(net, LARGE_BF16_UNHELD))
                info, grads = loss_and_grads(net, dev_batch, use_bfloat16_grads=bf16,
                                             split_at=split_at, gumbel=gumbel)
            check(plain == (dict(kernels.LAUNCHES) == before),
                  f"large {arm}: the {name} path launched {'a' if plain else 'no'} kernel")
            runs[name] = (info, grads, vision_out)
        del model32, grads, vision_out, info
        agree = {f"{a} vs {b}": _compare_paths(runs[a], runs[b], f"[large train] {arm} {a} "
                                               f"vs {b}, step 0")
                 for a, b in (("kernel_bf16", "plain_bf16"), ("kernel_f32", "plain_f32"),
                              ("kernel_bf16", "plain_f32"), ("plain_bf16", "plain_f32"))
                 if a in runs}
        bf16 = agree["kernel_bf16 vs plain_bf16"]
        for k in ("imgs_to_audio", "text_to_audio", "stuff_to_span", "total"):
            check(bf16["loss_diff"][k] <= TRAIN_LOSS_TOL,
                  f"large {arm}: {k} kernel vs plain {bf16['loss_diff'][k]} > {TRAIN_LOSS_TOL}")
        check(bf16["whole"] >= TRAIN_MIN_COSINE,
              f"large {arm}: whole-gradient cosine {bf16['whole']} below {TRAIN_MIN_COSINE}")
        for key in ("seq_attnpool", "audio_encoder.seq_attnpool"):
            pooled = bf16["vision_outputs"][key]
            check(pooled >= TRAIN_MIN_VISION_INPUT_COSINE, f"large {arm}: gradient cosine at "
                  f"the pooled tokens {key} {pooled} below {TRAIN_MIN_VISION_INPUT_COSINE}")
        held = {n: c for n, c in bf16["tensors"].items() if n not in ZERO_GRAD
                and n.split(".")[0] not in LARGE_BF16_UNHELD}
        low = min(held.items(), key=lambda kv: kv[1])
        check(low[1] >= TRAIN_MIN_TENSOR_COSINE,
              f"large {arm}: gradient cosine of {low[0]} {low[1]} below "
              f"{TRAIN_MIN_TENSOR_COSINE}")
        # the cancelling parts against the f32 plain path: the kernel bf16
        # path no farther from it than the plain bf16 path
        near = {}
        k32, p32 = agree["kernel_bf16 vs plain_f32"], agree["plain_bf16 vs plain_f32"]
        for part, kc, pc in (("whole", k32["whole"], p32["whole"]),
                             *((f"output {o}", k32["vision_outputs"][o],
                                p32["vision_outputs"][o]) for o in k32["vision_outputs"])):
            near[part] = {"kernel_bf16": kc, "plain_bf16": pc}
            check(kc >= pc - TRAIN_VS_F32_MARGIN,
                  f"large {arm}: {part}: the kernel bf16 path's gradient cosine to the f32 "
                  f"plain path {kc} is below the plain bf16 path's {pc} by more than "
                  f"{TRAIN_VS_F32_MARGIN}")
        print(f"[large train] {arm}: gradient cosine to the f32 plain path, kernel bf16 / plain "
              f"bf16: { {k: (round(v['kernel_bf16'], 5), round(v['plain_bf16'], 5)) for k, v in near.items()} }",
              flush=True)
        if "kernel_f32 vs plain_f32" in agree:
            f32 = agree["kernel_f32 vs plain_f32"]
            for k in ("imgs_to_audio", "text_to_audio", "stuff_to_span", "total"):
                check(f32["loss_diff"][k] <= TRAIN_F32_LOSS_TOL, f"large {arm}: {k} f32 kernel "
                      f"vs plain {f32['loss_diff'][k]} > {TRAIN_F32_LOSS_TOL}")
            check(f32["lowest_held"][1] >= TRAIN_F32_MIN_COSINE,
                  f"large {arm}: f32 gradient cosine of {f32['lowest_held'][0]} "
                  f"{f32['lowest_held'][1]} below {TRAIN_F32_MIN_COSINE}")
        del runs
        torch.cuda.empty_cache()

        # the steps, counted and timed, the peak over them
        state = create_train_state(cfg, model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        infos, host_ms, device_ms, per_step = _counted_steps(
            lambda: train_step(state, dev_batch), LARGE_TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd = _expected_long_launches(cfg, 1)
        for i, counts in enumerate(per_step):
            check(counts.get("flash_fwd", 0) == fwd
                  and all(counts.get(n, 0) == bwd for n in BWD_LAUNCHES)
                  and counts.get("adam_update", 0) == 1,
                  f"large {arm} step {i}: launches {counts}, want flash_fwd {fwd}, each "
                  f"backward launch {bwd}, one adam_update")
        check(all(math.isfinite(v) for i_ in infos for v in i_.values()),
              f"large {arm}: non-finite loss")
        expected = _expected_init_losses(cfg, B)
        for head, ln_n in expected.items():
            check(abs(infos[0][head] - ln_n) < 0.05,
                  f"large {arm}: step-0 {head} loss {infos[0][head]} is not near ln N = {ln_n}")
        plan = memory.estimate_train_hbm(cfg, B)
        rows = B * (d.num_segment_groups * (d.num_audio2text_seqs + d.num_text2audio_seqs)
                    + 1 + d.num_text_seqs)
        r = {"batch": B, "remat": remat, "joint_rows": rows,
             "launches_per_step": per_step, "losses": infos,
             "expected_init_losses": expected, "agreement_step0": {
                 k: {"whole": v["whole"], "towers": v["towers"], "loss_diff": v["loss_diff"],
                     "vision_outputs": v["vision_outputs"], "lowest_held": v["lowest_held"]}
                 for k, v in agree.items()},
             "lowest_held_bf16": low, "near_f32": near,
             "step_ms_host": host_ms, "step_ms_device": device_ms,
             "step_ms_host_median": float(np.median(host_ms[1:])),
             "step_ms_device_median": float(np.median(device_ms[1:])),
             "max_memory_allocated_bytes": peak, "planner_bytes": plan["total"],
             "planner_error": (plan["total"] - peak) / peak}
        r["examples_per_s"] = B / r["step_ms_host_median"] * 1e3
        res[arm] = r
        print(f"[large train] {card}: {arm}: totals {[round(i_['total'], 5) for i_ in infos]}; "
              f"step ms host {[round(t, 1) for t in host_ms]}, device "
              f"{[round(t, 1) for t in device_ms]}; launches per step {per_step[-1]}; peak "
              f"{peak / 2**30:.2f} GiB, planner {plan['total'] / 2**30:.2f} GiB "
              f"({100 * r['planner_error']:+.1f}%)", flush=True)
        state.optimizer = None
        torch.cuda.empty_cache()
        if arm != LARGE_TRAIN_ARMS[-1][0]:
            del state, model
            torch.cuda.empty_cache()
    labels = _capture_labels(model, dev_batch)
    res["labels"] = {L: (v.shape[0], int((v > 0).sum()), int(s_.max()))
                     for L, (v, s_) in labels.items()}
    del dev_batch, state
    torch.cuda.empty_cache()
    return res, labels[d.seq_len], model


def phase_large_finetune(card, pretrained):
    """Phase 26: the finetuning recipes at batch 32 on the large config
    from ``pretrained`` (phase 25's trained pretrainer): VCR at 18x32 (joint
    8 rows of 288 an example) and TVQA at 7 segments (10 rows of 676), each
    ``finetune_train_step`` with ``scan_minibatch``, one example at a time,
    as the JAX recipe runs large TVQA (the whole batch of 32 runs out of
    memory on an 80 GB card). First the scanned step's first gradient, that
    of its first example, through the kernels against the plain path in an
    f32 copy, every tensor at TRAIN_F32_MIN_COSINE as phase 14 holds base;
    then the step: its loss at the step's weights within FINETUNE_LOSS_TOL
    of ln N, the launches from the config, both clocks, the peak and the
    joint rows. Returns the record and, by task, the joint tower's labels
    of one example (the shape each scanned launch gets)."""
    import torch

    from merlot_reserve_tpu_torch import kernels
    from merlot_reserve_tpu_torch.data.dummy import (TVQA_NUM_ANSWERS, VCR_NUM_ANSWERS,
                                                     make_dummy_tvqa_batch, make_dummy_vcr_batch)
    from merlot_reserve_tpu_torch.finetune import models as tm
    from merlot_reserve_tpu_torch.finetune import train as tt
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.parallel import memory
    from merlot_reserve_tpu_torch.utils.weights import flax_tensors_from_state_dict, load_flax_params

    tree = flax_tensors_from_state_dict(dict(pretrained.named_parameters()),
                                        pretrained.config.size_per_head)
    B = LARGE_FINETUNE_BATCH
    out, example_labels = {}, {}
    for task, cls, make_batch, loss_fn, ln_n in (
            ("vcr", tm.MerlotReserveVCR, make_dummy_vcr_batch, tt.vcr_loss_fn,
             math.log(VCR_NUM_ANSWERS)),
            ("tvqa", tm.MerlotReserveTVQA, make_dummy_tvqa_batch, tt.tvqa_loss_fn,
             2 * math.log(TVQA_NUM_ANSWERS))):
        cfg = _finetune_config(task, "large")
        m = cfg.model
        model = cls(cfg, device="cuda", seed=0)
        load_flax_params(model, tm.adapt_pretrained_params(tree, m.hidden_size,
                                                           drop_audio=task == "vcr"))
        dev_batch = batch_to_tensors(make_batch(cfg, B, seed=0), "cuda")
        first = {k: v[:1] for k, v in dev_batch.items()}  # the scanned step's first microbatch
        labels = _capture_labels(model, first)
        L = max(labels)
        example_labels[task] = labels[L]
        rows = B * labels[L][0].shape[0]

        # the scanned step's first gradient, kernel path against plain path,
        # in an f32 copy
        model32 = cls(_finetune_config(task, "large", use_bfloat16=False), device="cuda", seed=0)
        model32.load_state_dict(model.state_dict())
        grads = {}
        for path in ("kernel", "plain"):
            before = dict(kernels.LAUNCHES)
            named = {n: p.detach().requires_grad_() for n, p in model32.named_parameters()}
            with contextlib.ExitStack() as stack:
                if path == "plain":
                    for patch in _plain_flash():
                        stack.enter_context(patch)
                loss, _ = loss_fn(model32, named, first)
                got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
            check((path == "plain") == (dict(kernels.LAUNCHES) == before),
                  f"large {task}: the {path} path launched {'a' if path == 'plain' else 'no'} "
                  f"kernel")
            grads[path] = {n: (torch.zeros_like(p) if g is None else g).float()
                           for (n, p), g in zip(named.items(), got)}
        del model32, named, got, loss
        held = [n for n, g in grads["plain"].items()
                if n not in ZERO_GRAD + FINETUNE_ZERO_GRAD and bool(g.any())]
        agree = _agreement({n: grads["kernel"][n] for n in held},
                           {n: grads["plain"][n] for n in held})
        worst = sorted(agree["tensors"].items(), key=lambda kv: kv[1])[:6]
        lowest = worst[0]
        del grads
        torch.cuda.empty_cache()
        print(f"[large finetune] {task}: the scanned step's first gradient (example 0, "
              f"{labels[L][0].shape[0]} joint rows of {L}) in f32, kernel vs plain: whole "
              f"{agree['whole']:.7f}, per tower { {k: round(v, 7) for k, v in agree['towers'].items()} }, "
              f"lowest per tensor {[(n, round(c, 7)) for n, c in worst]}", flush=True)
        check(agree["whole"] >= TRAIN_F32_MIN_COSINE and lowest[1] >= TRAIN_F32_MIN_COSINE,
              f"large {task}: f32 gradient cosine, whole {agree['whole']}, of {lowest[0]} "
              f"{lowest[1]}, below {TRAIN_F32_MIN_COSINE}")

        # the step-0 loss: under scan_minibatch the step's own metric sums the
        # examples' bf16 losses in bf16, as the reference does (about 0.01 a
        # stream at 32 examples); here the bf16 losses of chunks of 8,
        # summed in f32, at the same weights
        used = {n: p.detach().to(torch.bfloat16) for n, p in model.named_parameters()}
        with torch.no_grad():
            loss0 = sum(float(loss_fn(model, used, {k: v[i:i + 8] for k, v in
                                                    dev_batch.items()})[0]) * min(8, B - i)
                        for i in range(0, B, 8)) / B
        del used
        state = tt.create_finetune_state(cfg, model)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        infos, host_ms, device_ms, per_step = _counted_steps(
            lambda: tt.finetune_train_step(state, dev_batch, loss_fn, scan_minibatch=True),
            LARGE_FINETUNE_STEPS)
        peak = torch.cuda.max_memory_allocated()
        # the planner models the pretraining step; a scanned finetuning step
        # runs one example at a time, so its batch-1 plan is the nearest
        plan = memory.estimate_train_hbm(cfg, 1)["total"]
        metric0 = infos[0]["loss"] if task == "vcr" else \
            infos[0]["loss_audio"] + infos[0]["loss_text"]
        check(all(math.isfinite(v) for i_ in infos for v in i_.values()),
              f"large {task}: non-finite")
        check(abs(loss0 - ln_n) < FINETUNE_LOSS_TOL,
              f"large {task}: step-0 loss {loss0} (the step's metric {metric0}) is not near "
              f"ln N = {ln_n}")
        want = m.joint_num_layers * B
        for i, counts in enumerate(per_step):
            check(all(counts.get(n, 0) == want for n in ("flash_fwd", *BWD_LAUNCHES))
                  and counts.get("adam_update", 0) == 1,
                  f"large {task} step {i}: launches {counts}, want {want} of flash_fwd and of "
                  f"each backward launch, one adam_update")
        out[task] = {"batch": B, "joint_rows": rows, "joint_len": L, "scan_minibatch": True,
                     "launches_per_step": per_step, "metrics": infos,
                     "step0_loss": loss0, "step0_metric": metric0, "expected_init_loss": ln_n,
                     "step_ms_host": host_ms, "step_ms_device": device_ms,
                     "examples_per_s": B / host_ms[-1] * 1e3,
                     "max_memory_allocated_bytes": peak, "planner_pretraining_bytes": plan,
                     "first_gradient_f32_kernel_vs_plain": {
                         "whole": agree["whole"], "towers": agree["towers"], "lowest": lowest}}
        print(f"[large finetune] {card}: {task}: {B} examples, joint {rows} rows of {L}; step-0 "
              f"loss {loss0:.5f} (the step's metric {metric0:.5f}; ln N {ln_n:.5f}); steps "
              f"{[round(t, 1) for t in host_ms]} ms host, {[round(t, 1) for t in device_ms]} ms "
              f"device (scan_minibatch); {out[task]['examples_per_s']:.2f} examples/s; peak "
              f"{peak / 2**30:.2f} GiB (the planner's pretraining step at batch 1 of this "
              f"config: {plan / 2**30:.2f} GiB); launches per step {per_step[-1]}", flush=True)
        del state, model, dev_batch, first, labels
        torch.cuda.empty_cache()
    return out, example_labels


# ---------------------------------------------------------------------------
# phase 28: pod readiness, a multi-card layout's step as one stand-in rank
# ---------------------------------------------------------------------------

POD_LAYOUTS = ("dp8", "dp2pp2tp2")  # rank 0 of dp8; both pipeline stages of dp2pp2tp2
POD_STEPS = 2
POD_TIMEOUT = 240
# each role's peak against the planner's total, the bound the committed
# stand-in rows are held to (tests/test_torch_pod_readiness.py)
POD_PLAN_TOL = 0.25
# dp8's rank 0 against phase 5's one card at the same 8 rows: it holds 1/8
# of the f32 masters and bf16 moments (8 bytes a parameter) but keeps bf16
# compute copies and bf16 gradients where one card keeps f32 gradients, so
# the drop is held within this share of 7/8 of the masters' and moments'
# bytes (predicted 9 bytes a parameter against 7, PERF.md section 6)
POD_DROP_TOL = 0.5


def _pod_expected_launches(cfg, pp):
    """A base step's launches on one stage without remat: the joint layers
    it holds, once per microbatch under pp, and the span tower's."""
    m = cfg.model
    joint = (m.joint_num_layers // pp) * (m.pipeline_microbatches if pp > 1 else 1)
    per = joint + m.span_num_layers
    return {"flash_fwd": per, **{n: per for n in BWD_LAUNCHES}, "adam_update": 1}


def phase_pod_readiness(card, train):
    """Phase 28: ``scripts/pod_readiness_torch.py`` on the card (base, phase
    5's 8 rows a dp rank): rank 0 of dp8 and both stages of dp2 x pp2 x tp2,
    each a stand-in rank on torch's fake process group (its collectives
    answered at once, its state, activations and kernels real), 2 steps
    each. Holds each role's launches per step (``flash_fwd``, the three
    backward launches, one ``adam_update``), its peak against the planner
    (``POD_PLAN_TOL``), and dp8's drop below phase 5's one-card peak
    against 7/8 of the masters' and moments' bytes (``POD_DROP_TOL``)."""
    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.parallel import memory, readiness

    cmd = [sys.executable, str(ROOT / "scripts" / "pod_readiness_torch.py"), "--config", "base",
           "--batch-per-chip", str(TRAIN_BATCH), "--steps", str(POD_STEPS),
           "--layouts", ",".join(POD_LAYOUTS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=POD_TIMEOUT, cwd=ROOT)
    seconds = time.perf_counter() - t0
    logs = ROOT / "chiprun_out" / "ranks"
    logs.mkdir(parents=True, exist_ok=True)
    (logs / "pod_readiness.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"pod_readiness_torch.py exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rows = {r["key"]: r for r in (json.loads(x) for x in proc.stdout.splitlines()
                                  if x.startswith("{"))}
    check(set(rows) == set(POD_LAYOUTS), f"pod readiness rows {sorted(rows)}")
    cfg = load_config("base")
    launches = {}
    for key, row in rows.items():
        check(row["run"] == "clean" and row["standin"], f"{key}: {row['run']}")
        layout = readiness.LAYOUTS[key]
        want = _pod_expected_launches(readiness.layout_config(cfg, layout), layout.axis("pp"))
        for role in row["roles"]:
            name = f"pod_readiness_{key}_rank{role['rank']}"
            for step, got in enumerate(role["launches_per_step"]):
                check(all(got.get(k, 0) == v for k, v in want.items()) and not got.get("ring_fwd"),
                      f"{name} step {step}: launches {got}, want {want}")
            launches[name] = {k: sum(c.get(k, 0) for c in role["launches_per_step"])
                              for k in ("flash_fwd", *BWD_LAUNCHES, "ring_fwd", "adam_update")}
            peak = role["peak_bytes"]
            plan = readiness.plan(readiness.layout_config(cfg, layout), layout,
                                  role["rows"])["total"]
            role["planner_error"] = (plan - peak) / peak
            print(f"[pod] {card}: {key} rank {role['rank']} ({role['world']} ranks, "
                  f"{role['rows']} rows): peak {peak / 2**30:.3f} GiB, planner "
                  f"{plan / 2**30:.3f} GiB ({100 * role['planner_error']:+.1f}%); launches per "
                  f"step {role['launches_per_step'][-1]}; collectives per step "
                  f"{role['comm_per_step'][-1]['total_count']} "
                  f"({role['comm_per_step'][-1]['total_bytes'] / 2**20:.1f} MiB); state built in "
                  f"{role['build_s']:.2f} s, steps {[round(t, 3) for t in role['step_s']]} s",
                  flush=True)
            check(abs(role["planner_error"]) <= POD_PLAN_TOL,
                  f"{key} rank {role['rank']}: planner {plan} against peak {peak}")
    dp8 = rows["dp8"]["roles"][0]
    one_card = train["max_memory_allocated_bytes"]
    drop = one_card - dp8["peak_bytes"]
    share = 7 / 8 * 8 * memory.param_count(cfg)
    print(f"[pod] {card}: dp8 rank 0 peaks {drop / 2**30:.3f} GiB below phase 5's one card "
          f"({one_card / 2**30:.3f} GiB); 7/8 of the masters' and moments' bytes "
          f"{share / 2**30:.3f} GiB (ratio {drop / share:.3f}); phase {seconds:.1f} s",
          flush=True)
    check(abs(drop / share - 1) <= POD_DROP_TOL,
          f"dp8 drop {drop} against 7/8 of the masters and moments {share}")
    return {"rows": rows, "launches": launches, "dp8_drop_bytes": drop,
            "masters_moments_7_8_bytes": share, "seconds": seconds}


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
    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of phase 20's or 22's jobs
        worker = ring_worker if sys.argv[2] == "ring" else rank_worker
        return worker(sys.argv[2], json.loads(sys.argv[3]))

    seconds = {}
    t_start = time.perf_counter()
    dev = phase_device()
    card = dev["nvidia_smi"]

    def timed(name, fn, *args, **kwargs):
        # each phase starts with the earlier phases' garbage collected (a
        # reference cycle can hold device memory until the collector runs)
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = time.perf_counter() - t0
            print(f"[time] phase {name}: {seconds[name]:.1f} s (run so far "
                  f"{time.perf_counter() - t_start:.1f} s; {held / 2**30:.2f} GiB allocated "
                  f"at its start)", flush=True)

    build = timed("2 build", phase_build)
    kern, bwd = timed("3 kernels", phase_kernels, [(case, *_labels(case, B, L, "cuda"))
                                                   for case, B, L in SERVING_CASES], seed=0)
    sl = timed("4 slice", phase_slice, card)
    train, labels = timed("5 train", phase_train, card)
    train_fwd, train_bwd = timed("6 training kernels", phase_kernels,
                                 [("train_joint", *labels[640]), ("train_span", *labels[16])],
                                 seed=2)
    ring, k_labels, long_fwd = timed("7 ring kernels", phase_ring_kernels, seed=3)
    sp, sp_arrays = timed("8 sequence-parallel serving", phase_slice_sp, card)
    raw = timed("9 raw media", phase_raw_media, card, seed=4)
    long, long_labels = timed("10 long-video training", phase_train_long, card)
    hop_fwd, hop_bwd = timed("11 hop kernels", phase_hop_kernels, long_labels[LONG_JOINT_LEN],
                             seed=5)
    adam = timed("12 adam", phase_adam, card, seed=6)
    ckpt = timed("13 checkpoints", phase_train_ckpt, card)
    try:
        ft, ft_labels = timed("14 finetuning", phase_finetune, card, str(CKPT_DIR / "pretrain"))
        ft_fwd, ft_bwd = timed("14 finetuning kernels", phase_kernels,
                               [("vcr_joint", *ft_labels["vcr"]),
                                ("tvqa_joint", *ft_labels["tvqa"])], seed=7)
        data = timed("15 data", phase_data, card)
        fixres, fixres_fwd, fixres_bwd, _ = timed("16 fixres", phase_fixres, card,
                                                  str(CKPT_DIR / "pretrain"))
        down = timed("17 downstream", phase_downstream, card,
                     str(CKPT_DIR / "fixres" / f"ckpt_{FIXRES_SCRIPT_STEPS}"))
        created = timed("18 created records", phase_created, card)
        exported = timed("19 export", phase_export, card, str(CKPT_DIR / "pretrain"),
                         str(CKPT_DIR / "vcr_finetuned"))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    distributed = timed("20 distributed", phase_distributed, card, train, long, fixres)
    soak = timed("21 soak", phase_soak, card)
    ring_procs = timed("22 ring across processes", phase_ring_procs, card, sp, sp_arrays,
                       _dist_cfg().model.joint_num_layers)
    try:
        large_sl = timed("23 large serving", phase_slice, card, "large")
        large_zs, zs_labels = timed("24 large zero-shot", phase_large_zero_shot, card, seed=10)
        large_train, large_labels, large_model = timed("25 large pretraining",
                                                       phase_large_train, card)
        large_ft, large_ft_labels = timed("26 large finetuning", phase_large_finetune, card,
                                          large_model)
        del large_model
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    large_fwd, _ = timed("27 large kernels", phase_kernels,
                         [("large_serving", *_labels("serving", 8, 640, "cuda")),
                          ("large_zero_shot", *zs_labels)],
                         seed=8, heads=LARGE_HEADS, backward=False)
    joint_fwd, large_bwd = timed("27 large kernels, joint", phase_kernels,
                                 [("large_joint", *large_labels),
                                  ("large_vcr_joint", *large_ft_labels["vcr"]),
                                  ("large_tvqa_joint", *large_ft_labels["tvqa"])],
                                 seed=9, heads=LARGE_HEADS)
    large_fwd += joint_fwd
    pod = timed("28 pod readiness", phase_pod_readiness, card, train)
    seconds["whole"] = time.perf_counter() - t_start
    print(f"[time] whole run {seconds['whole']:.1f} s", flush=True)

    main_case = next(r for r in kern if r["case"] == "serving" and r["dtype"] == "bf16")
    joint = next(r for r in train_bwd if r["case"] == "train_joint" and r["dtype"] == "bf16")
    long_ring = next(r for r in ring if r["case"] == "long_video" and r["dtype"] == "bf16")
    procs_long = ring_procs["cases"]["long_video bf16 n4 B8 L2560"]
    launches_by_path = {name: {"serving": sl["launches"].get(name, 0),
                               "train": train["launches"].get(name, 0),
                               "serving_sp4_long": sp["launches_long_sp4"].get(name, 0),
                               "serving_sp2_entry": sp["launches_entry_sp2"].get(name, 0),
                               "raw_media_zero_shot": raw["launches"].get(name, 0),
                               "train_sp4_long": long["arms"]["ring_flash_sp4"]["launches"]
                               .get(name, 0),
                               "train_long_flash": long["arms"]["flash"]["launches"]
                               .get(name, 0),
                               "train_checkpointed": ckpt["launches"].get(name, 0),
                               "finetune_vcr": ft["vcr"]["launches"].get(name, 0),
                               "finetune_tvqa": ft["tvqa"]["launches"].get(name, 0),
                               **{f"train_data_{feed}": r["launches"].get(name, 0)
                                  for feed, r in data["feeds"].items()},
                               "train_fixres_mixed": fixres["launches"].get(name, 0),
                               "pretrain_fixres_script": fixres["script"]["launches"]
                               .get(name, 0),
                               "validate_script": fixres["validate"]["launches"].get(name, 0),
                               **{f"finetune_{t}_records": r["launches"].get(name, 0)
                                  for t, r in down["finetune"].items()},
                               **{f"zero_shot_{t}": r["launches"].get(name, 0)
                                  for t, r in down["zero_shot"].items()},
                               "train_created_records": created["launches"].get(name, 0),
                               **{f"exported_{call}": n.get(name, 0) for call, n in
                                  exported["launches_per_call"].items()},
                               **{f"leaderboard_{k}": r["launches"].get(name, 0)
                                  for k, r in exported["leaderboard"].items()},
                               "train_world1_nccl": distributed["world1"]["arms"]
                               ["world1_nccl"]["launches"].get(name, 0),
                               "train_f32_adam": adam["f32_path"]["launches"].get(name, 0),
                               **{f"soak_{SOAK_CONFIG}_{arm}": n.get(name, 0)
                                  for arm, n in soak["launches"].items()},
                               "serving_sp4_long_batcher": sp["batcher"]["launches"]
                               .get(name, 0),
                               "large_serving": large_sl["launches"].get(name, 0),
                               "large_zero_shot": large_zs["launches"].get(name, 0),
                               **{f"large_train_{arm}": sum(c.get(name, 0) for c in
                                                            r["launches_per_step"])
                                  for arm, r in large_train.items() if arm != "labels"},
                               **{f"large_finetune_{t}_b{r['batch']}": sum(
                                   c.get(name, 0) for c in r["launches_per_step"])
                                  for t, r in large_ft.items()},
                               **{role: n.get(name, 0) for role, n in pod["launches"].items()}}
                        for name in ("flash_fwd", *BWD_LAUNCHES, "ring_fwd", "adam_update")}
    large_arms = {arm: r for arm, r in large_train.items() if arm != "labels"}
    ft_bwd16 = [r for r in ft_bwd if r["dtype"] == "bf16"]

    def bwd_entry(name):
        """One launch of the bf16 backward at train_joint: its device time
        alone and its own bound. Against its plain version: prep and convert
        their own (convert is held bit for bit), the fused pass the whole
        backward's (flash_attention_backward_reference); library_ms SDPA's
        backward for the fused pass, none for the two small passes."""
        err = {"flash_bwd_prep": joint["prep_delta_max_abs_err"], "flash_bwd_convert": 0.0}
        return {"name": name, "route": "cuda",
                "source": "merlot_reserve_tpu_torch/csrc/flash_bwd.cu",
                "replaces": "merlot_reserve_tpu/ops/attention.py:281 and "
                            "merlot_reserve_tpu/ops/attention.py:320",
                "launches": sum(launches_by_path[name].values()),
                "launches_by_path": launches_by_path[name],
                "launches_per_train_step": launches_by_path[name]["train"] / TRAIN_STEPS,
                "launches_per_sp4_long_train_step":
                    launches_by_path[name]["train_sp4_long"] / LONG_TRAIN_STEPS,
                "launches_per_fixres_mixed_step":
                    launches_by_path[name]["train_fixres_mixed"] / FIXRES_STEPS,
                "case": "train_joint bf16",
                "max_abs_err": err.get(name, max(e["max_abs_err"]
                                                 for e in joint["errors"].values())),
                "ms": joint["launch_ms"][name],
                "plain_ms": joint["launch_plain_ms"].get(name, joint["plain_ms"]),
                "bound_ms": joint["bounds"][name]["bound_ms"],
                "bound_by": joint["bounds"][name]["bound_by"],
                "library_ms": joint["sdpa_bwd_ms"] if name == "flash_bwd" else None,
                "hop_shapes": {f"{r['case']} B{r['B']} L{r['L']}": {
                    "ms": r["launch_ms"][name], "backward_ms": r["ms"],
                    "backward_bound_ms": r["bound_ms"], "backward_bound_by": r["bound_by"],
                    "backward_plain_ms": r["plain_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"]}
                    for r in hop_bwd},
                "finetune_shapes": {f"{r['case']} B{r['B']} L{r['L']}": {
                    "ms": r["launch_ms"][name], "bound_ms": r["bounds"][name]["bound_ms"],
                    "bound_by": r["bounds"][name]["bound_by"], "backward_ms": r["ms"],
                    "backward_bound_ms": r["bounds"]["both"]["bound_ms"],
                    "backward_bound_by": r["bounds"]["both"]["bound_by"],
                    "backward_plain_ms": r["plain_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"]}
                    for r in ft_bwd16},
                "fixres_shapes": {f"{r['case']} B{r['B']} L{r['L']}": {
                    "ms": r["launch_ms"][name], "bound_ms": r["bounds"][name]["bound_ms"],
                    "bound_by": r["bounds"][name]["bound_by"], "backward_ms": r["ms"],
                    "backward_bound_ms": r["bounds"]["both"]["bound_ms"],
                    "backward_bound_by": r["bounds"]["both"]["bound_by"],
                    "backward_plain_ms": r["plain_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"]}
                    for r in fixres_bwd if r["dtype"] == "bf16"},
                "launches_per_large_train_step": {
                    arm: r["launches_per_step"][-1].get(name, 0) for arm, r in large_arms.items()},
                "large_shapes": {f"{r['case']} B{r['B']} L{r['L']} H{r['H']}": {
                    "ms": r["launch_ms"][name], "bound_ms": r["bounds"][name]["bound_ms"],
                    "bound_by": r["bounds"][name]["bound_by"], "backward_ms": r["ms"],
                    "backward_bound_ms": r["bounds"]["both"]["bound_ms"],
                    "backward_bound_by": r["bounds"]["both"]["bound_by"],
                    "backward_plain_ms": r["plain_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"],
                    "max_abs_err": max(e["max_abs_err"] for e in r["errors"].values())}
                    for r in large_bwd if r["dtype"] == "bf16"}}

    def shapes(records, keys):
        """Per case: the times on both clocks, the bound and the factor over
        SDPA on the graph clock."""
        return {f"{r['case']} B{r['B']} L{r['L']}" + (f" n{r['n']}" if "n" in r else "")
                + (f" H{r['H']}" if r.get("H", 12) != 12 else ""): {
            **{k: r.get(k) for k in keys},
            "graph_vs_sdpa": r["graph_ms"] / r["sdpa_graph_ms"]} for r in records}

    fwd_keys = ("graph_ms", "ms", "sdpa_graph_ms", "sdpa_ms", "plain_ms", "bound_ms", "bound_by")
    fwd_shapes = shapes([r for r in kern + train_fwd + long_fwd + raw["fwd_kernels"] + hop_fwd
                         + ft_fwd + fixres_fwd + large_fwd if r["dtype"] == "bf16" and r["case"] in (
                             "serving", "train_joint", "train_span", "long_video",
                             "zero_shot_joint", "zero_shot_span", "vcr_joint", "tvqa_joint",
                             "fixres_joint_a", "fixres_joint_b", "large_serving", "large_joint",
                             "large_zero_shot", "large_vcr_joint", "large_tvqa_joint",
                             *(c for c, _, _ in HOP_CASES))], fwd_keys)
    ring_shapes = shapes([r for r in ring if r["dtype"] == "bf16" and (r["n"], r["B"], r["L"]) in
                          ((4, 8, 2560), (2, 8, 640), (4, 48, 640))],
                         ("graph_ms", "ms", "sdpa_graph_ms", "sdpa_ms", "bound_ms", "bound_by"))
    kernels_line = {"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "merlot_reserve_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "merlot_reserve_tpu/ops/attention.py:115",
         "launches": sum(launches_by_path["flash_fwd"].values()),
         "launches_by_path": launches_by_path["flash_fwd"], "case": "serving bf16",
         "launches_per_sp4_long_train_step":
             launches_by_path["flash_fwd"]["train_sp4_long"] / LONG_TRAIN_STEPS,
         "launches_per_fixres_mixed_step":
             launches_by_path["flash_fwd"]["train_fixres_mixed"] / FIXRES_STEPS,
         "launches_per_exported_batch": launches_by_path["flash_fwd"]["exported_full"],
         "launches_per_exported_label_space": launches_by_path["flash_fwd"]["exported_label"],
         "max_abs_err": main_case["max_abs_err_out"], "ms": main_case["graph_ms"],
         "event_ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
         "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
         "library_ms": main_case["sdpa_graph_ms"], "shapes": fwd_shapes},
        *(bwd_entry(name) for name in BWD_LAUNCHES),
        {"name": "ring_fwd", "route": "cuda",
         "source": "merlot_reserve_tpu_torch/csrc/ring_fwd.cu",
         "replaces": "merlot_reserve_tpu/ops/ring_attention.py:454",
         "launches": sum(launches_by_path["ring_fwd"].values()),
         "launches_by_path": launches_by_path["ring_fwd"],
         "case": "long_video bf16 n=4 B=8 L=2560",
         "max_abs_err": long_ring["max_abs_err"], "ms": long_ring["graph_ms"],
         "event_ms": long_ring["ms"], "plain_ms": long_ring["plain_ms"],
         "bound_ms": long_ring["bound_ms"], "bound_by": long_ring["bound_by"],
         "library_ms": long_ring["sdpa_graph_ms"], "shapes": ring_shapes},
        {"name": "ring_fwd_procs", "route": "cuda",
         "source": "merlot_reserve_tpu_torch/csrc/ring_fwd.cu",
         "replaces": "merlot_reserve_tpu/ops/ring_attention.py:454",
         "launches": ring_procs["serve"][4]["ranks"][0]["launches"]["ring_fwd_procs"],
         "launches_by_path": {f"serving_sp{n}_long_processes": [
             r["launches"]["ring_fwd_procs"] for r in v["ranks"]]
             for n, v in ring_procs["serve"].items()},
         "case": "long_video bf16 n=4 B=8 L=2560, one process per rank, four on one card",
         # the card time-slices the processes: no time of this run is the
         # kernel's, so none stands under ms, plain_ms or library_ms
         "max_abs_err": procs_long["max_abs_err"], "ms": None, "plain_ms": None,
         "library_ms": None, "time_sliced_ms_by_rank": procs_long["ms_by_rank"],
         "time_sliced_clock": TIME_SLICED,
         "bound_ms": long_ring["bound_ms"], "bound_by": long_ring["bound_by"],
         "bound_of": "the whole ring's function on these inputs, the n processes together "
                     "(phase 7's long_video bf16 row)",
         "routes": {k: v["routes"] for k, v in ring_procs["cases"].items()},
         "flag_round_trip_us": ring_procs["probe"][0]["round_trip_us"]},
        {"name": "adam_update", "route": "cuda",
         "source": "merlot_reserve_tpu_torch/csrc/adam_update.cu",
         "replaces": "merlot_reserve_tpu/training/optimization.py:64 (scale_by_bfloat16_adam "
                     "and the chains of :178 and :206, one XLA program; no Pallas kernel)",
         "launches": sum(launches_by_path["adam_update"].values()),
         "launches_by_path": launches_by_path["adam_update"],
         "case": "the base pretrainer's parameters, pretraining chain",
         "max_abs_err": max(r["max_abs_err"] for r in adam["chains"].values()),
         **{k: adam["chains"]["pretrain"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
             "plain_host_ms", "launches_per_update", "plain_launches_per_update")},
         "chains": adam["chains"], "decode_sweep": adam["decode_sweep"],
         "f32_moments": {
             "launches": launches_by_path["adam_update"]["train_f32_adam"],
             "max_abs_err": max(r["max_abs_err"] for r in adam["chains_f32"].values()),
             **{k: adam["chains_f32"]["pretrain"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
                 "plain_host_ms", "launches_per_update")},
             "chains": adam["chains_f32"]}},
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record = {"device": dev, "build": build, "kernels": kern, "bwd_kernels": bwd, "slice": sl,
              "train": train, "train_fwd_kernels": train_fwd, "train_bwd_kernels": train_bwd,
              "ring_kernels": ring, "fwd_kernel_key_labels": k_labels,
              "long_fwd_kernels": long_fwd, "slice_sp": sp, "raw_media": raw,
              "train_long": long, "hop_fwd_kernels": hop_fwd, "hop_bwd_kernels": hop_bwd,
              "adam": adam, "train_checkpointed": ckpt, "finetune": ft,
              "finetune_fwd_kernels": ft_fwd, "finetune_bwd_kernels": ft_bwd,
              "data": data, "fixres": fixres, "fixres_fwd_kernels": fixres_fwd,
              "fixres_bwd_kernels": fixres_bwd, "downstream": down, "created": created,
              "export": exported, "distributed": distributed, "soak": soak,
              "ring_procs": ring_procs, "large_serving": large_sl, "large_zero_shot": large_zs,
              "large_train": large_train, "large_finetune": large_ft,
              "large_fwd_kernels": large_fwd, "large_bwd_kernels": large_bwd,
              "pod_readiness": pod,
              "phase_seconds": seconds, "kernels_line": kernels_line}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels_line))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                              "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
