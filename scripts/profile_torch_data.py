#!/usr/bin/env python3
"""Where a pretraining step fed from TFRecords spends its time, on the card.

``python3 scripts/profile_torch_data.py`` (from the repository root, on a
machine with a CUDA card) writes a synthetic corpus at the base shapes and
measures, apart from any training step:
  * the loaders alone: batches per second of the host-assembled
    ``PretrainLoader`` and of the raw ``DevicePretrainLoader(fused=True,
    on_device_frames=True)``, with their worker threads, over ``--batches``
    (20) after a warm-up, with the rate over each 5 of them as the spread;
    the host loader also on spawned processes (``use_processes=True``) at
    1, 2, 4 and 8 workers beside its threads at the same counts;
  * what a process pool's workers do at once, each count of workers
    against as many threads: the aggregate rate of the JPEG decodes alone
    and of the host builder's ``build`` alone (decode, resize, masking),
    each worker with its own records; and the parent's cost of one
    example through pickle (what a pool's pipe carries back);
  * one worker's cost per example: the JPEG decodes, the host builder's
    ``build`` (decode, resize, masking), and ``host_prepare`` with
    ``host_prepare_frames`` (what the fused path's workers do);
  * the device feed: the host's copy into the pinned buffers and the
    copy to the card, per batch of each kind;
  * the device builder: the host's time to enqueue ``build_batch`` and its
    time on the device clock;
  * the fused step and the plain step: the host's enqueue time (until the
    call returns) against the device clock.
It prints the card's name and power limit and one JSON line, and writes
``chiprun_out/profile_torch_data.json``.
"""

import argparse
import itertools
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def cuda_ms(fn, iters=5, warmup=1):
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


def host_ms(fn, iters=5, warmup=1):
    """The host's time until ``fn`` returns (its enqueue), synchronised
    before each call so that no earlier work is waited for inside it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def first(loader):
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()  # stops the loader's worker threads


def loader_rate(loader, batches, window=5):
    """Batches/s over ``batches`` after the first, and the rate over each
    ``window`` of them (the spread)."""
    it = iter(loader)
    next(it)  # warm-up: the workers' first batch
    stamps = [time.perf_counter()]
    for _ in range(batches):
        next(it)
        stamps.append(time.perf_counter())
    it.close()
    return {"batches_per_s": batches / (stamps[-1] - stamps[0]),
            "by_window": [window / (stamps[i + window] - stamps[i])
                          for i in range(0, batches - window + 1, window)]}


def _decode_many(jpegs, repeats):
    """A worker's share of the JPEG decodes: seconds for ``repeats`` passes."""
    from merlot_reserve_tpu_torch.data import native

    t0 = time.perf_counter()
    for _ in range(repeats):
        for data, channels in jpegs:
            native.decode_jpeg_native(data, channels)
    return time.perf_counter() - t0


def _build_many(records, cfg, repeats):
    """A worker's share of the host builder's work: seconds for ``repeats``
    passes of ``build`` over ``records``."""
    import numpy as np

    from merlot_reserve_tpu_torch.data.pretrain_pipeline import (PretrainExampleBuilder,
                                                                 parse_segment_record)

    builder = PretrainExampleBuilder(cfg)
    t0 = time.perf_counter()
    for r in range(repeats):
        for i, record in enumerate(records):
            builder.build(parse_segment_record(record, cfg.data.num_segments),
                          np.random.default_rng((r, i)))
    return time.perf_counter() - t0


def pool_rates(fn, args, units, counts):
    """{count: (units per s on that many threads, on that many spawned
    processes)}: every worker runs ``fn(*args)`` once to warm up (imports,
    the codec's per-process and per-thread state), then once more, all at
    once; the rate is the units done over the wall time of that round."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    out = {}
    for n in counts:
        rates = []
        for pool in (ThreadPoolExecutor(n),
                     ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn"))):
            with pool:
                for f in [pool.submit(fn, *args) for _ in range(n)]:
                    f.result()
                t0 = time.perf_counter()
                for f in [pool.submit(fn, *args) for _ in range(n)]:
                    f.result()
                rates.append(n * units / (time.perf_counter() - t0))
        out[n] = rates
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=20, help="batches timed per loader")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data import native
    from merlot_reserve_tpu_torch.data.device_builder import BuilderDraws, DeviceExampleBuilder
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
    from merlot_reserve_tpu_torch.data.loader import (DeviceFeed, DevicePretrainLoader,
                                                      PretrainLoader)
    from merlot_reserve_tpu_torch.data.pretrain_pipeline import (PretrainExampleBuilder,
                                                                 parse_segment_record)
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
    from merlot_reserve_tpu_torch.training.trainer import (create_train_state,
                                                           make_fused_data_train_step, train_step)

    if not torch.cuda.is_available():
        print("profile_torch_data: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = load_config("base", joint_attention_impl="flash")
    B, d = args.batch, cfg.data
    res = {"card": card, "batch": B, "workers": args.workers, "codec": native.jpeg_codec()}
    with tempfile.TemporaryDirectory(prefix="profile_data_") as tmp:
        files = [write_synthetic_corpus(os.path.join(tmp, f"s{i}.tfrecord"), cfg, num_records=8,
                                        seed=i, structured=True) for i in range(2)]
        kw = dict(seed=0, num_workers=args.workers, use_bfloat16=True, files_per_cycle=2,
                  parallel_reads=2, shuffle_buffer=8)
        res["loader_batches_per_s"] = {
            "host": loader_rate(PretrainLoader(files, cfg, B, **kw), args.batches),
            "fused_frames": loader_rate(DevicePretrainLoader(
                files, cfg, B, fused=True, on_device_frames=True, **kw), args.batches)}
        counts = [n for n in (1, 2, 4, 8) if n <= args.workers]
        res["host_loader_batches_per_s_by_workers"] = {
            n: {kind: loader_rate(PretrainLoader(files, cfg, B, use_processes=procs,
                                                 **{**kw, "num_workers": n}), args.batches)
                for kind, procs in (("threads", False), ("processes", True))}
            for n in counts}

        # a pool's workers at once: the decodes alone, the builder alone
        pool_records = list(native.read_records_native(files[0]))[:2]
        jpegs = [(bytes(x[k][0]), c)
                 for x in parse_segment_record(pool_records[0], d.num_segments)
                 for k, c in (("image/encoded", 3), ("spectrogram/encoded", 1))]
        decode_rates = pool_rates(_decode_many, (jpegs, 4), 4 * len(jpegs), counts)
        build_rates = pool_rates(_build_many, (pool_records, cfg, 2), 2 * len(pool_records),
                                 counts)
        example = PretrainExampleBuilder(cfg).build(
            parse_segment_record(pool_records[0], d.num_segments), np.random.default_rng(0))
        t0 = time.perf_counter()
        blob = pickle.dumps(example, protocol=pickle.HIGHEST_PROTOCOL)
        pickle.loads(blob)
        res["pool"] = {
            "decodes_per_s": {n: {"threads": t, "processes": p}
                              for n, (t, p) in decode_rates.items()},
            "examples_per_s": {n: {"threads": t, "processes": p}
                               for n, (t, p) in build_rates.items()},
            "example_pickle_bytes": len(blob),
            "example_pickle_round_trip_ms": (time.perf_counter() - t0) * 1e3}

        records = list(itertools.islice(native.read_records_native(files[0]), 4))
        segs = [parse_segment_record(r, d.num_segments) for r in records]
        hb, db = PretrainExampleBuilder(cfg), DeviceExampleBuilder(cfg)

        def per_example(fn):
            t0 = time.perf_counter()
            for i, s in enumerate(segs):
                fn(i, s)
            return (time.perf_counter() - t0) * 1e3 / len(segs)

        res["worker_ms_per_example"] = {
            "jpeg_decodes": per_example(lambda i, s: [
                native.decode_jpeg_native(bytes(x[k][0]), c) for x in s
                for k, c in (("image/encoded", 3), ("spectrogram/encoded", 1))]),
            "host_build": per_example(lambda i, s: hb.build(s, np.random.default_rng(i))),
            "host_prepare_and_frames": per_example(
                lambda i, s: (db.host_prepare(s), db.host_prepare_frames(s))),
        }

        # the feed, per kind of batch
        host_batch = first(PretrainLoader(files, cfg, B, **kw))
        raw_batch = first(DevicePretrainLoader(files, cfg, B, fused=True, on_device_frames=True,
                                               **kw))
        narrow = {"images": torch.bfloat16, "audio_clips": torch.bfloat16}
        res["feed"] = {}
        for name, batch, widen in (("dummy", make_dummy_batch(cfg, B, seed=0), True),
                                   ("host", host_batch, True), ("fused_frames", raw_batch, False)):
            feed = DeviceFeed(itertools.repeat(batch), "cuda", narrow=narrow, widen_ints=widen)
            it = iter(feed)
            for _ in range(3):
                next(it)
            torch.cuda.synchronize()
            host_copy = host_ms(lambda: next(it), iters=5, warmup=0)
            res["feed"][name] = {"bytes": feed.bytes_per_batch,
                                 "host_ms_per_batch": host_copy,
                                 "h2d_ms": float(np.median(feed.copy_ms()))}

        # the builder and the two steps
        raw = DeviceFeed([], "cuda", widen_ints=False).to_device(raw_batch)
        build = lambda: db.build_batch(raw, BuilderDraws(0, 0, "cuda"))  # noqa: E731
        res["builder"] = {"host_enqueue_ms": host_ms(build), "device_ms": cuda_ms(build)}
        model = MerlotReservePretrainer(cfg, device="cuda", seed=0)
        state = create_train_state(cfg, model)
        dummy = DeviceFeed([], "cuda", narrow=narrow).to_device(make_dummy_batch(cfg, B, seed=0))
        fused = make_fused_data_train_step(db, data_seed=0)
        res["steps"] = {}
        for name, fn in (("plain", lambda: train_step(state, dummy)),
                         ("fused_frames", lambda: fused(state, raw))):
            res["steps"][name] = {"host_enqueue_ms": host_ms(fn, iters=3),
                                  "device_ms": cuda_ms(fn, iters=3)}
    print(card)
    print(json.dumps(res))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_data.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
