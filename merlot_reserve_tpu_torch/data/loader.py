"""Input iterator: multi-file, multi-worker, prefetching pretraining loader,
and the feed that moves its batches to the card.

The port of ``merlot_reserve_tpu/data/loader.py``: the reference's
input_fn_builder (reference pretrain/dataloader.py:864-960) without tf.data.
Per-host file sharding (i % num_hosts == host_index), epoch-shuffled file
cycles of ``n_fns_per_cycle`` files whose records interleave round-robin
across up to ``num_parallel_reads`` readers, then a ``shuffle_buffer_size``
shuffle buffer, a pool of worker threads decoding and masking examples,
fixed-size batches, and per-file / per-record crash-only error handling
(dataloader.py:943-955). The record order, and the per-example numpy RNG
keyed by (seed, epoch, file, record), are the JAX package's, so with the
same files and seed both loaders yield the same examples.

The workers are threads, or with ``use_processes=True`` spawned processes
(the masking is Python that holds the GIL). A process gets the loader's
host-only state once, through the pool's initializer (``_RecordWork``: the
config and fresh builders, never a tensor on the card); a task carries a
record's bytes and its RNG key and returns numpy arrays. Collation, and the
device builder's ``build_batch``, stay in the parent.

``DevicePretrainLoader`` moves example assembly to the card
(``data/device_builder.py``): its workers only decode bytes. With
``fused=True`` it yields the raw host arrays and the assembly runs inside
the training step (``training/trainer.make_fused_data_train_step``).

``DeviceFeed`` copies batches to the card through reused pinned buffers on
a side stream, in their narrow dtypes; integer indices are widened there.
"""

from __future__ import annotations

import collections
import multiprocessing
import queue
import random as pyrandom
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.data.native import read_records_native
from merlot_reserve_tpu_torch.data.pretrain_pipeline import (
    PretrainExampleBuilder,
    collate_batch,
    parse_segment_record,
)
from merlot_reserve_tpu_torch.utils.device import resolve_device


class _RecordWork:
    """A record's bytes and RNG key -> one example: the loader's host-only
    state. Worker threads share the loader's instance. A process gets it
    pickled once, as the config alone (``__reduce__``), and builds its own
    builders from it, so no lock and no tensor on the card is pickled.

    With ``device_builder`` (a ``DeviceExampleBuilder``, or True to build
    one) the example is ``host_prepare``'s arrays and, unless
    ``on_device_frames``, the decoded images; else the host builder's
    example."""

    def __init__(self, cfg: MerlotConfig, device_builder=None, on_device_frames: bool = False):
        self.cfg = cfg
        self.builder = PretrainExampleBuilder(cfg)
        if device_builder is True:
            from merlot_reserve_tpu_torch.data.device_builder import DeviceExampleBuilder

            device_builder = DeviceExampleBuilder(cfg)
        self.device_builder = device_builder or None
        self.on_device_frames = on_device_frames

    def __reduce__(self):
        return _RecordWork, (self.cfg, self.device_builder is not None, self.on_device_frames)

    def __call__(self, record: bytes, key: Tuple[int, ...]):
        rng = np.random.default_rng(key)
        segments = parse_segment_record(record, self.cfg.data.num_segments)
        if self.device_builder is None:
            return self.builder.build(segments, rng)
        raw = self.device_builder.host_prepare(segments)
        if self.on_device_frames:
            raw.update(self.device_builder.host_prepare_frames(segments))
            return raw, None
        return raw, np.stack([self.builder.decode_image(s, rng) for s in segments])


_PROCESS_WORK: Optional[_RecordWork] = None  # one per worker process


def _init_process(work: _RecordWork):
    global _PROCESS_WORK
    _PROCESS_WORK = work


def _run_record(work: Optional[_RecordWork], record: bytes, key: Tuple[int, ...]):
    """One record -> (example, the device builder's counts to add to the
    loader's, or None). ``work`` is the loader's own on a thread; None in a
    worker process, which runs its initializer's copy and hands back what
    that copy counted."""
    if work is not None:
        return work(record, key), None
    dev = _PROCESS_WORK.device_builder
    return _PROCESS_WORK(record, key), (dev.take_stats() if dev is not None else None)


class PretrainLoader:
    """Iterate fixed-shape pretraining batches from TFRecord shards."""

    def __init__(self, file_paths: List[str], cfg: MerlotConfig, batch_size: int,
                 host_index: int = 0, num_hosts: int = 1,
                 seed: Optional[int] = None, num_workers: int = 8,
                 prefetch: int = 4, use_bfloat16: bool = False,
                 repeat: bool = True, use_processes: bool = False,
                 files_per_cycle: Optional[int] = None,
                 parallel_reads: Optional[int] = None,
                 shuffle_buffer: Optional[int] = None):
        self.files = [f for i, f in enumerate(file_paths)
                      if i % num_hosts == host_index]
        if not self.files:
            raise ValueError("no input files for this host")
        self.cfg = cfg
        self.batch_size = batch_size
        self.use_bfloat16 = use_bfloat16
        self.repeat = repeat
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed if seed is not None else int(time.time())
        # decorrelation knobs; None picks up the config's device section
        # (the reference YAML surface: n_fns_per_cycle / num_parallel_reads
        # / shuffle_buffer_size)
        dev = cfg.device
        self.files_per_cycle = (files_per_cycle if files_per_cycle is not None
                                else dev.n_fns_per_cycle)
        self.parallel_reads = (parallel_reads if parallel_reads is not None
                               else dev.num_parallel_reads)
        self.shuffle_buffer = (shuffle_buffer if shuffle_buffer is not None
                               else dev.shuffle_buffer_size)
        # processes sidestep the GIL for the masking; threads are enough
        # when the JPEG decode (which releases it) dominates
        self.use_processes = use_processes
        self._work = _RecordWork(cfg)
        self._consumed = 0     # records consumed by yielded batches (incl. skips)
        self._skipped = 0      # corrupt records dropped (observability)
        self._iterating = False

    # -- resumable data state (beyond the reference: dataloader.py:922-924
    # deliberately re-seeds with time() on restart, losing the position) ----

    def state_dict(self) -> Dict:
        """Checkpointable position: restore with ``load_state_dict`` on a
        loader built with the SAME files/seed to continue the exact record
        sequence (per-example RNG is keyed by (seed, epoch, file, record),
        so the continuation is bit-identical)."""
        return {"seed": self.seed, "records_consumed": int(self._consumed),
                "records_skipped": int(self._skipped),
                "num_files": len(self.files),
                "shuffle": [self.files_per_cycle, self.parallel_reads,
                            self.shuffle_buffer]}

    def load_state_dict(self, state: Dict):
        if state.get("seed") != self.seed or \
                state.get("num_files") != len(self.files):
            raise ValueError("loader state does not match this loader's "
                             "seed/file shard — resume would silently "
                             "change the data stream")
        want = [self.files_per_cycle, self.parallel_reads,
                self.shuffle_buffer]
        if state.get("shuffle", want) != want:
            raise ValueError("loader state was written with different "
                             "cycle/interleave/shuffle settings — resume "
                             "would silently change the data stream")
        self._consumed = int(state["records_consumed"])

    def _record_stream(self, skip: int = 0):
        """(record_bytes, per-example RNG key) pairs: epoch-shuffled file cycles
        -> round-robin interleave -> shuffle buffer. ``skip`` fast-forwards
        that many POST-shuffle records (bytes are read and the shuffle RNG
        replays deterministically, but no decode/masking happens — resume
        cost is sequential IO only)."""
        for item in self._shuffled_records():
            if skip > 0:
                skip -= 1
                continue
            yield item

    def _interleave_cycle(self, cycle_files, epoch: int, base_fi: int):
        """Round-robin records from up to ``parallel_reads`` concurrently
        open readers over one cycle's files (TFRecordDataset
        num_parallel_reads semantics); per-file errors drop that reader and
        move on (crash-only, dataloader.py:943-955)."""
        pending = list(enumerate(cycle_files))

        def open_next():
            while pending:
                fi, path = pending.pop(0)
                try:
                    return [fi, path, iter(read_records_native(path)), 0]
                except Exception as e:
                    print(f"loader error opening {path}: "
                          f"{type(e).__name__}: {e}", flush=True)
                    time.sleep(1.0)
            return None

        k = max(1, min(self.parallel_reads, len(cycle_files)))
        readers = []
        for _ in range(k):
            r = open_next()
            if r:
                readers.append(r)
        i = 0
        while readers:
            r = readers[i % len(readers)]
            try:
                record = next(r[2])
            except StopIteration:
                readers.remove(r)
                nr = open_next()
                if nr:
                    readers.append(nr)
                continue
            except Exception as e:
                print(f"loader error on {r[1]}: {type(e).__name__}: {e}",
                      flush=True)
                time.sleep(1.0)
                readers.remove(r)
                nr = open_next()
                if nr:
                    readers.append(nr)
                continue
            ri = r[3]
            r[3] += 1
            yield record, (self.seed, epoch, base_fi + r[0], ri)
            i += 1

    def _shuffled_records(self):
        """Cycles of ``files_per_cycle`` files, interleaved, through a
        ``shuffle_buffer``-element shuffle (fill buffer, emit a uniformly
        random element, refill — tf.data shuffle semantics with an explicit
        seeded RNG; buffer drains at each cycle boundary like the
        reference's per-cycle datasets).

        Memory: the buffer holds RAW record bytes — at base-corpus record
        sizes (~0.5-1 MB) the reference-parity 4096 buffer costs a few GB
        of host RAM, same as the reference's tf.data shuffle. Pass a
        smaller ``shuffle_buffer`` on small hosts."""
        rng_files = pyrandom.Random(self.seed)
        rng_shuf = pyrandom.Random(self.seed ^ 0x5DEECE66D)
        epoch = 0
        while True:
            files = list(self.files)
            rng_files.shuffle(files)
            fpc = max(1, min(self.files_per_cycle, len(files)))
            for c0 in range(0, len(files), fpc):
                buf = []
                for item in self._interleave_cycle(files[c0:c0 + fpc],
                                                   epoch, c0):
                    if self.shuffle_buffer <= 1:
                        yield item
                        continue
                    buf.append(item)
                    if len(buf) >= self.shuffle_buffer:
                        j = rng_shuf.randrange(len(buf))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
                while buf:
                    j = rng_shuf.randrange(len(buf))
                    buf[j], buf[-1] = buf[-1], buf[j]
                    yield buf.pop()
            epoch += 1
            if not self.repeat:
                return

    def _pool(self):
        if self.use_processes:
            return ProcessPoolExecutor(self.num_workers,
                                       mp_context=multiprocessing.get_context("spawn"),
                                       initializer=_init_process, initargs=(self._work,))
        return ThreadPoolExecutor(self.num_workers)

    def _collate(self, examples):
        """Batch assembly hook (DevicePretrainLoader overrides this to run
        the on-device example builder instead)."""
        return collate_batch(examples, use_bfloat16=self.use_bfloat16)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield collated batches; decode+mask runs on a worker pool ahead of
        consumption (the prefetch_to_device role moves to the trainer, which
        enqueues the next batch while the step runs).

        Every iteration CONTINUES from the current position (``_consumed``
        records, as restored by load_state_dict or advanced by previous
        iteration) — re-iterating never replays records already yielded, so
        the resumable position stays a true stream offset. A repeat=False
        loader is therefore exhausted for good after one pass; build a new
        loader (new seed) for another epoch."""
        if self._iterating:
            raise RuntimeError("PretrainLoader does not support concurrent "
                               "iteration (the stream position is shared)")
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer_error: List[BaseException] = []

        def producer():
            # NOTE: Executor.map consumes its iterable EAGERLY — on an
            # infinite (repeat=True) stream it would submit forever. Keep a
            # bounded window of in-flight decode jobs instead.
            def put_or_stop(item) -> bool:
                # never block forever: a consumer that stops early (e.g.
                # run_pretraining hit num_steps) must not leak this thread
                # parked in a full queue
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.5)
                        return True
                    except queue.Full:
                        continue
                return False

            pool = None
            try:
                pool = self._pool()
                task_work = None if self.use_processes else self._work
                stream = self._record_stream(skip=self._consumed)
                window = max(2 * self.num_workers, self.batch_size)
                inflight = collections.deque()
                batch_examples = []
                skipped_in_batch = 0
                while not stop.is_set():
                    while len(inflight) < window:
                        try:
                            inflight.append(pool.submit(_run_record, task_work, *next(stream)))
                        except StopIteration:
                            break
                    if not inflight:
                        break
                    # Per-record resilience: one poisoned record must not
                    # end the stream (the reference swallows ANY pipeline
                    # error and resumes, dataloader.py:943-955 — we skip
                    # and COUNT instead of swallowing silently).
                    try:
                        ex, counts = inflight.popleft().result()
                    except BrokenProcessPool:
                        raise  # a dead worker is the producer's failure, not a record's
                    except Exception as e:
                        self._skipped += 1
                        skipped_in_batch += 1
                        print(f"loader: skipping corrupt record "
                              f"({type(e).__name__}: {e}); "
                              f"{self._skipped} skipped total", flush=True)
                        continue
                    if counts:
                        self._work.device_builder.add_stats(counts)
                    batch_examples.append(ex)
                    if len(batch_examples) == self.batch_size:
                        batch = self._collate(batch_examples)
                        # the batch "consumed" its skips too, so the
                        # resume position stays a raw-record count
                        if not put_or_stop(
                                (batch,
                                 self.batch_size + skipped_in_batch)):
                            break
                        batch_examples = []
                        skipped_in_batch = 0
            except Exception as e:
                # a producer-level failure (collate/device error, not a
                # per-record skip) must surface to the trainer — ending the
                # stream here would read as "input exhausted" and a long
                # pretraining job would exit hours early WITH SUCCESS status
                print(f"loader producer died: {type(e).__name__}: {e}", flush=True)
                producer_error.append(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=True, cancel_futures=True)
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        self._iterating = True
        try:
            while True:
                item = out_q.get()
                if item is None:
                    if producer_error:
                        raise RuntimeError(
                            "loader producer failed") from producer_error[0]
                    return
                batch, n_records = item
                self._consumed += n_records
                yield batch
        finally:
            self._iterating = False
            stop.set()
            t.join()  # the workers have stopped when the iteration ends


class DevicePretrainLoader(PretrainLoader):
    """PretrainLoader with example assembly moved onto the card.

    The workers only decode bytes (JPEG spectrograms and, unless
    ``on_device_frames``, frames; protobuf fields to fixed-shape arrays
    through ``DeviceExampleBuilder.host_prepare``). With ``fused=False`` the
    masking, placement and collation run per batch on ``device`` in
    ``_collate``, with draws from ``BuilderDraws(seed, batch_counter)``; the
    counter restarts on resume, so the draws differ from an uninterrupted
    run while the record sequence stays exact (as in the JAX package). With
    ``fused=True`` the loader yields the raw host arrays and makes no device
    call; the training step assembles the batch with draws keyed by its own
    step (``training/trainer.make_fused_data_train_step``), which a resume
    restores. ``on_device_frames`` moves frame flip, resize, augmentation
    and patchify onto the card too (``ops/vision_train.py``)."""

    def __init__(self, *args, fused: bool = False, on_device_frames: Optional[bool] = None,
                 device="cuda", **kw):
        super().__init__(*args, **kw)
        from merlot_reserve_tpu_torch.data.device_builder import DeviceExampleBuilder

        self._dev_builder = DeviceExampleBuilder(self.cfg)
        self._batch_counter = 0
        self.fused = fused
        self.on_device_frames = (self.cfg.data.on_device_frames if on_device_frames is None
                                 else on_device_frames)
        self.device = None if fused else resolve_device(device)
        self._work = _RecordWork(self.cfg, self._dev_builder, self.on_device_frames)

    def _collate(self, examples):
        from merlot_reserve_tpu_torch.data.device_builder import BuilderDraws, stack_raw_examples

        raw_batch = stack_raw_examples([r for r, _ in examples])
        images = None
        if not self.on_device_frames:
            stacked = np.stack([im for _, im in examples])
            images = stacked.reshape(stacked.shape[0], -1, stacked.shape[-1])
            # cast here, in the worker: the images are most of the bytes a
            # step copies to the card
            images = (torch.from_numpy(images).to(torch.bfloat16) if self.use_bfloat16
                      else images)
        if self.fused:
            if images is not None:
                raw_batch["images"] = images
            return raw_batch
        draws = BuilderDraws(self.seed, self._batch_counter, self.device)
        self._batch_counter += 1
        raw_dev = {k: torch.from_numpy(v).to(self.device) for k, v in raw_batch.items()}
        batch = dict(self._dev_builder.build_batch(raw_dev, draws))
        if images is not None:
            batch["images"] = torch.as_tensor(images).to(self.device)
        return batch


def input_fn_builder(cfg: MerlotConfig, file_paths: List[str], host_index: int = 0,
                     num_hosts: int = 1, seed: Optional[int] = None, on_device: bool = False,
                     **kw) -> PretrainLoader:
    """Reference-shaped constructor (dataloader.py:906-960): the global batch
    is divided by num_hosts; each host reads its file shard.
    ``on_device=True`` assembles examples on the card (DevicePretrainLoader)."""
    if cfg.device.batch_size % num_hosts:
        raise ValueError(f"global batch {cfg.device.batch_size} must divide across "
                         f"{num_hosts} hosts (the reference divides exactly, dataloader.py:920)")
    cls = DevicePretrainLoader if on_device else PretrainLoader
    return cls(file_paths, cfg, cfg.device.batch_size // num_hosts, host_index=host_index,
               num_hosts=num_hosts, seed=seed, **kw)


class DeviceFeed:
    """Batches (dicts of numpy arrays or CPU tensors) to tensors on ``device``.

    On the card, each batch is written into pinned host buffers, reused
    round-robin over ``DEPTH`` slots, and copied with ``non_blocking``
    copies on a side stream; the consumer's stream waits on the copy's
    event, and a slot is refilled only after its last copy has completed.
    Values cross in narrow dtypes: uint8 stays uint8, int64 goes as int32
    (indices and tokens; checked to fit), float64 as float32, and the keys
    of ``narrow`` as the dtype given there (bf16 images). With
    ``widen_ints`` int32 tensors are widened to int64 on the card (the
    model's index dtype); a raw batch for the device builder keeps int32.
    A batch already on the card is not copied. On the CPU the feed hands
    over tensors with the same dtypes and does not pin.

    A batch is copied when the consumer asks for it, not before: a loader's
    position (``state_dict``) then counts exactly the batches consumed, and
    the copy still overlaps the device's work on the previous step, which
    runs behind the host. ``copies`` keeps the last 64 copies' (start event,
    end event, bytes); ``copy_ms`` reads their device times.
    """

    DEPTH = 2  # one slot filling while the other's copy may still run

    def __init__(self, batches: Iterable[Dict], device, narrow: Optional[Dict] = None,
                 widen_ints: bool = True):
        self.batches = batches
        self.device = resolve_device(device)
        self.narrow = dict(narrow or {})
        self.widen_ints = widen_ints
        self.pinned = self.device.type == "cuda"
        self.bytes_per_batch = 0
        self.copies: collections.deque = collections.deque(maxlen=64)
        self._slots: List[Optional[Dict]] = [None] * self.DEPTH
        self._count = 0
        self._stream = None

    def _host_tensor(self, key, value) -> torch.Tensor:
        t = torch.as_tensor(value)
        if key in self.narrow:
            return t.to(self.narrow[key])
        if t.dtype == torch.int64:
            if t.numel() and (int(t.max()) > 2**31 - 1 or int(t.min()) < -2**31):
                raise ValueError(f"{key}: values do not fit in int32")
            return t.to(torch.int32)
        if t.dtype == torch.float64:
            return t.to(torch.float32)
        return t

    def _on_card(self, t: torch.Tensor) -> torch.Tensor:
        return t.long() if self.widen_ints and t.dtype == torch.int32 else t

    def _copy(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Fill the next slot's pinned buffers and start their copies."""
        host = {k: self._host_tensor(k, v) for k, v in batch.items()}
        i = self._count % self.DEPTH
        self._count += 1
        slot = self._slots[i]
        if slot is None or {k: (b.shape, b.dtype) for k, b in slot["bufs"].items()} != \
                {k: (t.shape, t.dtype) for k, t in host.items()}:
            if slot is not None:
                slot["done"].synchronize()
            slot = {"bufs": {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                             for k, t in host.items()}, "done": None}
            self._slots[i] = slot
        elif slot["done"] is not None:
            slot["done"].synchronize()  # its last copy has left the buffers
        for k, t in host.items():
            slot["bufs"][k].copy_(t)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            out = {k: b.to(self.device, non_blocking=True) for k, b in slot["bufs"].items()}
            done.record()
        slot["done"] = done
        nbytes = sum(b.numel() * b.element_size() for b in slot["bufs"].values())
        self.bytes_per_batch = nbytes
        self.copies.append((start, done, nbytes))
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)  # allocated on the side stream, used on this one
        return {k: self._on_card(v) for k, v in out.items()}

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One batch on the feed's device (the feed's copy path)."""
        if all(isinstance(v, torch.Tensor) and v.device == self.device for v in batch.values()):
            return {k: self._on_card(v) for k, v in batch.items()}
        if self.device.type == "cuda":
            return self._copy(batch)
        return {k: self._on_card(self._host_tensor(k, v).to(self.device))
                for k, v in batch.items()}

    def copy_ms(self) -> List[float]:
        """Device ms of each kept copy (waits for them to end)."""
        out = []
        for start, done, _ in self.copies:
            done.synchronize()
            out.append(start.elapsed_time(done))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for batch in self.batches:
            yield self.to_device(batch)
