"""Pretraining driver: the step loop of
``merlot_reserve_tpu/training/pretrain.py`` over the port's ``train_step``.

Every step runs under ``activate_mesh`` of the run's mesh, built from
``cfg.device`` (dp, tp, sp, pp, dcn_dp) when the caller gives none, as in
the JAX package: a config whose joint attention is ``ring:flash`` with
``seq_shard_axis="sp"`` trains with its joint attention split over the
mesh's sp ranks (virtual ranks on the run's device).

With an ``output_dir`` (or ``cfg.device.output_dir``) the run checkpoints
every ``save_every`` steps and at its end (``utils.checkpoint``, the
flax-msgpack format: asynchronously, off the step's critical path), with
the data position in a ``loader_state.json`` sidecar where the batch
iterator has ``state_dict`` / ``load_state_dict``; it resumes from the
newest checkpoint there. SIGTERM or SIGINT finishes the step, checkpoints
and stops. Metrics reach ``log_fn`` and the tracker ``log_every`` steps
late (``MetricsQueue``), so that logging never waits on the device.

Batches reach the device through a ``data.loader.DeviceFeed`` (pinned
buffers and a side stream on the card; images and audio in bf16 when the
model computes in bf16). With a ``fused_builder`` the loader yields raw
batches and each step assembles its own on the device
(``trainer.make_fused_data_train_step``).

Across processes (after ``parallel.distributed.initialize``, one process
per card, started by torchrun: ``scripts/pretrain_torch.py -distributed``)
the default mesh is a process mesh over the job's ranks, and the run trains
the ZeRO-1 state of ``trainer.create_distributed_train_state``: each
process's batches are its rows of the global batch (its loader reads its
file shard, ``parallel.sharding.data_shard``), the logged loss terms are
the global batch's (summed over the data-parallel ranks' parts), and only
rank 0 writes a tracker or the loader's position. Such a job checkpoints
per rank (``utils.checkpoint.sharded_manager``: each rank writes its own
shards, asynchronously, nothing gathered), as the JAX package's loop uses
orbax on several processes. At a resume the newest checkpoint in
``output_dir`` is read, sharded or msgpack, sharded first at a tie, at
whatever layout it was written.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.data.loader import DeviceFeed
from merlot_reserve_tpu_torch.models.pretrainer import (
    MerlotReservePretrainer,
    batch_to_tensors,
    concat_preds,
    loss_fn_given_preds,
)
from merlot_reserve_tpu_torch.parallel import distributed
from merlot_reserve_tpu_torch.parallel.mesh import Mesh, activate_mesh, make_mesh
from merlot_reserve_tpu_torch.parallel.sharding import form_global_batch
from merlot_reserve_tpu_torch.training.trainer import (
    MetricsQueue,
    TrainState,
    create_distributed_train_state,
    create_train_state,
    make_fused_data_train_step,
    train_step,
)
from merlot_reserve_tpu_torch.utils import checkpoint as ckpt_lib
from merlot_reserve_tpu_torch.utils.device import resolve_device
from merlot_reserve_tpu_torch.utils.experiment import make_tracker


def config_mesh(cfg: MerlotConfig, device) -> Mesh:
    """The mesh of ``cfg.device`` (dp, tp, sp, pp, dcn_dp): in a job of
    several processes (``parallel.distributed``) a process mesh over its
    ranks (dp = -1: the ranks left), else every rank on ``device`` (dp = -1
    counts as 1 there)."""
    d = cfg.device
    if distributed.process_count() > 1:
        return make_mesh(dp=d.dp, tp=d.tp, sp=d.sp, pp=d.pp, dcn_dp=d.dcn_dp)
    n = (1 if d.dp == -1 else d.dp) * d.sp * d.pp * d.tp
    return make_mesh(dp=d.dp, tp=d.tp, sp=d.sp, pp=d.pp, dcn_dp=d.dcn_dp, devices=[device] * n)


class _StopFlag:
    """Set by SIGTERM / SIGINT while installed: the loop finishes its step,
    checkpoints and stops. Outside the main thread no handler can be
    installed, and the flag stays settable by hand."""

    def __init__(self):
        self.set = False
        self._restore = []

    def _on_signal(self, signum, frame):
        self.set = True
        print(f"signal {signum}: checkpointing and exiting after the current step", flush=True)

    def __enter__(self):
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._restore.append((sig, signal.signal(sig, self._on_signal)))
        except ValueError:
            pass  # not the main thread
        return self

    def __exit__(self, *exc):
        for sig, old in self._restore:
            signal.signal(sig, old)


def run_pretraining(cfg: MerlotConfig, batch_iterator: Iterable[Dict[str, np.ndarray]],
                    num_steps: Optional[int] = None, output_dir: Optional[str] = None,
                    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
                    device="cuda", seed: int = 0, mesh: Optional[Mesh] = None,
                    log_every: int = 50, save_every: Optional[int] = None,
                    tracker=None, fused_builder=None, data_seed: int = 0,
                    on_batch: Optional[Callable[[int, Dict, Dict], None]] = None
                    ) -> TrainState:
    """Build a ``MerlotReservePretrainer`` (weights from ``seed``) on
    ``device`` and train it up to step ``num_steps`` under ``mesh``,
    resuming from ``output_dir``'s newest checkpoint; returns the final
    ``TrainState``.

    :param batch_iterator: yields ``make_dummy_batch``-shaped batches (numpy
        arrays or tensors: ``PretrainLoader``, ``make_dummy_batch``), or with
        ``fused_builder`` raw batches (``DevicePretrainLoader(fused=True)``).
        They reach the device through a ``DeviceFeed``
    :param num_steps: overrides ``cfg.optimizer.num_train_steps``
    :param output_dir: checkpoint directory (default ``cfg.device.output_dir``;
        none: no checkpoints)
    :param log_fn: called as ``log_fn(step, {name: float})`` for every step,
        ``log_every`` steps after it, and for the rest at the end
    :param device: the card unless the caller passes "cpu"; never falls back.
        A stand-in rank (``parallel.distributed.initialize_standin``) is
        refused: its losses would be meaningless
    :param mesh: default ``config_mesh(cfg, device)``
    :param save_every: default ``cfg.device.iterations_per_loop``
    :param tracker: a ``utils.experiment`` tracker; default a ``JsonlTracker``
        in ``output_dir/run`` (none without an ``output_dir``)
    :param fused_builder: a ``data.device_builder.DeviceExampleBuilder``: each
        step assembles its batch on the device from the raw batch
        (``make_fused_data_train_step``), with draws keyed by
        ``(data_seed, step)``
    :param on_batch: called as ``on_batch(step, raw, batch)`` before every
        step with the batch as the device got it and as the step trains on
        it (with ``fused_builder`` built on the device, else the same dict):
        ``batch_digest`` of both shows which records and draws a step saw
    """
    distributed.refuse_standin("run_pretraining")
    num_steps = num_steps or cfg.optimizer.num_train_steps
    save_every = save_every or cfg.device.iterations_per_loop
    output_dir = output_dir or cfg.device.output_dir or None
    device = resolve_device(device)
    mesh = mesh or config_mesh(cfg, device)
    writer = distributed.process_index() == 0
    if tracker is None:
        tracker = make_tracker(f"jsonl:{os.path.join(output_dir, 'run')}"
                               if output_dir and writer else None)
    tracker.log_config(dataclasses.asdict(cfg))

    loader_state_path = os.path.join(output_dir, "loader_state.json") if output_dir else None
    if (loader_state_path and os.path.exists(loader_state_path)
            and hasattr(batch_iterator, "load_state_dict")):
        with open(loader_state_path) as f:
            try:
                batch_iterator.load_state_dict(json.load(f))
                print("restored loader position", flush=True)
            except ValueError as e:
                print(f"loader state ignored: {e}", flush=True)

    def save_loader_state():
        if writer and loader_state_path and hasattr(batch_iterator, "state_dict"):
            tmp = loader_state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(batch_iterator.state_dict(), f)
            os.replace(tmp, loader_state_path)

    model = MerlotReservePretrainer(cfg, device=device, seed=seed)
    state = (create_distributed_train_state(cfg, model, mesh) if mesh.is_process_mesh
             else create_train_state(cfg, model))
    if output_dir:
        t_load = time.perf_counter()
        kind, _ = ckpt_lib.latest_checkpoint(output_dir)
        if kind == "sharded":
            ckpt_lib.load_checkpoint_sharded(output_dir, state)
        elif kind == "msgpack":
            ckpt_lib.load_checkpoint(output_dir, state=state)
        if state.step:
            print(f"resumed from step {state.step} ({kind}) in "
                  f"{time.perf_counter() - t_load:.2f} s", flush=True)

    metrics_q = MetricsQueue(delay=log_every)
    # several processes: each writes its own shards (the JAX loop's orbax)
    manager = (ckpt_lib.sharded_manager(output_dir)
               if output_dir and distributed.process_count() > 1 else None)
    async_ckpt = ckpt_lib.AsyncCheckpointer()

    def save():
        if manager is not None:
            manager.save(state)
        else:
            async_ckpt.save(state, output_dir)

    def report(ready):
        if ready is not None:
            tracker.log(*ready)
            if log_fn is not None:
                log_fn(*ready)

    narrow = ({"images": torch.bfloat16, "audio_clips": torch.bfloat16}
              if cfg.model.use_bfloat16 else {})
    feed = DeviceFeed(batch_iterator, device, narrow=narrow, widen_ints=fused_builder is None)
    step_fn = (train_step if fused_builder is None
               else make_fused_data_train_step(fused_builder, data_seed, on_batch=on_batch))
    batches = iter(feed)
    t_block = time.time()
    with _StopFlag() as stop:
        for step in range(state.step, num_steps):
            try:
                batch = next(batches)
            except StopIteration:
                print(f"input exhausted after {state.step} of {num_steps} steps", flush=True)
                break
            with activate_mesh(mesh):
                batch = form_global_batch(mesh, batch)
                if on_batch is not None and fused_builder is None:
                    on_batch(step, batch, batch)
                state, metrics = step_fn(state, batch)
            report(metrics_q.push(step, metrics))
            if output_dir and (step + 1) % save_every == 0:
                save()
                save_loader_state()
                # contrastive temperature health print
                scales = model.contrastive_scales.detach().float().cpu()
                if writer:
                    print(f"step {step + 1} contrastive temps: "
                          f"{torch.exp(scales / 2.0).numpy().round(3).tolist()}", flush=True)
            if (step + 1) % 100 == 0:
                dt = time.time() - t_block
                print(f"steps {step - 98}..{step + 1}: {dt:.1f}s ({100 / dt:.2f} it/s)",
                      flush=True)
                t_block = time.time()
            if stop.set:
                break

    for ready in metrics_q.drain():
        report(ready)
    tracker.finish()
    async_ckpt.wait()
    if output_dir:
        t_save = time.perf_counter()
        if manager is not None:
            manager.save(state)
            manager.close()
        else:
            ckpt_lib.save_checkpoint(state, output_dir)
        save_loader_state()
        if writer:
            print(f"checkpoint of step {state.step} written in "
                  f"{time.perf_counter() - t_save:.2f} s", flush=True)
    if device.type == "cuda" and writer:
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB",
              flush=True)
    return state


def batch_digest(batch: Dict[str, torch.Tensor]) -> str:
    """A SHA-1 of a batch's keys, dtypes, shapes and bytes: equal digests,
    equal batches bit for bit."""
    h = hashlib.sha1()
    for key in sorted(batch):
        t = torch.as_tensor(batch[key]).detach().cpu().contiguous()
        h.update(f"{key}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def evaluate_loss(cfg: MerlotConfig, state: TrainState, batch_iterator,
                  num_batches: int, mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Forward over ``num_batches`` batches under ``mesh`` (default
    ``config_mesh``, as ``run_pretraining``), then the contrastive loss once
    over the concatenated preds, so that the denominator spans all of them
    (the training loss's whole-batch semantics)."""
    model = state.model
    device = next(model.parameters()).device
    mesh = mesh or config_mesh(cfg, device)
    it = iter(batch_iterator)
    with activate_mesh(mesh):
        preds_acc = [model(batch_to_tensors(next(it), device)) for _ in range(num_batches)]
    loss, info = loss_fn_given_preds(concat_preds(preds_acc))
    info = {k: float(v) for k, v in info.items()}
    info["total"] = float(loss)
    return info
