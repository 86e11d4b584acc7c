"""Pretraining driver: the step loop of
``merlot_reserve_tpu/training/pretrain.py`` over the port's ``train_step``.

Every step runs under ``activate_mesh`` of the run's mesh, built from
``cfg.device`` (dp, tp, sp, pp, dcn_dp) when the caller gives none, as in
the JAX package: a config whose joint attention is ``ring:flash`` with
``seq_shard_axis="sp"`` trains with its joint attention split over the
mesh's sp ranks (virtual ranks on the run's device).

Not ported yet: checkpointing and resume, SIGTERM handling, experiment
trackers and the asynchronous ``MetricsQueue``. ``output_dir`` raises
``NotImplementedError`` until then, and ``log_fn`` reads every step's
metrics when the step ends.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.models.pretrainer import (
    MerlotReservePretrainer,
    batch_to_tensors,
    loss_fn_given_preds,
)
from merlot_reserve_tpu_torch.parallel.mesh import Mesh, activate_mesh, make_mesh
from merlot_reserve_tpu_torch.training.trainer import TrainState, create_train_state, train_step
from merlot_reserve_tpu_torch.utils.device import resolve_device


def config_mesh(cfg: MerlotConfig, device) -> Mesh:
    """The mesh of ``cfg.device`` (dp, tp, sp, pp, dcn_dp), every rank on
    ``device`` (dp = -1 counts as 1 there)."""
    d = cfg.device
    n = (1 if d.dp == -1 else d.dp) * d.sp * d.pp * d.tp
    return make_mesh(dp=d.dp, tp=d.tp, sp=d.sp, pp=d.pp, dcn_dp=d.dcn_dp, devices=[device] * n)


def run_pretraining(cfg: MerlotConfig, batch_iterator: Iterable[Dict[str, np.ndarray]],
                    num_steps: Optional[int] = None, output_dir: Optional[str] = None,
                    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
                    device="cuda", seed: int = 0, mesh: Optional[Mesh] = None) -> TrainState:
    """Build a ``MerlotReservePretrainer`` (weights from ``seed``) on
    ``device`` and train it for ``num_steps`` steps under ``mesh``; returns
    the final ``TrainState``.

    :param batch_iterator: yields ``make_dummy_batch``-shaped numpy batches
    :param num_steps: overrides ``cfg.optimizer.num_train_steps``
    :param log_fn: called as ``log_fn(step, {name: float})`` after each step
    :param device: the card unless the caller passes "cpu"; never falls back
    :param mesh: default ``config_mesh(cfg, device)``
    """
    if output_dir or cfg.device.output_dir:
        raise NotImplementedError("checkpointing is not ported yet: run without output_dir")
    num_steps = num_steps or cfg.optimizer.num_train_steps
    device = resolve_device(device)
    mesh = mesh or config_mesh(cfg, device)
    model = MerlotReservePretrainer(cfg, device=device, seed=seed)
    state = create_train_state(cfg, model)

    for step, batch in zip(range(num_steps), batch_iterator):
        with activate_mesh(mesh):
            state, metrics = train_step(state, batch_to_tensors(batch, device))
        if log_fn is not None:
            log_fn(step, {k: float(v) for k, v in metrics.items()})
    if state.step < num_steps:
        print(f"input exhausted after {state.step} of {num_steps} steps", flush=True)
    return state


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
    preds = {head: {side: torch.cat([p[head][side] for p in preds_acc], 0)
                    for side in preds_acc[0][head]}
             for head in preds_acc[0]}
    loss, info = loss_fn_given_preds(preds)
    info = {k: float(v) for k, v in info.items()}
    info["total"] = float(loss)
    return info
