"""One pretraining step: forward, the three-head loss, backward, and the
bf16 Adam update.

The port of ``merlot_reserve_tpu/training/trainer.py``'s ``train_step``.
Under ``use_bfloat16_grads`` every parameter is cast to bf16 before the
forward (the JAX package's ``f32_to_bf16(params)``): the cast sits inside
the differentiated function, so the gradient is taken at the bf16 copy,
summed in bf16 where a parameter is used more than once, and cast up to f32
by the cast's backward. Then ``nan_to_num``, then the optimizer updates the
f32 masters in place.

Each part of a step runs in a ``torch.profiler.record_function`` range named
``train_step/<part>``: cast, forward (the model and the loss), backward,
grads (the f32 cast and ``nan_to_num``) and optimizer. A trace splits the
step's host and device time by them (``scripts/profile_torch_training.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call
from torch.profiler import record_function

from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, loss_fn_given_preds
from merlot_reserve_tpu_torch.training.optimization import PretrainOptimizer
from merlot_reserve_tpu_torch.utils.weights import flax_leaf_shapes


@dataclass
class TrainState:
    """The model (f32 master parameters), its optimizer, and the number of
    steps taken."""

    model: MerlotReservePretrainer
    optimizer: PretrainOptimizer
    step: int = 0


def weight_decay_names(model: MerlotReservePretrainer):
    """The parameters that take weight decay: those whose flax leaf has more
    than one axis, read through the weight bridge's name map in the JAX
    package's layout (``scan_layers``: every per-layer leaf carries the
    stacked layer axis, so per-layer biases and LayerNorm scales decay too,
    as in the JAX package)."""
    shapes = flax_leaf_shapes(dict(model.named_parameters()), model.config.size_per_head,
                              model.config.scan_layers)
    return [name for name, shape in shapes.items() if len(shape) > 1]


def create_train_state(cfg, model: MerlotReservePretrainer) -> TrainState:
    """A fresh ``TrainState`` for ``model`` with the pretraining chain of
    ``cfg.optimizer``."""
    optimizer = PretrainOptimizer(model.named_parameters(), weight_decay_names(model),
                                  cfg.optimizer)
    return TrainState(model=model, optimizer=optimizer)


def loss_and_grads(model: MerlotReservePretrainer, batch: Dict[str, torch.Tensor],
                   use_bfloat16_grads: bool = True,
                   split_at: Optional[Sequence[torch.Tensor]] = None,
                   gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The loss terms and the f32 gradient of every parameter (through
    ``nan_to_num``). Leaves ``model``'s parameters and their ``.grad``
    untouched.

    :param batch: a ``make_dummy_batch``-shaped dict of tensors on the
        model's device (``batch_to_tensors``)
    :param split_at, gumbel: injected draws, see ``MerlotReservePretrainer``;
        by default the model draws them from the batch's content
    """
    params = {n: p.detach().requires_grad_() for n, p in model.named_parameters()}
    with record_function("train_step/cast"):
        used = ({n: p.to(torch.bfloat16) for n, p in params.items()} if use_bfloat16_grads
                else params)
    with record_function("train_step/forward"):
        preds = functional_call(model, used, (batch,), {"split_at": split_at, "gumbel": gumbel})
        loss, loss_info = loss_fn_given_preds(preds)
    with record_function("train_step/backward"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    with record_function("train_step/grads"):
        grads = {n: torch.nan_to_num(torch.zeros_like(p) if g is None else g.float())
                 for (n, p), g in zip(params.items(), grads)}
        info = {k: torch.as_tensor(v).detach().float() for k, v in loss_info.items()}
        info["total"] = loss.detach().float()
    return info, grads


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               use_bfloat16_grads: bool = True, split_at=None, gumbel=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One pretraining step; updates ``state`` in place and returns it with
    the loss terms (0-d f32 tensors on the model's device, not synchronised).
    Arguments as for ``loss_and_grads``."""
    info, grads = loss_and_grads(state.model, batch, use_bfloat16_grads, split_at, gumbel)
    with record_function("train_step/optimizer"):
        state.optimizer.step(grads)
    state.step += 1
    return state, info
