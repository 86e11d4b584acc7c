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

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call
from torch.profiler import record_function

from merlot_reserve_tpu_torch.data.device_builder import BuilderDraws
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, loss_fn_given_preds
from merlot_reserve_tpu_torch.training.optimization import PretrainOptimizer
from merlot_reserve_tpu_torch.utils.weights import flax_leaf_shapes


@dataclass
class TrainState:
    """The model (f32 master parameters), its optimizer, and the number of
    steps taken. The model is a ``MerlotReservePretrainer`` or a finetuning
    head (``finetune.models``)."""

    model: torch.nn.Module
    optimizer: PretrainOptimizer
    step: int = 0


def weight_decay_names(model: torch.nn.Module, min_size: int = 0):
    """The parameters that take weight decay: those whose flax leaf has more
    than one axis and more than ``min_size`` elements (0 for the pretraining
    chain's mask, 4096 for the finetuning chain's), read through the weight
    bridge's name map in the JAX package's layout (``scan_layers``: every
    per-layer leaf carries the stacked layer axis, so per-layer biases and
    LayerNorm scales decay too, as in the JAX package)."""
    shapes = flax_leaf_shapes(dict(model.named_parameters()), model.config.size_per_head,
                              model.config.scan_layers)
    return [name for name, shape in shapes.items()
            if len(shape) > 1 and math.prod(shape) > min_size]


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


def model_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A batch in the dtypes the model takes: integer tensors widened to
    int64 (its index dtype) where they are narrower."""
    return {k: v.long() if not (v.is_floating_point() or v.dtype in (torch.int64, torch.bool))
            else v for k, v in batch.items()}


def make_fused_data_train_step(builder, data_seed: int = 0, use_bfloat16_grads: bool = True):
    """The training step from a raw batch: example assembly on the card
    (``DeviceExampleBuilder.build_batch``), then ``train_step``. The port of
    the JAX package's ``make_jit_fused_data_train_step``.

    The builder's draws are a pure function of ``(data_seed, state.step)``
    (``BuilderDraws``), as JAX folds ``state.step`` into its key: fresh masks
    every step, and the same masks at a step after a resume.

    The raw batch is ``stack_raw_examples`` of ``host_prepare`` outputs as
    int32, float32 and uint8 tensors on the card (``DeviceFeed(...,
    widen_ints=False)``), with either ``images`` decoded on the host or the
    frames (``frames_u8``, ``frame_hw``) that the builder augments on the
    card. Returns ``step(state, raw, split_at=None, gumbel=None,
    draws=None)``; ``draws`` replaces the builder's sampler (a test's hook),
    ``split_at`` and ``gumbel`` are ``train_step``'s.
    """
    def step(state: TrainState, raw: Dict[str, torch.Tensor], split_at=None, gumbel=None,
             draws=None):
        raw = dict(raw)
        images = raw.pop("images", None)
        with record_function("train_step/build"):
            if draws is None:
                draws = BuilderDraws(data_seed, state.step, raw["tok_ids"].device)
            batch = builder.build_batch(raw, draws)
            if images is not None:
                batch["images"] = (images.to(torch.bfloat16) if builder.cfg.model.use_bfloat16
                                   else images)
            batch = model_batch(batch)
        return train_step(state, batch, use_bfloat16_grads, split_at, gumbel)

    return step


class MetricsQueue:
    """Metrics read ``delay`` steps late, so that logging never makes the
    host wait for the device (the JAX package's ``MetricsQueue``, the
    reference's copy_to_host_async pattern).

    ``push`` starts the copy of a step's 0-d device tensors to pinned host
    memory and records an event behind it; once more than ``delay`` steps
    are pending, it returns the oldest step's metrics as floats, waiting only
    for that step's copies (``delay`` 0: the pushed step's own, at once).
    ``drain`` yields the rest in order.
    """

    def __init__(self, delay: int = 50):
        self.delay = delay
        self._queue: List[Tuple[int, Dict[str, torch.Tensor], Any]] = []

    def push(self, step: int, metrics: Dict[str, Any]) -> Optional[Tuple[int, Dict[str, float]]]:
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        event = None
        if any(v.is_cuda for v in metrics.values()):
            metrics = {k: v.to("cpu", non_blocking=True) for k, v in metrics.items()}
            event = torch.cuda.Event()
            event.record()
        self._queue.append((step, metrics, event))
        if len(self._queue) > max(self.delay, 0):
            return self.pop()
        return None

    def pop(self) -> Optional[Tuple[int, Dict[str, float]]]:
        if not self._queue:
            return None
        step, metrics, event = self._queue.pop(0)
        if event is not None:
            event.synchronize()
        return step, {k: float(v) for k, v in metrics.items()}

    def drain(self):
        while self._queue:
            yield self.pop()
