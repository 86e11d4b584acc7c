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

Across processes (``create_distributed_train_state`` on a process mesh,
the port of ``make_jit_train_step(mesh, state, zero1=True)``) the model is
cut to the rank's tp and pp share and holds compute copies; each dp rank
runs the forward and backward on its rows, differentiating at the copies,
and the optimizer (``ShardedOptimizer``) reduce-scatters the gradients in
the compute dtype onto its ZeRO-1 shard, updates it in one ``adam_update``
launch and all-gathers the compute-dtype casts for the next step. The loss
terms are summed over the batch axes before they are returned.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call
from torch.profiler import record_function

from merlot_reserve_tpu_torch.data.device_builder import BuilderDraws, RowShardDraws
from merlot_reserve_tpu_torch.models.pretrainer import (
    MerlotReservePretrainer,
    concat_preds,
    loss_fn_given_preds,
)
from merlot_reserve_tpu_torch.parallel import comm
from merlot_reserve_tpu_torch.parallel.mesh import Mesh, activate_mesh, batch_axes, process_mesh
from merlot_reserve_tpu_torch.parallel.sharding import data_shard
from merlot_reserve_tpu_torch.training.optimization import PretrainOptimizer, ShardedOptimizer
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


def create_distributed_train_state(cfg, model: MerlotReservePretrainer, mesh: Mesh,
                                   zero1: bool = True, use_bfloat16_grads: bool = True,
                                   chain: str = "pretrain") -> TrainState:
    """A ``TrainState`` on the process mesh ``mesh`` from the full ``model``
    (every process builds it alike, e.g. from one seed or one checkpoint):
    the model is cut to this rank's share (``ShardPlan.shard_model_``) and
    its optimizer is a ``ShardedOptimizer`` (ZeRO-1 over dp with ``zero1``)
    whose compute copies are bf16 under ``use_bfloat16_grads``."""
    from merlot_reserve_tpu_torch.parallel.sharding import ShardPlan

    if not mesh.is_process_mesh:
        raise ValueError("create_distributed_train_state needs a process mesh "
                         "(parallel.distributed.initialize, then make_mesh)")
    plan = ShardPlan.build(mesh, model, zero1)
    decay = weight_decay_names(model, 0 if chain == "pretrain" else 4096)
    plan.shard_model_(model)
    optimizer = ShardedOptimizer(model, plan, cfg.optimizer, decay, chain,
                                 torch.bfloat16 if use_bfloat16_grads else torch.float32)
    return TrainState(model=model, optimizer=optimizer)


def _loss_and_grads(model: torch.nn.Module, forward_loss, use_bfloat16_grads: bool,
                    cast_grads: bool = True):
    """The core of every step: ``forward_loss(used)`` -> (loss, loss_info)
    with ``used`` the tensors to run the model on (the bf16 copies of its
    parameters under ``use_bfloat16_grads``, made once), then the f32
    gradient of every parameter through ``nan_to_num`` (without
    ``cast_grads``: the gradients as they come, for a ``ShardedOptimizer``
    to reduce first)."""
    params = {n: p.detach().requires_grad_() for n, p in model.named_parameters()}
    with record_function("train_step/cast"):
        used = ({n: p.to(torch.bfloat16) for n, p in params.items()} if use_bfloat16_grads
                else params)
    with record_function("train_step/forward"):
        loss, loss_info = forward_loss(used)
    with record_function("train_step/backward"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    with record_function("train_step/grads"):
        if cast_grads:
            grads = {n: torch.nan_to_num(torch.zeros_like(p) if g is None else g.float())
                     for (n, p), g in zip(params.items(), grads)}
        else:
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
        info = {k: torch.as_tensor(v).detach().float() for k, v in loss_info.items()}
        info["total"] = loss.detach().float()
    return info, grads


def loss_and_grads(model: MerlotReservePretrainer, batch: Dict[str, torch.Tensor],
                   use_bfloat16_grads: bool = True,
                   split_at: Optional[Sequence[torch.Tensor]] = None,
                   gumbel: Optional[torch.Tensor] = None, cast_grads: bool = True
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The loss terms and the f32 gradient of every parameter (through
    ``nan_to_num``). Leaves ``model``'s parameters and their ``.grad``
    untouched.

    :param batch: a ``make_dummy_batch``-shaped dict of tensors on the
        model's device (``batch_to_tensors``)
    :param split_at, gumbel: injected draws, see ``MerlotReservePretrainer``;
        by default the model draws them from the batch's content
    """
    def forward_loss(used):
        preds = functional_call(model, used, (batch,), {"split_at": split_at, "gumbel": gumbel})
        return loss_fn_given_preds(preds)

    return _loss_and_grads(model, forward_loss, use_bfloat16_grads, cast_grads)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               use_bfloat16_grads: bool = True, split_at=None, gumbel=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One pretraining step; updates ``state`` in place and returns it with
    the loss terms (0-d f32 tensors on the model's device, not synchronised).
    Arguments as for ``loss_and_grads``. With a ``ShardedOptimizer`` the
    step runs under the active process mesh on this rank's rows of the
    batch (``split_at`` and ``gumbel`` the global batch's), and the loss
    terms returned are the global batch's."""
    sharded = isinstance(state.optimizer, ShardedOptimizer)
    info, grads = loss_and_grads(state.model, batch, use_bfloat16_grads, split_at, gumbel,
                                 cast_grads=not sharded)
    if sharded:
        info = _sum_over_batch(info, state.optimizer.plan.mesh)
    with record_function("train_step/optimizer"):
        state.optimizer.step(grads)
    state.step += 1
    return state, info


def _sum_over_batch(info: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Each rank's loss terms (its parts) summed over the batch axes, in one
    all-reduce."""
    keys = sorted(info)
    total = comm.all_reduce(torch.stack([info[k].reshape(()) for k in keys]), mesh,
                            batch_axes(mesh), what="metrics")
    return dict(zip(keys, total.unbind()))


def mixed_loss_and_grads(model_a: MerlotReservePretrainer, model_b: MerlotReservePretrainer,
                         batch_a: Dict[str, torch.Tensor], batch_b: Dict[str, torch.Tensor],
                         use_bfloat16_grads: bool = True, split_at=(None, None),
                         gumbel=(None, None)
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``loss_and_grads`` of the two-resolution step (``make_mixed_res_train_step``):
    ``model_a`` on ``batch_a`` and ``model_b`` on ``batch_b``, both run on
    ``model_a``'s parameters (one bf16 copy under ``use_bfloat16_grads``),
    their preds concatenated before one loss; ``split_at`` and ``gumbel``
    are each half's injected draws."""
    def forward_loss(used):
        preds = [functional_call(m, used, (b,), {"split_at": s, "gumbel": g})
                 for m, b, s, g in zip((model_a, model_b), (batch_a, batch_b), split_at, gumbel)]
        return loss_fn_given_preds(concat_preds(preds))

    return _loss_and_grads(model_a, forward_loss, use_bfloat16_grads)


def make_mixed_res_train_step(cfg, state: TrainState, model_b: MerlotReservePretrainer,
                              mesh=None, use_bfloat16_grads: bool = True):
    """The two-resolution (fixres) pretraining step: the port of the JAX
    package's ``make_jit_mixed_res_train_step``.

    ``state.model`` (grid A) runs on ``batch_a`` and ``model_b``, a
    ``MerlotReservePretrainer`` built at grid B, runs on ``batch_b``, both on
    the same tensors: ``state.model``'s parameters, cast to bf16 once under
    ``use_bfloat16_grads``, so that the two halves' gradients sum in bf16
    before the cast's backward takes them to f32, as in JAX. The two preds
    trees are concatenated on dim 0 before one ``loss_fn_given_preds``, so
    every InfoNCE denominator spans both grids. Then one optimizer update.

    Rotary positions make the parameters independent of the grid, so model
    B has A's names and shapes (checked here); build it on the "meta" device
    (``MerlotReservePretrainer(cfg_b, device="meta")``): it then holds no
    weights and no optimizer of its own, and its grid-dependent state (the
    rotary coordinates) is computed in its forward. The two batches must
    come from disjoint data (``scripts/pretrain_fixres_torch.py``): the same
    examples on both grids would put each row's exact positive into the
    other half's denominator.

    Returns ``step(state, batch_a, batch_b, split_at=(None, None),
    gumbel=(None, None))``, which runs under ``activate_mesh(mesh)`` (default
    ``cfg``'s mesh on the model's device, as ``run_pretraining``), updates
    ``state`` in place and returns it with the loss terms; ``split_at`` and
    ``gumbel`` are each half's injected draws (``train_step``'s).
    """
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh

    model_a = state.model
    shapes_a = [(n, p.shape) for n, p in model_a.named_parameters()]
    shapes_b = [(n, p.shape) for n, p in model_b.named_parameters()]
    if shapes_a != shapes_b:
        raise ValueError("the grid-B model's parameters are not grid A's: the mixed step "
                         "needs resolution-independent parameters (do_rotary)")
    if mesh is None:
        mesh = config_mesh(cfg, next(model_a.parameters()).device)

    def step(state: TrainState, batch_a: Dict[str, torch.Tensor],
             batch_b: Dict[str, torch.Tensor], split_at=(None, None), gumbel=(None, None)
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with activate_mesh(mesh):
            info, grads = mixed_loss_and_grads(state.model, model_b, batch_a, batch_b,
                                               use_bfloat16_grads, split_at, gumbel)
            with record_function("train_step/optimizer"):
                state.optimizer.step(grads)
        state.step += 1
        return state, info

    return step


def model_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A batch in the dtypes the model takes: integer tensors widened to
    int64 (its index dtype) where they are narrower."""
    return {k: v.long() if not (v.is_floating_point() or v.dtype in (torch.int64, torch.bool))
            else v for k, v in batch.items()}


def make_fused_data_train_step(builder, data_seed: int = 0, use_bfloat16_grads: bool = True,
                               on_batch=None):
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
    ``split_at`` and ``gumbel`` are ``train_step``'s. Under a process mesh
    each data-parallel rank takes its rows of the global batch's draws
    (``RowShardDraws``). ``on_batch(step, raw, batch)``, where given, sees
    each step's raw batch and the batch built from it.
    """
    def step(state: TrainState, raw: Dict[str, torch.Tensor], split_at=None, gumbel=None,
             draws=None):
        fed, raw = raw, dict(raw)
        images = raw.pop("images", None)
        with record_function("train_step/build"):
            if draws is None:
                mesh = process_mesh()
                draws = (BuilderDraws(data_seed, state.step, raw["tok_ids"].device)
                         if mesh is None else
                         RowShardDraws(data_seed, state.step, raw["tok_ids"].device,
                                       *data_shard(mesh)))
            batch = builder.build_batch(raw, draws)
            if images is not None:
                batch["images"] = (images.to(torch.bfloat16) if builder.cfg.model.use_bfloat16
                                   else images)
            batch = model_batch(batch)
        if on_batch is not None:
            on_batch(state.step, fed, batch)
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
