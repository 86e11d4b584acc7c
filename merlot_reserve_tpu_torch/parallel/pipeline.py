"""GPipe pipeline parallelism of the joint transformer over a mesh axis.

The counterpart of ``merlot_reserve_tpu/parallel/pipeline.py``. With
``ModelConfig.pipeline_axis`` set and the axis larger than 1, stage s of S
holds joint layers [s n / S, (s + 1) n / S) (``keep_stage_layers_``, names
kept: a stage's ``joint_transformer.layers.<i>`` are the full model's), and
the batch runs through the stages in ``pipeline_microbatches`` microbatches.

The schedule is all forward, then the loss, then all backward: the InfoNCE
denominator couples every microbatch, so no microbatch's backward can start
before the whole batch's loss, which is why the JAX package rejected 1F1B
(its ``pipeline.py`` docstring). ``remat`` composes: each stage's layers go
through ``checkpointed_call`` and only the stage boundaries are kept.

Under a process mesh a microbatch goes from stage to stage by ``send`` /
``recv`` (``parallel.comm``) inside one autograd function per step, whose
backward sends the gradients the other way. As in the JAX package the
towers and heads are replicated over pp: the last stage's output is
broadcast to every stage, which all compute the same loss from it, and the
gradient at the pipeline's input is broadcast from stage 0, so the
replicated towers take the same gradient on every stage. On virtual ranks
(one process) the stages run one after the other in the process: the
microbatched layers, which is what the pipeline computes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from merlot_reserve_tpu_torch.parallel import comm
from merlot_reserve_tpu_torch.parallel.mesh import Mesh, activate_mesh


class StageLayers(nn.Module):
    """A pipeline stage's layers, registered under their index in the full
    stack (so parameter names match the full model's), iterated in order."""

    def __init__(self, layers: Dict[int, nn.Module]):
        super().__init__()
        for i in sorted(layers):
            self.add_module(str(i), layers[i])

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


def keep_stage_layers_(encoder: nn.Module, stage: int, num_stages: int) -> None:
    """Keep only stage ``stage`` of ``num_stages``'s layers in ``encoder``."""
    n = len(encoder.layers)
    if n % num_stages:
        raise ValueError(f"{n} layers do not split over {num_stages} pipeline stages")
    per = n // num_stages
    encoder.layers = StageLayers({i: encoder.layers[i]
                                  for i in range(stage * per, (stage + 1) * per)})


def _microbatches(x: torch.Tensor, layer_kwargs: Dict, m: int) -> List:
    """(x, kwargs) of each of ``m`` microbatches: dim 0 of x and of every
    batch-major layer input (labels [B, L], sinusoids [B, 2, L, r], a bias
    [B, ...]) cut into ``m`` equal parts; inputs shared by the rows stay."""
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch {batch} does not split into {m} microbatches")
    parts = [dict() for _ in range(m)]
    for key, value in layer_kwargs.items():
        batch_major = (isinstance(value, torch.Tensor) and value.dim() >= 2
                       and value.shape[0] == batch
                       and not (key == "sinusoids" and value.dim() < 4))
        chunks = value.chunk(m) if batch_major else [value] * m
        for part, c in zip(parts, chunks):
            part[key] = c
    return list(zip(x.chunk(m), parts))


class _StageRunner(nn.Module):
    """A stage's layers as one module, so that ``functional_call`` can run
    them on given tensors."""

    def __init__(self, layers, remat_saves, param_names):
        super().__init__()
        self.layers = layers
        self.remat_saves = remat_saves
        self.param_names = param_names

    def forward(self, x, layer_kwargs):
        from merlot_reserve_tpu_torch.models.layers import run_layers

        return run_layers(self.layers, x, layer_kwargs, self.remat_saves, self.param_names)


class _Pipeline(torch.autograd.Function):
    """The schedule on one stage: ``forward`` runs every microbatch through
    the stage's layers (receiving from the stage before, sending to the one
    after) and returns the last stage's output, broadcast; ``backward``
    runs the microbatches' backward in reverse, gradients going the other
    way, and returns the input's gradient broadcast from stage 0."""

    @staticmethod
    def forward(ctx, x, run, *params):
        mesh, axis, runner, names, micro = run
        n_stages, stage = mesh.size(axis), mesh.axis_index(axis)
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        saved, outs = [], []
        with torch.enable_grad(), activate_mesh(mesh):
            for m, (x_m, kwargs_m) in enumerate(micro):
                h = x_m.detach() if stage == 0 else comm.recv(
                    torch.empty_like(x_m), mesh, axis, stage - 1, tag=m, what="pp")
                h.requires_grad_(True)
                y = functional_call(runner, dict(zip(names, leaves)), (h, kwargs_m))
                if stage < n_stages - 1:
                    comm.send(y.detach(), mesh, axis, stage + 1, tag=m, what="pp")
                else:
                    outs.append(y.detach())
                saved.append((h, y))
        out = torch.cat(outs) if outs else torch.empty_like(x)
        comm.broadcast(out, mesh, axis, n_stages - 1, what="pp")
        ctx.run, ctx.saved, ctx.leaves = run, saved, leaves
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        mesh, axis, runner, names, micro = ctx.run
        n_stages, stage = mesh.size(axis), mesh.axis_index(axis)
        m_count = len(micro)
        wanted = [p for p in ctx.leaves if p.requires_grad]
        param_grads: List[Optional[torch.Tensor]] = [None] * len(wanted)
        grad_in: List[Optional[torch.Tensor]] = [None] * m_count
        grads_out = grad_out.chunk(m_count)
        with activate_mesh(mesh):
            for m in reversed(range(m_count)):
                h, y = ctx.saved[m]
                g = grads_out[m].contiguous() if stage == n_stages - 1 else comm.recv(
                    torch.empty_like(y), mesh, axis, stage + 1, tag=m_count + m, what="pp")
                got = torch.autograd.grad(y, [h] + wanted, g, allow_unused=True)
                for i, gp in enumerate(got[1:]):
                    if gp is not None:
                        param_grads[i] = gp if param_grads[i] is None else param_grads[i] + gp
                if stage > 0:
                    comm.send(got[0], mesh, axis, stage - 1, tag=m_count + m, what="pp")
                else:
                    grad_in[m] = got[0]
        ctx.saved = None
        grad_x = torch.cat(grad_in) if stage == 0 else torch.empty(
            grad_out.shape, dtype=grad_out.dtype, device=grad_out.device)
        comm.broadcast(grad_x, mesh, axis, 0, what="pp")
        it = iter(param_grads)
        return (grad_x, None) + tuple(next(it) if p.requires_grad else None
                                      for p in ctx.leaves)


def pipeline_transformer(layers, x: torch.Tensor, layer_kwargs: Dict, *, mesh: Mesh,
                         axis: str = "pp", num_microbatches: int = 2,
                         remat_saves: Optional[Sequence] = None,
                         param_names: Sequence[str] = ()) -> torch.Tensor:
    """``layers`` applied to ``x`` [B, L, H] as a pipeline over ``axis`` of
    ``mesh`` in ``num_microbatches`` microbatches -> [B, L, H], the
    microbatched layers' result on every rank.

    :param layers: under a process mesh this stage's layers
        (``StageLayers``), else the whole stack (which must split over the
        axis's stages)
    :param layer_kwargs: the layers' keyword inputs (``TransformerEncoder``'s)
    :param remat_saves: the remat policy's saved ops (None: no remat)
    :param param_names: a layer's parameter names (for ``checkpointed_call``)
    """
    from merlot_reserve_tpu_torch.models.layers import run_layers

    n_stages = mesh.size(axis)
    micro = _microbatches(x, layer_kwargs, num_microbatches)
    if not mesh.is_process_mesh:
        if len(layers) % n_stages:
            raise ValueError(f"{len(layers)} layers do not split over {n_stages} stages")
        return torch.cat([run_layers(layers, x_m, kw, remat_saves, param_names)
                          for x_m, kw in micro])
    runner = _StageRunner(layers, remat_saves, list(param_names))
    names, params = zip(*runner.named_parameters()) if len(layers) else ((), ())
    return _Pipeline.apply(x, (mesh, axis, runner, list(names), micro), *params)
