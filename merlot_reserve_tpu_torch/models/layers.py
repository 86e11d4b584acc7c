"""Transformer building blocks.

Module and parameter names follow the flax tree (qkv / attn_proj /
pre_attn_ln / pre_mlp_ln / attention_layer / mlp_layer / pre_ln / final_ln /
cls / cls_proj / intermediate / out), so ``utils/weights.py`` maps the two
one to one. Parameters are f32; each module computes in its ``dtype`` (bf16
under the model's bf16 policy), casting weights at use as flax does, with
LayerNorm statistics in f32. Attention masks travel as per-position labels
(is_valid, segment_ids) down to ``ops.attention``. ``TransformerEncoder``
recomputes its layers in the backward under ``remat`` (the JAX package's
``nn.remat``), with ``torch.utils.checkpoint``.

Under a process mesh (``parallel.mesh``) the layers run Megatron tensor
parallelism once ``parallel.sharding.ShardPlan.shard_model_`` has cut
them (``shard_tp_``): qkv and the MLP's intermediate are column parallel
(the rank's heads, its share of the hidden units), attn_proj and the
MLP's out row parallel, one all-reduce per pair in the forward and one in
the backward (``parallel.comm``); the attention runs on the rank's heads.
A ``TransformerEncoder`` whose attention is sequence parallel across
processes splits its sequence over the axis for its layers, and one with
``pipeline_axis`` runs its layers as a GPipe pipeline
(``parallel/pipeline.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint as torch_checkpoint

from merlot_reserve_tpu_torch.ops import attention as attn_ops
from merlot_reserve_tpu_torch.ops import rotary as rotary_ops
from merlot_reserve_tpu_torch.parallel import comm
from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, current_mesh, process_mesh


def kernel_stddev(flax_shape: Sequence[int]) -> float:
    """Depth-scaled init scale min(18 / fan_in, 0.02) / sqrt(2), with fan_in
    read off the flax kernel shape as the reference's DenseGeneral does: a
    3-D kernel [a, b, c] has fan_in a, or a*b when a < c."""
    if len(flax_shape) == 3:
        fan_in = flax_shape[0]
        if fan_in < flax_shape[2]:
            fan_in *= flax_shape[1]
    else:
        fan_in = flax_shape[-2]
    return min(18.0 / fan_in, 0.02) / math.sqrt(2)


def kernel_init_(weight: torch.Tensor, flax_shape: Sequence[int],
                 generator: torch.Generator) -> torch.Tensor:
    """Truncated normal in [-2, 2] standard deviations of ``kernel_stddev``."""
    std = kernel_stddev(flax_shape)
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def linear(x, layer: nn.Linear, dtype):
    """``layer`` applied in ``dtype`` (the flax dtype policy)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x, layer: nn.LayerNorm, dtype):
    """LayerNorm computed in f32, result in ``dtype``. Like flax, it takes
    the scale and bias at the precision they are held in (bf16 under a bf16
    training step) and applies them in f32."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight.float(),
                        layer.bias.float(), layer.eps).to(dtype)


def _tp_mesh(module: nn.Module):
    """The process mesh a tensor-parallel module runs on (None when the
    module was not cut for tp)."""
    if not getattr(module, "tp", False):
        return None
    mesh = process_mesh()
    if mesh is None:
        raise RuntimeError(f"{type(module).__name__} holds a tensor-parallel share: run it "
                           "under its process mesh (parallel.mesh.activate_mesh)")
    return mesh


def _tp_bias(bias, mesh, blocks: int):
    """The rank's share of a column-parallel layer's whole bias (held
    replicated, as the JAX package's rules hold it): ``blocks`` equal
    blocks (q, k, v: 3), each cut over tp. The bias's gradient is summed
    over tp in the backward, so every rank holds all of it."""
    n, i = mesh.shape["tp"], mesh.axis_index("tp")
    b = comm.copy_to_parallel(bias, mesh, "tp").reshape(blocks, -1)
    k = b.shape[1] // n
    return b[:, i * k:(i + 1) * k].reshape(-1)


def my_gelu(x):
    """Sigmoid-approximated GELU with the reference's 1.702 constant."""
    return x * torch.sigmoid(1.702 * x)


def init_linear(in_features, out_features, flax_shape, generator, bias=True):
    """``nn.Linear`` with the flax kernel's init (``kernel_init_`` for the
    flax kernel shape ``flax_shape``) and a zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    kernel_init_(layer.weight, flax_shape, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class AttentionLayer(nn.Module):
    """Self-attention with a fused QKV projection; rotary rotates the query
    and key heads together."""

    def __init__(self, hidden_size: int, size_per_head: int, dtype, rotary_sign_quirk: bool,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = hidden_size // size_per_head
        self.size_per_head = size_per_head
        self.dtype = dtype
        self.rotary_sign_quirk = rotary_sign_quirk
        inner = 3 * self.num_heads * size_per_head
        self.qkv = init_linear(hidden_size, inner,
                               (hidden_size, 3 * self.num_heads, size_per_head), generator)
        self.attn_proj = init_linear(self.num_heads * size_per_head, hidden_size,
                                     (self.num_heads, size_per_head, hidden_size),
                                     generator, bias=False)

    def shard_tp_(self, mesh) -> None:
        """Run on the rank's heads: qkv and attn_proj hold their tp shares."""
        n = mesh.shape["tp"]
        if self.num_heads % n:
            raise ValueError(f"{self.num_heads} heads do not split over tp={n}")
        self.num_heads //= n
        self.tp = True

    def forward(self, x, *, impl: str = "auto", sinusoids=None, is_valid=None,
                segment_ids=None, attention_bias=None):
        *batch_dims, seq_len, _ = x.shape
        heads, d = self.num_heads, self.size_per_head
        mesh = _tp_mesh(self)
        if mesh is None:
            qkv = linear(x, self.qkv, self.dtype)
        else:
            qkv = F.linear(comm.copy_to_parallel(x, mesh, "tp").to(self.dtype),
                           self.qkv.weight.to(self.dtype),
                           _tp_bias(self.qkv.bias, mesh, 3).to(self.dtype))
        qkv = qkv.reshape(*batch_dims, seq_len, 3 * heads, d)
        query_key, value = qkv[..., :2 * heads, :], qkv[..., 2 * heads:, :]
        if sinusoids is not None:
            query_key = rotary_ops.apply_rotary(query_key, sinusoids,
                                                sign_quirk=self.rotary_sign_quirk)
        query, key = query_key[..., :heads, :], query_key[..., heads:, :]

        if len(batch_dims) != 1:  # attention() wants [B, L, heads, d]
            flat_b = math.prod(batch_dims)
            query, key, value = (t.reshape(flat_b, seq_len, heads, d)
                                 for t in (query, key, value))
            if is_valid is not None:
                is_valid = is_valid.reshape(flat_b, seq_len)
            if segment_ids is not None:
                segment_ids = segment_ids.reshape(flat_b, seq_len)
            if attention_bias is not None:
                attention_bias = attention_bias.reshape(
                    (flat_b,) + attention_bias.shape[len(batch_dims):])

        x_att = attn_ops.attention(query, key, value, is_valid=is_valid,
                                   segment_ids=segment_ids, bias=attention_bias,
                                   impl=impl)
        x_att = x_att.reshape(*batch_dims, seq_len, heads * d)
        out = linear(x_att, self.attn_proj, self.dtype)
        return out if mesh is None else comm.reduce_from_parallel(out, mesh, "tp")


class MLPBlock(nn.Module):
    def __init__(self, hidden_size: int, dtype, generator: torch.Generator,
                 expansion_mult: int = 4):
        super().__init__()
        self.dtype = dtype
        inner = hidden_size * expansion_mult
        self.intermediate = init_linear(hidden_size, inner, (hidden_size, inner), generator)
        self.out = init_linear(inner, hidden_size, (inner, hidden_size), generator,
                               bias=False)

    def shard_tp_(self, mesh) -> None:
        """Run on the rank's share of the hidden units."""
        self.tp = True

    def forward(self, x):
        mesh = _tp_mesh(self)
        if mesh is None:
            return linear(my_gelu(linear(x, self.intermediate, self.dtype)), self.out, self.dtype)
        h = F.linear(comm.copy_to_parallel(x, mesh, "tp").to(self.dtype),
                     self.intermediate.weight.to(self.dtype),
                     _tp_bias(self.intermediate.bias, mesh, 1).to(self.dtype))
        return comm.reduce_from_parallel(linear(my_gelu(h), self.out, self.dtype), mesh, "tp")


class TransformerLayer(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + mlp(LN(x)), LN eps 1e-5."""

    def __init__(self, hidden_size: int, size_per_head: int, dtype, rotary_sign_quirk: bool,
                 generator: torch.Generator, expansion_mult: int = 4):
        super().__init__()
        self.dtype = dtype
        self.pre_attn_ln = nn.LayerNorm(hidden_size, eps=1e-5)
        self.attention_layer = AttentionLayer(hidden_size, size_per_head, dtype,
                                              rotary_sign_quirk, generator)
        self.pre_mlp_ln = nn.LayerNorm(hidden_size, eps=1e-5)
        self.mlp_layer = MLPBlock(hidden_size, dtype, generator, expansion_mult)

    def forward(self, x, *, impl: str = "auto", sinusoids=None, is_valid=None,
                segment_ids=None, attention_bias=None):
        x = x + self.attention_layer(layer_norm(x, self.pre_attn_ln, self.dtype), impl=impl,
                                     sinusoids=sinusoids, is_valid=is_valid,
                                     segment_ids=segment_ids, attention_bias=attention_bias)
        return x + self.mlp_layer(layer_norm(x, self.pre_mlp_ln, self.dtype))


_ATEN = torch.ops.aten
# the jax.checkpoint_policies names that configs, scripts and tests use, by
# the aten products whose outputs each one saves (None: every output, so
# nothing is recomputed). Products with batch dims are bmm/baddbmm (the
# einsums of dense attention); mm/addmm are the linear layers. The
# hand-written attention kernels are ctypes launches, not aten ops, so no
# policy saves their outputs and the recompute launches them again, as
# JAX's dots_saveable recomputes a pallas_call.
_REMAT_POLICIES = {
    None: (),
    "nothing_saveable": (),
    "dots_saveable": (_ATEN.mm.default, _ATEN.addmm.default, _ATEN.bmm.default,
                      _ATEN.baddbmm.default),
    "dots_with_no_batch_dims_saveable": (_ATEN.mm.default, _ATEN.addmm.default),
    "everything_saveable": None,
}


def resolve_remat_policy(name: Optional[str]):
    """A ``jax.checkpoint_policies`` name -> the aten ops whose outputs it
    saves: () for None and 'nothing_saveable' (full recompute), None for
    'everything_saveable' (no recompute). The port implements the names in
    ``_REMAT_POLICIES``; any other raises, as the JAX package does for a
    name that is not a policy."""
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; the port implements "
                         f"{sorted(n for n in _REMAT_POLICIES if n)} (or None)")
    return _REMAT_POLICIES[name]


def checkpointed_call(module: nn.Module, param_names, saved_ops, *args, **kwargs):
    """``module(*args, **kwargs)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) except the outputs of
    ``saved_ops``.

    Two things the forward saw are handed to the recompute explicitly:
      * the parameters ``param_names`` as they are now: under the training
        step's ``functional_call`` they are its bf16 copies, which are gone
        by the backward, when ``module`` holds its f32 masters again. They
        go in as arguments, so every gradient reaches the copies;
      * the active mesh (a context variable): the backward, and with it
        the recompute, may run on autograd's own thread, which does not
        see it, and attention would then take the path without a mesh.
    """
    tensors = [functools.reduce(getattr, n.split("."), module) for n in param_names]
    mesh = current_mesh()

    def run(*args_and_tensors):
        with activate_mesh(mesh):
            return functional_call(module, dict(zip(param_names, args_and_tensors[len(args):])),
                                   args_and_tensors[:len(args)], kwargs)

    context_fn = torch_checkpoint.noop_context_fn
    if saved_ops:
        context_fn = functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                       list(saved_ops))
    # the layers draw no random numbers: no RNG state to stash and restore
    return torch_checkpoint.checkpoint(run, *args, *tensors, use_reentrant=False,
                                       context_fn=context_fn, preserve_rng_state=False)


def run_layers(layers, x, layer_kwargs, remat_saves, param_names):
    """``layers`` in order on ``x``, each recomputed in the backward when
    ``remat_saves`` is not None (``checkpointed_call``)."""
    for layer in layers:
        if remat_saves is not None:
            x = checkpointed_call(layer, param_names, remat_saves, x, **layer_kwargs)
        else:
            x = layer(x, **layer_kwargs)
    return x


def _split_sequence(x, layer_kwargs, mesh, axis):
    """This rank's slice of the sequence of ``x`` [*batch, L, H] and of the
    layers' per-position inputs (sinusoids [*, 2, L, r], labels [*, L]);
    every rank computed them alike. The backward gathers x's gradient."""
    n, i = mesh.size(axis), mesh.axis_index(axis)
    seq_len = x.shape[-2]
    if seq_len % n:
        raise ValueError(f"sequence of {seq_len} does not split over {axis}={n}")
    k = seq_len // n
    kwargs = dict(layer_kwargs)
    if kwargs.get("attention_bias") is not None:
        raise ValueError("sequence-parallel attention takes labels, not a dense bias")
    batch = x.shape[:-2]
    if kwargs.get("is_valid") is None:
        kwargs["is_valid"] = torch.ones(batch + (seq_len,), dtype=torch.int32, device=x.device)
    if kwargs.get("segment_ids") is None:
        kwargs["segment_ids"] = torch.zeros(batch + (seq_len,), dtype=torch.int32,
                                            device=x.device)
    for key in ("is_valid", "segment_ids"):
        kwargs[key] = kwargs[key].narrow(-1, i * k, k).contiguous()
    if kwargs.get("sinusoids") is not None:
        sin = kwargs["sinusoids"]
        kwargs["sinusoids"] = sin.narrow(sin.dim() - 2, i * k, k)
    return comm.split_replicated(x, mesh, axis, x.dim() - 2, "sp"), kwargs


class TransformerEncoder(nn.Module):
    """1-D pre-LN encoder with an optional CLS token, rotary or learned
    positions, and label-vector attention masking.

    Mask inputs (provide at most one family):
      * ``is_valid`` [.., L] and/or ``segment_ids`` [.., L] — label path;
      * ``attention_mask`` [.., L, L] dense boolean.

    ``pe_len`` gives the learned position table its length (sequence length
    including CLS); the table is only used, and only needed, when forward
    gets no rotary coordinates. ``seq_shard_axis`` names the mesh axis the
    sequence is split over; in the JAX package it is a sharding hint for
    GSPMD, which changes no number, so here it is only checked against the
    active mesh (``parallel.mesh.activate_mesh``) when there is one. The
    split itself is the attention's (``attention_impl='ring...'``). The
    layer stack is one ``nn.ModuleList`` whichever flax layout
    (scan-stacked or ``layer_NN``) the weights came in.

    ``remat`` recomputes each layer in the backward (``checkpointed_call``)
    and keeps only what ``remat_policy`` saves (``resolve_remat_policy``),
    as the JAX package's per-layer ``nn.remat``. Without grad it runs the
    layers plainly.

    With ``pipeline_axis`` and an active mesh whose axis is larger than 1,
    the layers run as a GPipe pipeline of ``pipeline_microbatches``
    microbatches (``parallel.pipeline.pipeline_transformer``; under a
    process mesh this process holds its stage's layers only). When the
    attention is sequence parallel across processes (a 'ring...' or
    'ulysses...' impl under a process mesh), the layers run on this rank's
    slice of the sequence and the output is gathered after them; under
    'ring:rdma' each rank drains its card's queue and the axis's ranks meet
    at a host barrier (``parallel.comm.barrier``), once per forward, so that
    no rank's ring kernel waits on a neighbour still busy with earlier work.
    """

    def __init__(self, hidden_size: int, num_layers: int, *, generator: torch.Generator,
                 dtype=torch.float32, size_per_head: int = 64, expansion_mult: int = 4,
                 add_cls_token: bool = False, cls_output_size: Optional[int] = None,
                 rotary_hsize: int = 32, attention_impl: str = "auto",
                 rotary_sign_quirk: bool = True, pe_len: Optional[int] = None,
                 seq_shard_axis: Optional[str] = None, remat: bool = False,
                 remat_policy: Optional[str] = None, pipeline_axis: Optional[str] = None,
                 pipeline_microbatches: int = 2):
        super().__init__()
        self.pipeline_axis = pipeline_axis
        self.pipeline_microbatches = pipeline_microbatches
        if rotary_hsize > size_per_head:
            raise ValueError("rotary_hsize exceeds size_per_head")
        # the ops whose outputs a recomputed layer saves; None: no recompute
        # (no remat, or the policy saves everything). As in the JAX package,
        # the policy is read only under remat
        self.remat_saves = resolve_remat_policy(remat_policy) if remat else None
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.add_cls_token = add_cls_token
        self.rotary_hsize = rotary_hsize
        self.attention_impl = attention_impl
        self.seq_shard_axis = seq_shard_axis
        if add_cls_token:
            self.cls = nn.Parameter(torch.empty(hidden_size))
            with torch.no_grad():
                nn.init.normal_(self.cls, std=0.02, generator=generator)
            out_size = hidden_size if cls_output_size is None else cls_output_size
            self.cls_proj = init_linear(hidden_size, out_size, (hidden_size, out_size),
                                        generator)
        if pe_len is not None:
            self.pe = nn.Parameter(torch.empty(pe_len, hidden_size))
            with torch.no_grad():
                nn.init.normal_(self.pe, std=0.02, generator=generator)
        self.pre_ln = nn.LayerNorm(hidden_size, eps=1e-5)
        self.layers = nn.ModuleList(
            TransformerLayer(hidden_size, size_per_head, dtype, rotary_sign_quirk,
                             generator, expansion_mult)
            for _ in range(num_layers))
        # every layer has the same parameter names
        self._layer_param_names = [n for n, _ in self.layers[0].named_parameters()] \
            if num_layers else []
        self.final_ln = nn.LayerNorm(hidden_size, eps=1e-5)

    def sequence_split_axis(self, mesh) -> Optional[Tuple[str, str]]:
        """(inner impl, axis) of a sequence-parallel attention impl that
        splits this encoder's sequence under ``mesh``, when ``mesh`` is a
        process mesh and the axis is larger than 1; else None."""
        if (mesh is None or not mesh.is_process_mesh
                or not self.attention_impl.startswith(("ring", "ulysses"))):
            return None
        from merlot_reserve_tpu_torch.ops.ring_attention import parse_sequence_parallel_impl

        inner, axis = parse_sequence_parallel_impl(self.attention_impl)
        return (inner, axis) if mesh.shape.get(axis, 1) > 1 else None

    def forward(self, x, *, rotary_coords=None, attention_mask=None, is_valid=None,
                segment_ids=None):
        *batch_dims, seq_len, hsz = x.shape
        if hsz != self.hidden_size:
            raise ValueError(f"hidden size {hsz} != {self.hidden_size}")

        if self.add_cls_token:
            if attention_mask is not None:
                raise ValueError("attention_mask can't be combined with add_cls_token")
            if segment_ids is not None:
                # CLS would attend globally only if everything shared a segment;
                # the reference never combines CLS with packing
                raise ValueError("segment_ids can't be combined with add_cls_token")
            seq_len += 1
            cls_tiled = self.cls.to(x.dtype).expand(*batch_dims, 1, self.hidden_size)
            x = torch.cat([cls_tiled, x], -2)
            if is_valid is not None:
                is_valid = torch.cat([torch.ones_like(is_valid[..., :1]), is_valid], -1)
            if rotary_coords is not None:
                rotary_coords = torch.cat(
                    [torch.zeros_like(rotary_coords[..., :1, :]), rotary_coords], -2)

        if rotary_coords is not None:
            if rotary_coords.shape[-2] != seq_len:
                raise ValueError("rotary_coords length does not match the sequence")
            sinusoids = rotary_ops.construct_rotary_sinusoids(
                rotary_coords, rotary_hsize=self.rotary_hsize)
        else:
            if not hasattr(self, "pe"):
                raise ValueError("no rotary_coords given and no learned positions (pe_len)")
            if self.pe.shape[0] != seq_len:
                raise ValueError(f"learned positions cover {self.pe.shape[0]} positions, "
                                 f"got {seq_len}")
            sinusoids = None
            x = x + self.pe

        if attention_mask is not None and is_valid is not None:
            raise ValueError("provide only one of is_valid / attention_mask")
        attention_bias = None
        if attention_mask is not None:
            attention_bias = attn_ops.make_attention_bias(attention_mask=attention_mask,
                                                          dtype=self.dtype)

        # resolve the impl once: on the dense path the additive bias is built
        # here, once for all layers; on the flash path the labels go through
        has_labels = is_valid is not None or segment_ids is not None
        resolved = attn_ops.resolve_impl(self.attention_impl,
                                         has_bias=attention_bias is not None,
                                         has_labels=has_labels, on_cuda=x.is_cuda)
        if resolved == "xla" and has_labels and attention_bias is None:
            attention_bias = attn_ops.make_attention_bias(
                is_valid=is_valid, segment_ids=segment_ids, dtype=self.dtype)
            is_valid = segment_ids = None

        x = layer_norm(x, self.pre_ln, self.dtype)
        mesh = current_mesh()
        if self.seq_shard_axis and mesh is not None and self.seq_shard_axis not in mesh.shape:
            raise ValueError(f"seq_shard_axis {self.seq_shard_axis!r} not in the active "
                             f"mesh's axes {tuple(mesh.shape)}")
        layer_kwargs = dict(impl=resolved, sinusoids=sinusoids, is_valid=is_valid,
                            segment_ids=segment_ids, attention_bias=attention_bias)
        remat = self.remat_saves is not None and torch.is_grad_enabled()
        split = self.sequence_split_axis(mesh)
        if split is not None:
            inner, split = split
            x, layer_kwargs = _split_sequence(x, layer_kwargs, mesh, split)
            if inner == "rdma":
                # the ring kernel's waits on a neighbour trap after
                # RING_TIMEOUT_NS: ranks that reach a batch seconds apart,
                # on the host or in their card's queue, meet here first,
                # once per forward, each with its queue drained
                if x.is_cuda:
                    torch.cuda.current_stream(x.device).synchronize()
                comm.barrier(mesh, split, "sp")
        if (self.pipeline_axis and mesh is not None
                and mesh.shape.get(self.pipeline_axis, 1) > 1):
            from merlot_reserve_tpu_torch.parallel.pipeline import pipeline_transformer

            x = pipeline_transformer(
                self.layers, x, layer_kwargs, mesh=mesh, axis=self.pipeline_axis,
                num_microbatches=self.pipeline_microbatches,
                remat_saves=self.remat_saves if remat else None,
                param_names=self._layer_param_names)
        else:
            x = run_layers(self.layers, x, layer_kwargs,
                           self.remat_saves if remat else None, self._layer_param_names)
        if split is not None:
            x = comm.gather_replicated(x, mesh, split, x.dim() - 2, "sp")
        x_ln = layer_norm(x, self.final_ln, self.dtype)

        if self.add_cls_token:
            return {"cls": linear(x_ln[..., 0, :], self.cls_proj, self.dtype),
                    "seq": x_ln[..., 1:, :]}
        return {"seq": x_ln}
