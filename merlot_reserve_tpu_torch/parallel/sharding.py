"""Sharding rules: how parameters, optimizer state and batches lay out on
a mesh.

The counterpart of ``merlot_reserve_tpu/parallel/sharding.py``. The rules
are the JAX package's, by flax name over the flax leaf shapes that the
port's parameters map to (``utils/weights.py``): ``param_shardings``,
``opt_state_shardings`` and ``state_shardings`` give, per flax leaf, the
same ``PartitionSpec`` entries as the JAX package for the same tree and
mesh shape (tuples: ``()`` for ``P()``). Precedence is pp -> tp -> ZeRO-1
dp, as there.

The JAX package hands the specs to GSPMD. The port applies them itself
(``ShardPlan``), one process per rank:

  * tp: the Megatron kernels (qkv, attn_proj, the MLP's intermediate and
    out) and the token embedding hold the rank's share; the layers issue
    the collectives (``models/layers.py``, ``models/towers.py``). The spec
    splits qkv's [H, 3*heads, d] on its heads axis; the port's share is
    the rank's heads of each of q, k and v, which is the share the
    attention needs (GSPMD would reshard a contiguous block there);
  * pp: each stage holds its joint layers (``parallel/pipeline.py``);
  * ZeRO-1 dp: the model keeps full compute copies, and the optimizer
    holds the rank's slice of the f32 masters and Adam moments of every
    leaf whose spec names dp, in the leaf's flax layout with the split dim
    moved to the front, so that every shard is contiguous
    (``training.optimization.ShardedOptimizer``).

Batches: under a process mesh each process reads and keeps its own rows
(``form_global_batch`` is the identity); the loader's file shard is the
process's index over the batch axes (``data_shard``). A tensor on a
process's card already is its shard, so nothing like the JAX package's
``_global_from_local_device_array`` is needed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from merlot_reserve_tpu_torch.parallel.mesh import Mesh, batch_axes
from merlot_reserve_tpu_torch.utils.weights import (
    flax_leaf_paths,
    flax_leaf_shapes,
    from_flax_layout,
    to_flax_layout,
)

Spec = Tuple[Optional[str], ...]


def _tp_spec_for(path: str, ndim: int) -> Spec:
    """Megatron pairs: the MLP up-projection and the qkv heads column
    parallel, the MLP down-projection and the attention output projection
    row parallel (one reduction a pair), the vocabulary over tp."""
    if ndim < 2:
        return ()
    if re.search(r"intermediate/kernel$", path):
        return (None, "tp")
    if re.search(r"mlp_layer/out/kernel$", path):
        return ("tp", None)
    if re.search(r"qkv/kernel$", path) and ndim == 3:
        return (None, "tp", None)
    if re.search(r"attn_proj/kernel$", path) and ndim == 3:
        return ("tp", None, None)
    if re.search(r"Embed_0/embedding$", path):
        return ("tp", None)
    return ()


def _zero1_spec_for(path: str, shape: Sequence[int], dp_size: int) -> Spec:
    """ZeRO-1: the first dim that divides over dp."""
    if not shape:
        return ()
    for dim, n in enumerate(shape):
        if n % dp_size == 0 and n >= dp_size:
            spec: List[Optional[str]] = [None] * len(shape)
            spec[dim] = "dp"
            return tuple(spec)
    return ()


def _pp_spec_for(path: str, ndim: int, tp: bool = False) -> Spec:
    """The stacked joint layers over pp, with the per-layer tp spec on the
    other dims under tp."""
    if re.search(r"joint_transformer/layers/", path) and ndim >= 1:
        if tp:
            inner = _tp_spec_for(path, ndim - 1)
            if any(e is not None for e in inner):
                return ("pp",) + inner
        return ("pp",)
    return ()


def leaf_spec(path: str, shape: Sequence[int], mesh_shape: Dict[str, int], zero1_dp: bool,
              per_layer: bool = False) -> Spec:
    """The spec of one flax leaf: pp, else tp, else (with ``zero1_dp``) dp.

    ``per_layer``: the leaf's dim 0 stacks layers, and the tp rule reads the
    layer's dims, as ``_pp_spec_for`` reads them; the port lays its shares
    out so (``ShardPlan``). Without it, the JAX package's rules: under the
    scan layout without pp they match the per-layer patterns against the
    stacked leaf (the MLP's out kernel then splits its layer axis, qkv and
    attn_proj not at all), and GSPMD reshards for the computation. The port
    computes on its shares, so it takes Megatron's per-layer split."""
    tp, pp, dp = (mesh_shape.get(a, 1) for a in ("tp", "pp", "dp"))
    spec: Spec = ()
    if pp > 1:
        spec = _pp_spec_for(path, len(shape), tp=tp > 1)
    if spec == () and tp > 1:
        inner = _tp_spec_for(path, len(shape) - 1 if per_layer else len(shape))
        spec = (None,) + inner if per_layer and inner else inner
    if spec == () and zero1_dp and dp > 1:
        spec = _zero1_spec_for(path, shape, dp)
    return spec


@dataclass
class Leaf:
    """One flax leaf: its path, the port entries it holds (by layer when
    the layers are stacked on its dim 0) and its shape."""

    path: str
    names: List[str]
    shape: Tuple[int, ...]
    stacked: bool


def _named(params, size_per_head: Optional[int], scan_layers: Optional[bool]):
    if isinstance(params, nn.Module):
        cfg = params.config
        size_per_head = cfg.size_per_head if size_per_head is None else size_per_head
        scan_layers = cfg.scan_layers if scan_layers is None else scan_layers
        params = dict(params.named_parameters())
    return (params, 64 if size_per_head is None else size_per_head,
            True if scan_layers is None else scan_layers)


def param_leaves(params, size_per_head: Optional[int] = None,
                 scan_layers: Optional[bool] = None) -> Dict[str, Leaf]:
    """The flax leaves of a port model (or a name -> tensor dict), by path."""
    named, size_per_head, scan_layers = _named(params, size_per_head, scan_layers)
    paths = flax_leaf_paths(named, size_per_head, scan_layers)
    shapes = flax_leaf_shapes(named, size_per_head, scan_layers)
    by_path: Dict[str, List[Tuple[int, str]]] = {}
    for name, (path, layer) in paths.items():
        by_path.setdefault(path, []).append((-1 if layer is None else layer, name))
    leaves = {}
    for path, entries in by_path.items():
        entries.sort()
        names = [n for _, n in entries]
        leaves[path] = Leaf(path, names, shapes[names[0]], entries[0][0] >= 0)
    return leaves


def param_shardings(mesh: Mesh, params, zero1_dp: bool = False,
                    size_per_head: Optional[int] = None,
                    scan_layers: Optional[bool] = None) -> Dict[str, Spec]:
    """Flax path -> spec of every parameter leaf: the tp/pp rules, the rest
    replicated, or with ``zero1_dp`` split over dp on its first divisible
    dim (the f32 masters under ZeRO-1). ``params``: a port model, or a
    state_dict with ``size_per_head`` and ``scan_layers``."""
    return {path: leaf_spec(path, leaf.shape, mesh.shape, zero1_dp)
            for path, leaf in param_leaves(params, size_per_head, scan_layers).items()}


def opt_state_shardings(mesh: Mesh, params, zero1: bool = True,
                        size_per_head: Optional[int] = None,
                        scan_layers: Optional[bool] = None) -> Dict[str, Dict[str, Spec]]:
    """The Adam moments' specs, per moment and flax path: a moment lives
    with its parameter's pp or tp shard, else over dp under ``zero1``."""
    specs = param_shardings(mesh, params, zero1, size_per_head, scan_layers)
    return {"mu": dict(specs), "nu": dict(specs)}


def state_shardings(mesh: Mesh, params, zero1: bool = True,
                    size_per_head: Optional[int] = None,
                    scan_layers: Optional[bool] = None) -> Dict[str, Any]:
    """The whole train state's specs: the step replicated; with ``zero1``
    the f32 masters and both moments over dp (ZeRO-1, the step gathers a
    bf16 cast for compute)."""
    return {"step": (), "params": param_shardings(mesh, params, zero1, size_per_head,
                                                  scan_layers),
            "opt_state": opt_state_shardings(mesh, params, zero1, size_per_head, scan_layers)}


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def data_shard(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(index, count) of this process's rows of the global batch: its index
    over the batch axes, and their size. Ranks that differ only in tp, sp
    or pp read the same rows. (0, 1) without a process mesh."""
    if mesh is None or not mesh.is_process_mesh:
        return 0, 1
    bax = batch_axes(mesh)
    return mesh.axis_index(bax), mesh.size(bax)


def local_rows(mesh: Optional[Mesh], x):
    """This process's contiguous share of dim 0 of ``x`` (a tensor, an
    array, or a dict or list of them): its rows of a global batch."""
    index, count = data_shard(mesh)
    if isinstance(x, dict):
        return {k: local_rows(mesh, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(local_rows(mesh, v) for v in x)
    if count == 1 or x is None:
        return x
    if x.shape[0] % count:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split over {count} data-parallel ranks")
    k = x.shape[0] // count
    return x[index * k:(index + 1) * k]


def form_global_batch(mesh: Optional[Mesh], local_batch):
    """The batch a step takes, from this process's local rows. With one
    process the batch is already global; with several each process keeps
    its own rows, which its loader read from its file shard
    (``data_shard``): a tensor on a process's card is its shard. Returns
    ``local_batch``, after checking under a process mesh that its leaves
    agree on dim 0."""
    if mesh is None or not mesh.is_process_mesh:
        return local_batch
    sizes = {v.shape[0] for v in local_batch.values() if hasattr(v, "shape") and v.ndim}
    if len(sizes) > 1:
        raise ValueError(f"batch leaves disagree on dim 0: {sorted(sizes)}")
    return local_batch


# ---------------------------------------------------------------------------
# the port's layout: which rank holds what
# ---------------------------------------------------------------------------

_TP_KINDS = {"qkv/kernel": "qkv", "intermediate/kernel": "col", "mlp_layer/out/kernel": "row",
             "attn_proj/kernel": "row", "Embed_0/embedding": "vocab"}


def _tp_kind(path: str) -> str:
    for suffix, kind in _TP_KINDS.items():
        if path.endswith(suffix):
            return kind
    raise ValueError(f"no tensor-parallel layout for {path}")


def tp_join(kind: Optional[str], parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor of an entry whose tp split is ``kind`` (``ShardPlan.
    tp_kind``; None: not split) from the tp ranks' shares, in rank order."""
    if kind is None:
        return parts[0]
    if kind == "qkv":
        blocks = [p.reshape((3, p.shape[0] // 3) + tuple(p.shape[1:])) for p in parts]
        return torch.cat(blocks, 1).reshape((-1,) + tuple(parts[0].shape[1:]))
    return torch.cat(list(parts), 1 if kind == "row" else 0)


@dataclass
class ShardPlan:
    """Where every parameter of a port model lives on a process mesh, from
    the rules above (``leaf_spec`` per layer on stacked leaves). Built from
    the full model (all layers, whole tensors).

    Per port entry: ``tp_kind`` (None, or how its tensor splits over tp:
    'qkv' the rank's heads of q, k and v on dim 0, 'col' dim 0, 'row' dim 1,
    'vocab' dim 0), ``stage`` (under pp, the stage that holds a joint
    layer's entry), ``partial`` (the axes over which the entry's gradient is
    a sum of the ranks' parts besides the batch axes: sp for the layers of
    an encoder whose attention splits the sequence over processes). Per
    flax leaf whose spec names dp: ``zero_dim``, the dim it splits on.
    """

    mesh: Mesh
    zero1: bool
    leaves: Dict[str, Leaf]
    specs: Dict[str, Spec]
    full_shapes: Dict[str, torch.Size]
    tp_kind: Dict[str, Optional[str]] = field(default_factory=dict)
    stage: Dict[str, int] = field(default_factory=dict)
    partial: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    zero_dim: Dict[str, int] = field(default_factory=dict)
    size_per_head: int = 64
    heads: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def build(cls, mesh: Mesh, model: nn.Module, zero1: bool = True) -> "ShardPlan":
        cfg = model.config
        named = dict(model.named_parameters())
        leaves = param_leaves(named, cfg.size_per_head, cfg.scan_layers)
        specs = {p: leaf_spec(p, lf.shape, mesh.shape, zero1, per_layer=lf.stacked)
                 for p, lf in leaves.items()}
        plan = cls(mesh, zero1, leaves, specs, {n: t.shape for n, t in named.items()},
                   size_per_head=cfg.size_per_head)
        pp = mesh.shape.get("pp", 1)
        for path, leaf in leaves.items():
            spec = specs[path]
            for n in leaf.names:
                plan.tp_kind[n] = _tp_kind(path) if "tp" in spec else None
            if "dp" in spec:
                plan.zero_dim[path] = spec.index("dp")
            if spec[:1] == ("pp",):
                num_layers = len(leaf.names)
                if num_layers % pp:
                    raise ValueError(f"{num_layers} joint layers do not split over {pp} stages")
                for i, n in enumerate(leaf.names):
                    plan.stage[n] = i // (num_layers // pp)
        for mod_name, mod in model.named_modules():
            split = getattr(mod, "sequence_split_axis", lambda m: None)(mesh)
            if split is not None:
                for n in named:
                    if n.startswith(f"{mod_name}.layers."):
                        plan.partial[n] = (split[1],)
            if hasattr(mod, "qkv") and hasattr(mod, "num_heads"):
                plan.heads[f"{mod_name}.qkv.weight"] = mod.num_heads
                plan.heads[f"{mod_name}.qkv.bias"] = mod.num_heads
        return plan

    # -- tensor-parallel slicing ------------------------------------------

    def tp_dim(self, name: str) -> int:
        return 1 if self.tp_kind[name] == "row" else 0

    def tp_slice(self, name: str, full: torch.Tensor, index: Optional[int] = None,
                 size: Optional[int] = None) -> torch.Tensor:
        """Rank ``index`` of tp's share of the whole tensor ``full`` (a view)."""
        kind = self.tp_kind.get(name)
        if kind is None:
            return full
        n = self.mesh.shape["tp"] if size is None else size
        i = self.mesh.axis_index("tp") if index is None else index
        if kind == "qkv":
            heads = self.heads[name]
            if heads % n:
                raise ValueError(f"{name}: {heads} heads do not split over tp={n}")
            blocks = full.reshape((3, full.shape[0] // 3) + tuple(full.shape[1:]))
            k = blocks.shape[1] // n
            return blocks[:, i * k:(i + 1) * k].reshape((-1,) + tuple(full.shape[1:]))
        dim = self.tp_dim(name)
        if full.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} does not split over tp={n}")
        k = full.shape[dim] // n
        return full.narrow(dim, i * k, k)

    def tp_join(self, name: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from the tp ranks' shares, in rank order."""
        return tp_join(self.tp_kind.get(name), parts)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This process's share of the whole tensor of ``name`` (contiguous)."""
        return self.tp_slice(name, full).contiguous()

    # -- ZeRO-1 ------------------------------------------------------------

    def zero_leaves(self) -> List[str]:
        """The flax paths whose masters and moments split over dp, in order."""
        return [p for p in self.leaves if p in self.zero_dim]

    def leaf_tensor(self, path: str, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The flax leaf ``path`` from its entries in ``tensors``, with its
        dp dim moved to the front (contiguous)."""
        leaf = self.leaves[path]
        parts = [to_flax_layout(n, tensors[n], self.size_per_head) for n in leaf.names]
        x = torch.stack(parts) if leaf.stacked else parts[0]
        return x.movedim(self.zero_dim[path], 0).contiguous()

    def leaf_entries(self, path: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The inverse of ``leaf_tensor``: the entries (views) of a whole
        leaf given with its dp dim in front."""
        leaf = self.leaves[path]
        x = x.movedim(0, self.zero_dim[path])
        parts = list(x.unbind(0)) if leaf.stacked else [x]
        return {n: from_flax_layout(n, p) for n, p in zip(leaf.names, parts)}

    def zero_slice(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This dp rank's slice of a whole leaf (dp dim in front)."""
        n, i = self.mesh.shape["dp"], self.mesh.axis_index("dp")
        k = whole.shape[0] // n
        return whole[i * k:(i + 1) * k]

    def zero_names(self) -> List[str]:
        return [n for p in self.zero_leaves() for n in self.leaves[p].names]

    # -- the model ---------------------------------------------------------

    def shard_model_(self, model: nn.Module) -> nn.Module:
        """Cut the full ``model`` down to this process's share in place: the
        tp entries to their slices (and the layers told so), and under pp
        the joint transformer to this stage's layers."""
        mesh = self.mesh
        with torch.no_grad():
            for name, p in model.named_parameters():
                if self.tp_kind.get(name):
                    p.data = self.local(name, p.data)
        if mesh.shape.get("tp", 1) > 1:
            for mod in model.modules():
                if hasattr(mod, "shard_tp_"):
                    mod.shard_tp_(mesh)
        if self.stage:
            from merlot_reserve_tpu_torch.parallel.pipeline import keep_stage_layers_

            keep_stage_layers_(model.joint_transformer, mesh.axis_index("pp"),
                               mesh.shape["pp"])
        return model
