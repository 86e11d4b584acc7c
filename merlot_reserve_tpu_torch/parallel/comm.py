"""Every collective the port issues, and the audit of them.

The counterpart of ``merlot_reserve_tpu/parallel/comm.py``. The JAX package
reads its collectives out of the compiled HLO; the port has no HLO, so every
collective it issues goes through the wrappers here, each over the process
group of a mesh axis (``Mesh.group``), and a recorder, when active, notes
each one: op, dtype, bytes, axis, the group's ranks, and what it moves
(``what``: 'grads', 'params', 'loss', 'draws', 'metrics', 'tp', 'sp', 'pp',
'checkpoint'). ``collective_records`` runs one step under it;
``collective_summary`` adds the records up per op; ``split_intra_inter``
(the counterpart of ``split_ici_dcn``) splits them by whether a group spans
nodes (``LOCAL_WORLD_SIZE`` ranks a node). Bytes are
those of the op's result buffer, as the JAX audit counts them (the tensor a
send moves, a receive's buffer), not wire bytes; a host ``barrier`` is
recorded with none.

The differentiable collectives are the autograd functions below:
``gather_rows`` (the batch's rows over dp: each rank's loss is its own
part, so the backward sums, a reduce-scatter), ``gather_replicated`` and
``split_replicated`` (a tensor computed alike on every rank of the axis:
the backward of a gather takes the rank's slice, that of a split gathers),
and Megatron's pair ``copy_to_parallel`` (identity forward, all-reduce
backward) and ``reduce_from_parallel`` (all-reduce forward, identity
backward).

All collectives are ``torch.distributed``'s. Only calls that exist from
torch 2.11 on are used: the flat gather and reduce-scatter are taken from
``all_gather_single`` / ``reduce_scatter_single`` where torch has them
(2.13 deprecates the ``*_tensor`` names) and from the ``*_tensor`` ones else.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from merlot_reserve_tpu_torch.parallel import distributed

_RECORDS: Optional[List[Dict[str, Any]]] = None


@contextlib.contextmanager
def recording():
    """Record every collective issued inside the block (on any thread: an
    autograd backward may run on its own) into the list it yields."""
    global _RECORDS
    saved, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = saved


def _axis_label(axes) -> str:
    return axes if isinstance(axes, str) else "+".join(axes)


def _record(op: str, t: torch.Tensor, mesh, axes, what: str, ranks=None) -> None:
    if _RECORDS is not None:
        _RECORDS.append({"op": op, "dtype": str(t.dtype).replace("torch.", ""),
                         "bytes": t.numel() * t.element_size(), "axis": _axis_label(axes),
                         "what": what,
                         "ranks": list(ranks if ranks is not None else mesh.group_ranks(axes))})


def _flat_gather():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _flat_reduce_scatter():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ---------------------------------------------------------------------------
# plain collectives over a mesh axis
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM,
               what: str = "") -> torch.Tensor:
    """Sum (or ``op``) ``t`` in place over ``axes``; returns it."""
    _record("all-reduce", t, mesh, axes, what)
    dist.all_reduce(t, op=op, group=mesh.group(axes))
    return t


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0, what: str = "") -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in axis order."""
    n = mesh.size(axes)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _record("all-gather", out, mesh, axes, what)
    _flat_gather()(out, src, group=mesh.group(axes))
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int = 0,
                   what: str = "") -> torch.Tensor:
    """The sum over ``axes`` of ``t``, of which each rank keeps its slice of
    ``dim`` (1/n of it, in axis order)."""
    n = mesh.size(axes)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not split {n} ways")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _record("reduce-scatter", out, mesh, axes, what)
    _flat_reduce_scatter()(out, src, group=mesh.group(axes))
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, mesh, axes, what: str = "") -> torch.Tensor:
    """``all_to_all_single`` over ``axes``: dim 0 in n equal blocks, block j
    to rank j, and the blocks received in rank order."""
    src = t.contiguous()
    out = torch.empty_like(src)
    _record("all-to-all", out, mesh, axes, what)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return out


def broadcast(t: torch.Tensor, mesh, axes, src_index: int, what: str = "") -> torch.Tensor:
    """``t`` of the rank at ``src_index`` along ``axes`` into every rank's
    ``t`` (in place); returns it."""
    _record("broadcast", t, mesh, axes, what)
    dist.broadcast(t, src=mesh.group_ranks(axes)[src_index], group=mesh.group(axes))
    return t


def send(t: torch.Tensor, mesh, axes, dst_index: int, tag: int = 0, what: str = "") -> None:
    """Send ``t`` to the rank at ``dst_index`` along ``axes``."""
    peer = mesh.group_ranks(axes)[dst_index]
    _record("send", t, mesh, axes, what, ranks=[distributed.process_index(), peer])
    dist.send(t.contiguous(), dst=peer, group=mesh.group(axes), tag=tag)


def recv(t: torch.Tensor, mesh, axes, src_index: int, tag: int = 0,
         what: str = "") -> torch.Tensor:
    """Receive into ``t`` from the rank at ``src_index`` along ``axes``."""
    peer = mesh.group_ranks(axes)[src_index]
    _record("recv", t, mesh, axes, what, ranks=[peer, distributed.process_index()])
    dist.recv(t, src=peer, group=mesh.group(axes), tag=tag)
    return t


def exchange(send_t: torch.Tensor, recv_t: torch.Tensor, mesh, axes, dst_index: int,
             src_index: int, what: str = "") -> torch.Tensor:
    """Send ``send_t`` to ``dst_index`` and receive ``recv_t`` from
    ``src_index`` along ``axes`` at once (``batch_isend_irecv``: a ring's
    hop, every rank sending and receiving); returns ``recv_t``."""
    group = mesh.group(axes)
    members = mesh.group_ranks(axes)
    me = distributed.process_index()
    _record("send", send_t, mesh, axes, what, ranks=[me, members[dst_index]])
    _record("recv", recv_t, mesh, axes, what, ranks=[members[src_index], me])
    ops = [dist.P2POp(dist.isend, send_t.contiguous(), members[dst_index], group),
           dist.P2POp(dist.irecv, recv_t, members[src_index], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv_t


def all_gather_object(obj, mesh, axes, what: str = "") -> list:
    """Every rank's picklable ``obj`` along ``axes``, in axis order (its
    record counts no bytes: the pickles' sizes are not known here). A
    stand-in (``distributed.is_standin``) records what a real rank would
    and returns its own ``obj`` for every rank: the fake group would hand
    back whatever its buffers held, to be unpickled."""
    if _RECORDS is not None:
        _RECORDS.append({"op": "all-gather-object", "dtype": "object", "bytes": 0,
                         "axis": _axis_label(axes), "what": what,
                         "ranks": list(mesh.group_ranks(axes))})
    if distributed.is_standin():
        mesh.group(axes)
        return [obj] * mesh.size(axes)
    out = [None] * mesh.size(axes)
    dist.all_gather_object(out, obj, group=mesh.group(axes))
    return out


def barrier(mesh, axes, what: str = "") -> None:
    """Wait on the host until every rank of ``axes`` has come here (its
    record moves no bytes)."""
    if _RECORDS is not None:
        _RECORDS.append({"op": "barrier", "dtype": "none", "bytes": 0,
                         "axis": _axis_label(axes), "what": what,
                         "ranks": list(mesh.group_ranks(axes))})
    dist.barrier(group=mesh.group(axes))


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, what):
        ctx.mesh, ctx.axes, ctx.what = mesh, axes, what
        return all_gather(x, mesh, axes, what=what)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, what=ctx.what), None, None, None


def gather_rows(x: torch.Tensor, mesh, axes, what: str = "") -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0, axis order) where each rank's loss
    is its own part of the total: the backward sums the rows' gradients
    over the ranks and hands each its own (a reduce-scatter)."""
    return _GatherRows.apply(x, mesh, axes, what)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, what):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return all_gather(x, mesh, axes, dim, what)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None, None, None


def gather_replicated(x: torch.Tensor, mesh, axes, dim: int = 0,
                      what: str = "") -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim``, for a result that every rank
    then uses alike: the backward keeps the rank's own slice."""
    return _GatherReplicated.apply(x, mesh, axes, dim, what)


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, what):
        ctx.mesh, ctx.axes, ctx.dim, ctx.what = mesh, axes, dim, what
        n = mesh.size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"split_replicated: dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways")
        k = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axes) * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim, ctx.what), None, None, None, None


def split_replicated(x: torch.Tensor, mesh, axes, dim: int = 0,
                     what: str = "") -> torch.Tensor:
    """The rank's slice of ``dim`` of an ``x`` that every rank holds alike:
    the backward gathers the slices' gradients, so every rank sees the
    whole gradient of ``x``."""
    return _SplitReplicated.apply(x, mesh, axes, dim, what)


class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, what):
        ctx.mesh, ctx.axes, ctx.what = mesh, axes, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes, what=ctx.what)
        return g, None, None, None


def copy_to_parallel(x: torch.Tensor, mesh, axes, what: str = "tp") -> torch.Tensor:
    """Megatron's f: ``x`` as it is, into a region whose ranks each hold a
    part of the weights; the backward sums the parts' gradients."""
    return _CopyToParallel.apply(x, mesh, axes, what)


class _ReduceFromParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, what):
        return all_reduce(x.contiguous().clone(), mesh, axes, what=what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def reduce_from_parallel(x: torch.Tensor, mesh, axes, what: str = "tp") -> torch.Tensor:
    """Megatron's g: the sum of the ranks' partial ``x``; the backward hands
    the gradient to every part as it is."""
    return _ReduceFromParallel.apply(x, mesh, axes, what)


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


def collective_records(step_fn, *args, **kwargs) -> List[Dict[str, Any]]:
    """Run ``step_fn(*args, **kwargs)`` once under the recorder and return
    its records, one per collective issued (forward and backward)."""
    with recording() as records:
        step_fn(*args, **kwargs)
    return list(records)


def summarize_records(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-op counts and bytes of ``records``, with per-(op, dtype),
    per-(op, axis) and per-(op, what) counts, the bytes per (op, what), and
    the totals."""
    keys = ("dtypes", "axes", "what", "what_bytes")
    per_op: Dict[str, Dict[str, Any]] = defaultdict(
        lambda: dict({"count": 0, "bytes": 0}, **{k: defaultdict(int) for k in keys}))
    for rec in records:
        entry = per_op[rec["op"]]
        entry["count"] += 1
        entry["bytes"] += rec["bytes"]
        entry["dtypes"][rec["dtype"]] += 1
        entry["axes"][rec["axis"]] += 1
        entry["what"][rec.get("what", "")] += 1
        entry["what_bytes"][rec.get("what", "")] += rec["bytes"]
    summary: Dict[str, Any] = {op: dict({"count": v["count"], "bytes": v["bytes"]},
                                        **{k: dict(v[k]) for k in keys})
                               for op, v in per_op.items()}
    summary["total_bytes"] = sum(v["bytes"] for v in per_op.values())
    summary["total_count"] = sum(v["count"] for v in per_op.values())
    return summary


def collective_summary(step_fn, *args, **kwargs) -> Dict[str, Any]:
    """``summarize_records`` of ``collective_records``."""
    return summarize_records(collective_records(step_fn, *args, **kwargs))


def split_intra_inter(records: List[Dict[str, Any]],
                      local_world_size: Optional[int] = None) -> Dict[str, Dict[str, int]]:
    """Records' counts and bytes by whether their ranks share a node (rank
    r on node r // ``local_world_size``, default ``LOCAL_WORLD_SIZE``): the
    counterpart of the JAX audit's ``split_ici_dcn``, NVLink in a node
    against the network between nodes."""
    n = local_world_size or distributed.local_world_size()
    out = {"intra": {"count": 0, "bytes": 0}, "inter": {"count": 0, "bytes": 0}}
    for rec in records:
        bucket = "inter" if len({r // n for r in rec["ranks"]}) > 1 else "intra"
        out[bucket]["count"] += 1
        out[bucket]["bytes"] += rec["bytes"]
    return out
