"""Sequence-parallel exact attention: ring and Ulysses over a mesh axis.

The JAX package shards the sequence of global [B, L, H, D] inputs over a
mesh axis ('sp') under shard_map and exchanges K/V between the ranks with
collectives. The port runs the n ranks of the axis either in one process,
on the tensors' device (virtual ranks: a rank's shard is its slice of L
rows, and a collective is an operation on the list of shards, ``ppermute``
to the right neighbour a rotation of the list, Ulysses' ``all_to_all`` a
split by heads), or as n processes of a process mesh, one per card: there
each process holds its own [B, L/n, H, D] shard (the encoder split the
sequence, ``models.layers.TransformerEncoder``) and the ranks exchange
K/V with ``torch.distributed`` (``parallel.comm``): the ring's hops are a
send to rank r + 1 and a receive from r - 1 (the backward's dk/dv travel
with their shard and come home), Ulysses' two trades are
``all_to_all_single``. A mesh over several devices of one process raises.
The ring kernel ``ring:rdma`` runs on virtual ranks in one launch, and
across processes as one launch per rank (``PeerRing``): each process's
shard slots sit in device memory that its neighbours open by CUDA IPC,
and the kernel copies K/V into the right neighbour's slots and raises
flags in the neighbours' memory, as the TPU kernel's remote DMA and
semaphores do.

``sequence_parallel_attention`` picks the strategy (``impl``):
  * 'lax': ``ring_attention``, the online softmax over the rotating shards
    in plain torch, differentiable through autograd. It is also the plain
    version of the ring kernel (``ring_attention_reference``).
  * 'flash': ``ring_flash_attention``, one ``flash_forward`` per hop with the
    visiting shard's labels, merged by log-sum-exp. Differentiable
    (``RingFlashAttention``): its backward walks the ring again with one
    ``flash_backward`` per hop against the merged out/lse, the dk/dv
    accumulators travelling with their shard.
  * 'rdma': ``ring_flash_attention_rdma``, the whole ring in one launch of
    the hand-written kernel ``csrc/ring_fwd.cu`` on a CUDA tensor (the plain
    ring on a CPU tensor); under a process mesh one launch per rank of the
    kernel's mode across processes. Forward only, as in the JAX package.
  * 'ulysses' / 'ulysses-flash': the full sequence with H/n heads per rank,
    dense or flash, differentiable.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from merlot_reserve_tpu_torch.ops import attention as attn_ops
from merlot_reserve_tpu_torch.parallel import comm
from merlot_reserve_tpu_torch.parallel.mesh import Mesh

NEG_INF = attn_ops.NEG_INF
# the inner strategies each family takes; the first is its default
_INNERS = {"ring": ("lax", "flash", "rdma"), "ulysses": ("xla", "flash")}
# the longest a ring kernel waits on a neighbour before it traps
RING_TIMEOUT_NS = 5_000_000_000
RING_KEY_TILE = 128  # keys per tile of the bf16 ring kernel (csrc/ring_fwd.cu kKeyTile)
# where training under sequence parallelism goes instead of ring:rdma
_TRAINING_ITEM = ("training under sequence parallelism takes 'ring:flash', whose backward "
                  "ring runs the flash backward hop by hop")


def parse_sequence_parallel_impl(impl: str):
    """'ring[:lax|flash|rdma][:AXIS]' / 'ulysses[:xla|flash][:AXIS]' ->
    (inner for ``sequence_parallel_attention``, axis name). A single tail
    token that is not a known inner names the axis. Anything else raises:
    a typo must not turn into dense attention."""
    family, *tail = impl.split(":")
    if family not in _INNERS:
        raise ValueError(f"unknown sequence-parallel impl {impl!r}: want "
                         "'ring[:lax|flash|rdma][:AXIS]' or 'ulysses[:xla|flash][:AXIS]'")
    known = _INNERS[family]
    inner, axis = known[0], "sp"
    if len(tail) == 1:
        if tail[0] in known:
            inner = tail[0]
        else:
            axis = tail[0]
    elif len(tail) == 2:
        if tail[0] not in known:
            raise ValueError(f"impl {impl!r}: unknown {family} inner {tail[0]!r}; "
                             f"expected one of {known}")
        inner, axis = tail
    elif tail:
        raise ValueError(f"bad sequence-parallel impl string {impl!r}")
    if not axis:
        raise ValueError(f"impl {impl!r}: empty axis name")
    if family == "ulysses":
        inner = "ulysses-flash" if inner == "flash" else "ulysses"
    return inner, axis


# ---------------------------------------------------------------------------
# ring over a list of shards (the plain version)
# ---------------------------------------------------------------------------


def _partial_attention(q, k, v, q_valid, q_seg, k_valid, k_seg, scale):
    """One shard's contribution: (numerator [B, H, Lq, D], row max m
    [B, H, Lq], row sum l), in f32, with masked scores at -1e10."""
    s = torch.einsum("blhd,bmhd->bhlm", (q * scale).float(), k.float())
    mask = ((q_valid[:, None, :, None] > 0) & (k_valid[:, None, None, :] > 0)
            & (q_seg[:, None, :, None] == k_seg[:, None, None, :]))
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhlm,bmhd->bhld", p, v.float()), m, p.sum(dim=-1)


class _VirtualRing:
    """The n ranks of a ring held in this process, rank r's tensors at
    index r of each list: a hop rotates the lists (the JAX package's
    ``ppermute`` i -> i + 1). ``labels(j)``: shard j's int32 [B, Lloc]
    (is_valid, segment_ids)."""

    def __init__(self, valids, segs):
        self.n = len(valids)
        self.ranks = list(range(self.n))
        self._labels = list(zip(valids, segs))

    def labels(self, j):
        return self._labels[j]

    def split(self, x):
        return _shards(x, self.n)

    def shift(self, xs):
        return xs[-1:] + xs[:-1]


class _ProcessRing:
    """Rank r of an n-rank ring along ``axis`` of a process mesh, the one
    rank of this process: a hop sends its tensors, stacked into one buffer,
    to rank r + 1 and takes rank r - 1's (differentiable: the gradient goes
    the other way). The labels of every shard are here, gathered once
    ([B, L] each)."""

    def __init__(self, mesh, axis, valid_all, seg_all, lloc):
        self.mesh, self.axis, self.lloc = mesh, axis, lloc
        self.n = mesh.size(axis)
        self.ranks = [mesh.axis_index(axis)]
        self.valid_all, self.seg_all = valid_all, seg_all

    def labels(self, j):
        return (_label_shard(self.valid_all, j, self.lloc),
                _label_shard(self.seg_all, j, self.lloc))

    def split(self, x):
        return [x]

    def shift(self, xs):
        (x,) = xs
        return [tuple(_RingShift.apply(torch.stack(x), self.mesh, self.axis).unbind(0))]


def _lax_ring(qs, ks, vs, ring):
    """The JAX package's lax ring for the ranks ``ring.ranks`` (one
    [B, Lloc, H, D] shard each in ``qs``, ``ks``, ``vs``): at step t rank r
    merges the visiting shard, the one that started at rank (r - t) mod n,
    into its online softmax (m, l, acc in f32); n - 1 hops. Returns one
    output per rank in q's dtype."""
    n = ring.n
    B, Lq, H, D = qs[0].shape
    scale = 1.0 / math.sqrt(D)
    dev = qs[0].device
    state = [(torch.zeros((B, H, Lq, D), dtype=torch.float32, device=dev),
              torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=dev),
              torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)) for _ in ring.ranks]
    kv = list(zip(ks, vs))
    for t in range(n):
        for i, r in enumerate(ring.ranks):
            acc, m_run, l_run = state[i]
            acc_b, m_b, l_b = _partial_attention(qs[i], *kv[i], *ring.labels(r),
                                                 *ring.labels((r - t) % n), scale)
            m_new = torch.maximum(m_run, m_b)
            c_run, c_b = torch.exp(m_run - m_new), torch.exp(m_b - m_new)
            state[i] = (acc * c_run[..., None] + acc_b * c_b[..., None], m_new,
                        l_run * c_run + l_b * c_b)
        if t < n - 1:
            kv = ring.shift(kv)
    outs = []
    for q, (acc, _, l) in zip(qs, state):
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l_safe[..., None]).transpose(1, 2).to(q.dtype))
    return outs


def ring_attention(qs, ks, vs, valids, segs):
    """The JAX package's lax ring over n local shards (``_lax_ring`` on
    virtual ranks).

    :param qs, ks, vs: lists of n [B, Lloc, H, D] shards, rank r's at index r
    :param valids, segs: lists of n [B, Lloc] labels
    :return: list of n [B, Lloc, H, D] outputs in q's dtype
    """
    return _lax_ring(qs, ks, vs, _VirtualRing([x.to(torch.int32) for x in valids],
                                              [x.to(torch.int32) for x in segs]))


def _shards(x, n):
    return list(x.split(x.shape[1] // n, dim=1))


def ring_attention_reference(q, k, v, is_valid, segment_ids, n):
    """The plain version of the ring kernel (``ring_fwd``): ``ring_attention``
    over the n shards of global [B, L, H, D] inputs and [B, L] labels ->
    [B, L, H, D] in q's dtype."""
    shards = [_shards(x, n) for x in (q, k, v, is_valid, segment_ids)]
    return torch.cat(ring_attention(*shards), dim=1)


def _ring_shards(q, k, v, is_valid, segment_ids, n):
    """The n ranks' shards of global q, k, v (views) and their labels,
    contiguous once here rather than copied by every launch of every hop."""
    return ([_shards(x, n) for x in (q, k, v)]
            + [[x.contiguous() for x in _shards(y, n)] for y in (is_valid, segment_ids)])


def _ring_flash_forward(qs, ks, vs, ring):
    """The per-hop flash ring, forward (``_ring_flash_forward`` of the JAX
    package): at each hop rank r runs ``flash_forward`` of its queries
    against the visiting shard (with that shard's labels) and merges the
    hop's (out, lse) into its running pair by log-sum-exp.

    :param qs, ks, vs: one [B, Lloc, H, D] shard per rank of ``ring.ranks``
    :param ring: ``_VirtualRing`` or ``_ProcessRing``: the hops and labels
    :return: (outs [B, Lloc, H, D] in q's dtype, merged lses [B, Lloc, H, 1]
        f32), one per rank
    """
    n = ring.n
    B, Lq, H, D = qs[0].shape
    dev = qs[0].device
    out_run = [torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev) for _ in qs]
    # finite "-inf": exp(lse_run - lse_new) stays defined at the first merge
    lse_run = [torch.full((B, Lq, H, 1), -1e30, dtype=torch.float32, device=dev) for _ in qs]
    kv = list(zip(ks, vs))
    for t in range(n):
        for i, r in enumerate(ring.ranks):
            k_valid, k_seg = ring.labels((r - t) % n)
            out_t, lse_t = attn_ops.flash_forward(qs[i], *kv[i], *ring.labels(r),
                                                  k_is_valid=k_valid, k_segment_ids=k_seg)
            out_run[i], lse_run[i] = _merge_flash(out_run[i], lse_run[i], out_t, lse_t)
        if t < n - 1:
            kv = ring.shift(kv)
    return [o.to(q.dtype) for o, q in zip(out_run, qs)], lse_run


def _merge_flash(out_run, lse_run, out_t, lse_t):
    """A hop's (out, lse [B, H, Lq]) merged into the running pair by
    log-sum-exp; out_t is promoted to f32 inside each product (no f32 copy
    of it)."""
    lse_t = lse_t.transpose(1, 2)[..., None]  # [B, H, Lq] -> [B, Lq, H, 1]
    lse_new = torch.logaddexp(lse_run, lse_t)
    return out_run * torch.exp(lse_run - lse_new) + out_t * torch.exp(lse_t - lse_new), lse_new


def _ring_flash_backward(qs, ks, vs, outs, lses, douts, ring):
    """The backward ring (``_ring_flash_bwd`` of the JAX package): the K/V
    shards and their f32 dk/dv accumulators travel past each rank's fixed
    (q, dO, out, lse), and at each hop rank r adds ``flash_backward`` of its
    queries against the visiting shard. The out/lse are the merged ones, so
    p = exp(s - lse) is the probability over the whole sequence and the
    hops' dq, dk, dv add up exactly. The accumulators move with their shard
    after every hop; the move after the last hop (the JAX package's final
    ppermute) brings them home.

    :param outs, douts: one contiguous [B, Lloc, H, D] per rank, q's dtype
    :param lses: one f32 [B, Lloc, H, 1] per rank
    :return: (dqs, dks, dvs), one [B, Lloc, H, D] per rank in q's dtype
    """
    n = ring.n
    lse_rows = [lse[..., 0].transpose(1, 2).contiguous() for lse in lses]  # [B, H, Lloc]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    kv = list(zip(ks, vs))
    dkv = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device)) for k, v in kv]
    for t in range(n):
        for i, r in enumerate(ring.ranks):
            k_valid, k_seg = ring.labels((r - t) % n)
            dq_t, dk_t, dv_t = attn_ops.flash_backward(
                qs[i], *kv[i], douts[i], outs[i], lse_rows[i], *ring.labels(r),
                k_is_valid=k_valid, k_segment_ids=k_seg)
            # f32 += q's dtype: promoted inside the add, no f32 copy
            dqs[i] += dq_t
            dkv[i][0].add_(dk_t)
            dkv[i][1].add_(dv_t)
        dkv = ring.shift(dkv)
        if t < n - 1:
            kv = ring.shift(kv)
    dtype = qs[0].dtype
    return ([dq.to(dtype) for dq in dqs], [dk.to(dtype) for dk, _ in dkv],
            [dv.to(dtype) for _, dv in dkv])


def _ring_inputs(q, k, v, is_valid, segment_ids, n, mesh, axis):
    """(qs, ks, vs, ring) for the ranks this caller computes: the n shards of
    global inputs on virtual ranks (``mesh`` None), or this process's shard
    on its process ring (the labels of the whole sequence)."""
    if mesh is None:
        qs, ks, vs, valids, segs = _ring_shards(q, k, v, is_valid, segment_ids, n)
        return qs, ks, vs, _VirtualRing(valids, segs)
    return [q], [k], [v], _ProcessRing(mesh, axis, is_valid, segment_ids, q.shape[1])


class RingFlashAttention(torch.autograd.Function):
    """The ``ring_flash_attention`` custom_vjp of the JAX package: the
    forward saves (q, k, v, labels, out, merged lse); the backward walks
    the ring again (``_ring_flash_backward``). Over the n virtual ranks of
    one process (``mesh`` None: global [B, L, H, D] inputs and labels), or
    as this process's rank along ``axis`` of a process mesh (its
    [B, L/n, H, D] shard, the [B, L] labels of the whole sequence)."""

    @staticmethod
    def forward(ctx, q, k, v, is_valid, segment_ids, n, mesh, axis):
        qs, ks, vs, ring = _ring_inputs(q, k, v, is_valid, segment_ids, n, mesh, axis)
        outs, lses = _ring_flash_forward(qs, ks, vs, ring)
        out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=1)
        ctx.ring = (n, mesh, axis)
        ctx.save_for_backward(q, k, v, is_valid, segment_ids, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, is_valid, segment_ids, out, lse = ctx.saved_tensors
        qs, ks, vs, ring = _ring_inputs(q, k, v, is_valid, segment_ids, *ctx.ring)
        outs, douts = ([x.contiguous() for x in ring.split(t.to(q.dtype))] for t in (out, dout))
        dqs, dks, dvs = _ring_flash_backward(qs, ks, vs, outs, ring.split(lse), douts, ring)
        return (torch.cat(dqs, dim=1), torch.cat(dks, dim=1), torch.cat(dvs, dim=1),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, is_valid, segment_ids, n: int):
    """The per-hop flash ring over the n shards of global [B, L, H, D]
    inputs and int32 [B, L] labels -> [B, L, H, D] in q's dtype.
    Differentiable through ``RingFlashAttention`` when an input requires
    grad; otherwise the forward ring alone, nothing saved."""
    if attn_ops._records_grad(q, k, v):
        return RingFlashAttention.apply(q, k, v, is_valid, segment_ids, n, None, None)
    qs, ks, vs, ring = _ring_inputs(q, k, v, is_valid, segment_ids, n, None, None)
    return torch.cat(_ring_flash_forward(qs, ks, vs, ring)[0], dim=1)


def ulysses_attention(qs, ks, vs, valids, segs, inner: str = "xla"):
    """Ulysses: one all_to_all trades the sequence sharding for a head
    sharding (rank g gets all L rows of heads [g H/n, (g + 1) H/n)), each
    rank attends over the full sequence, and a second all_to_all trades
    back. ``inner``: 'xla' (dense) or 'flash' (``flash_attention``, with its
    backward kernels under grad). Same arguments and result as
    ``ring_attention``; needs H % n == 0."""
    n = len(qs)
    q, k, v = (torch.cat(xs, dim=1) for xs in (qs, ks, vs))
    valid = torch.cat([x.to(torch.int32) for x in valids], dim=1)
    seg = torch.cat([x.to(torch.int32) for x in segs], dim=1)
    hn = q.shape[2] // n
    outs = []
    for g in range(n):
        heads = slice(g * hn, (g + 1) * hn)
        qg, kg, vg = q[:, :, heads], k[:, :, heads], v[:, :, heads]
        if inner == "flash":
            out = attn_ops.flash_attention(qg, kg, vg, valid, seg)
        else:
            out = attn_ops.xla_attention(qg, kg, vg, attn_ops.make_attention_bias(
                is_valid=valid, segment_ids=seg, dtype=torch.float32))
        outs.append(out.to(q.dtype))
    return _shards(torch.cat(outs, dim=2), n)


def sequence_parallel_attention(mesh: Mesh, q, k, v, is_valid=None, segment_ids=None,
                                axis_name: str = "sp", impl: str = "lax",
                                tp_heads=None):
    """Exact attention over global [B, L, H, D] inputs with the sequence
    split over ``axis_name``'s n ranks of ``mesh`` -> [B, L, H, D]. Under a
    process mesh the inputs and the result are this rank's [B, L/n, H, D]
    shard and its [B, L/n] labels (``_process_attention``).

    impl: 'lax', 'flash', 'rdma', 'ulysses' or 'ulysses-flash' (module doc).
    As in the JAX package, L must divide by n, the batch splits over dp when
    dp divides it, and ``tp_heads`` (default: whenever a tp axis divides H)
    says q, k, v arrive head-sharded over tp. Rows of different dp shards
    and heads of different tp shards never meet in attention, so in one
    process they run together and only the checks remain.
    """
    B, L, H, D = q.shape
    if axis_name not in mesh.shape:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {tuple(mesh.shape)}")
    n = mesh.shape[axis_name]
    if mesh.is_process_mesh:
        return _process_attention(mesh, q, k, v, is_valid, segment_ids, axis_name, impl)
    if L % n:
        raise ValueError(f"L={L} not divisible by {axis_name}={n}")
    others = [d for d in mesh.distinct_devices() if d != q.device]
    if others:
        raise NotImplementedError(
            f"mesh devices {[str(d) for d in mesh.distinct_devices()]} for tensors on "
            f"{q.device}: virtual ranks run on the tensors' device; a ring across "
            "several cards runs one process per card (a process mesh)")
    if is_valid is None:
        is_valid = torch.ones((B, L), dtype=torch.int32, device=q.device)
    if segment_ids is None:
        segment_ids = torch.zeros((B, L), dtype=torch.int32, device=q.device)
    tp_n = mesh.shape.get("tp", 1)
    if tp_heads is None:
        tp_heads = tp_n > 1 and H % tp_n == 0 and axis_name != "tp"
    elif tp_heads and not (tp_n > 1 and H % tp_n == 0 and axis_name != "tp"):
        raise ValueError(f"tp_heads=True needs a tp mesh axis dividing num_heads={H} "
                         f"(tp={tp_n}) distinct from axis_name={axis_name!r}")

    if impl == "rdma":
        return ring_flash_attention_rdma(q, k, v, is_valid, segment_ids, n)
    if impl == "flash":
        return ring_flash_attention(q, k, v, is_valid.to(torch.int32),
                                    segment_ids.to(torch.int32), n)
    if impl in ("ulysses", "ulysses-flash"):
        local_heads = H // tp_n if tp_heads else H
        if local_heads % n:
            raise ValueError(
                f"ulysses attention shards heads over {axis_name!r}: {local_heads} local "
                f"heads not divisible by {axis_name}={n}; use impl='lax' (ring)")
        body = functools.partial(ulysses_attention,
                                 inner="flash" if impl == "ulysses-flash" else "xla")
    elif impl == "lax":
        body = ring_attention
    else:
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    shards = [_shards(x, n) for x in (q, k, v, is_valid, segment_ids)]
    return torch.cat(body(*shards), dim=1)


# ---------------------------------------------------------------------------
# across processes: one rank's shard per process
# ---------------------------------------------------------------------------


def _label_shard(labels_all, j, lloc):
    return labels_all[:, j * lloc:(j + 1) * lloc].contiguous()


def _hop(x, mesh, axis, back: bool = False):
    """One ring hop of ``x``: to rank r + 1 from r - 1 (``back``: the other
    way)."""
    n, r = mesh.size(axis), mesh.axis_index(axis)
    dst, src = ((r - 1) % n, (r + 1) % n) if back else ((r + 1) % n, (r - 1) % n)
    return comm.exchange(x, torch.empty_like(x), mesh, axis, dst, src, what="sp")


class _RingShift(torch.autograd.Function):
    """A differentiable hop: forward to rank r + 1, gradients back to r - 1."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _hop(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _hop(g.contiguous(), ctx.mesh, ctx.axis, back=True), None, None


class _AllToAll(torch.autograd.Function):
    """``comm.all_to_all`` (block j of dim 0 to rank j); its own backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return comm.all_to_all(x, mesh, axis, what="sp")

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g, ctx.mesh, ctx.axis, what="sp"), None, None


def _seq_to_heads(x, mesh, axis):
    """[B, L/n, H, D] sequence shard -> [B, L, H/n, D] head group r."""
    n = mesh.size(axis)
    B, lloc, H, D = x.shape
    blocks = x.reshape(B, lloc, n, H // n, D).permute(2, 0, 1, 3, 4)
    y = _AllToAll.apply(blocks, mesh, axis)  # block i: sequence shard i of my heads
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * lloc, H // n, D)


def _heads_to_seq(x, mesh, axis):
    """[B, L, H/n, D] head group r -> [B, L/n, H, D] sequence shard r."""
    n = mesh.size(axis)
    B, L, hn, D = x.shape
    blocks = x.reshape(B, n, L // n, hn, D).permute(1, 0, 2, 3, 4)
    y = _AllToAll.apply(blocks, mesh, axis)  # block j: head group j of my shard
    return y.permute(1, 2, 0, 3, 4).reshape(B, L // n, n * hn, D)


def _process_attention(mesh, q, k, v, is_valid, segment_ids, axis, impl):
    """Sequence-parallel attention with one rank per process: q, k, v are
    this rank's [B, L/n, H, D] shard, the labels its [B, L/n] ones."""
    n = mesh.size(axis)
    B, lloc, H, D = q.shape
    if is_valid is None:
        is_valid = torch.ones((B, lloc), dtype=torch.int32, device=q.device)
    if segment_ids is None:
        segment_ids = torch.zeros((B, lloc), dtype=torch.int32, device=q.device)
    if impl == "rdma":
        if attn_ops._records_grad(q, k, v):
            raise NotImplementedError(f"ring:rdma is forward-only, as in the JAX package; "
                                      f"{_TRAINING_ITEM}")
        is_valid, segment_ids = is_valid.to(torch.int32), segment_ids.to(torch.int32)
        if n == 1:
            return attn_ops.flash_forward(q, k, v, is_valid, segment_ids)[0]
        if q.device.type == "cuda":
            return peer_ring(mesh, axis, q).launch(q, k, v, is_valid, segment_ids)
        if q.device.type != "cpu":
            raise ValueError(f"ring: no path for device {q.device}")
        # on the CPU the plain version: the lax ring, its hops through torch.distributed
        impl = "lax"
    valid_all = comm.all_gather(is_valid.to(torch.int32).contiguous(), mesh, axis, 1, "sp")
    seg_all = comm.all_gather(segment_ids.to(torch.int32).contiguous(), mesh, axis, 1, "sp")
    if impl == "flash":
        return RingFlashAttention.apply(q, k, v, valid_all, seg_all, n, mesh, axis)
    if impl == "lax":
        return _lax_ring([q], [k], [v], _ProcessRing(mesh, axis, valid_all, seg_all, lloc))[0]
    if impl in ("ulysses", "ulysses-flash"):
        if H % n:
            raise ValueError(f"ulysses attention shards heads over {axis!r}: {H} local heads "
                             f"not divisible by {axis}={n}; use impl='lax' (ring)")
        qh, kh, vh = (_seq_to_heads(t, mesh, axis) for t in (q, k, v))
        if impl == "ulysses-flash":
            out = attn_ops.flash_attention(qh, kh, vh, valid_all, seg_all)
        else:
            out = attn_ops.xla_attention(qh, kh, vh, attn_ops.make_attention_bias(
                is_valid=valid_all, segment_ids=seg_all, dtype=torch.float32))
        return _heads_to_seq(out.to(q.dtype), mesh, axis)
    raise ValueError(f"unknown sequence-parallel impl {impl!r}")


# ---------------------------------------------------------------------------
# the ring in one kernel
# ---------------------------------------------------------------------------


def ring_flash_attention_rdma(q, k, v, is_valid, segment_ids, n: int):
    """The whole ring forward as one kernel (``_rdma_ring_kernel``'s
    function) over global [B, L, H, D] inputs split over n ranks.

    n = 1 is the flash forward, as in the JAX package. Otherwise a CUDA
    tensor launches ``csrc/ring_fwd.cu`` (or raises) and a CPU tensor runs
    the plain ring. Forward only.
    """
    if attn_ops._records_grad(q, k, v):
        raise NotImplementedError(f"ring:rdma is forward-only, as in the JAX package; "
                                  f"{_TRAINING_ITEM}")
    is_valid, segment_ids = is_valid.to(torch.int32), segment_ids.to(torch.int32)
    if n == 1:
        return attn_ops.flash_forward(q, k, v, is_valid, segment_ids)[0]
    if q.device.type == "cuda":
        return ring_fwd(q, k, v, is_valid, segment_ids, n)
    if q.device.type == "cpu":
        return ring_attention_reference(q, k, v, is_valid, segment_ids, n)
    raise ValueError(f"ring: no path for device {q.device}")


class _RingParams(ctypes.Structure):
    """Field for field the ``RingParams`` struct of csrc/ring_fwd.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("is_valid", ctypes.c_void_p), ("segment_ids", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("k_slots", ctypes.c_void_p), ("v_slots", ctypes.c_void_p),
        ("lab_slots", ctypes.c_void_p), ("flags", ctypes.c_void_p),
        ("right_k_slots", ctypes.c_void_p), ("right_v_slots", ctypes.c_void_p),
        ("right_lab_slots", ctypes.c_void_p), ("right_flags", ctypes.c_void_p),
        ("left_flags", ctypes.c_void_p),
        ("q_strides", ctypes.c_int64 * 3), ("k_strides", ctypes.c_int64 * 3),
        ("v_strides", ctypes.c_int64 * 3),
        ("batch", ctypes.c_int32), ("seq_len", ctypes.c_int32), ("heads", ctypes.c_int32),
        ("n_ranks", ctypes.c_int32), ("grid", ctypes.c_int32), ("rank", ctypes.c_int32),
        ("epoch", ctypes.c_uint32), ("peer_store", ctypes.c_int32), ("scale", ctypes.c_float),
        ("timeout_ns", ctypes.c_int64),
    ]


@functools.lru_cache(maxsize=None)
def _ring_lib() -> ctypes.CDLL:
    lib = attn_ops._load_lib("ring_fwd", _RingParams, ("ring_fwd_bf16", "ring_fwd_f32"))
    signatures = {
        "ring_fwd_launch_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int32)],
        "ring_ipc_alloc": [ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p],
        "ring_ipc_open": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)],
        "ring_ipc_close": [ctypes.c_void_p],
        "ring_ipc_free": [ctypes.c_void_p],
        "ring_ipc_pingpong": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    }
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.ring_ipc_handle_size.argtypes = []
    lib.ring_ipc_handle_size.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _launch_info(device: torch.device, f32: bool):
    """(most blocks resident at once, query rows of a q-group) of the ring
    kernel on ``device``; the kernel's C side asks the occupancy calculator
    with its dynamic shared memory."""
    max_blocks, group_rows = ctypes.c_int32(), ctypes.c_int32()
    with torch.cuda.device(device):
        err = _ring_lib().ring_fwd_launch_info(int(f32), ctypes.byref(max_blocks),
                                               ctypes.byref(group_rows))
    if err != 0:
        raise RuntimeError(f"ring_fwd: occupancy query failed with cudaError_t {err}")
    return max_blocks.value, group_rows.value


def ring_grid(max_blocks: int, n: int, lloc: int, members: int, group_rows: int = 128) -> int:
    """Blocks to launch for ``members`` = n * B * H ring members of ``lloc``
    query rows each, the n ranks in this launch (1 for a process's rank).
    The unit is a q-group (``group_rows`` rows of one member, for the whole
    walk), so a ring is n * ceil(lloc / group_rows) blocks: all units if
    they fit at once, else the most whole rings that do (0 if not one
    does)."""
    groups = -(-lloc // group_rows)
    per_ring = n * groups
    return min(members * groups, (max_blocks // per_ring) * per_ring)


def _slot_layout(B, H, lloc, ranks, dtype):
    """Byte offsets of the K slots, V slots, label slots and flags of
    ``ranks`` ring ranks in one buffer, and its size; each part starts on
    1024 bytes. Shapes as ``RingParams`` gives them."""
    members = B * H
    kv = ranks * 2 * members * lloc * 64 * torch.tensor([], dtype=dtype).element_size()
    parts = (kv, kv, ranks * 2 * members * 2 * lloc * 4,
             ranks * members * 2 * (1 + -(-lloc // RING_KEY_TILE)) * 4)
    offsets, at = [], 0
    for nbytes in parts:
        offsets.append(at)
        at += -(-nbytes // 1024) * 1024
    return offsets, at


def _check_grid(lloc, B, H, max_blocks, group_rows, ranks):
    """``ring_grid`` for ``ranks`` ranks of B * H members each, which must
    hold at least one ring."""
    grid = ring_grid(max_blocks, ranks, lloc, ranks * B * H, group_rows)
    if grid == 0:
        raise RuntimeError(f"ring_fwd: {max_blocks} resident blocks cannot hold a ring of "
                           f"{ranks} x {-(-lloc // group_rows)} q-groups")
    return grid


def ring_fwd(q, k, v, is_valid, segment_ids, n: int):
    """Launch csrc/ring_fwd.cu on PyTorch's current stream: the ring of n
    virtual ranks over [B, L, H, 64] q, k, v (strided views allowed) and
    [B, L] labels -> out [B, L, H, 64] in q's dtype.

    Allocates the ranks' K/V and label slots and the flags (zeroed here, on
    the stream, before every launch). The online softmax stays in the
    kernel's registers.
    """
    named = (("q", q), ("k", k), ("v", v))
    is_valid, segment_ids = attn_ops._check_operands(named, is_valid, segment_ids)
    B, L, H, D = q.shape
    if n < 2:
        raise ValueError(f"ring_fwd: needs n >= 2 ranks, got {n}")
    if L % n:
        raise ValueError(f"ring_fwd: L={L} not divisible by n={n}")
    if n > 65535:
        raise ValueError(f"ring_fwd: n must be <= 65535, got {n}")
    f32 = q.dtype == torch.float32
    lloc = L // n
    grid = _check_grid(lloc, B, H, *_launch_info(q.device, f32), ranks=n)
    dev = q.device
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=dev)
    offsets, size = _slot_layout(B, H, lloc, n, q.dtype)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    k_slots, v_slots, lab_slots, flags = (buf.data_ptr() + o for o in offsets)
    buf[offsets[3]:].zero_()  # the flags
    params = _RingParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), is_valid.data_ptr(), segment_ids.data_ptr(),
        out.data_ptr(), k_slots, v_slots, lab_slots, flags, k_slots, v_slots, lab_slots, flags,
        flags, attn_ops._strides(q), attn_ops._strides(k), attn_ops._strides(v),
        B, L, H, n, grid, -1, 0, 0, 1.0 / math.sqrt(D), RING_TIMEOUT_NS)
    lib = _ring_lib()
    attn_ops._launch(lib.ring_fwd_f32 if f32 else lib.ring_fwd_bf16, params, dev, "ring_fwd")
    return out


# ---------------------------------------------------------------------------
# the ring kernel across processes
# ---------------------------------------------------------------------------


class PeerRing:
    """This process's rank of the ring kernel across the processes of one
    line of a process mesh axis, for one shape: [B, Lloc, H, 64] shards of
    ``dtype`` on ``device``.

    At construction it allocates its slots and flags in one buffer
    (``csrc/ring_fwd.cu`` ``ring_ipc_alloc``: device memory outside
    PyTorch's allocator, zeroed), gathers every rank's IPC handle and grid
    over the axis's process group, opens the right and left
    neighbours' buffers (``cudaIpcOpenMemHandle``, which enables peer
    access where a neighbour's card is another) and waits at a barrier. A
    handle that will not open, or ranks that would launch different grids,
    raise. ``launch`` runs the
    kernel's mode across processes on this rank's shard; its flags count
    up across launches (``epoch``), so nothing is zeroed between calls and
    the host never waits on the neighbours. ``close`` (at
    ``parallel.distributed.shutdown``) unmaps and frees after barriers.

    ``route``: how the copies to the right neighbour went at the last bf16
    launch, "tma" (TMA stores through a tensor map over its slots) or
    "stores" (16-byte stores by the producer warp's lanes, when asked for
    by setting ``peer_store`` before a launch, or when the driver refuses
    the map); the f32 kernel always stores. A stand-in rank
    (``parallel.distributed.initialize_standin``) is refused: its slots
    need real peers.
    """

    def __init__(self, mesh: Mesh, axis: str, B: int, H: int, lloc: int, dtype, device):
        import torch.distributed as dist

        from merlot_reserve_tpu_torch.parallel import distributed

        distributed.refuse_standin("PeerRing (its CUDA IPC slots need real peers)")
        self.n, self.rank = mesh.size(axis), mesh.axis_index(axis)
        self.group = mesh.group(axis)
        self.shape, self.dtype, self.device = (B, H, lloc), dtype, torch.device(device)
        self.epoch, self.peer_store, self.route = 0, False, None
        lib = _ring_lib()
        self._lib = lib
        f32 = dtype == torch.float32
        self.grid = _check_grid(lloc, B, H, *_launch_info(self.device, f32), ranks=1)
        self.offsets, size = _slot_layout(B, H, lloc, 1, dtype)
        own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(lib.ring_ipc_handle_size())
        with torch.cuda.device(self.device):
            err = lib.ring_ipc_alloc(size, ctypes.byref(own), handle)
        if err != 0:
            raise RuntimeError(f"ring across processes: cudaMalloc or cudaIpcGetMemHandle of "
                               f"{size} bytes failed with cudaError_t {err}")
        self.own, self.peers = own.value, {}
        everyone = [None] * self.n
        dist.all_gather_object(everyone, {"handle": handle.raw, "grid": self.grid},
                               group=self.group)
        grids = {e["grid"] for e in everyone}
        if len(grids) != 1:
            raise RuntimeError(f"ring across processes: the ranks would launch grids {grids}; "
                               "every rank of a ring must launch the same")
        for j in ((self.rank + 1) % self.n, (self.rank - 1) % self.n):
            if j in self.peers:
                continue
            ptr = ctypes.c_void_p()
            with torch.cuda.device(self.device):
                err = lib.ring_ipc_open(ctypes.create_string_buffer(everyone[j]["handle"],
                                                                    len(handle.raw)),
                                        ctypes.byref(ptr))
            if err != 0:
                raise RuntimeError(f"ring across processes: rank {self.rank} could not open rank "
                                   f"{j}'s buffer (cudaIpcOpenMemHandle: cudaError_t {err})")
            self.peers[j] = ptr.value
        dist.barrier(group=self.group)

    def _parts(self, base):
        return [base + o for o in self.offsets]

    def launch(self, q, k, v, is_valid, segment_ids):
        """The kernel on this rank's [B, Lloc, H, 64] q, k, v (strided views
        allowed) and int32 [B, Lloc] labels -> out [B, Lloc, H, 64] in q's
        dtype, on PyTorch's current stream. Every rank of the ring launches
        the same sequence of calls."""
        named = (("q", q), ("k", k), ("v", v))
        is_valid, segment_ids = attn_ops._check_operands(named, is_valid, segment_ids)
        B, lloc, H, D = q.shape
        if (B, H, lloc) != self.shape or q.dtype != self.dtype or q.device != self.device:
            raise ValueError(f"ring across processes: a shard [{B}, {lloc}, {H}] {q.dtype} on "
                             f"{q.device} for a ring of {self.shape} {self.dtype} on "
                             f"{self.device}")
        out = torch.empty((B, lloc, H, D), dtype=q.dtype, device=q.device)
        own = self._parts(self.own)
        right = self._parts(self.peers[(self.rank + 1) % self.n])
        left = self._parts(self.peers[(self.rank - 1) % self.n])
        params = _RingParams(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), is_valid.data_ptr(),
            segment_ids.data_ptr(), out.data_ptr(), *own, *right, left[3],
            attn_ops._strides(q), attn_ops._strides(k), attn_ops._strides(v),
            B, self.n * lloc, H, self.n, self.grid, self.rank, self.epoch & 0xFFFFFFFF,
            int(self.peer_store), 1.0 / math.sqrt(D), RING_TIMEOUT_NS)
        f32 = q.dtype == torch.float32
        lib = self._lib
        attn_ops._launch(lib.ring_fwd_f32 if f32 else lib.ring_fwd_bf16, params, q.device,
                         "ring_fwd_procs")
        self.epoch += 1
        self.route = "stores" if f32 or params.peer_store else "tma"
        return out

    def close(self):
        """Unmap the neighbours' buffers and free this one, once every rank's
        kernels have ended (a barrier before each)."""
        import torch.distributed as dist

        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            for ptr in self.peers.values():
                self._lib.ring_ipc_close(ptr)
        self.peers = {}
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            self._lib.ring_ipc_free(self.own)
        self.own = None


_PEER_RINGS = {}


def peer_ring(mesh: Mesh, axis: str, q) -> PeerRing:
    """The ``PeerRing`` of this rank for ``q``'s [B, Lloc, H, 64] shards on
    ``axis`` of ``mesh``, made at first use (collectively: every rank of the
    axis calls this with the same shape) and kept until
    ``parallel.distributed.shutdown``."""
    from merlot_reserve_tpu_torch.parallel import distributed

    B, lloc, H, _ = q.shape
    key = (tuple(mesh.group_ranks(axis)), B, H, lloc, q.dtype, q.device)
    if key not in _PEER_RINGS:
        if not _PEER_RINGS:
            distributed.at_shutdown(close_peer_rings)
        _PEER_RINGS[key] = PeerRing(mesh, axis, B, H, lloc, q.dtype, q.device)
    return _PEER_RINGS[key]


def close_peer_rings():
    """Close every ``PeerRing`` of this process, in the order they were made."""
    for ring in _PEER_RINGS.values():
        ring.close()
    _PEER_RINGS.clear()
