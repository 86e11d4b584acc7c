"""Sequence-parallel exact attention: ring and Ulysses over a mesh axis.

The JAX package shards the sequence of global [B, L, H, D] inputs over a
mesh axis ('sp') under shard_map and exchanges K/V between the ranks with
collectives. The port runs the n ranks of the axis in one process, on the
tensors' device: a rank's shard is its slice of L rows, and a collective is
an operation on the list of shards (``ppermute`` to the right neighbour is
a rotation of the list, Ulysses' ``all_to_all`` a split by heads). Every
device of the mesh must be the tensors' device, so the ranks are virtual
ranks on one card (or on the CPU); meshes over several cards wait for a
launch across them.

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
    ring on a CPU tensor). Forward only, as in the JAX package.
  * 'ulysses' / 'ulysses-flash': the full sequence with H/n heads per rank,
    dense or flash, differentiable.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from merlot_reserve_tpu_torch.ops import attention as attn_ops
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


def ring_attention(qs, ks, vs, valids, segs):
    """The JAX package's lax ring over n local shards.

    :param qs, ks, vs: lists of n [B, Lloc, H, D] shards, rank r's at index r
    :param valids, segs: lists of n [B, Lloc] labels
    :return: list of n [B, Lloc, H, D] outputs in q's dtype

    At step s rank r merges the shard that started at rank (r - s) mod n into
    its online softmax (m, l, acc in f32), then every shard moves one rank
    to the right; n - 1 rotations and a merge-only last step.
    """
    n = len(qs)
    B, Lq, H, D = qs[0].shape
    scale = 1.0 / math.sqrt(D)
    q_valid = [x.to(torch.int32) for x in valids]
    q_seg = [x.to(torch.int32) for x in segs]
    dev = qs[0].device
    state = [(torch.zeros((B, H, Lq, D), dtype=torch.float32, device=dev),
              torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=dev),
              torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)) for _ in range(n)]
    resident = list(zip(ks, vs, q_valid, q_seg))

    def merge(r):
        acc, m_run, l_run = state[r]
        acc_b, m_b, l_b = _partial_attention(qs[r], *resident[r][:2], q_valid[r], q_seg[r],
                                             *resident[r][2:], scale)
        m_new = torch.maximum(m_run, m_b)
        c_run, c_b = torch.exp(m_run - m_new), torch.exp(m_b - m_new)
        state[r] = (acc * c_run[..., None] + acc_b * c_b[..., None], m_new,
                    l_run * c_run + l_b * c_b)

    for step in range(n):
        for r in range(n):
            merge(r)
        if step < n - 1:
            resident = resident[-1:] + resident[:-1]  # ppermute i -> i + 1
    outs = []
    for q, (acc, _, l) in zip(qs, state):
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l_safe[..., None]).transpose(1, 2).to(q.dtype))
    return outs


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


def _ring_flash_forward(qs, ks, vs, q_valid, q_seg):
    """The per-hop flash ring, forward (``_ring_flash_forward`` of the JAX
    package): at each hop rank r runs ``flash_forward`` of its queries
    against the visiting shard (with that shard's labels) and merges the
    hop's (out, lse) into its running pair by log-sum-exp.

    :param qs, ks, vs: lists of n [B, Lloc, H, D] shards, rank r's at index r
    :param q_valid, q_seg: lists of n int32 [B, Lloc] labels
    :return: (outs [B, Lloc, H, D] in q's dtype, merged lses [B, Lloc, H, 1]
        f32), one per rank
    """
    n = len(qs)
    B, Lq, H, D = qs[0].shape
    dev = qs[0].device
    out_run = [torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev) for _ in range(n)]
    # finite "-inf": exp(lse_run - lse_new) stays defined at the first merge
    lse_run = [torch.full((B, Lq, H, 1), -1e30, dtype=torch.float32, device=dev)
               for _ in range(n)]
    resident = list(zip(ks, vs, q_valid, q_seg))
    for step in range(n):
        for r in range(n):
            k, v, k_valid, k_seg = resident[r]
            out_t, lse_t = attn_ops.flash_forward(qs[r], k, v, q_valid[r], q_seg[r],
                                                  k_is_valid=k_valid, k_segment_ids=k_seg)
            lse_t = lse_t.transpose(1, 2)[..., None]  # [B, H, Lq] -> [B, Lq, H, 1]
            lse_new = torch.logaddexp(lse_run[r], lse_t)
            # out_t is promoted to f32 inside each product (no f32 copy of it)
            out_run[r] = (out_run[r] * torch.exp(lse_run[r] - lse_new)
                          + out_t * torch.exp(lse_t - lse_new))
            lse_run[r] = lse_new
        if step < n - 1:
            resident = resident[-1:] + resident[:-1]  # ppermute i -> i + 1
    return [o.to(q.dtype) for o, q in zip(out_run, qs)], lse_run


def _ring_flash_backward(qs, ks, vs, q_valid, q_seg, outs, lses, douts):
    """The backward ring (``_ring_flash_bwd`` of the JAX package): the K/V
    shards, their labels and their f32 dk/dv accumulators rotate past each
    rank's fixed (q, dO, out, lse), and at each hop rank r adds
    ``flash_backward`` of its queries against the visiting shard. The
    out/lse are the merged ones, so p = exp(s - lse) is the probability
    over the whole sequence and the hops' dq, dk, dv add up exactly. The
    accumulators rotate with their shard after every hop; the rotation
    after the last hop (the JAX package's final ppermute) brings them home.

    :param outs, douts: lists of n contiguous [B, Lloc, H, D], q's dtype
    :param lses: list of n f32 [B, Lloc, H, 1]
    :return: (dqs, dks, dvs) lists of n [B, Lloc, H, D] in q's dtype
    """
    n = len(qs)
    lse_rows = [lse[..., 0].transpose(1, 2).contiguous() for lse in lses]  # [B, H, Lloc]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    resident = [(k, v, val, seg, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                 torch.zeros(v.shape, dtype=torch.float32, device=v.device))
                for k, v, val, seg in zip(ks, vs, q_valid, q_seg)]
    for _ in range(n):
        for r in range(n):
            k, v, k_valid, k_seg, dk_acc, dv_acc = resident[r]
            dq_t, dk_t, dv_t = attn_ops.flash_backward(
                qs[r], k, v, douts[r], outs[r], lse_rows[r], q_valid[r], q_seg[r],
                k_is_valid=k_valid, k_segment_ids=k_seg)
            # f32 += q's dtype: promoted inside the add, no f32 copy
            dqs[r] += dq_t
            dk_acc += dk_t
            dv_acc += dv_t
        resident = resident[-1:] + resident[:-1]  # ppermute i -> i + 1
    dtype = qs[0].dtype
    return ([dq.to(dtype) for dq in dqs], [res[4].to(dtype) for res in resident],
            [res[5].to(dtype) for res in resident])


class RingFlashAttention(torch.autograd.Function):
    """The ``ring_flash_attention`` custom_vjp of the JAX package over the n
    ranks of one process: the forward saves (q, k, v, labels, out, merged
    lse); the backward walks the ring again (``_ring_flash_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, is_valid, segment_ids, n):
        outs, lses = _ring_flash_forward(*_ring_shards(q, k, v, is_valid, segment_ids, n))
        out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=1)
        ctx.n = n
        ctx.save_for_backward(q, k, v, is_valid, segment_ids, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        n = ctx.n
        q, k, v, is_valid, segment_ids, out, lse = ctx.saved_tensors
        qs, ks, vs, q_valid, q_seg = _ring_shards(q, k, v, is_valid, segment_ids, n)
        outs, douts = ([x.contiguous() for x in _shards(t.to(q.dtype), n)] for t in (out, dout))
        lses = _shards(lse, n)
        dqs, dks, dvs = _ring_flash_backward(qs, ks, vs, q_valid, q_seg, outs, lses, douts)
        return (torch.cat(dqs, dim=1), torch.cat(dks, dim=1), torch.cat(dvs, dim=1),
                None, None, None)


def ring_flash_attention(q, k, v, is_valid, segment_ids, n: int):
    """The per-hop flash ring over the n shards of global [B, L, H, D]
    inputs and int32 [B, L] labels -> [B, L, H, D] in q's dtype.
    Differentiable through ``RingFlashAttention`` when an input requires
    grad; otherwise the forward ring alone, nothing saved."""
    if attn_ops._records_grad(q, k, v):
        return RingFlashAttention.apply(q, k, v, is_valid, segment_ids, n)
    return torch.cat(_ring_flash_forward(*_ring_shards(q, k, v, is_valid, segment_ids, n))[0],
                     dim=1)


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
    split over ``axis_name``'s n ranks of ``mesh`` -> [B, L, H, D].

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
    if L % n:
        raise ValueError(f"L={L} not divisible by {axis_name}={n}")
    others = [d for d in mesh.distinct_devices() if d != q.device]
    if others:
        raise NotImplementedError(
            f"mesh devices {[str(d) for d in mesh.distinct_devices()]} for tensors on "
            f"{q.device}: every rank runs on the tensors' device here; a ring across "
            "several cards is not ported yet")
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
        ("q_strides", ctypes.c_int64 * 3), ("k_strides", ctypes.c_int64 * 3),
        ("v_strides", ctypes.c_int64 * 3),
        ("batch", ctypes.c_int32), ("seq_len", ctypes.c_int32), ("heads", ctypes.c_int32),
        ("n_ranks", ctypes.c_int32), ("grid", ctypes.c_int32), ("scale", ctypes.c_float),
        ("timeout_ns", ctypes.c_int64),
    ]


@functools.lru_cache(maxsize=None)
def _ring_lib() -> ctypes.CDLL:
    lib = attn_ops._load_lib("ring_fwd", _RingParams, ("ring_fwd_bf16", "ring_fwd_f32"))
    lib.ring_fwd_launch_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                                         ctypes.POINTER(ctypes.c_int32)]
    lib.ring_fwd_launch_info.restype = ctypes.c_int
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
    query rows each. The unit is a q-group (``group_rows`` rows of one
    member, for the whole walk), so a ring is n * ceil(lloc / group_rows)
    blocks: all units if they fit at once, else the most whole rings that
    do (0 if not one does)."""
    groups = -(-lloc // group_rows)
    per_ring = n * groups
    return min(members * groups, (max_blocks // per_ring) * per_ring)


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
    max_blocks, group_rows = _launch_info(q.device, f32)
    grid = ring_grid(max_blocks, n, lloc, n * B * H, group_rows)
    if grid == 0:
        raise RuntimeError(f"ring_fwd: {max_blocks} resident blocks cannot hold a ring of "
                           f"{n} x {-(-lloc // group_rows)} q-groups")
    dev = q.device
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=dev)
    k_slots = torch.empty((n, 2, B, H, lloc, D), dtype=q.dtype, device=dev)
    v_slots = torch.empty_like(k_slots)
    lab_slots = torch.empty((n, 2, B, H, 2, lloc), dtype=torch.int32, device=dev)
    # per member's slot: capacity, then the ready count of each 128-key tile
    flags = torch.zeros((n, B, H, 2, 1 + -(-lloc // RING_KEY_TILE)), dtype=torch.int32,
                        device=dev)
    params = _RingParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), is_valid.data_ptr(), segment_ids.data_ptr(),
        out.data_ptr(), k_slots.data_ptr(), v_slots.data_ptr(), lab_slots.data_ptr(),
        flags.data_ptr(),
        attn_ops._strides(q), attn_ops._strides(k), attn_ops._strides(v),
        B, L, H, n, grid, 1.0 / math.sqrt(D), RING_TIMEOUT_NS)
    lib = _ring_lib()
    attn_ops._launch(lib.ring_fwd_f32 if f32 else lib.ring_fwd_bf16, params, dev, "ring_fwd")
    return out
