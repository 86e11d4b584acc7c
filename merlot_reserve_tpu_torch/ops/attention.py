"""Attention with per-position label masking.

Every mask the model builds factors through two [B, L] label vectors:

    mask(i, j) = valid(i) & valid(j) & (segment_id(i) == segment_id(j))

(padding validity, and segment ids from video packing). The flash path
passes those labels to a kernel that rebuilds the mask per tile; the dense
path broadcasts them into an additive [B, 1, L, L] bias of 0 / -1e10.

``attention(...)`` is the single entry point; ``impl`` picks:
  * 'flash': label-masked flash attention. On a CUDA tensor the forward
    launches the hand-written kernel ``csrc/flash_fwd.cu`` and the backward
    ``csrc/flash_bwd.cu`` (in bf16 a preprocess pass, one fused wgmma pass
    for dq, dk and dv, and a dq convert pass); on a CPU tensor they run
    their plain PyTorch versions,
    ``flash_attention_reference`` and ``flash_attention_backward_reference``.
  * 'xla': dense attention (the JAX package's name for it is kept so that
    one config string means the same thing in both packages).
  * 'auto': flash for label-masked attention on a CUDA tensor, else dense.
  * 'ring[:lax|flash|rdma][:AXIS]' / 'ulysses[:xla|flash][:AXIS]':
    sequence-parallel attention over a mesh axis ('sp' by default) of the
    active mesh (``ops/ring_attention.py``); with no mesh, or an axis of
    size 1, the dense path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from merlot_reserve_tpu_torch import kernels
from merlot_reserve_tpu_torch.kernels import build

NEG_INF = -1e10
HEAD_DIM = 64  # the only head size the flash kernel is built for


def make_attention_bias(is_valid=None, segment_ids=None, attention_mask=None,
                        dtype=torch.float32):
    """Additive [B, 1, L, L] bias (0 where attended, -1e10 elsewhere) from
    per-position labels, or from a dense boolean ``attention_mask``."""
    if attention_mask is None:
        if is_valid is None and segment_ids is None:
            raise ValueError("need is_valid, segment_ids or attention_mask")
        if is_valid is not None:
            valid = is_valid.bool()
            attention_mask = valid[..., None, :] & valid[..., :, None]
        if segment_ids is not None:
            seg_eq = segment_ids[..., None, :] == segment_ids[..., :, None]
            attention_mask = seg_eq if attention_mask is None else attention_mask & seg_eq
    return torch.where(attention_mask[..., None, :, :], 0.0, NEG_INF).to(dtype)


def xla_attention(q, k, v, bias=None):
    """Dense attention over [B, L, heads, d] with the softmax in q.dtype.
    Returns [B, L, heads, d]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q * scale, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


# ---------------------------------------------------------------------------
# flash attention: plain versions, kernel wrappers, autograd
# ---------------------------------------------------------------------------


def _masked_scores(q, k, is_valid, segment_ids, k_is_valid=None, k_segment_ids=None):
    """f32 scores (q . k) / sqrt(d) [B, heads, L, L], -1e10 where masked.
    The keys' labels default to the queries'."""
    if k_is_valid is None:
        k_is_valid, k_segment_ids = is_valid, segment_ids
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    mask = (((is_valid > 0)[:, :, None] & (k_is_valid > 0)[:, None, :])
            & (segment_ids[:, :, None] == k_segment_ids[:, None, :]))
    return torch.where(mask[:, None], s, NEG_INF)


def flash_attention_reference(q, k, v, is_valid, segment_ids, k_is_valid=None,
                              k_segment_ids=None):
    """Plain PyTorch version of the flash forward kernel.

    :param q, k, v: [B, L, heads, d]
    :param is_valid: [B, L] bool/int; a position is valid where > 0
    :param segment_ids: [B, L] int; positions attend only within equal ids
    :param k_is_valid, k_segment_ids: the keys' own labels (a ring hop's K/V
        shard); default: the queries' (self-attention)
    :return: (out [B, L, heads, d] in q.dtype, lse [B, heads, L] f32)

    Computes in f32. Masked scores are -1e10, so a row that sees no key
    (a padding row) is the mean of V over all L keys, with lse = -1e10 + log L.
    """
    s = _masked_scores(q, k, is_valid, segment_ids, k_is_valid, k_segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(l)


def flash_attention_backward_reference(q, k, v, do, out, lse, is_valid, segment_ids,
                                       k_is_valid=None, k_segment_ids=None):
    """Plain PyTorch version of the flash backward kernels.

    :param do: [B, L, heads, d], the gradient of ``out``
    :param out, lse: the forward's outputs (``flash_attention_reference``)
    :param k_is_valid, k_segment_ids: the keys' own labels (a ring hop's
        shard, with out/lse merged over all shards); default the queries'
    :return: (dq, dk, dv) [B, L, heads, d] in the dtypes of q, k, v

    Computes in f32 what the kernels compute: p is recomputed as
    exp(s - lse) from the saved lse, so a row that saw no key (lse = -1e10
    in f32) gets p = 1 for every key, as in the JAX package's kernels.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.float()
    delta = torch.einsum("blhd,blhd->bhl", do, out.float())
    s = _masked_scores(q, k, is_valid, segment_ids, k_is_valid, k_segment_ids)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashParams(ctypes.Structure):
    """Field for field the ``FlashParams`` struct of csrc/flash_fwd.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("is_valid", ctypes.c_void_p), ("segment_ids", ctypes.c_void_p),
        ("k_is_valid", ctypes.c_void_p), ("k_segment_ids", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        ("q_strides", ctypes.c_int64 * 3), ("k_strides", ctypes.c_int64 * 3),
        ("v_strides", ctypes.c_int64 * 3),
        ("batch", ctypes.c_int32), ("seq_len", ctypes.c_int32),
        ("heads", ctypes.c_int32), ("scale", ctypes.c_float),
    ]


class _FlashBwdParams(ctypes.Structure):
    """Field for field the ``FlashBwdParams`` struct of csrc/flash_bwd.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("dout", ctypes.c_void_p), ("out", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        ("delta", ctypes.c_void_p), ("is_valid", ctypes.c_void_p),
        ("segment_ids", ctypes.c_void_p), ("k_is_valid", ctypes.c_void_p),
        ("k_segment_ids", ctypes.c_void_p), ("stats", ctypes.c_void_p),
        ("dq_acc", ctypes.c_void_p),
        ("dq", ctypes.c_void_p), ("dk", ctypes.c_void_p), ("dv", ctypes.c_void_p),
        ("q_strides", ctypes.c_int64 * 3), ("k_strides", ctypes.c_int64 * 3),
        ("v_strides", ctypes.c_int64 * 3), ("do_strides", ctypes.c_int64 * 3),
        ("batch", ctypes.c_int32), ("seq_len", ctypes.c_int32),
        ("heads", ctypes.c_int32), ("padded_len", ctypes.c_int32), ("scale", ctypes.c_float),
    ]


def _load_lib(name, params, launchers) -> ctypes.CDLL:
    lib = build.load(name)
    size = getattr(lib, f"{name}_params_size")
    size.argtypes = []
    size.restype = ctypes.c_size_t
    if size() != ctypes.sizeof(params):
        raise RuntimeError(f"csrc/{name}.cu's params struct does not match {params.__name__}")
    for launcher in launchers:
        fn = getattr(lib, launcher)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    return _load_lib("flash_fwd", _FlashParams, ("flash_fwd_bf16", "flash_fwd_f32"))


@functools.lru_cache(maxsize=None)
def _flash_bwd_lib() -> ctypes.CDLL:
    return _load_lib("flash_bwd", _FlashBwdParams,
                     ("flash_bwd_prep", "flash_bwd_bf16", "flash_bwd_convert",
                      "flash_bwd_dq_f32", "flash_bwd_dkv_f32"))


def _check_operands(named, is_valid, segment_ids):
    """Raise on what the kernels do not take; returns the int32 labels on
    the operands' device. ``named``: (name, [B, L, H, D] tensor) pairs."""
    (_, q), *_ = named
    if q.dim() != 4 or any(x.shape != q.shape for _, x in named):
        raise ValueError("flash: " + ", ".join(n for n, _ in named) + " must share one "
                         f"[B, L, H, D] shape, got {[tuple(x.shape) for _, x in named]}")
    B, L, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash: the kernel is built for head dim {HEAD_DIM}, got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(x.dtype != q.dtype for _, x in named):
        raise ValueError("flash: " + ", ".join(n for n, _ in named) + " must all be bf16 or "
                         f"all f32, got {[x.dtype for _, x in named]}")
    if any(x.device != q.device for _, x in named):
        raise ValueError("flash: the operands must be on one device")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash: batch and heads must be <= 65535, got {B}, {H}")
    # 16-byte vector loads: aligned base, unit head-dim stride, and every
    # other stride a whole number of 16-byte chunks
    chunk = 16 // q.element_size()
    for name, x in named:
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(s % chunk for s in x.stride()[:3]):
            raise ValueError(f"flash: {name} needs a unit last stride, a 16-byte aligned "
                             f"base and strides in multiples of {chunk}, got {x.stride()}")
    if tuple(is_valid.shape) != (B, L) or tuple(segment_ids.shape) != (B, L):
        raise ValueError(f"flash: labels must be [B, L] = {(B, L)}")
    return (is_valid.to(device=q.device, dtype=torch.int32).contiguous(),
            segment_ids.to(device=q.device, dtype=torch.int32).contiguous())


def _strides(x):
    return (ctypes.c_int64 * 3)(*x.stride()[:3])


def _launch(launcher, params, device, name):
    with torch.cuda.device(device):
        err = launcher(ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    kernels.LAUNCHES[name] += 1


def _flash_forward_cuda(q, k, v, is_valid, segment_ids, k_is_valid, k_segment_ids):
    """Launch csrc/flash_fwd.cu on PyTorch's current stream."""
    named = (("q", q), ("k", k), ("v", v))
    is_valid, segment_ids = _check_operands(named, is_valid, segment_ids)
    if k_is_valid is None:
        k_is_valid, k_segment_ids = is_valid, segment_ids
    else:
        k_is_valid, k_segment_ids = _check_operands(named, k_is_valid, k_segment_ids)
    B, L, H, D = q.shape
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    params = _FlashParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), is_valid.data_ptr(),
        segment_ids.data_ptr(), k_is_valid.data_ptr(), k_segment_ids.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        _strides(q), _strides(k), _strides(v), B, L, H, 1.0 / math.sqrt(D))
    lib = _flash_lib()
    _launch(lib.flash_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_fwd_f32,
            params, q.device, "flash_fwd")
    return out, lse


BWD_ROWS = 64  # the backward's query tile: stats and dq_acc are padded to a multiple
LOG2E = 1.4426950408889634


def _padded_len(L):
    return -(-L // BWD_ROWS) * BWD_ROWS


def _check_f32(name, x, shape):
    if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"flash: {name} must be contiguous f32 {shape}")


def _bwd_params(q, k, v, do, is_valid, segment_ids, k_is_valid=None, k_segment_ids=None,
                **tensors):
    """Checked ``_FlashBwdParams`` for one backward launch; ``tensors`` are
    the launch's other pointer fields by name. Returns the params and the
    int32 labels, which the caller keeps alive through the launch."""
    named = (("q", q), ("k", k), ("v", v), ("dout", do))
    is_valid, segment_ids = _check_operands(named, is_valid, segment_ids)
    if k_is_valid is None:
        k_is_valid, k_segment_ids = is_valid, segment_ids
    else:
        k_is_valid, k_segment_ids = _check_operands(named, k_is_valid, k_segment_ids)
    B, L, H, D = q.shape
    params = _FlashBwdParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), dout=do.data_ptr(),
        is_valid=is_valid.data_ptr(), segment_ids=segment_ids.data_ptr(),
        k_is_valid=k_is_valid.data_ptr(), k_segment_ids=k_segment_ids.data_ptr(),
        q_strides=_strides(q), k_strides=_strides(k), v_strides=_strides(v),
        do_strides=_strides(do), batch=B, seq_len=L, heads=H, padded_len=_padded_len(L),
        scale=1.0 / math.sqrt(D))
    for name, x in tensors.items():
        setattr(params, name, x.data_ptr())
    return params, (is_valid, segment_ids, k_is_valid, k_segment_ids)


def _check_bf16(q):
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash: this backward pass is bf16 only, got {q.dtype}")


def flash_bwd_prep(q, k, v, do, out, lse, is_valid, segment_ids):
    """Launch csrc/flash_bwd.cu's preprocess pass (bf16): returns (stats,
    dq_acc). stats [B, H, Lpad, 4] f32 holds per query row lse * log2(e),
    delta = rowsum(dO * out) and the row's valid flag and segment id (as
    int32 bits); dq_acc [B, H, Lpad, 64] f32 comes back zeroed. Lpad is L
    rounded up to ``BWD_ROWS``.

    :param out: contiguous [B, L, H, 64], the forward's output
    :param lse: contiguous f32 [B, H, L]
    """
    _check_bf16(q)
    B, L, H, D = q.shape
    if out.shape != q.shape or out.dtype != q.dtype or not out.is_contiguous():
        raise ValueError(f"flash: out must be contiguous {q.dtype} {tuple(q.shape)}")
    _check_f32("lse", lse, (B, H, L))
    Lp = _padded_len(L)
    stats = torch.empty((B, H, Lp, 4), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((B, H, Lp, D), dtype=torch.float32, device=q.device)
    params, _keep = _bwd_params(q, k, v, do, is_valid, segment_ids, out=out, lse=lse,
                                stats=stats, dq_acc=dq_acc)
    _launch(_flash_bwd_lib().flash_bwd_prep, params, q.device, "flash_bwd_prep")
    return stats, dq_acc


def flash_bwd_prep_reference(do, out, lse, is_valid, segment_ids):
    """Plain PyTorch version of ``flash_bwd_prep``: (stats, zeroed dq_acc);
    rows past L have lse * log2(e) = +inf, delta 0 and labels 0."""
    B, L, H, D = do.shape
    Lp = _padded_len(L)
    stats = torch.zeros((B, H, Lp, 4), dtype=torch.float32, device=do.device)
    stats[..., 0] = math.inf
    stats[:, :, :L, 0] = lse.float() * LOG2E
    stats[:, :, :L, 1] = torch.einsum("blhd,blhd->bhl", do.float(), out.float())
    labels = torch.stack([(is_valid > 0).to(torch.int32), segment_ids.to(torch.int32)], -1)
    stats.view(torch.int32)[:, :, :L, 2:] = labels[:, None]
    return stats, torch.zeros((B, H, Lp, D), dtype=torch.float32, device=do.device)


def flash_bwd_convert_reference(q, dq_acc):
    """Plain PyTorch version of ``flash_bwd_convert``: scale * dq_acc as
    [B, L, H, D] in q's dtype. Each 64-row tile of dq_acc is in the fused
    pass's fragment order: float4 (4j + w) 32 + lane holds row
    16w + lane // 4 (and that + 8), columns 8j + 2 (lane % 4) + {0, 1}."""
    B, H, Lp, D = dq_acc.shape
    tiles = dq_acc.reshape(B, H, Lp // BWD_ROWS, 8, 4, 8, 4, 2, 2)  # j, w, g, t, i, c
    rows = tiles.permute(0, 1, 2, 4, 7, 5, 3, 6, 8).reshape(B, H, Lp, D)  # (w, i, g), (j, t, c)
    L = q.shape[1]
    return (rows[:, :, :L] * (1.0 / math.sqrt(D))).to(q.dtype).transpose(1, 2)


def flash_bwd_fused(q, k, v, do, stats, dq_acc, is_valid, segment_ids, k_is_valid=None,
                    k_segment_ids=None):
    """Launch csrc/flash_bwd.cu's fused pass (bf16): returns (dk, dv)
    [B, L, H, D] and adds dq / scale into ``dq_acc``. ``stats`` and
    ``dq_acc`` come from ``flash_bwd_prep``; the keys' labels default to the
    queries'. Its plain version is ``flash_attention_backward_reference``."""
    _check_bf16(q)
    B, L, H, D = q.shape
    _check_f32("stats", stats, (B, H, _padded_len(L), 4))
    _check_f32("dq_acc", dq_acc, (B, H, _padded_len(L), D))
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    params, _keep = _bwd_params(q, k, v, do, is_valid, segment_ids, k_is_valid, k_segment_ids,
                                stats=stats, dq_acc=dq_acc, dk=dk, dv=dv)
    _launch(_flash_bwd_lib().flash_bwd_bf16, params, q.device, "flash_bwd")
    return dk, dv


def flash_bwd_convert(q, k, v, do, dq_acc, is_valid, segment_ids):
    """Launch csrc/flash_bwd.cu's convert pass (bf16): dq = scale * dq_acc
    as [B, L, H, D] in q's dtype."""
    _check_bf16(q)
    B, L, H, D = q.shape
    _check_f32("dq_acc", dq_acc, (B, H, _padded_len(L), D))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    params, _keep = _bwd_params(q, k, v, do, is_valid, segment_ids, dq_acc=dq_acc, dq=dq)
    _launch(_flash_bwd_lib().flash_bwd_convert, params, q.device, "flash_bwd_convert")
    return dq


def _flash_backward_f32(q, k, v, do, out, lse, is_valid, segment_ids, k_is_valid,
                        k_segment_ids):
    """The f32 check path: delta as one plain op, then the scalar f32 dq and
    dk/dv kernels of csrc/flash_bwd.cu."""
    B, L, H, D = q.shape
    _check_f32("lse", lse, (B, H, L))
    delta = torch.einsum("blhd,blhd->bhl", do.float(), out.float()).contiguous()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    params, _keep = _bwd_params(q, k, v, do, is_valid, segment_ids, k_is_valid, k_segment_ids,
                                lse=lse, delta=delta, dq=dq, dk=dk, dv=dv)
    lib = _flash_bwd_lib()
    _launch(lib.flash_bwd_dq_f32, params, q.device, "flash_bwd_dq_f32")
    _launch(lib.flash_bwd_dkv_f32, params, q.device, "flash_bwd_dkv_f32")
    return dq, dk, dv


def _records_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_forward(q, k, v, is_valid, segment_ids, k_is_valid=None, k_segment_ids=None):
    """Label-masked flash forward -> (out [B, L, heads, d], lse [B, heads, L]).

    ``k_is_valid`` / ``k_segment_ids`` give the keys labels of their own
    (both or neither; default the queries'), as a ring hop needs.
    The grad-free launcher: a CUDA tensor launches the kernel (or raises); a
    CPU tensor runs the plain version. Raises when it would have to record a
    gradient: ``flash_attention`` is the differentiable entry.
    """
    if _records_grad(q, k, v):
        raise RuntimeError("flash_forward is the grad-free launcher and records no "
                           "gradient: call flash_attention for a differentiable one")
    if (k_is_valid is None) != (k_segment_ids is None):
        raise ValueError("flash: give both k_is_valid and k_segment_ids, or neither")
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, is_valid, segment_ids, k_is_valid, k_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, is_valid, segment_ids, k_is_valid,
                                         k_segment_ids)
    raise ValueError(f"flash: no path for device {q.device}")


def flash_backward(q, k, v, do, out, lse, is_valid, segment_ids, k_is_valid=None,
                   k_segment_ids=None):
    """Flash backward -> (dq, dk, dv) [B, L, heads, d].

    ``k_is_valid`` / ``k_segment_ids`` give the keys labels of their own
    (both or neither; default the queries'). A bf16 CUDA tensor launches
    ``flash_bwd_prep``, ``flash_bwd_fused`` and ``flash_bwd_convert``; an
    f32 one the scalar f32 kernels (delta as one plain op); either raises
    rather than fall back. A CPU tensor runs
    ``flash_attention_backward_reference``.
    """
    if (k_is_valid is None) != (k_segment_ids is None):
        raise ValueError("flash: give both k_is_valid and k_segment_ids, or neither")
    if q.device.type == "cuda":
        do = do.contiguous()
        lse = lse.float().contiguous()
        if q.dtype != torch.bfloat16:
            return _flash_backward_f32(q, k, v, do, out, lse, is_valid, segment_ids,
                                       k_is_valid, k_segment_ids)
        stats, dq_acc = flash_bwd_prep(q, k, v, do, out.contiguous(), lse, is_valid,
                                       segment_ids)
        dk, dv = flash_bwd_fused(q, k, v, do, stats, dq_acc, is_valid, segment_ids,
                                 k_is_valid, k_segment_ids)
        return flash_bwd_convert(q, k, v, do, dq_acc, is_valid, segment_ids), dk, dv
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, do, out, lse, is_valid, segment_ids,
                                                  k_is_valid, k_segment_ids)
    raise ValueError(f"flash: no path for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """The ``flash_attention`` custom_vjp of the JAX package: the forward
    saves (q, k, v, out, lse, labels); the backward recomputes the
    probabilities tile by tile from lse (``flash_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, is_valid, segment_ids):
        out, lse = flash_forward(q.detach(), k.detach(), v.detach(), is_valid, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, is_valid, segment_ids)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, is_valid, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, dout, out, lse, is_valid, segment_ids)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, is_valid, segment_ids):
    """Label-masked flash attention: [B, L, heads, d] in q.dtype.

    Differentiable through ``FlashAttention`` when an input requires grad;
    otherwise (serving) one forward launch and nothing saved.
    """
    if _records_grad(q, k, v):
        return FlashAttention.apply(q, k, v, is_valid, segment_ids)
    return flash_forward(q, k, v, is_valid, segment_ids)[0]


def resolve_impl(impl: str = "auto", *, has_bias: bool = False, has_labels: bool = False,
                 on_cuda: bool = False) -> str:
    """Resolve the 'auto' policy once (the encoder hoists the dense bias out
    of its layer loop with it). The JAX package's 'flash:BQ:BK' is 'flash':
    the CUDA kernels fix their own tiles. Other strings pass through."""
    if impl.startswith("flash:"):
        parts = impl.split(":")
        if len(parts) != 3 or not all(p.isdigit() for p in parts[1:]):
            raise ValueError(f"attention impl {impl!r}: want flash[:BQ:BK]")
        return "flash"
    if impl != "auto":
        return impl
    if has_bias or not has_labels:
        return "xla"
    return "flash" if on_cuda else "xla"


def attention(q, k, v, *, is_valid=None, segment_ids=None,
              bias: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Unified attention over [B, L, heads, d]. Labels (is_valid,
    segment_ids) feed either path; a dense ``bias`` forces the dense path."""
    has_labels = is_valid is not None or segment_ids is not None
    impl = resolve_impl(impl, has_bias=bias is not None, has_labels=has_labels,
                        on_cuda=q.is_cuda)
    if impl.startswith(("ring", "ulysses")):
        if bias is not None:
            raise ValueError("sequence-parallel attention consumes per-position labels, "
                             "not a dense bias: pass is_valid/segment_ids or use impl='xla'")
        from merlot_reserve_tpu_torch.ops.ring_attention import (
            parse_sequence_parallel_impl, sequence_parallel_attention)
        from merlot_reserve_tpu_torch.parallel.mesh import current_mesh

        sub, axis = parse_sequence_parallel_impl(impl)
        mesh = current_mesh()
        if mesh is not None and axis not in mesh.shape:
            raise ValueError(f"impl {impl!r}: axis {axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        if mesh is not None and mesh.shape[axis] > 1:
            return sequence_parallel_attention(mesh, q, k, v, is_valid=is_valid,
                                               segment_ids=segment_ids, axis_name=axis,
                                               impl=sub)
        impl = "xla"  # no sequence axis to shard over
    if impl == "flash":
        if bias is not None:
            raise ValueError("flash attention consumes per-position labels, not a "
                             "dense bias: pass is_valid/segment_ids or use impl='xla'")
        if q.shape[-3] != k.shape[-3]:
            raise ValueError(f"flash self-attention requires Lq == Lk, got "
                             f"{q.shape[-3]} vs {k.shape[-3]}: use impl='xla'")
        B, L = q.shape[0], q.shape[-3]
        if is_valid is None:
            is_valid = torch.ones((B, L), dtype=torch.int32, device=q.device)
        if segment_ids is None:
            segment_ids = torch.zeros((B, L), dtype=torch.int32, device=q.device)
        return flash_attention(q, k, v, is_valid, segment_ids)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}; want 'auto', 'flash[:BQ:BK]', 'xla', "
                         "'ring[:lax|flash|rdma][:AXIS]' or 'ulysses[:xla|flash][:AXIS]'")
    if bias is None and has_labels:
        bias = make_attention_bias(is_valid=is_valid, segment_ids=segment_ids)
    return xla_attention(q, k, v, bias=bias)
