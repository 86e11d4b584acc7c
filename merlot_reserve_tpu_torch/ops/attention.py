"""Attention with per-position label masking.

Every mask the model builds factors through two [B, L] label vectors:

    mask(i, j) = valid(i) & valid(j) & (segment_id(i) == segment_id(j))

(padding validity, and segment ids from video packing). The flash path
passes those labels to a kernel that rebuilds the mask per tile; the dense
path broadcasts them into an additive [B, 1, L, L] bias of 0 / -1e10.

``attention(...)`` is the single entry point; ``impl`` picks:
  * 'flash': the label-masked flash forward. On a CUDA tensor it launches
    the hand-written kernel ``csrc/flash_fwd.cu``; on a CPU tensor it runs
    ``flash_attention_reference``, the kernel's plain PyTorch version.
    Forward only: there is no backward kernel yet.
  * 'xla': dense attention (the JAX package's name for it is kept so that
    one config string means the same thing in both packages).
  * 'auto': flash for label-masked attention on a CUDA tensor, else dense.
  * 'ring*' / 'ulysses*': sequence-parallel attention, not ported yet.
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
# flash forward: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def flash_attention_reference(q, k, v, is_valid, segment_ids):
    """Plain PyTorch version of the flash forward kernel.

    :param q, k, v: [B, L, heads, d]
    :param is_valid: [B, L] bool/int; a position is valid where > 0
    :param segment_ids: [B, L] int; positions attend only within equal ids
    :return: (out [B, L, heads, d] in q.dtype, lse [B, heads, L] f32)

    Computes in f32. Masked scores are -1e10, so a row that sees no key
    (a padding row) is the mean of V over all L keys, with lse = -1e10 + log L.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    valid = is_valid > 0
    mask = ((valid[:, :, None] & valid[:, None, :])
            & (segment_ids[:, :, None] == segment_ids[:, None, :]))
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(l)


class _FlashParams(ctypes.Structure):
    """Field for field the ``FlashParams`` struct of csrc/flash_fwd.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("is_valid", ctypes.c_void_p), ("segment_ids", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        ("q_strides", ctypes.c_int64 * 3), ("k_strides", ctypes.c_int64 * 3),
        ("v_strides", ctypes.c_int64 * 3),
        ("batch", ctypes.c_int32), ("seq_len", ctypes.c_int32),
        ("heads", ctypes.c_int32), ("scale", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    lib = build.load("flash_fwd")
    lib.flash_fwd_params_size.argtypes = []
    lib.flash_fwd_params_size.restype = ctypes.c_size_t
    if lib.flash_fwd_params_size() != ctypes.sizeof(_FlashParams):
        raise RuntimeError("csrc/flash_fwd.cu FlashParams does not match _FlashParams")
    for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _flash_forward_cuda(q, k, v, is_valid, segment_ids):
    """Launch csrc/flash_fwd.cu on PyTorch's current stream."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash: q, k, v must share one [B, L, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash: the kernel is built for head dim {HEAD_DIM}, got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash: q, k, v must all be bf16 or all f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash: q, k, v must be on one device")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash: batch and heads must be <= 65535, got {B}, {H}")
    # 16-byte vector loads: aligned base, unit head-dim stride, and every
    # other stride a whole number of 16-byte chunks
    chunk = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(s % chunk for s in x.stride()[:3]):
            raise ValueError(f"flash: {name} needs a unit last stride, a 16-byte aligned "
                             f"base and strides in multiples of {chunk}, got {x.stride()}")
    if tuple(is_valid.shape) != (B, L) or tuple(segment_ids.shape) != (B, L):
        raise ValueError(f"flash: labels must be [B, L] = {(B, L)}")
    is_valid = is_valid.to(device=q.device, dtype=torch.int32).contiguous()
    segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()

    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    params = _FlashParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), is_valid.data_ptr(),
        segment_ids.data_ptr(), out.data_ptr(), lse.data_ptr(),
        (ctypes.c_int64 * 3)(*q.stride()[:3]), (ctypes.c_int64 * 3)(*k.stride()[:3]),
        (ctypes.c_int64 * 3)(*v.stride()[:3]), B, L, H, 1.0 / math.sqrt(D))
    lib = _flash_lib()
    launch = lib.flash_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_fwd_f32
    with torch.cuda.device(q.device):
        err = launch(ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError_t {err}")
    kernels.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_forward(q, k, v, is_valid, segment_ids):
    """Label-masked flash forward -> (out [B, L, heads, d], lse [B, heads, L]).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version. Forward only: raises when an input requires grad.
    """
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash attention has no backward kernel yet: run under "
                           "torch.inference_mode() / torch.no_grad(), or use impl='xla'")
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, is_valid, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, is_valid, segment_ids)
    raise ValueError(f"flash: no path for device {q.device}")


def flash_attention(q, k, v, is_valid, segment_ids):
    """``flash_forward`` without the lse: [B, L, heads, d] in q.dtype."""
    return flash_forward(q, k, v, is_valid, segment_ids)[0]


def resolve_impl(impl: str = "auto", *, has_bias: bool = False, has_labels: bool = False,
                 on_cuda: bool = False) -> str:
    """Resolve the 'auto' policy once (the encoder hoists the dense bias out
    of its layer loop with it). Other strings pass through."""
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
        raise NotImplementedError(f"attention impl {impl!r}: sequence-parallel "
                                  "attention is not ported yet")
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
        raise ValueError(f"unknown attention impl {impl!r}; want 'auto', 'flash' or 'xla'")
    if bias is None and has_labels:
        bias = make_attention_bias(is_valid=is_valid, segment_ids=segment_ids)
    return xla_attention(q, k, v, bias=bias)
