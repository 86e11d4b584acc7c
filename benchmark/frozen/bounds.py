"""Frozen copies of the attention kernels' and the optimizer's bounds.

``_pair_counts``, ``_bound``, ``_fwd_bound`` and ``_bwd_bounds`` are
copied from ``chip_smoke.py`` at commit 3f8d0e0
(names without the leading underscore): operations and bytes from the
shapes and the labels a launch gets; a bound is the larger of operations
at the bf16 (or f32) peak and bytes at the memory's. ``ADAM_BYTES_PER_PARAM``
is the update's traffic as PERF.md states it: with bf16 moments each
parameter reads its f32 value and gradient and its two bf16 moments and
writes the three back (4 + 4 + 2 + 2 + 4 + 2 + 2 = 20 bytes; 28 with f32
moments).
"""

from __future__ import annotations

from .flops import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_F32_FLOPS

ADAM_BYTES_PER_PARAM = {"bf16": 20, "f32": 28}


def pair_counts(valid, seg):
    """(attended pairs, rows that see no key) for these labels."""
    v = valid > 0
    pairs = ((v[:, :, None] & v[:, None, :]) & (seg[:, :, None] == seg[:, None, :])).sum()
    return int(pairs), int((~v).sum())


def bound(ops, nbytes, dtype):
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fwd_bound(valid, seg, H, D, dtype, element_size):
    """Bound of the forward, from the products these labels need: q.k and
    p.v over the attended pairs, and for each row that sees no key the mean
    of V over all L keys. Bytes: q, k, v read and out written once, plus the
    labels and lse."""
    B, L = valid.shape
    pairs, blind = pair_counts(valid, seg)
    ops = 2 * D * H * (2 * pairs + L * blind)
    nbytes = 4 * B * L * H * D * element_size + 2 * B * L * 4 + B * H * L * 4
    bound_ms, bound_by = bound(ops, nbytes, dtype)
    return {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}


def bwd_bounds(valid, seg, H, D, dtype, element_size):
    """Bound of the backward as one function ("both": dq, dk and dv), from
    the five products q.k, dO.v, p.dO, ds.q and ds.k over the pairs with
    nonzero p: the attended pairs, plus all L keys of each row that sees no
    key (p = 1 there), except q.k, which those rows skip. Bytes: q, k, v, dO
    read and the gradients written once, plus lse, delta and the labels."""
    B, L = valid.shape
    pairs, blind = pair_counts(valid, seg)
    ops = 2 * D * H * (pairs + 4 * (pairs + L * blind))
    nbytes = 7 * B * L * H * D * element_size + 2 * B * H * L * 4 + 2 * B * L * 4
    bound_ms, bound_by = bound(ops, nbytes, dtype)
    return {"both": {"ops": ops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}}
