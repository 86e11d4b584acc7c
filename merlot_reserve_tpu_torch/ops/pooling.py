"""Scatter-pooling and normalization helpers for the contrastive heads."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def one_hot_pool(do_pool, idx, v, num_segments: int,
                 real_bsize: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Sum-pool rows of ``v`` [B, L, H] into ``num_segments`` slots keyed by
    ``idx`` [B, L], only where ``do_pool`` [B, L].

    :param real_bsize: if given, first reshape (B, L) -> (real_bsize, B*L/real_bsize)
                       so slots pool across the stream's sub-batches.
    :return: {'x': [B', num_segments, H], 'idx_oh': [B', L', num_segments]}
    """
    B, L, H = v.shape
    if do_pool.shape != (B, L) or idx.shape != (B, L):
        raise ValueError(f"do_pool and idx must be [B, L] = {(B, L)}")
    if real_bsize is not None:
        l2 = (L * B) // real_bsize
        do_pool = do_pool.reshape(real_bsize, l2)
        idx = idx.reshape(real_bsize, l2)
        v = v.reshape(real_bsize, l2, H)
    pointer = torch.where(do_pool, idx, -1)
    slots = torch.arange(num_segments, device=v.device)
    pointer_oh = (pointer[..., None] == slots).to(v.dtype)
    pooled = torch.einsum("bls,blh->bsh", pointer_oh, v)
    return {"x": pooled, "idx_oh": pointer_oh}


def unit_normalize(x):
    """L2-normalize the last dim in f32 (+1e-5 under the sqrt), cast back."""
    x_f32 = x.float()
    x_norm = x_f32 / torch.sqrt(torch.square(x_f32).sum(-1, keepdim=True) + 1e-5)
    return x_norm.to(x.dtype)
