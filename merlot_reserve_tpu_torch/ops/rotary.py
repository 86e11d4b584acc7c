"""Multimodal rotary position embeddings.

Position is up to four normalized coordinate axes, (h, w, segment_idx/16,
token_idx/1024), expanded into sinusoids that rotate the first
``rotary_hsize`` dims of each head's query and key. Two details of the
reference are kept because the released checkpoints were trained with them:
the rotation pairs as [-x0, x1] instead of the standard [-x1, x0]
(``sign_quirk``), and slot 0 of the sinusoids (built as cos) multiplies the
rotated half, slot 1 (built as sin) the unrotated one.

Coordinates and sinusoids are built in the dtype they are asked for; the
model asks for its compute dtype, bf16 on the card, as the JAX model does.
"""

from __future__ import annotations

import math

import torch


def get_rotary_coordinates(seq_len: int, dtype=torch.float32, center_origin: bool = True,
                           device=None):
    """1-D coordinates: [-L//2 .. -1, 1 .. L-L//2] (skipping 0) when
    centered, else [1 .. L]."""
    if center_origin:
        neg_half = seq_len // 2
        neg = torch.arange(neg_half, dtype=dtype, device=device) - float(neg_half)
        pos = 1.0 + torch.arange(seq_len - neg_half, dtype=dtype, device=device)
        return torch.cat([neg, pos], 0)
    return 1.0 + torch.arange(seq_len, dtype=dtype, device=device)


def get_rotary_coordinates_2d(h: int, w: int, dtype=torch.float32, device=None):
    """[h*w, 2] centered coordinates, scaled as if cropped from a square box."""
    base_scale = 1.0 / (max(h, w) + 1.0)
    h_coords = base_scale * get_rotary_coordinates(h, dtype=dtype, device=device)
    w_coords = base_scale * get_rotary_coordinates(w, dtype=dtype, device=device)
    grid = torch.stack(torch.meshgrid(h_coords, w_coords, indexing="ij"), -1)
    return grid.reshape(h * w, 2)


def multimodal_rotary_coords(h=None, w=None, segment_idx=None, token_idx=None,
                             dtype=torch.float32, max_segment: float = 16.0,
                             max_token: float = 1024.0):
    """Stack the four axes into [*shape, 4], zero-filling absent ones and
    normalizing segment and token indices."""
    provided = [x for x in (h, w, segment_idx, token_idx) if x is not None]
    if not provided:
        raise ValueError("provide at least one coordinate tensor")
    shape = provided[0].shape
    if any(x.shape != shape for x in provided):
        raise ValueError("coordinate tensors must share one shape")
    zeros = torch.zeros(shape, dtype=dtype, device=provided[0].device)
    h_vec = zeros if h is None else h.to(dtype)
    w_vec = zeros if w is None else w.to(dtype)
    s_vec = zeros if segment_idx is None else segment_idx.to(dtype) / max_segment
    t_vec = zeros if token_idx is None else token_idx.to(dtype) / max_token
    return torch.stack([h_vec, w_vec, s_vec, t_vec], -1)


def construct_rotary_sinusoids(coords, rotary_hsize: int = 32, max_freq: float = 10.0,
                               dtype=None):
    """Expand [*batch, L, num_dims] coordinates into sinusoids
    [*batch, 2 (cos, sin), L, rotary_hsize]; the last dim repeats each
    frequency twice to line up with the rotation pairs. Frequencies are
    log-spaced over [1, max_freq / 2]."""
    *batch_dims, seq_len, num_dims = coords.shape
    if rotary_hsize % (num_dims * 2):
        raise ValueError(f"rotary_hsize {rotary_hsize} is not a multiple of 2 * {num_dims}")
    dim_expansion = rotary_hsize // (num_dims * 2)
    dtype = coords.dtype if dtype is None else dtype
    exponents = torch.linspace(0.0, math.log2(max_freq / 2.0), dim_expansion,
                               dtype=torch.float32, device=coords.device).to(dtype)
    freqs = torch.pow(2.0, exponents)
    radians = coords[..., None] * freqs * math.pi
    radians = radians.reshape(*batch_dims, seq_len, num_dims * dim_expansion)
    sinusoids = torch.stack([torch.cos(radians), torch.sin(radians)], -3)
    return torch.repeat_interleave(sinusoids, 2, dim=-1)


def apply_rotary(query_key, sinusoids, sign_quirk: bool = True):
    """Rotate the first ``rotary_hsize`` dims of [*batch, L, heads, d] by
    sinusoids [*sin_batch, 2, L, rotary_hsize]."""
    rotary_hsize = sinusoids.shape[-1]
    sin_batch = sinusoids.shape[:-3]
    batch_dims = query_key.shape[:-3]
    if rotary_hsize > query_key.shape[-1]:
        raise ValueError("rotary_hsize exceeds the head size")
    sinusoids = sinusoids.reshape((1,) * (len(batch_dims) - len(sin_batch)) + sinusoids.shape)
    sin = sinusoids[..., 0, :, None, :]
    cos = sinusoids[..., 1, :, None, :]

    qk_rope = query_key[..., :rotary_hsize]
    if sign_quirk:
        rotated = torch.stack([-qk_rope[..., ::2], qk_rope[..., 1::2]], -1)
    else:
        rotated = torch.stack([-qk_rope[..., 1::2], qk_rope[..., ::2]], -1)
    rotated = rotated.reshape(qk_rope.shape)
    qk_rope = qk_rope * cos + rotated * sin
    return torch.cat([qk_rope, query_key[..., rotary_hsize:]], -1)
