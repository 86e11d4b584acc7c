"""The span-masking engine as fixed-shape tensor programs, batched.

The port of ``merlot_reserve_tpu/ops/masking_device.py``. Every function
takes a leading example dimension B where the JAX package vmaps one
example: ragged (values, row_lengths) pairs are [B, L] values and [B, N]
lengths, and per-row reductions run over ``value_rowids``.

Randomness is not drawn here: each stochastic function takes its draws as
tensors (a coin, a Gumbel vector, segment scores) or a callable, which the
device builder gets from its sampler (``data/device_builder.BuilderDraws``),
so that a test can hand both packages the same numbers.

JAX's scatters with ``mode="drop"`` become writes into one dump row or
column past the end, cut off afterwards. Every sort is stable, as
``jnp.argsort`` is, and a stable compaction (valid entries first, in their
order) is computed by prefix sums, not by a sort. Integer outputs are
int32, as in JAX; indices are int64 inside.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch.data.masking import _WEIGHTS_V1, _WEIGHTS_V2
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, MASK, MASKAUDIO

_BIG = 1e4


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def compaction_order(valid: torch.Tensor) -> torch.Tensor:
    """[..., L] bool -> the stable order that puts valid entries first, each
    group in its original order: ``argsort(~valid, stable=True)``, by prefix
    sums."""
    v = valid.long()
    n_valid = v.sum(-1, keepdim=True)
    dest = torch.where(valid, v.cumsum(-1) - 1, n_valid + (1 - v).cumsum(-1) - 1)
    order = torch.empty_like(dest)
    order.scatter_(-1, dest, _arange(valid.shape[-1], valid).expand_as(dest).contiguous())
    return order


def value_rowids(row_lengths: torch.Tensor, total_length: int) -> torch.Tensor:
    """[B, N] row lengths -> [B, L] row ids; positions past the rows' total
    take the last row's id, as ``jnp.repeat(..., total_repeat_length=L)``."""
    n = row_lengths.shape[-1]
    ends = row_lengths.long().cumsum(-1)
    pos = _arange(total_length, row_lengths).expand(*row_lengths.shape[:-1], total_length)
    rid = torch.searchsorted(ends, pos.contiguous(), right=True)
    return rid.clamp(max=n - 1)


def shift_row_lengths(row_lengths, positions_onehot, right_to_left: bool = True):
    """Marked rows donate one boundary token to their neighbour (the row-length
    algebra of data/masking.shift_ragged_tokens_at_positions)."""
    amt = (positions_onehot & (row_lengths > 0)).to(row_lengths.dtype)
    zero = torch.zeros_like(amt[..., :1])
    if right_to_left:
        take = amt[..., 1:]
        sub1 = torch.cat([zero, -take], -1)
        add1 = torch.cat([take, zero], -1)
    else:
        take = amt[..., :-1]
        sub1 = torch.cat([-take, zero], -1)
        add1 = torch.cat([zero, take], -1)
    return row_lengths + sub1 + add1


def _reassign_one_dir(row_lengths, masked, right_to_left: bool):
    needs = masked & (row_lengths == 0)
    can_donate = (~masked) & (row_lengths >= 2)
    no = torch.zeros_like(masked[..., :1])
    if right_to_left:
        pos = torch.cat([no, can_donate[..., 1:] & needs[..., :-1]], -1)
        return shift_row_lengths(row_lengths, pos, right_to_left=True)
    pos = torch.cat([can_donate[..., :-1] & needs[..., 1:], no], -1)
    return shift_row_lengths(row_lengths, pos, right_to_left=False)


def reassign_empty_tokens(row_lengths, masked, coin):
    """Empty masked rows steal one token from an adjacent donor; ``coin``
    [B] uniform picks the direction order (the engine's coin flip)."""
    a = _reassign_one_dir(_reassign_one_dir(row_lengths, masked, True), masked, False)
    b = _reassign_one_dir(_reassign_one_dir(row_lengths, masked, False), masked, True)
    return torch.where((coin < 0.5)[..., None], a, b)


def _row_min_max(vals, row_lengths, total_length: int):
    """Per-row (min, max) of flat f32 ``vals`` [B, L] under the current
    lengths; empty rows give (+inf, -inf). Positions past the rows' total go
    to a discard bin."""
    n = row_lengths.shape[-1]
    rid = value_rowids(row_lengths, total_length)
    in_stream = _arange(total_length, vals) < row_lengths.sum(-1, keepdim=True)
    rid = torch.where(in_stream, rid, n)
    shape = (*row_lengths.shape[:-1], n + 1)
    inf = torch.full(shape, float("inf"), dtype=vals.dtype, device=vals.device)
    mins = inf.scatter_reduce(-1, rid, vals, "amin")[..., :n]
    maxs = (-inf).scatter_reduce(-1, rid, vals, "amax")[..., :n]
    empty = row_lengths == 0
    return mins.masked_fill(empty, float("inf")), maxs.masked_fill(empty, float("-inf"))


def _increase_one_dir(row_lengths, masked, tok_centroids, audio_start_end,
                      delta_thresh: float, right_to_left: bool):
    n = row_lengths.shape[-1]
    L = tok_centroids.shape[-1]
    mins, maxs = _row_min_max(tok_centroids.float(), row_lengths, L)
    no = torch.zeros_like(masked[..., :1])
    zl = torch.zeros_like(row_lengths[..., :1])
    idx = _arange(n, row_lengths)
    if right_to_left:
        t_next = torch.cat([mins[..., 1:], torch.full_like(mins[..., :1], float("inf"))], -1)
        len_next = torch.cat([row_lengths[..., 1:], zl], -1)
        t_next = torch.where(len_next <= 1, torch.full_like(t_next, _BIG), t_next)
        masked_next = torch.cat([masked[..., 1:], no], -1)
        take = masked & ((t_next - audio_start_end[..., 1]) < delta_thresh)
        take &= ~masked_next
        take &= idx + 1 < n
        pos = torch.cat([no, take[..., :-1]], -1)
        return shift_row_lengths(row_lengths, pos, right_to_left=True)
    t_prev = torch.cat([torch.full_like(maxs[..., :1], float("-inf")), maxs[..., :-1]], -1)
    len_prev = torch.cat([zl, row_lengths[..., :-1]], -1)
    t_prev = torch.where(len_prev <= 1, torch.full_like(t_prev, -_BIG), t_prev)
    masked_prev = torch.cat([no, masked[..., :-1]], -1)
    take = masked & ((audio_start_end[..., 0] - t_prev) < delta_thresh)
    take &= ~masked_prev
    take &= idx > 0
    pos = torch.cat([take[..., 1:], no], -1)
    return shift_row_lengths(row_lengths, pos, right_to_left=False)


def increase_textmask(row_lengths, masked, tok_centroids, audio_start_end, coin,
                      delta_thresh: float = 0.1):
    """Widen text masks across subsegment borders (reference
    dataloader.py:324-380). As in the numpy engine, the second direction
    regroups under the lengths the first one left. ``coin`` [B] uniform
    picks the order."""
    def f(rl, right_to_left):
        return _increase_one_dir(rl, masked, tok_centroids, audio_start_end, delta_thresh,
                                 right_to_left)

    a = f(f(row_lengths, True), False)
    b = f(f(row_lengths, False), True)
    return torch.where((coin < 0.5)[..., None], a, b)


# ---------------------------------------------------------------------------
# raw-text fake segmentation
# ---------------------------------------------------------------------------


def rawtext_weights(use_v1_stats: bool = False) -> np.ndarray:
    return np.asarray(_WEIGHTS_V1 if use_v1_stats else _WEIGHTS_V2)


def rawtext_flat_bound(desired_len: int, span_budget: int, use_v1_stats: bool = False) -> int:
    """Static bound on the raw-text flat stream and the fake-segment row
    count: ``desired_len + (E[span_len] * 0.85 - 1) * span_budget``, the one
    source of this formula (the device builder sizes its buffers with it)."""
    w = rawtext_weights(use_v1_stats)
    ev = float((np.arange(len(w)) * w).sum()) + 1.0
    return desired_len + int((ev * 0.85 - 1) * span_budget)


def rawtext_max_rows(desired_len: int, span_budget: int, use_v1_stats: bool = False) -> int:
    """Rows drawn per raw text: the all-length-1 worst case needs as many as
    the flat bound."""
    return max(desired_len, rawtext_flat_bound(desired_len, span_budget, use_v1_stats))


def convert_rawtext_into_fake_segments(segm_draws: torch.Tensor, n_tokens: torch.Tensor,
                                       desired_len: int, span_budget: int,
                                       offset_draw: Callable[[torch.Tensor], torch.Tensor],
                                       use_v1_stats: bool = False):
    """Chop raw text into fake 'audio span'-length rows by the empirical
    length distribution (reference dataloader.py:400-446), fixed-shape.

    :param segm_draws: [B, rawtext_max_rows] categorical draws in
        [0, len(weights)) (a row of length draw + 1 each)
    :param n_tokens: [B] actual raw-text lengths
    :param offset_draw: maps the [B] window slack to [B] offsets drawn
        uniformly in [0, slack)
    :return: (row_lengths [B, max_rows] int32, zero past the kept rows;
        offset [B] int32; l_sel [B]): values = tokens[offset : offset + l_sel]
    """
    L_target = rawtext_flat_bound(desired_len, span_budget, use_v1_stats)
    L = n_tokens.long().clamp(max=L_target)
    segm_lens = segm_draws.long() + 1
    keep = segm_lens.cumsum(-1) <= L[..., None]
    segm_lens = torch.where(keep, segm_lens, 0).to(torch.int32)
    l_sel = segm_lens.sum(-1)
    wiggle = (n_tokens.long() - l_sel).clamp(min=1)
    offset = offset_draw(wiggle)
    return segm_lens, offset.to(torch.int32), l_sel


# ---------------------------------------------------------------------------
# audio placement + assignment
# ---------------------------------------------------------------------------


def place_audio_subsegments(paddings: torch.Tensor, spec_size: int, num_subsegments: int,
                            seq_length: int) -> torch.Tensor:
    """Random non-overlapping windows by normalised-gap cumsum (reference
    dataloader.py:102-110). ``paddings`` [..., num_subsegments + 1] uniform
    draws in [0, 1); returns int32 start indices [..., num_subsegments]."""
    num_pad = spec_size - num_subsegments * seq_length
    csum = torch.cumsum(paddings / paddings.sum(-1, keepdim=True), -1)
    paddings_int = (num_pad * csum).to(torch.int32)
    steps = torch.arange(num_subsegments, dtype=torch.int32, device=paddings.device)
    return paddings_int[..., :num_subsegments] + steps * seq_length


def assign_tokens_to_audio(tok_centroids, audio_centroids):
    """Nearest centroid with the monotonic fix (reference
    dataloader.py:510-518): [..., T] and [..., A] -> [..., T] int64."""
    dist = (tok_centroids[..., :, None] - audio_centroids[..., None, :]).abs()
    return torch.cummax(dist.argmin(-1), -1).values


# ---------------------------------------------------------------------------
# masking + budget selection (fixed [B, Lmax, 3] streams)
# ---------------------------------------------------------------------------


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x [B, L, ...] rows gathered by order [B, L']."""
    idx = order.reshape(*order.shape, *([1] * (x.dim() - order.dim())))
    return torch.gather(x, order.dim() - 1, idx.expand(*order.shape, *x.shape[order.dim():]))


def select_tokens(tokens, valid, seg_score, gumbel, padded_seq_len: int, num_segments: int):
    """Budget subsample of padded [B, Lmax, 3] streams (reference
    dataloader.py:150-189): truncate from both ends outside the MASK span,
    then Gumbel top-k protecting MASK tokens, whole segments preferred.

    :param seg_score: [B, num_segments] uniform draws in [-1e5, 1e5)
    :param gumbel: [B, Lmax] Gumbel draws
    :return: ([B, padded_seq_len, 3] int32, [B, padded_seq_len] valid),
        real tokens compacted to the front in their order
    """
    Lmax = tokens.shape[-2]
    tok = tokens[..., 0]
    L = valid.sum(-1)
    amt_to_truncate = (L - padded_seq_len).clamp(min=0)

    is_mask_c = (valid & ((tok == MASK) | (tok == MASKAUDIO))).long().cumsum(-1)
    is_span_c = (valid & (tok == AUDIOSPAN)).long().cumsum(-1)
    lhs_amt = ((is_mask_c == 0) & (is_span_c == 0) & valid).sum(-1)
    rhs_amt = (((is_mask_c == is_mask_c[..., -1:]) & valid).sum(-1) - 1).clamp(min=0)

    trunc_start = torch.minimum(amt_to_truncate // 2, lhs_amt)
    trunc_end = torch.minimum(amt_to_truncate - trunc_start, rhs_amt)
    trunc_start = torch.minimum(amt_to_truncate - trunc_end, lhs_amt)

    pos = valid.long().cumsum(-1) - 1
    keep = valid & (pos >= trunc_start[..., None]) & (pos < (L - trunc_end)[..., None])

    keep_logits = 1e7 * ((tok == MASK) & keep).float()
    ptr = tokens[..., 1].long().clamp(0, num_segments - 1)
    keep_logits = keep_logits + torch.gather(seg_score, -1, ptr)
    keep_logits = torch.where(keep, keep_logits, float("-inf"))
    scores = keep_logits + gumbel

    n_keep = keep.sum(-1).clamp(max=padded_seq_len)
    order = torch.argsort(-scores, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, _arange(Lmax, order).expand_as(order).contiguous())
    selected = keep & (rank < n_keep[..., None])

    comp = compaction_order(selected)[..., :padded_seq_len]
    out = _take(tokens, comp)
    out_valid = torch.gather(selected, -1, comp)
    pad = torch.tensor([0, -1, -1], dtype=out.dtype, device=out.device)
    return torch.where(out_valid[..., None], out, pad), out_valid


def mask_tokens(tokens, row_lengths, masked, *, max_row: int, do_audio_span=None,
                audio_token_length: int = 6, text_span_start_counter: int = 0,
                do_audio_mask: bool = False, padded_seq_len: Optional[int] = None,
                num_groups: int = 1, text_span_len: int = 15,
                select_draws: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Rewrite masked and audio rows and emit fixed-shape grouped streams
    (reference dataloader.py:192-257).

    :param tokens: flat [B, L]; row_lengths [B, N]; masked [B, N] bool
    :param max_row: static cap on tokens per output row
    :param select_draws: with ``padded_seq_len``, maps group g to its
        (seg_score [B, N], gumbel [B, rows of the group's stream]) draws
    :return: (text_spans [B, N, text_span_len], -1 padded, row i holding
        row i's span iff masked; a list of num_groups (stream [B, *, 3]
        int32, valid [B, *]) pairs)
    """
    B, n = row_lengths.shape
    L = tokens.shape[-1]
    rl = row_lengths.long()
    rid = value_rowids(rl, L)
    starts = torch.cat([torch.zeros_like(rl[..., :1]), rl.cumsum(-1)[..., :-1]], -1)
    pos_in_row = _arange(L, tokens) - torch.gather(starts, -1, rid)

    # dense [B, N, max_row] of the original rows: writes out of range (rows
    # past the stream's end, tokens past max_row) go to the dump row N and
    # column max_row, cut off below (JAX's scatter mode="drop")
    is_real = _arange(L, tokens) < rl.sum(-1, keepdim=True)
    row = torch.where(is_real, rid, n)
    col = torch.where((pos_in_row >= 0) & (pos_in_row < max_row), pos_in_row, max_row)
    dense = torch.zeros(B, (n + 1) * (max_row + 1), dtype=tokens.dtype, device=tokens.device)
    dense.scatter_(-1, row * (max_row + 1) + col, tokens)
    dense = dense.view(B, n + 1, max_row + 1)[:, :n, :max_row]
    dense_len = rl.clamp(max=max_row)

    w = min(max_row, text_span_len)
    span_w = _arange(w, tokens)
    spans = torch.where((span_w < dense_len[..., None]) & masked[..., None],
                        dense[..., :w], -1).to(torch.int32)
    if w < text_span_len:
        spans = torch.nn.functional.pad(spans, (0, text_span_len - w), value=-1)

    if do_audio_span is not None:
        do_span = do_audio_span & ~masked
        dense = torch.where(do_span[..., None], AUDIOSPAN, dense)
        dense_len = torch.where(do_span, audio_token_length, dense_len)

    mask_row = torch.zeros(max_row, dtype=dense.dtype, device=dense.device)
    mask_row[0] = MASK
    mask_len = 1
    if do_audio_mask:
        mask_row[1] = MASKAUDIO
        mask_len = 2
    dense = torch.where(masked[..., None], mask_row, dense)
    dense_len = torch.where(masked, mask_len, dense_len)

    text_ptr_row = masked.long().cumsum(-1) - 1 + text_span_start_counter
    text_ptr_row = torch.where(masked, text_ptr_row, -1)

    col = _arange(max_row, tokens)
    valid_nm = col < dense_len[..., None]
    audio_ptr = _arange(n, tokens)[:, None].expand(n, max_row)
    triples = torch.stack([dense.long(), audio_ptr.expand(B, n, max_row),
                           text_ptr_row[..., None].expand(B, n, max_row)], -1)

    grp = n // num_groups
    streams = []
    for g in range(num_groups):
        t = triples[:, g * grp:(g + 1) * grp].reshape(B, -1, 3).to(torch.int32)
        v = valid_nm[:, g * grp:(g + 1) * grp].reshape(B, -1)
        order = compaction_order(v)
        t, v = _take(t, order), torch.gather(v, -1, order)
        if padded_seq_len is not None:
            seg_score, gumbel = select_draws(g)
            t, v = select_tokens(t, v, seg_score, gumbel, padded_seq_len, num_segments=n)
        streams.append((t, v))
    return spans, streams
