"""Span-masking engine for pretraining sequences (the port's copy of
``merlot_reserve_tpu/data/masking.py``, numpy on the host).

Re-expresses the reference's ragged-tensor masking machinery
(reference pretrain/dataloader.py:150-446) as plain numpy on a
(values, row_lengths) ragged representation with an explicit RNG. The
heuristics here were distribution-tuned by the reference authors (span-length
KL between streams, dataloader.py:1040-1096) so semantics are preserved
operation-for-operation:

  * rows = audio subsegment slots; tokens assigned by nearest audio centroid
    with a monotonic fix;
  * masked empty rows steal a token from a donor neighbor
    (reassign_empty_tokens);
  * text masks widen across subsegment borders when the neighbor token's
    timestamp is within delta of the audio boundary (increase_textmask);
  * masked rows become MASK (+MASKAUDIO), optionally others become
    6-token AUDIOSPAN runs; outputs are [L, 3] (token, audio_ptr, text_ptr);
  * over-budget sequences truncate from both ends, then Gumbel-subsample
    protecting MASK tokens and preferring whole segments (select_tokens);
  * raw text is chopped into fake spans by an empirical length distribution
    to mimic audio-span lengths (convert_rawtext_into_fake_segments).

Host-side by design: each example is a few hundred integers — the JPEG
decodes dominate the loader, not this.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, MASK, MASKAUDIO

# ---------------------------------------------------------------------------
# ragged representation
# ---------------------------------------------------------------------------


@dataclass
class Ragged:
    """Ragged [N, *] int array as (values, row_lengths)."""

    values: np.ndarray
    row_lengths: np.ndarray

    @classmethod
    def from_value_rowids(cls, values, rowids, nrows: int) -> "Ragged":
        values = np.asarray(values)
        rowids = np.asarray(rowids)
        lengths = np.bincount(rowids, minlength=nrows)
        order = np.argsort(rowids, kind="stable")
        return cls(values[order], lengths.astype(np.int64))

    @classmethod
    def from_row_lengths(cls, values, row_lengths) -> "Ragged":
        return cls(np.asarray(values), np.asarray(row_lengths, dtype=np.int64))

    @property
    def nrows(self) -> int:
        return len(self.row_lengths)

    @property
    def row_splits(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.row_lengths)])

    def value_rowids(self) -> np.ndarray:
        return np.repeat(np.arange(self.nrows), self.row_lengths)

    def row(self, i: int) -> np.ndarray:
        s = self.row_splits
        return self.values[s[i]:s[i + 1]]

    def rows(self) -> List[np.ndarray]:
        s = self.row_splits
        return [self.values[s[i]:s[i + 1]] for i in range(self.nrows)]

    def gather_rows(self, idx) -> "Ragged":
        rows = [self.row(int(i)) for i in idx]
        values = np.concatenate(rows) if rows else np.zeros(0, self.values.dtype)
        lengths = np.asarray([len(r) for r in rows], dtype=np.int64)
        return Ragged(values, lengths)

    def slice_rows(self, start: int, stop: int) -> "Ragged":
        s = self.row_splits
        return Ragged(self.values[s[start]:s[stop]], self.row_lengths[start:stop])


def _one_hot(idx, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=bool)
    out[np.asarray(idx, dtype=np.int64)] = True
    return out


# ---------------------------------------------------------------------------
# primitive RNG ops (dataloader's data_utils helpers)
# ---------------------------------------------------------------------------


def uniform_random_select(n: int, num_samples: int, rng: np.random.Generator,
                          sort_idx: bool = False) -> np.ndarray:
    idx = rng.permutation(n)[:num_samples]
    return np.sort(idx) if sort_idx else idx


def random_categorical_without_replacement(logits, num_samples: int,
                                           rng: np.random.Generator) -> np.ndarray:
    """Gumbel top-k = categorical sampling without replacement."""
    z = -np.log(-np.log(rng.uniform(1e-20, 1.0, size=len(logits))))
    return np.argsort(-(np.asarray(logits, dtype=np.float64) + z))[:num_samples]


def cumulative_maximum_int(x: np.ndarray) -> np.ndarray:
    return np.maximum.accumulate(x)


# ---------------------------------------------------------------------------
# ragged shifting + donation + widening
# ---------------------------------------------------------------------------


def shift_ragged_tokens_at_positions(r: Ragged, positions, right_to_left: bool = True) -> Ragged:
    """Marked rows donate one boundary token to their neighbor
    (dataloader.py:260-283): right_to_left moves each marked row's FIRST token
    to the row above; otherwise its LAST token to the row below."""
    n = r.nrows
    onehot = _one_hot(positions, n)
    onehot &= r.row_lengths > 0
    amt = onehot.astype(np.int64)

    if right_to_left:
        take = amt[1:]
        sub1 = np.concatenate([[0], -take])
        add1 = np.concatenate([take, [0]])
    else:
        take = amt[:-1]
        sub1 = np.concatenate([-take, [0]])
        add1 = np.concatenate([[0], take])
    new_lengths = r.row_lengths + sub1 + add1
    assert (new_lengths >= 0).all()
    return Ragged(r.values, new_lengths)


def _random_do_both_directions(f, r, rng, **kwargs):
    """Apply f in both directions, random order (dataloader.py:286-295)."""
    a = f(f(r, right_to_left=True, **kwargs), right_to_left=False, **kwargs)
    b = f(f(r, right_to_left=False, **kwargs), right_to_left=True, **kwargs)
    return a if rng.uniform() < 0.5 else b


def _reassign_one_dir(r: Ragged, *, mask_idx, right_to_left: bool) -> Ragged:
    n = r.nrows
    masked = _one_hot(mask_idx, n)
    needs = masked & (r.row_lengths == 0)
    can_donate = ~masked & (r.row_lengths >= 2)
    if right_to_left:
        positions = np.where(can_donate[1:] & needs[:-1])[0] + 1
        return shift_ragged_tokens_at_positions(r, positions, right_to_left=True)
    positions = np.where(can_donate[:-1] & needs[1:])[0]
    return shift_ragged_tokens_at_positions(r, positions, right_to_left=False)


def reassign_empty_tokens(r: Ragged, mask_idx, rng: np.random.Generator) -> Ragged:
    """Empty masked rows steal one token from an adjacent donor
    (dataloader.py:298-321)."""
    return _random_do_both_directions(_reassign_one_dir, r, rng, mask_idx=mask_idx)


def _increase_one_dir(r: Ragged, *, mask_idx, tok_centroids_vals, audio_start_end,
                      delta_thresh: float, right_to_left: bool) -> Ragged:
    n = r.nrows
    mask_idx = np.asarray(mask_idx, dtype=np.int64)
    nmask = len(mask_idx)

    # centroids regrouped by the *current* row assignment, with one padding
    # row on each side so +-1 neighbor lookups stay in bounds
    cent = Ragged.from_value_rowids(tok_centroids_vals, r.value_rowids() + 1, n + 2)

    def row_min(i):
        row = cent.row(i)
        return row.min() if len(row) else np.inf

    def row_max(i):
        row = cent.row(i)
        return row.max() if len(row) else -np.inf

    if right_to_left:
        t_out_right = np.asarray([row_min(int(m) + 2) for m in mask_idx])
        too_short = cent.row_lengths[mask_idx + 2] <= 1
        t_out_right = np.where(too_short, 1e4, t_out_right)
        audio_boundary_r = audio_start_end[mask_idx, 1]
        take = (t_out_right - audio_boundary_r) < delta_thresh
        right_is_masked = np.isin(mask_idx + 1, mask_idx)
        take &= ~right_is_masked
        take &= (mask_idx + 1) < n
        positions = (mask_idx + 1)[take]
        return shift_ragged_tokens_at_positions(r, positions, right_to_left=True)

    t_out_left = np.asarray([row_max(int(m)) for m in mask_idx])
    too_short = cent.row_lengths[mask_idx] <= 1
    t_out_left = np.where(too_short, -1e4, t_out_left)
    audio_boundary_l = audio_start_end[mask_idx, 0]
    take = (audio_boundary_l - t_out_left) < delta_thresh
    left_is_masked = np.isin(mask_idx - 1, mask_idx)
    take &= ~left_is_masked
    take &= mask_idx > 0
    positions = (mask_idx - 1)[take]
    return shift_ragged_tokens_at_positions(r, positions, right_to_left=False)


def increase_textmask(r: Ragged, mask_idx, tok_centroids_vals, audio_start_end,
                      rng: np.random.Generator, delta_thresh: float = 0.1) -> Ragged:
    """Widen text masks across subsegment borders by time threshold
    (dataloader.py:324-380)."""
    return _random_do_both_directions(
        _increase_one_dir, r, rng, mask_idx=mask_idx,
        tok_centroids_vals=np.asarray(tok_centroids_vals),
        audio_start_end=np.asarray(audio_start_end), delta_thresh=delta_thresh)


# ---------------------------------------------------------------------------
# masking + budget selection
# ---------------------------------------------------------------------------


def pad_tokens_to_fixed_size(tokens: np.ndarray, padded_seq_len: int) -> np.ndarray:
    """Pad [L, 3] with [0, -1, -1] rows, truncate to padded_seq_len."""
    missing = max(padded_seq_len - len(tokens), 0)
    dummy = np.tile(np.asarray([[0, -1, -1]], dtype=np.int32), [missing, 1])
    return np.concatenate([tokens.astype(np.int32), dummy], 0)[:padded_seq_len]


def select_tokens(tokens: np.ndarray, padded_seq_len: int, num_segments: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Cut [L, 3] down to padded_seq_len without dropping MASK tokens:
    truncate from both ends, then Gumbel-subsample preferring whole segments
    (dataloader.py:150-189)."""
    L = len(tokens)
    amt_to_truncate = L - padded_seq_len

    is_mask = np.cumsum((tokens[:, 0] == MASK) | (tokens[:, 0] == MASKAUDIO))
    is_audiospan = np.cumsum(tokens[:, 0] == AUDIOSPAN)

    lhs_amt = int(((is_mask == 0) & (is_audiospan == 0)).sum())
    rhs_amt = int((is_mask == is_mask[-1]).sum()) - 1

    trunc_start = min(amt_to_truncate // 2, lhs_amt)
    trunc_end = min(amt_to_truncate - trunc_start, rhs_amt)
    trunc_start = min(amt_to_truncate - trunc_end, lhs_amt)

    tokens0 = tokens[trunc_start:L - trunc_end]
    if len(tokens0) <= padded_seq_len:
        return tokens0

    keep_logits = 1e7 * ((tokens0[:, 0] == MASK) & (tokens0[:, 0] != AUDIOSPAN)).astype(np.float64)
    segment_to_score = rng.uniform(-1e5, 1e5, size=num_segments)
    keep_logits += segment_to_score[tokens0[:, 1]]
    idx2 = np.sort(random_categorical_without_replacement(keep_logits, padded_seq_len, rng))
    return tokens0[idx2]


def mask_tokens(r: Ragged, mask_idx, rng: np.random.Generator,
                do_audio_span: Optional[np.ndarray] = None,
                audio_token_length: int = 6, text_span_start_counter: int = 0,
                num_groups: int = 1, padded_seq_len: Optional[int] = None,
                do_audio_mask: bool = False) -> Tuple[Ragged, List[np.ndarray]]:
    """Mask rows of the ragged token tensor (dataloader.py:192-257).

    :return: (text_spans ragged [len(mask_idx), *],
              list of num_groups [<=L, 3] arrays of (token, audio_ptr, text_ptr))
    """
    n = r.nrows
    mask_idx = np.sort(np.asarray(mask_idx, dtype=np.int64))
    text_spans = r.gather_rows(mask_idx)
    masked = _one_hot(mask_idx, n)

    rows = r.rows()
    if do_audio_span is not None:
        do_audio_span = np.asarray(do_audio_span, dtype=bool) & ~masked
        for i in np.where(do_audio_span)[0]:
            rows[i] = np.full(audio_token_length, AUDIOSPAN, dtype=np.int64)

    mask_row = ([MASK, MASKAUDIO] if do_audio_mask else [MASK])
    for i in mask_idx:
        rows[i] = np.asarray(mask_row, dtype=np.int64)

    text_ptr_row = np.cumsum(masked.astype(np.int64)) - 1 + text_span_start_counter
    text_ptr_row = np.where(masked, text_ptr_row, -1)

    grp_size = n // num_groups
    output_grouped = []
    for g in range(num_groups):
        grp_rows = rows[g * grp_size:(g + 1) * grp_size]
        toks = (np.concatenate(grp_rows) if grp_rows else np.zeros(0, np.int64))
        row_lens = [len(x) for x in grp_rows]
        rowids = np.repeat(np.arange(len(grp_rows)), row_lens)
        audio_ptr = rowids + g * grp_size
        text_ptr = text_ptr_row[g * grp_size:(g + 1) * grp_size][rowids]
        out = np.stack([toks, audio_ptr, text_ptr], -1).astype(np.int32)
        if padded_seq_len is not None:
            if len(out) > padded_seq_len:
                out = select_tokens(out, padded_seq_len, num_segments=n, rng=rng)
            else:
                out = pad_tokens_to_fixed_size(out, padded_seq_len)
        output_grouped.append(out)
    return text_spans, output_grouped


# ---------------------------------------------------------------------------
# raw-text fake segmentation
# ---------------------------------------------------------------------------

_WEIGHTS_V1 = [0.0210583, 0.03984984, 0.06506665, 0.09467365, 0.12138153,
               0.13305461, 0.12973022, 0.11296043, 0.09024, 0.06730134,
               0.04789645, 0.03232633, 0.02123288, 0.01397406, 0.00925371]
_WEIGHTS_V2 = [0.03233136, 0.05236081, 0.08763368, 0.11757072, 0.13737426,
               0.13717706, 0.12541218, 0.10262764, 0.0771088, 0.05364242,
               0.0342899, 0.0203823, 0.01177542, 0.00664939, 0.00366406]


def convert_rawtext_into_fake_segments(tokens: np.ndarray, desired_len: int,
                                       span_budget: int, rng: np.random.Generator,
                                       use_v1_stats: bool = False):
    """Chop raw text into fake 'audio span'-length segments using the
    empirical length distribution (dataloader.py:400-446).

    :return: (ragged segments, extra_lhs tokens, extra_rhs tokens)
    """
    weights = np.asarray(_WEIGHTS_V1 if use_v1_stats else _WEIGHTS_V2)
    ev = float((np.arange(len(weights)) * weights).sum()) + 1.0

    L = desired_len + int((ev * 0.85 - 1) * span_budget)
    L = min(L, len(tokens))

    segm_lens = rng.choice(len(weights), size=L, p=weights / weights.sum()) + 1
    keep = np.cumsum(segm_lens) <= L
    segm_lens = segm_lens[keep]

    l_sel = int(segm_lens.sum())
    wiggle = len(tokens) - l_sel
    offset = int(rng.integers(0, max(wiggle, 1)))

    ragged = Ragged.from_row_lengths(tokens[offset:offset + l_sel], segm_lens)
    return ragged, tokens[:offset], tokens[offset + l_sel:]


# ---------------------------------------------------------------------------
# audio subsegment placement + token assignment
# ---------------------------------------------------------------------------


def place_audio_subsegments(spec_size: int, num_subsegments: int, seq_length: int,
                            rng: np.random.Generator) -> np.ndarray:
    """Randomly place non-overlapping subsegment windows inside the
    spec_size-frame spectrogram (dataloader.py:102-110): start indices."""
    content_len = num_subsegments * seq_length
    assert content_len < spec_size
    paddings = rng.uniform(0, 1.0, size=num_subsegments + 1)
    num_pad = spec_size - content_len
    paddings_int = (num_pad * np.cumsum(paddings / paddings.sum())).astype(np.int32)
    return paddings_int[:num_subsegments] + np.arange(num_subsegments) * seq_length


def audio_window_times(start_idx, seq_length: int, sample_rate: int,
                       fft_hop_length: int, fft_window_size: int,
                       dtype=np.float64):
    """Real start/end times of each subsegment window (dataloader.py:123-126).

    The device builder calls it too, with torch inputs and
    dtype=torch.float32 (a Python-float scalar is applied in the tensor's
    dtype, as in JAX's weak typing), so both builders share the formula."""
    fft_window = fft_window_size / sample_rate
    scale = fft_hop_length / sample_rate
    start_t = (start_idx.to(dtype) if isinstance(dtype, torch.dtype)
               else start_idx.astype(dtype)) * scale - fft_window / 2.0
    end_t = start_t + seq_length * scale + fft_window
    return start_t, end_t


def assign_tokens_to_audio(tok_centroids: np.ndarray, audio_centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid assignment with a monotonic fix
    (dataloader.py:510-518)."""
    if len(tok_centroids) == 0:
        return np.zeros(0, dtype=np.int64)
    dist = np.abs(tok_centroids[:, None] - audio_centroids[None])
    assignment = dist.argmin(1)
    return cumulative_maximum_int(assignment)
