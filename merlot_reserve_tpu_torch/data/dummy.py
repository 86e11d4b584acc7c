"""Synthetic pretraining batches with the exact schema the real pipeline
produces (the reference dataloader's collated batch, flattened to
global-batch-major):

  images           [B, num_segments * grid_h * grid_w, 16*16*3]
  audio_clips      [B, num_segments * num_subsegments * 60, 65]
  text_spans       [B, num_text_spans, text_span_length] int32
  video_src_index  [B, num_segments] int32
  text2audio, audio2text           [B, groups * n_seqs, lang_seq_len] (+ /audio_ptr, /text_ptr)
  audio_text_matching, random_text [B, n, seq_len] (+ pointer variants)

Pointer semantics are structurally valid (MASKAUDIO rows point at real audio
spans, MASK rows at real text spans, AUDIOSPAN runs are 6 tokens long) so the
objective computes meaningful losses; content is random.

The port's own copy of ``merlot_reserve_tpu/data/dummy.py`` (numpy only):
with the same config and seed its batches are byte-identical to the JAX
package's. Used by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, LTOVPOOL, MASK, MASKAUDIO, PADDING


def make_dummy_batch(cfg: MerlotConfig, batch_size: int = 2, seed: int = 0,
                     num_text_spans: int = 64) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    m, d = cfg.model, cfg.data

    nseg = d.num_segments
    nsub = d.num_audio_subsegments
    groups = d.num_segment_groups
    seg_per_group = d.num_segments_per_group
    lang_len = d.lang_seq_len
    seq_len = d.seq_len
    span_len = m.text_span_length
    grid_hw = m.vit_seq_len
    audio_spans_total = nseg * nsub

    # the audio_text_matching stream needs one LTOVPOOL + nsub*audio_token_length
    # AUDIOSPAN tokens per segment
    atm_needed = nseg * (1 + nsub * m.audio_token_length)
    assert seq_len >= atm_needed, (
        f"seq_len={seq_len} too small for audio_text_matching: "
        f"{nseg} segments need {atm_needed} tokens")

    batch: Dict[str, np.ndarray] = {}
    batch["images"] = rng.randn(batch_size, nseg * grid_hw,
                                m.vit_patch_size ** 2 * 3).astype(np.float32)
    batch["audio_clips"] = rng.randn(batch_size, nseg * nsub * m.audio_seq_length,
                                     65).astype(np.float32)

    spans = rng.randint(100, m.vocab_size, size=(batch_size, num_text_spans, span_len))
    span_lens = rng.randint(1, span_len + 1, size=(batch_size, num_text_spans))
    spans[np.arange(span_len)[None, None] >= span_lens[..., None]] = PADDING
    batch["text_spans"] = spans.astype(np.int32)

    batch["video_src_index"] = np.ones((batch_size, nseg), dtype=np.int32)

    vocab_lo, vocab_hi = 100, m.vocab_size

    def _rand_tokens(n):
        return rng.randint(vocab_lo, vocab_hi, size=n)

    # ---- text2audio: text input with MASKAUDIO targets + MASK text spans ----
    n_t2a = groups * d.num_text2audio_seqs
    t2a = np.zeros((batch_size, n_t2a, lang_len, 3), dtype=np.int32)
    mask_per_seq = max(int(audio_spans_total * d.mask_rate) // n_t2a, 1)
    for b in range(batch_size):
        for s in range(n_t2a):
            toks = _rand_tokens(lang_len)
            audio_ptr = np.repeat(np.arange(lang_len) * nsub * seg_per_group // lang_len,
                                  1) % audio_spans_total
            text_ptr = np.zeros(lang_len, dtype=np.int64)
            # place MASKAUDIO targets at distinct audio spans
            pos = rng.choice(lang_len, size=mask_per_seq, replace=False)
            for j, p in enumerate(sorted(pos)):
                toks[p] = MASKAUDIO
                audio_ptr[p] = (s * mask_per_seq + j) % audio_spans_total
            # a few MASK text spans
            tpos = rng.choice(np.setdiff1d(np.arange(lang_len), pos), size=4, replace=False)
            for j, p in enumerate(sorted(tpos)):
                toks[p] = MASK
                text_ptr[p] = rng.randint(0, num_text_spans)
            t2a[b, s, :, 0] = toks
            t2a[b, s, :, 1] = audio_ptr
            t2a[b, s, :, 2] = text_ptr
    _emit_triple(batch, "text2audio", t2a)

    # ---- audio2text: AUDIOSPAN runs + MASK text spans ----
    a2t = np.zeros((batch_size, groups * d.num_audio2text_seqs, lang_len, 3), dtype=np.int32)
    for b in range(batch_size):
        for s in range(a2t.shape[1]):
            toks = _rand_tokens(lang_len)
            audio_ptr = np.zeros(lang_len, dtype=np.int64)
            text_ptr = np.zeros(lang_len, dtype=np.int64)
            # AUDIOSPAN runs of exactly audio_token_length
            n_runs = min(8, lang_len // (m.audio_token_length * 2))
            cursor = 0
            for r in range(n_runs):
                toks[cursor:cursor + m.audio_token_length] = AUDIOSPAN
                audio_ptr[cursor:cursor + m.audio_token_length] = r % audio_spans_total
                cursor += m.audio_token_length * 2
            tpos = rng.choice(np.arange(cursor, lang_len), size=4, replace=False)
            for p in sorted(tpos):
                toks[p] = MASK
                text_ptr[p] = rng.randint(0, num_text_spans)
            a2t[b, s, :, 0] = toks
            a2t[b, s, :, 1] = audio_ptr
            a2t[b, s, :, 2] = text_ptr
    _emit_triple(batch, "audio2text", a2t)

    # ---- audio_text_matching: LTOVPOOL per segment + AUDIOSPAN/text ----
    atm = np.zeros((batch_size, 1, seq_len, 3), dtype=np.int32)
    for b in range(batch_size):
        toks = np.full(seq_len, PADDING, dtype=np.int64)
        audio_ptr = np.zeros(seq_len, dtype=np.int64)
        cursor = 0
        for seg in range(nseg):
            toks[cursor] = LTOVPOOL
            cursor += 1
            for sub in range(nsub):
                toks[cursor:cursor + m.audio_token_length] = AUDIOSPAN
                audio_ptr[cursor:cursor + m.audio_token_length] = seg * nsub + sub
                cursor += m.audio_token_length
        atm[b, 0, :, 0] = toks
        atm[b, 0, :, 1] = audio_ptr
    _emit_triple(batch, "audio_text_matching", atm, ptr_names=("audio_ptr",))

    # ---- random_text: plain text with MASK spans ----
    rt = np.zeros((batch_size, d.num_text_seqs, seq_len, 3), dtype=np.int32)
    for b in range(batch_size):
        for s in range(d.num_text_seqs):
            toks = _rand_tokens(seq_len)
            text_ptr = np.zeros(seq_len, dtype=np.int64)
            tpos = rng.choice(seq_len, size=8, replace=False)
            for p in sorted(tpos):
                toks[p] = MASK
                text_ptr[p] = rng.randint(0, num_text_spans)
            rt[b, s, :, 0] = toks
            rt[b, s, :, 2] = text_ptr
    _emit_triple(batch, "random_text", rt, ptr_names=("text_ptr",))

    return batch


def _emit_triple(batch, key, arr, ptr_names=("audio_ptr", "text_ptr")):
    batch[key] = arr[..., 0]
    if "audio_ptr" in ptr_names:
        batch[f"{key}/audio_ptr"] = arr[..., 1]
    if "text_ptr" in ptr_names:
        batch[f"{key}/text_ptr"] = arr[..., 2]
