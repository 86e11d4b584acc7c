"""The pretraining example builder on the card, batched over examples.

The port of ``merlot_reserve_tpu/data/device_builder.py``: the example
assembly of the reference's tf.data parser (reference
pretrain/dataloader.py:449-712) as fixed-shape tensor programs with a
leading example dimension where JAX vmaps ``build``: spectrogram dequant and
random subsegment placement, token-to-audio assignment, span donation and
widening, MASK and AUDIOSPAN rewriting, budget selection, the
audio_text_matching and random_text builders, the text-span table, the
training frames (``ops/vision_train.py``) and the collation.

Division of labour:
  * host (``host_prepare``, ``host_prepare_frames``): bytes to fixed-shape
    numpy arrays (native JPEG decode, protobuf fields padded, the tokenized
    aux prefix). No randomness, no masking, no float math.
  * card (``build_batch``): everything else, with every random number drawn
    through one sampler (``BuilderDraws``), a pure function of
    (seed, step, site). A test hands in a sampler that returns the JAX
    package's draws for its key tree; then the two builders agree on the
    same raw batch.

Draw sites, with their shapes (B examples, S segments, A audio
subsegments, N = S*A spans, i a stream's index, g a group's):
  ``audio``                  uniform [B, S, A+1]            placement gaps
  ``targets``                permutation [B, N]              target spans
  ``t2a{i}/reassign``        uniform [B]                     direction coin
  ``t2a{i}/increase``        uniform [B]                     direction coin
  ``t2a{i}/select{g}/segments``  uniform [B, N] in [-1e5, 1e5)
  ``t2a{i}/select{g}/gumbel``    Gumbel [B, rows of group g's stream]
  ``a2t{i}/coin``            uniform [B, N]                  textify coins
  ``a2t{i}/select{g}/...``   as for t2a
  ``matching``               uniform [B]                     audio-token coin
  ``random_text``            permutation [B, num_text_seqs_in_record]
  ``rt{i}/lengths``          categorical [B, rows] over the fake-span weights
  ``rt{i}/offset``           randint [B] in [0, slack)
  ``rt{i}/mask``             Gumbel [B, rows]
  ``frames/mult``            uniform [B, S] in the config's scale range
  ``frames/kernel``          randint [B, S] in [0, 6) (random_resize_method)
  ``frames/off_y``, ``frames/off_x``   uniform [B, S]

Shapes are fixed: per-segment token counts cap at ``max_tokens_per_segment``
(``host_prepare`` truncates and counts), raw text at ``raw_text_len``. The
JAX package's accepted cap deviation (tests/test_device_builder_longtail.py
there) holds for the same caps here.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List

import numpy as np
import torch

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.data import masking as M
from merlot_reserve_tpu_torch.data import native as N_
from merlot_reserve_tpu_torch.ops import masking_device as dev
from merlot_reserve_tpu_torch.ops import vision_train as VT
from merlot_reserve_tpu_torch.tokenizer import (
    AUDIOSPAN,
    END,
    LTOVPOOL,
    PADDING,
    START,
    get_tokenizer,
    token_is_valid_table,
)


class BuilderDraws:
    """The builder's random numbers: each site's draw comes from a
    ``torch.Generator`` on ``device`` seeded by a hash of
    (seed, step, site), so a batch's draws are a pure function of
    (seed, step): fresh every step, the same after a resume."""

    def __init__(self, seed: int, step: int, device):
        self.seed, self.step = int(seed), int(step)
        self.device = torch.device(device)

    def _gen(self, site: str) -> torch.Generator:
        digest = hashlib.blake2b(f"{self.seed}/{self.step}/{site}".encode(),
                                 digest_size=8).digest()
        return torch.Generator(device=self.device).manual_seed(
            int.from_bytes(digest, "little") & (2**63 - 1))

    def uniform(self, site: str, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._gen(site), device=self.device)
        return u * (high - low) + low

    def gumbel(self, site: str, shape) -> torch.Tensor:
        u = self.uniform(site, shape).clamp(min=1e-20)
        return -torch.log(-torch.log(u))

    def permutation(self, site: str, shape) -> torch.Tensor:
        """Random permutations of range(shape[-1]) along the last axis."""
        return torch.argsort(self.uniform(site, shape), dim=-1)

    def categorical(self, site: str, logits: torch.Tensor, shape) -> torch.Tensor:
        """Draws of indices into ``logits`` [K], ``shape`` of them."""
        g = self.gumbel(site, (*shape, logits.shape[-1]))
        return torch.argmax(logits.to(self.device) + g, dim=-1)

    def randint(self, site: str, high: torch.Tensor) -> torch.Tensor:
        """Integers uniform in [0, high) for each entry of ``high`` (>= 1)."""
        u = self.uniform(site, high.shape)
        return torch.minimum((u * high).long(), high.long() - 1)


class RowShardDraws(BuilderDraws):
    """``BuilderDraws`` for rank ``index`` of ``count`` data-parallel ranks:
    every site draws for the global batch (``count`` times the rows of the
    shape asked for, dim 0 being the batch) and hands back this rank's
    contiguous rows, so a batch's draws do not depend on the layout."""

    def __init__(self, seed: int, step: int, device, index: int, count: int):
        super().__init__(seed, step, device)
        self.index, self.count = index, count

    def uniform(self, site: str, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        shape = tuple(shape)
        full = super().uniform(site, (shape[0] * self.count,) + shape[1:], low, high)
        return full[self.index * shape[0]:(self.index + 1) * shape[0]]


def _compact(triples, valid, out_len: int):
    """Stable-compact valid [B, L, 3] rows to the front, pad or cut to
    out_len (the device analogue of pad_tokens_to_fixed_size after a
    validity-ordered concat)."""
    order = dev.compaction_order(valid)[:, :out_len]
    t = dev._take(triples, order)
    v = torch.gather(valid, 1, order)
    pad = torch.tensor([0, -1, -1], dtype=t.dtype, device=t.device)
    return torch.where(v[..., None], t, pad), v


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, N, W] rows by idx [B, K] -> [B, K, W]."""
    return torch.gather(table, 1, idx[..., None].expand(*idx.shape, table.shape[-1]))


class DeviceExampleBuilder:
    """Builds pretraining batches on the card.

    Usage::

        builder = DeviceExampleBuilder(cfg)
        raw = builder.host_prepare(segments)             # host, bytes -> arrays
        batch = builder.build_batch(raw_batch, draws)    # tensors on the card
    """

    def __init__(self, cfg: MerlotConfig, max_tokens_per_segment: int = 48,
                 aux_len: int = 160, raw_text_len: int = 1024):
        self.cfg = cfg
        d = cfg.data
        self.S = d.num_segments
        self.A = d.num_audio_subsegments
        self.N = d.num_audio_spans
        self.TM = max_tokens_per_segment
        self.AUXL = aux_len
        self.RTL = raw_text_len
        self.n_trg = int(self.N * d.mask_rate)
        self.span_len = cfg.model.text_span_length
        self.rt_flat_bound = dev.rawtext_flat_bound(d.seq_len, d.text_span_budget)
        self.rt_rows = dev.rawtext_max_rows(d.seq_len, d.text_span_budget)
        # a subsegment row holds a whole segment's tokens plus donation (<= 2)
        # and widening (<= 2) boundary moves
        self.max_row = max(self.TM + 4, cfg.model.audio_token_length, self.span_len)
        # host_prepare's truncate-and-count contract; it runs on the loader's
        # worker threads, hence the lock (worker processes count in their own
        # copy, which take_stats and add_stats carry back)
        self.stats = {"truncated_segments": 0, "truncated_tokens": 0, "oversize_frames": 0}
        self._stats_lock = threading.Lock()
        self._mask_tbl_np = token_is_valid_table()
        self._mask_tbl: Dict[torch.device, torch.Tensor] = {}
        enc = get_tokenizer()
        self._title_prefix = enc.encode("title:").ids
        self._desc_prefix = enc.encode("description:").ids
        self._tags_prefix = enc.encode("tags:").ids

    # ------------------------------------------------------------------
    # host side: bytes -> fixed-shape arrays (no randomness, no masking)
    # ------------------------------------------------------------------

    def take_stats(self) -> Dict[str, int]:
        """The counts since the last call, which are zeroed: a worker
        process's builder hands them to the loader's copy."""
        with self._stats_lock:
            out, self.stats = self.stats, dict.fromkeys(self.stats, 0)
        return out

    def add_stats(self, counts: Dict[str, int]):
        with self._stats_lock:
            for k, v in counts.items():
                self.stats[k] += v

    def host_prepare(self, segments: List[Dict]) -> Dict[str, np.ndarray]:
        """Decode one record's segments to the builder's inputs (the decode
        part of PretrainExampleBuilder.build)."""
        from merlot_reserve_tpu_torch.data.pretrain_pipeline import _scalar

        d = self.cfg.data
        S, TM = self.S, self.TM
        if len(segments) != S:
            raise ValueError(f"{len(segments)} segments, the config has {S}")
        spec_u8 = np.zeros((S, d.spec_size, d.num_mels), np.uint8)
        magic = np.ones(S, np.float32)
        playback = np.ones(S, np.float32)
        tok_ids = np.zeros((S, TM), np.int32)
        tok_num = np.zeros(S, np.int32)
        tok_start = np.zeros((S, TM), np.float32)
        tok_end = np.zeros((S, TM), np.float32)
        seg_start = np.zeros(S, np.float32)
        seg_end = np.full(S, 5.0, np.float32)
        video_src = np.ones(S, np.int32)

        for i, seg in enumerate(segments):
            spec = N_.decode_jpeg_native(bytes(seg["spectrogram/encoded"][0]), channels=1)
            spec_u8[i] = spec.reshape(d.num_mels, d.spec_size).T
            magic[i] = float(_scalar(seg["spectrogram/magic_number"], 1.0))
            # int() as the host builder floors fractional speeds
            playback[i] = int(_scalar(seg.get("playback_speed", [1]), 1))
            ids_full = np.asarray(seg.get("tok_ids", np.zeros(0, np.int64)))
            if len(ids_full) > TM:
                with self._stats_lock:
                    self.stats["truncated_segments"] += 1
                    self.stats["truncated_tokens"] += len(ids_full) - TM
            ids = ids_full[:TM]
            tok_ids[i, :len(ids)] = ids
            tok_num[i] = len(ids)
            ts = np.asarray(seg.get("tok_start_times", np.zeros(0)))[:TM]
            te = np.asarray(seg.get("tok_end_times", np.zeros(0)))[:TM]
            tok_start[i, :len(ts)] = ts
            tok_end[i, :len(te)] = te
            seg_start[i] = float(_scalar(seg.get("start_time", 0.0), 0.0))
            seg_end[i] = float(_scalar(seg.get("end_time", 5.0), 5.0))
            video_src[i] = int(_scalar(seg.get("video_src_index", 1), 1))

        aux_full = np.concatenate([
            [START], self._title_prefix, np.asarray(segments[0].get("title", []), np.int64),
            [START], self._desc_prefix, np.asarray(segments[0].get("description", []), np.int64),
            [START], self._tags_prefix, np.asarray(segments[0].get("tags", []), np.int64),
            [END]]).astype(np.int32)[:self.AUXL]
        aux = np.zeros(self.AUXL, np.int32)
        aux[:len(aux_full)] = aux_full

        n_rt = d.num_text_seqs_in_record
        random_text = np.zeros((n_rt, self.RTL), np.int32)
        random_text_num = np.zeros(n_rt, np.int32)
        for i in range(n_rt):
            rt = np.asarray(segments[i].get("random_text", np.zeros(0, np.int64)))[:self.RTL]
            random_text[i, :len(rt)] = rt
            random_text_num[i] = len(rt)

        return {
            "spec_u8": spec_u8, "magic": magic, "playback": playback,
            "tok_ids": tok_ids, "tok_num": tok_num, "tok_start": tok_start, "tok_end": tok_end,
            "seg_start": seg_start, "seg_end": seg_end,
            "aux": aux, "aux_num": np.int32(len(aux_full)),
            "random_text": random_text, "random_text_num": random_text_num,
            "video_src_index": video_src,
        }

    def host_prepare_frames(self, segments: List[Dict]) -> Dict[str, np.ndarray]:
        """Decode one record's frames into fixed square uint8 buffers for
        the frame path on the card: JPEG decode is the only host work.
        Frames too large for the buffer (the reference corpus stores frames
        of at most 512 px) are downscaled on the host to fit, with torch's
        antialiased bilinear resize (the JAX package uses PIL's), and
        counted in ``stats['oversize_frames']``."""
        FB = self.cfg.data.frame_buffer_size
        frames = np.zeros((self.S, FB, FB, 3), np.uint8)
        hw = np.zeros((self.S, 2), np.int32)
        for i, seg in enumerate(segments):
            img = N_.decode_jpeg_native(bytes(seg["image/encoded"][0]), channels=3)
            h, w = img.shape[:2]
            if max(h, w) > FB - 8:  # -8: room for the flip's side markers
                with self._stats_lock:
                    self.stats["oversize_frames"] += 1
                s = (FB - 8) / max(h, w)
                size = (max(int(h * s), 1), max(int(w * s), 1))
                x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
                x = torch.nn.functional.interpolate(x, size=size, mode="bilinear",
                                                    antialias=True, align_corners=False)
                img = x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
                h, w = img.shape[:2]
            frames[i, :h, :w] = img
            hw[i] = (h, w)
        return {"frames_u8": frames, "frame_hw": hw}

    # ------------------------------------------------------------------
    # on the card, batched over B
    # ------------------------------------------------------------------

    def mask_table(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._mask_tbl:
            self._mask_tbl[device] = torch.from_numpy(self._mask_tbl_np).to(device)
        return self._mask_tbl[device]

    def _frames(self, raw, draws):
        """Training frames: flip if portrait, random scale, per-frame random
        kernel, random crop, patchify (ops/vision_train.py)."""
        d = self.cfg.data
        shape = raw["frame_hw"].shape[:-1]
        if d.random_resize_method:
            kernel = draws.randint("frames/kernel", torch.full(shape, VT.NUM_KERNELS,
                                                               device=draws.device))
        else:
            kernel = torch.full(shape, VT.BILINEAR, device=raw["frame_hw"].device)
        fd = {"mult": draws.uniform("frames/mult", shape, d.random_scale_min,
                                    d.random_scale_max),
              "kernel": kernel, "u_off_y": draws.uniform("frames/off_y", shape),
              "u_off_x": draws.uniform("frames/off_x", shape)}
        return VT.augment_frames(raw["frames_u8"], raw["frame_hw"],
                                 tuple(self.cfg.model.output_grid), fd)

    def _audio_clips(self, raw, draws):
        """Random subsegment placement, window slice, dequant, speed channel
        and the windows' real times (reference dataloader.py:88-128)."""
        d, m = self.cfg.data, self.cfg.model
        spec = raw["spec_u8"]
        B = spec.shape[0]
        gaps = draws.uniform("audio", (B, self.S, self.A + 1))
        starts = dev.place_audio_subsegments(gaps, d.spec_size, self.A, m.audio_seq_length)
        W = m.audio_seq_length
        window = (starts.long()[..., None] + torch.arange(W, device=spec.device)).reshape(
            B, self.S, self.A * W)
        clips = torch.gather(spec, 2, window[..., None].expand(*window.shape, spec.shape[-1]))
        clips = clips.float().reshape(B, self.S, self.A, W, -1)
        clips = clips / raw["magic"][:, :, None, None, None]
        speed = raw["playback"][:, :, None, None, None].expand(*clips.shape[:-1], 1)
        clips = torch.cat([clips, speed], -1)
        start_t, end_t = M.audio_window_times(starts, W, d.sample_rate, d.fft_hop_length,
                                              d.fft_window_size, dtype=torch.float32)
        return clips, start_t, end_t

    def _token_ragged(self, raw, start_t, end_t):
        """Every token's audio subsegment row and the flat (values,
        row_lengths) stream in global time order (reference
        dataloader.py:505-531)."""
        S, TM, N = self.S, self.TM, self.N
        B = raw["tok_ids"].shape[0]
        device = raw["tok_ids"].device
        tok_valid = torch.arange(TM, device=device) < raw["tok_num"][..., None]   # [B, S, TM]
        cent = (raw["tok_start"] + raw["tok_end"]) / 2.0
        audio_cent = (start_t + end_t) / 2.0                                       # [B, S, A]
        assignment = dev.assign_tokens_to_audio(cent, audio_cent)
        rowids = assignment + torch.arange(S, device=device)[:, None] * self.A

        seg_dur = raw["seg_end"] - raw["seg_start"]
        t_off = torch.cat([torch.zeros_like(seg_dur[:, :1]), seg_dur.cumsum(-1)[:, :-1]], -1)
        cent_g = cent + t_off[..., None]
        audio_start_end = torch.stack([start_t + t_off[..., None], end_t + t_off[..., None]],
                                      -1).reshape(B, N, 2)

        # valid tokens compacted to the front; segment-major order is the host
        # ragged's stable row sort, since row ids never decrease
        flat_valid = tok_valid.reshape(B, -1)
        order = dev.compaction_order(flat_valid)
        tokens_flat = torch.gather(raw["tok_ids"].reshape(B, -1).long(), 1, order)
        cent_flat = torch.gather(cent_g.reshape(B, -1), 1, order)

        rid = torch.where(tok_valid, rowids, N).reshape(B, -1)
        row_lengths = torch.zeros(B, N + 1, dtype=torch.long, device=device).scatter_add_(
            1, rid, torch.ones_like(rid))[:, :N]
        return tokens_flat, row_lengths, cent_flat, audio_start_end

    def _select_draws(self, draws, prefix: str, batch: int, rows: int):
        """Group g's budget-selection draws of one stream (mask_tokens'
        ``select_draws``)."""
        def per_group(g):
            return (draws.uniform(f"{prefix}/select{g}/segments", (batch, self.N), -1e5, 1e5),
                    draws.gumbel(f"{prefix}/select{g}/gumbel", (batch, rows)))
        return per_group

    def _one_hot(self, idx: torch.Tensor, n: int) -> torch.Tensor:
        return torch.zeros(*idx.shape[:-1], n, dtype=torch.bool, device=idx.device).scatter_(
            -1, idx, True)

    def _random_text_seq(self, draws, i: int, raw_tokens, n_raw, counter: int):
        """One random_text sequence per example: fake segmentation, the
        maskable-preferred span draw, masking, and the left/right context
        fill (reference dataloader.py:640-692)."""
        d = self.cfg.data
        seq_len, budget = d.seq_len, d.text_span_budget
        B = raw_tokens.shape[0]
        device = raw_tokens.device
        weights = torch.from_numpy(dev.rawtext_weights()).float()
        lens, offset, l_sel = dev.convert_rawtext_into_fake_segments(
            draws.categorical(f"rt{i}/lengths", torch.log(weights), (B, self.rt_rows)),
            n_raw, desired_len=seq_len, span_budget=budget,
            offset_draw=lambda wiggle: draws.randint(f"rt{i}/offset", wiggle))
        n_rows = lens.shape[-1]
        LB = self.rt_flat_bound
        ar = torch.arange(LB, device=device)
        vals = torch.gather(raw_tokens, 1, (offset.long()[:, None] + ar).clamp(0, self.RTL - 1))

        # prefer fully maskable rows 4:1 (reference dataloader.py:676-679)
        tbl = self.mask_table(device)
        rid = dev.value_rowids(lens, LB)
        tok_ok = tbl[vals.long().clamp(0, tbl.shape[0] - 1)]
        in_stream = ar < l_sel[:, None]
        big = torch.full((B, n_rows), torch.iinfo(torch.int32).max, dtype=torch.int32,
                         device=device)
        row_ok = big.scatter_reduce(1, rid, torch.where(in_stream, tok_ok.int(), 1), "amin")
        want = (row_ok > 0) & (lens > 0)
        logits = torch.where(lens > 0, torch.log(0.2 + 0.8 * want.float()), float("-inf"))
        g = draws.gumbel(f"rt{i}/mask", (B, n_rows))
        # lax.top_k: the lower index first among ties
        top = torch.argsort(logits + g, dim=-1, descending=True, stable=True)[:, :budget]
        masked = self._one_hot(top, n_rows) & (lens > 0)

        # fake rows draw lengths 1..15 whatever the configured span length:
        # max_row covers 15, and the span table keeps the configured width
        spans, streams = dev.mask_tokens(
            vals, lens, masked, max_row=max(self.span_len, 15),
            text_span_start_counter=counter, num_groups=1, text_span_len=self.span_len)
        stream_t, stream_v = streams[0]

        # left/right raw context into the remaining budget
        total = stream_v.sum(-1)
        needed = (seq_len - total).clamp(min=0)
        lhs_amt = torch.minimum(offset.long(), needed // 2)
        rhs_avail = (n_raw.long() - (offset.long() + l_sel)).clamp(min=0)
        rhs_amt = torch.minimum(rhs_avail, (needed + 1) // 2)

        pos = torch.arange(seq_len, device=device)
        start = offset.long()[:, None]
        lhs_tok = torch.gather(raw_tokens, 1,
                               (start - lhs_amt[:, None] + pos).clamp(0, self.RTL - 1))
        zeros = torch.zeros(B, seq_len, dtype=torch.int32, device=device)
        lhs = torch.stack([lhs_tok.int(), zeros, zeros - 1], -1)
        lhs_v = pos < lhs_amt[:, None]

        rows = torch.arange(n_rows, device=device)
        last_ptr = torch.where(lens > 0, rows, -1).max(-1).values
        rhs_tok = torch.gather(raw_tokens, 1,
                               (start + l_sel[:, None] + pos).clamp(0, self.RTL - 1))
        rhs = torch.stack([rhs_tok.int(), (last_ptr + 1).int()[:, None].expand(B, seq_len),
                           zeros - 1], -1)
        rhs_v = pos < rhs_amt[:, None]

        out, _ = _compact(torch.cat([lhs, stream_t, rhs], 1),
                          torch.cat([lhs_v, stream_v, rhs_v], 1), seq_len)

        # span table rows: the masked rows' contents without non-maskable
        # tokens (reference dataloader.py:389-397), compacted left, -1 padded
        sel = torch.sort(torch.where(masked, rows, n_rows), dim=-1).values[:, :budget]
        spans_sel = _rows(spans, sel.clamp(max=n_rows - 1))
        spans_sel = torch.where((sel < n_rows)[..., None], spans_sel, -1)
        keep = (spans_sel >= 0) & tbl[spans_sel.long().clamp(0, tbl.shape[0] - 1)]
        korder = dev.compaction_order(keep)
        spans_out = torch.where(torch.gather(keep, -1, korder),
                                torch.gather(spans_sel, -1, korder), -1)
        return out, spans_out

    def _audio_text_matching(self, draws, raw):
        """The matching stream: per segment one LTOVPOOL token and either 18
        AUDIOSPAN tokens or the segment's ASR text (one coin per example),
        after as much of the title/description/tags prefix as fits
        (reference dataloader.py:598-636)."""
        d, m = self.cfg.data, self.cfg.model
        S, TM, A = self.S, self.TM, self.A
        B = raw["tok_ids"].shape[0]
        device = raw["tok_ids"].device
        use_audio = (draws.uniform("matching", (B,)) < d.use_audio_token_prob)[:, None, None]

        n_audio_tok = A * m.audio_token_length
        BL = 1 + max(n_audio_tok, TM)
        seg_ids = torch.arange(S, device=device)[:, None]
        col = torch.arange(BL, device=device)

        a_tok = torch.where(col == 0, LTOVPOOL,
                            torch.where(col <= n_audio_tok, AUDIOSPAN, 0)).expand(S, BL)
        a_ptr = torch.where((col >= 1) & (col <= n_audio_tok),
                            seg_ids * A + (col - 1).clamp(min=0) // m.audio_token_length,
                            torch.where(col == 0, seg_ids * A, 0))
        a_val = (col < 1 + n_audio_tok).expand(S, BL)

        t_tok = torch.cat([torch.full((B, S, 1), LTOVPOOL, dtype=torch.int32, device=device),
                           raw["tok_ids"],
                           torch.zeros(B, S, BL - 1 - TM, dtype=torch.int32, device=device)], -1)
        t_ptr = (seg_ids * A).expand(S, BL)
        t_val = torch.cat([torch.ones(B, S, 1, dtype=torch.bool, device=device),
                           torch.arange(TM, device=device) < raw["tok_num"][..., None],
                           torch.zeros(B, S, BL - 1 - TM, dtype=torch.bool, device=device)], -1)

        tok = torch.where(use_audio, a_tok.int(), t_tok.int())
        ptr = torch.where(use_audio, a_ptr, t_ptr).int()
        val = torch.where(use_audio, a_val, t_val)
        triples = torch.stack([tok, ptr, torch.full_like(tok, -1)], -1).reshape(B, -1, 3)
        valid = val.reshape(B, -1)

        extra_space = (d.seq_len - valid.sum(-1)).clamp(min=0)
        aux_keep = (torch.arange(self.AUXL, device=device)
                    < torch.minimum(extra_space, raw["aux_num"].long())[:, None])
        neg = torch.full_like(raw["aux"], -1)
        aux_triples = torch.stack([raw["aux"], neg, neg], -1)
        out, _ = _compact(torch.cat([aux_triples, triples], 1),
                          torch.cat([aux_keep, valid], 1), d.seq_len)
        return out

    def build_batch(self, raw: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        """Raw arrays stacked over B (``stack_raw_examples``, as tensors on
        the card) -> the trainer's batch dict (``collate_batch`` semantics;
        ``images`` too when ``raw`` carries frames). Integer streams are
        int32, as in JAX; with ``use_bfloat16`` the images and audio clips
        are bf16. ``draws``: a ``BuilderDraws`` or a sampler with its
        methods."""
        d = self.cfg.data
        B = raw["tok_ids"].shape[0]
        clips, start_t, end_t = self._audio_clips(raw, draws)
        tokens, row_lengths, cent, ase = self._token_ragged(raw, start_t, end_t)

        n_t2a, n_a2t = d.num_text2audio_seqs, d.num_audio2text_seqs
        n_trg = self.n_trg
        trg = draws.permutation("targets", (B, self.N))[:, :n_trg * (n_t2a + n_a2t)]
        span_tables = []
        rows_t2a = (self.N // d.num_segment_groups) * self.max_row

        t2a_streams = []
        for i in range(n_t2a):
            idx = trg[:, i * n_trg:(i + 1) * n_trg]
            masked = self._one_hot(idx, self.N)
            rl = dev.reassign_empty_tokens(row_lengths, masked,
                                           draws.uniform(f"t2a{i}/reassign", (B,)))
            rl = dev.increase_textmask(rl, masked, cent, ase,
                                       draws.uniform(f"t2a{i}/increase", (B,)), delta_thresh=0.125)
            spans, streams = dev.mask_tokens(
                tokens, rl, masked, max_row=self.max_row, do_audio_mask=True,
                padded_seq_len=d.lang_seq_len, num_groups=d.num_segment_groups,
                text_span_start_counter=i * n_trg, text_span_len=self.span_len,
                select_draws=self._select_draws(draws, f"t2a{i}", B, rows_t2a))
            t2a_streams.extend(t for t, _ in streams)
            span_tables.append(_rows(spans, torch.sort(idx, -1).values))
        text2audio = torch.stack(t2a_streams, 1)

        a2t_streams = []
        for i in range(n_a2t):
            idx = trg[:, (n_t2a + i) * n_trg:(n_t2a + i + 1) * n_trg]
            masked = self._one_hot(idx, self.N)
            no = torch.zeros_like(masked[:, :1])
            neighbor = torch.cat([masked[:, 1:], no], 1) | torch.cat([no, masked[:, :-1]], 1)
            should_textify = neighbor & ~masked
            should_textify &= draws.uniform(f"a2t{i}/coin", (B, self.N)) < 0.8
            spans, streams = dev.mask_tokens(
                tokens, row_lengths, masked, max_row=self.max_row,
                do_audio_span=~should_textify,
                audio_token_length=self.cfg.model.audio_token_length,
                padded_seq_len=d.lang_seq_len, num_groups=d.num_segment_groups,
                text_span_start_counter=(i + n_t2a) * n_trg, text_span_len=self.span_len,
                select_draws=self._select_draws(draws, f"a2t{i}", B, rows_t2a))
            a2t_streams.extend(t for t, _ in streams)
            span_tables.append(_rows(spans, torch.sort(idx, -1).values))
        audio2text = torch.stack(a2t_streams, 1)

        matching = self._audio_text_matching(draws, raw)[:, None]

        counter = n_trg * (n_t2a + n_a2t)
        pick = draws.permutation("random_text", (B, d.num_text_seqs_in_record))
        rt_streams = []
        for i in range(d.num_text_seqs):
            p = pick[:, i]
            rt_tokens = _rows(raw["random_text"], p[:, None])[:, 0]
            rt_num = torch.gather(raw["random_text_num"], 1, p[:, None])[:, 0]
            out, spans = self._random_text_seq(draws, i, rt_tokens, rt_num, counter)
            rt_streams.append(out)
            span_tables.append(spans)
            counter += d.text_span_budget
        random_text = torch.stack(rt_streams, 1)

        table = torch.cat(span_tables, 1)[..., :self.span_len]
        table = torch.where(table >= 0, table, PADDING).to(torch.int32)

        batch = {"audio_clips": clips.reshape(B, -1, clips.shape[-1])}
        for k, x in (("text2audio", text2audio), ("audio2text", audio2text),
                     ("audio_text_matching", matching), ("random_text", random_text)):
            batch[k] = x[..., 0]
            batch[f"{k}/audio_ptr"] = x[..., 1]
            batch[f"{k}/text_ptr"] = x[..., 2]
        batch["text_spans"] = table
        batch["video_src_index"] = raw["video_src_index"]
        if "frames_u8" in raw:
            imgs = self._frames(raw, draws)
            batch["images"] = imgs.reshape(B, -1, imgs.shape[-1])
        if self.cfg.model.use_bfloat16:
            for k in ("audio_clips", "images"):
                if k in batch:
                    batch[k] = batch[k].to(torch.bfloat16)
        return batch


def stack_raw_examples(raws: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Host-side collation of host_prepare outputs to the batched raw dict
    that build_batch consumes."""
    return {k: np.stack([r[k] for r in raws]) for k in raws[0]}
