"""Pretraining example pipeline: TFRecord segments -> fixed-shape model batches.

The port of ``merlot_reserve_tpu/data/pretrain_pipeline.py``: the host-side
equivalent of the reference's dataset_parser + handle_batch (reference
pretrain/dataloader.py:449-789) without TensorFlow. Records are parsed and
JPEGs decoded, resized and patchified by the port's native library
(``data/native.py``; no PIL and no pure-Python fallback), the masking engine
is ``data/masking.py``, and batches come out global-batch-major.

Example schema per segment (keys c{i:02d}/...): JPEG frame, JPEG-quantized
uint8 spectrogram + float magic_number dequantizer, BPE tok_ids with
per-token start/end times, playback_speed, title/tags/description tokens,
random_text (The Pile), video_src_index (dataloader.py:30-60).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
import torch

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.data import masking as M
from merlot_reserve_tpu_torch.data import native as N
from merlot_reserve_tpu_torch.tokenizer import (
    END,
    PADDING,
    START,
    get_tokenizer,
    token_is_valid_table,
)


def flip_if_vertical(img: np.ndarray) -> np.ndarray:
    """Rotate portrait videos 90 degrees and pad with 0.5-gray side markers so
    the model can tell it was flipped (data_utils.py:25-39)."""
    h, w = img.shape[:2]
    if h >= 4 * w / 3.0:
        img = np.rot90(img, k=1, axes=(0, 1))
        marker = np.full((img.shape[0], 4, img.shape[2]), 128, img.dtype)
        img = np.concatenate([marker, img, marker], axis=1)
    return img


# typed per-segment schema for the native parser fast path (the subset the
# example builder consumes; names follow the reference's segment_k2f,
# dataloader.py:30-60)
_SEG_BYTES_KEYS = ("image/encoded", "spectrogram/encoded")
_SEG_INT_KEYS = ("playback_speed", "tok_ids", "title", "description", "tags",
                 "random_text", "video_src_index")
_SEG_FLOAT_KEYS = ("spectrogram/magic_number", "start_time", "end_time",
                   "tok_start_times", "tok_end_times")


def parse_segment_record(record: bytes, num_segments: int) -> List[Dict]:
    """One TFRecord example -> list of per-segment feature dicts, parsed by
    the native protobuf parser (one parse, typed per-key reads)."""
    ex = N.NativeExample(record)
    segments = []
    for i in range(num_segments):
        p = f"c{i:02d}/"
        seg = {}
        for k in _SEG_BYTES_KEYS:
            v = ex.bytes_list(p + k)
            if v:
                seg[k] = v
        for k in _SEG_INT_KEYS:
            v = ex.int64s(p + k)
            if len(v):
                seg[k] = v
        for k in _SEG_FLOAT_KEYS:
            v = ex.floats(p + k)
            if len(v):
                seg[k] = v
        segments.append(seg)
    return segments


def _scalar(v, default=0):
    arr = np.asarray(v)
    return arr.reshape(-1)[0] if arr.size else default


@dataclass
class PretrainExampleBuilder:
    """Builds one training example from decoded segments (dataset_parser
    equivalent, dataloader.py:449-712)."""

    cfg: MerlotConfig

    def __post_init__(self):
        enc = get_tokenizer()
        self._title_prefix = enc.encode("title:").ids
        self._desc_prefix = enc.encode("description:").ids
        self._tags_prefix = enc.encode("tags:").ids
        self._token_valid = token_is_valid_table()

    # -- decode --------------------------------------------------------

    def decode_image(self, seg: Dict, rng: np.random.Generator) -> np.ndarray:
        """JPEG -> [grid_h*grid_w, P*P*3] patches on the host, in the native
        library (decode, then the fused resize, crop, pad and patchify). The
        training-time random scale, per-image resize kernel and crop are
        drawn from ``rng`` in the JAX package's order (mult, kernel, off_y,
        off_x; reference dataloader.py:63-85)."""
        data = bytes(seg["image/encoded"][0])
        grid = tuple(self.cfg.model.output_grid)
        scale_rng = (self.cfg.data.random_scale_min, self.cfg.data.random_scale_max)
        img = flip_if_vertical(N.decode_jpeg_native(data, channels=3))
        h, w = img.shape[:2]
        dh, dw = grid[0] * 16, grid[1] * 16
        mult = float(rng.uniform(*scale_rng))
        kernel = N.BILINEAR
        if self.cfg.data.random_resize_method:
            kernel = int(rng.integers(0, len(N.RESIZE_KERNELS)))
        sh = int(h * min(dh / h, dw / w) * mult)
        sw = int(w * min(dh / h, dw / w) * mult)
        off_y = int(rng.integers(0, max(sh - dh, 0) + 1))
        off_x = int(rng.integers(0, max(sw - dw, 0) + 1))
        return N.resize_patchify_native(img, grid, kernel, scale_mult=mult, off_y=off_y,
                                        off_x=off_x)

    def decode_audio(self, seg: Dict, rng: np.random.Generator):
        """Spectrogram JPEG + magic number -> [num_subsegments, 60, 65] with
        random subsegment placement; returns (clips, start_t, end_t)
        (dataloader.py:88-128)."""
        d = self.cfg.data
        spec = N.decode_jpeg_native(bytes(seg["spectrogram/encoded"][0]), channels=1)
        spec = spec.reshape(d.num_mels, d.spec_size).T  # [T, num_mels]
        magic = float(_scalar(seg["spectrogram/magic_number"], 1.0))
        playback_speed = int(_scalar(seg.get("playback_speed", [1]), 1))

        start_idx = M.place_audio_subsegments(d.spec_size, d.num_audio_subsegments,
                                              self.cfg.model.audio_seq_length, rng)
        clips = np.stack([
            spec[s:s + self.cfg.model.audio_seq_length] for s in start_idx
        ]).astype(np.float32) / magic
        speed_feat = np.full(clips.shape[:-1] + (1,), float(playback_speed), np.float32)
        clips = np.concatenate([clips, speed_feat], -1)

        start_t, end_t = M.audio_window_times(
            start_idx, self.cfg.model.audio_seq_length, d.sample_rate,
            d.fft_hop_length, d.fft_window_size)
        return clips, start_t, end_t

    # -- assemble ------------------------------------------------------

    def build(self, segments: List[Dict], rng: np.random.Generator) -> Dict[str, np.ndarray]:
        cfg, d, m = self.cfg, self.cfg.data, self.cfg.model
        num_segments = d.num_segments
        assert len(segments) == num_segments
        num_audio_spans = d.num_audio_spans
        num_audio_spans_trg = int(num_audio_spans * d.mask_rate)

        features: Dict[str, np.ndarray] = {}
        features["images"] = np.stack(
            [self.decode_image(s, rng) for s in segments])

        audio_clips, audio_start, audio_end = [], [], []
        for seg in segments:
            c, st, et = self.decode_audio(seg, rng)
            audio_clips.append(c)
            audio_start.append(st)
            audio_end.append(et)
        features["audio_clips"] = np.stack(audio_clips)

        # token -> audio-subsegment assignment (dataloader.py:505-531)
        segment_idx, tok_centroids_all, audio_start_end_all = [], [], []
        t_start = 0.0
        tok_ids_all = []
        for i, seg in enumerate(segments):
            tok_ids = np.asarray(seg.get("tok_ids", np.zeros(0, np.int64)), np.int64)
            ts = np.asarray(seg.get("tok_start_times", np.zeros(0, np.float32)))
            te = np.asarray(seg.get("tok_end_times", np.zeros(0, np.float32)))
            tok_centroids = (ts + te) / 2.0
            audio_centroids = (audio_start[i] + audio_end[i]) / 2.0
            assignment = M.assign_tokens_to_audio(tok_centroids, audio_centroids)
            segment_idx.append(assignment + i * d.num_audio_subsegments)
            tok_ids_all.append(tok_ids)
            tok_centroids_all.append(tok_centroids + t_start)
            audio_start_end_all.append(
                np.stack([audio_start[i], audio_end[i]], -1) + t_start)
            t_start += float(_scalar(seg.get("end_time", 5.0), 5.0)
                             ) - float(_scalar(seg.get("start_time", 0.0), 0.0))

        tokens_ragged = M.Ragged.from_value_rowids(
            np.concatenate(tok_ids_all), np.concatenate(segment_idx), num_audio_spans)
        tok_centroids_vals = np.concatenate(tok_centroids_all)
        audio_start_end = np.concatenate(audio_start_end_all, 0)

        # distinct target spans for the two directions (dataloader.py:533-541)
        trg_idx = M.uniform_random_select(
            num_audio_spans,
            num_audio_spans_trg * (d.num_text2audio_seqs + d.num_audio2text_seqs), rng)
        t2a_idx = trg_idx[:num_audio_spans_trg * d.num_text2audio_seqs].reshape(
            d.num_text2audio_seqs, num_audio_spans_trg)
        a2t_idx = trg_idx[num_audio_spans_trg * d.num_text2audio_seqs:].reshape(
            d.num_audio2text_seqs, num_audio_spans_trg)

        spans_all: List[M.Ragged] = []

        # ---- text2audio (dataloader.py:543-566) ----
        tokens_all = []
        for i in range(d.num_text2audio_seqs):
            r_i = M.reassign_empty_tokens(tokens_ragged, t2a_idx[i], rng)
            r_i = M.increase_textmask(r_i, t2a_idx[i], tok_centroids_vals,
                                      audio_start_end, rng, delta_thresh=0.125)
            spans, groups = M.mask_tokens(
                r_i, t2a_idx[i], rng,
                text_span_start_counter=i * num_audio_spans_trg,
                num_groups=d.num_segment_groups, padded_seq_len=d.lang_seq_len,
                do_audio_mask=True)
            spans_all.append(spans)
            tokens_all.extend(groups)
        features["text2audio"] = np.stack(tokens_all, 0)

        # ---- audio2text (dataloader.py:570-594) ----
        audio_tokens_all = []
        for i in range(d.num_audio2text_seqs):
            idx = a2t_idx[i]
            onehot = M._one_hot(idx, num_audio_spans)
            onehot_exp = np.concatenate([[False], onehot, [False]])
            should_textify = (onehot_exp[2:] | onehot_exp[:-2]) & ~onehot
            should_textify &= rng.uniform(size=num_audio_spans) < 0.8
            spans, groups = M.mask_tokens(
                tokens_ragged, idx, rng, do_audio_span=~should_textify,
                audio_token_length=m.audio_token_length,
                padded_seq_len=d.lang_seq_len,
                text_span_start_counter=(i + d.num_text2audio_seqs) * num_audio_spans_trg,
                num_groups=d.num_segment_groups)
            spans_all.append(spans)
            audio_tokens_all.extend(groups)
        features["audio2text"] = np.stack(audio_tokens_all, 0)

        # ---- audio_text_matching (dataloader.py:598-636) ----
        max_text_seq_len = d.seq_len
        use_audio_tokens = rng.uniform() < d.use_audio_token_prob
        matching = []
        for i, seg in enumerate(segments):
            matching.append(np.asarray(
                [[LTOVPOOL_ROW[0], i * d.num_audio_subsegments, -1]], np.int64))
            if use_audio_tokens:
                for j in range(d.num_audio_subsegments):
                    row = np.asarray(
                        [[AUDIOSPAN_ROW[0], j + i * d.num_audio_subsegments, -1]],
                        np.int64)
                    matching.append(np.tile(row, [m.audio_token_length, 1]))
            else:
                tok_ids = tok_ids_all[i]
                matching.append(np.stack([
                    tok_ids,
                    np.full(len(tok_ids), i * d.num_audio_subsegments, np.int64),
                    np.full(len(tok_ids), -1, np.int64)], 1))
        matching = np.concatenate(matching, 0)

        aux = np.concatenate([
            [START], self._title_prefix, np.asarray(segments[0].get("title", []), np.int64),
            [START], self._desc_prefix, np.asarray(segments[0].get("description", []), np.int64),
            [START], self._tags_prefix, np.asarray(segments[0].get("tags", []), np.int64),
            [END]]).astype(np.int64)
        aux = np.stack([aux, np.full(len(aux), -1, np.int64),
                        np.full(len(aux), -1, np.int64)], 1)
        extra_space = max(max_text_seq_len - len(matching), 0)
        matching = np.concatenate([aux[:extra_space], matching], 0)
        features["audio_text_matching"] = M.pad_tokens_to_fixed_size(
            matching, d.seq_len)[None]

        # ---- random_text (dataloader.py:640-692) ----
        counter = num_audio_spans_trg * (d.num_audio2text_seqs + d.num_text2audio_seqs)
        random_texts = [np.asarray(seg.get("random_text", np.zeros(0, np.int64)), np.int64)
                        for seg in segments[:d.num_text_seqs_in_record]]
        pick = M.uniform_random_select(d.num_text_seqs_in_record, d.num_text_seqs, rng)
        random_text_l = []
        for i in range(d.num_text_seqs):
            span_budget = d.text_span_budget
            r_i, extra_lhs, extra_rhs = M.convert_rawtext_into_fake_segments(
                random_texts[int(pick[i])], desired_len=max_text_seq_len,
                span_budget=span_budget, rng=rng)
            # prefer YouTube-style maskable spans 4:1 (dataloader.py:676-679)
            want_rows = np.ones(r_i.nrows, dtype=bool)
            splits = r_i.row_splits
            valid_vals = self._token_valid[np.clip(r_i.values, 0, None)]
            for j in range(r_i.nrows):
                row_valid = valid_vals[splits[j]:splits[j + 1]]
                want_rows[j] = bool(row_valid.all()) and len(row_valid) > 0
            mask_w = 0.2 + 0.8 * want_rows.astype(np.float64)
            budget = min(span_budget, r_i.nrows)
            do_mask = np.sort(M.random_categorical_without_replacement(
                np.log(mask_w), budget, rng))
            spans_i, tokens_i = M.mask_tokens(r_i, do_mask, rng,
                                              text_span_start_counter=counter,
                                              num_groups=1)
            tokens_i = tokens_i[0]
            amt_needed = max(max_text_seq_len - len(tokens_i), 0)
            amt_lhs = min(len(extra_lhs), amt_needed // 2)
            lhs = np.stack([extra_lhs[len(extra_lhs) - amt_lhs:],
                            np.zeros(amt_lhs, np.int64),
                            np.full(amt_lhs, -1, np.int64)], 1)
            amt_rhs = min(len(extra_rhs), (amt_needed + 1) // 2)
            last_ptr = tokens_i[-1, 1] if len(tokens_i) else 0
            rhs = np.stack([extra_rhs[:amt_rhs],
                            np.full(amt_rhs, last_ptr + 1, np.int64),
                            np.full(amt_rhs, -1, np.int64)], 1)
            tokens_i = np.concatenate([lhs, tokens_i, rhs], 0)
            tokens_i = M.pad_tokens_to_fixed_size(tokens_i, d.seq_len)

            # drop non-YouTube tokens from span targets (dataloader.py:389-397)
            keep = self._token_valid[np.clip(spans_i.values, 0, None)]
            rowids = spans_i.value_rowids()[keep]
            spans_i = M.Ragged.from_value_rowids(spans_i.values[keep], rowids,
                                                 spans_i.nrows)
            counter += span_budget
            random_text_l.append(tokens_i)
            spans_all.append(spans_i)
        features["random_text"] = np.stack(random_text_l, 0)

        # ---- span table (dataloader.py:694-697) ----
        span_len = m.text_span_length
        all_rows: List[np.ndarray] = []
        for sp in spans_all:
            all_rows.extend(sp.rows())
        table = np.full((len(all_rows), span_len), PADDING, np.int32)
        for j, row in enumerate(all_rows):
            row = row[:span_len]
            table[j, :len(row)] = row
        features["text_spans"] = table

        features["video_src_index"] = np.asarray(
            [int(_scalar(s.get("video_src_index", 1), 1)) for s in segments],
            np.int32)
        return features


LTOVPOOL_ROW = (6,)
AUDIOSPAN_ROW = (5,)


def collate_batch(examples: List[Dict[str, np.ndarray]], use_bfloat16: bool = False) -> Dict:
    """handle_batch equivalent (dataloader.py:732-789), global-batch-major:
    flattens image/audio leading dims and splits [.., L, 3] triples into
    k, k/audio_ptr, k/text_ptr. With ``use_bfloat16`` the images and audio
    clips come as bf16 CPU tensors (numpy has no bf16), cast here, in the
    loader's worker, so that the device feed copies half the bytes."""
    # preallocate + assign for the two large float arrays: np.stack's
    # generic path is ~5x slower than contiguous row assignment at these
    # sizes (measured: 22 -> 4.3 ms/example for base images)
    batch = {k: np.stack([e[k] for e in examples])
             for k in examples[0] if k not in ("images", "audio_clips")}
    B = len(examples)
    num_segments, hw, pp3 = examples[0]["images"].shape
    images = np.empty((B, num_segments * hw, pp3), np.float32)
    for i, e in enumerate(examples):
        images[i] = e["images"].reshape(num_segments * hw, pp3)
    batch["images"] = images

    n_, nsub, aseq, mel = examples[0]["audio_clips"].shape
    audio = np.empty((B, n_ * nsub * aseq, mel), np.float32)
    for i, e in enumerate(examples):
        audio[i] = e["audio_clips"].reshape(n_ * nsub * aseq, mel)
    batch["audio_clips"] = audio

    for k in ["text2audio", "audio2text", "audio_text_matching", "random_text"]:
        x = batch[k]
        x = x.reshape(B, int(np.prod(x.shape[1:-2])), x.shape[-2], 3)
        batch[k] = x[..., 0]
        batch[f"{k}/audio_ptr"] = x[..., 1]
        batch[f"{k}/text_ptr"] = x[..., 2]

    if use_bfloat16:
        for k in ("images", "audio_clips"):
            batch[k] = torch.from_numpy(batch[k]).to(torch.bfloat16)
    return batch


def pretrain_examples_from_file(path: str, cfg: MerlotConfig,
                                seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Stream examples from one TFRecord file."""
    builder = PretrainExampleBuilder(cfg)
    rng = np.random.default_rng(seed)
    for record in N.read_records_native(path):
        segments = parse_segment_record(record, cfg.data.num_segments)
        yield builder.build(segments, rng)
