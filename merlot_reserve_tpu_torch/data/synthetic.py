"""Synthetic TFRecord corpora with the exact pretraining schema
(reference pretrain/dataloader.py:30-60 ``segment_k2f``) and the VCR and
TVQA finetuning schemas (reference finetune/common_dataloader.py): the
port's copy of ``merlot_reserve_tpu/data/synthetic.py``, used by the tests,
``chip_smoke.py`` and as executable documentation of the record formats. Its JPEGs are encoded by the port's native library
(``data/native.py``), not PIL, so its bytes differ from the JAX package's
writer; the schema and the pixels it encodes are the same."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.data import tfrecord as T
from merlot_reserve_tpu_torch.data.native import encode_jpeg_native


def _jpeg_bytes(arr: np.ndarray) -> bytes:
    return encode_jpeg_native(arr, quality=90)


def _structured_image(uid: int) -> np.ndarray:
    """A JPEG-robust, segment-identifying frame: a 4x5 grid of solid color
    cells drawn deterministically from ``uid``. Low-frequency content
    survives JPEG quality 90 + resize + patchify, so the vision tower CAN
    discriminate segments — unlike iid pixel noise, which the encoder maps
    to near-identical embeddings (whiteness has nothing to attend to)."""
    rs = np.random.RandomState((uid * 7919 + 13) % (2**31 - 1))
    colors = rs.randint(0, 256, (4, 5, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(colors, 45, axis=0), 64, axis=1)
    return np.ascontiguousarray(img)


def _structured_spec(uid: int, num_mels: int, spec_size: int) -> np.ndarray:
    """A segment-identifying spectrogram: per-mel-band intensities constant
    along time (so the random 3x60-frame subsegment placement crops the same
    pattern wherever it lands), drawn deterministically from ``uid``."""
    rs = np.random.RandomState((uid * 104729 + 7) % (2**31 - 1))
    bands = rs.randint(20, 236, (num_mels, 1), dtype=np.uint8)
    return np.ascontiguousarray(np.broadcast_to(bands, (num_mels, spec_size)))


def make_segment_features(cfg: MerlotConfig, rng: np.random.Generator,
                          segment_idx: int, video_src_index: int = 1,
                          n_tokens: int = 20,
                          uid: Optional[int] = None) -> Dict[str, bytes]:
    """One segment's features (prefixed later with c{i:02d}/).

    ``uid`` switches image/spectrogram content from iid noise to a
    deterministic segment-identifying pattern (see _structured_image) so
    that contrastive pretraining on the synthetic corpus has signal to
    learn in ALL THREE heads — noise media leaves imgs_to_audio and
    text_to_audio pinned at their ln(N) initialization signatures."""
    d, m = cfg.data, cfg.model

    if uid is None:
        img = rng.integers(0, 256, (180, 320, 3), dtype=np.uint8)
        spec = rng.integers(0, 256, (d.num_mels, d.spec_size), dtype=np.uint8)
    else:
        img = _structured_image(uid)
        spec = _structured_spec(uid, d.num_mels, d.spec_size)

    start_time = 5.0 * segment_idx
    end_time = start_time + 5.0
    tok_ids = rng.integers(100, m.vocab_size, n_tokens)
    # word timings spread over the segment, relative to segment start
    starts = np.sort(rng.uniform(0, 4.5, n_tokens)).astype(np.float32)
    ends = starts + rng.uniform(0.05, 0.4, n_tokens).astype(np.float32)

    return {
        "image/encoded": T.bytes_feature([_jpeg_bytes(img)]),
        "image/format": T.bytes_feature([b"jpeg"]),
        "image/key/sha256": T.bytes_feature([b""]),
        "image/height": T.int64_feature([img.shape[0]]),
        "image/width": T.int64_feature([img.shape[1]]),
        "spectrogram/encoded": T.bytes_feature([_jpeg_bytes(spec)]),
        "spectrogram/format": T.bytes_feature([b"jpeg"]),
        "spectrogram/key/sha256": T.bytes_feature([b""]),
        "spectrogram/height": T.int64_feature([spec.shape[0]]),
        "spectrogram/width": T.int64_feature([spec.shape[1]]),
        "spectrogram/magic_number": T.float_feature([float(rng.uniform(20, 60))]),
        "youtube_id": T.bytes_feature([b"synthetic000"]),
        "video_src_index": T.int64_feature([video_src_index]),
        "title": T.int64_feature(rng.integers(100, 1000, 4).tolist()),
        "tags": T.int64_feature(rng.integers(100, 1000, 3).tolist()),
        "description": T.int64_feature(rng.integers(100, 1000, 6).tolist()),
        "meta": T.bytes_feature([b""]),
        "playback_speed": T.int64_feature([1]),
        "start_time": T.float_feature([start_time]),
        "end_time": T.float_feature([end_time]),
        "tok_ids": T.int64_feature(tok_ids.tolist()),
        "tok_start_times": T.float_feature(starts.tolist()),
        "tok_end_times": T.float_feature(ends.tolist()),
        "random_text": T.int64_feature(
            rng.integers(100, m.vocab_size, 1200).tolist()),
    }


def make_video_record(cfg: MerlotConfig, rng: np.random.Generator,
                      packed_videos: Optional[List[int]] = None,
                      uid_base: Optional[int] = None) -> bytes:
    """One 16-segment example; ``packed_videos`` gives segment counts of
    packed clips (summing to num_segments) for video_src_index variety.
    ``uid_base`` enables structured (learnable) media: segment i gets
    uid = uid_base + i."""
    n = cfg.data.num_segments
    if packed_videos is None:
        packed_videos = [n]
    assert sum(packed_videos) == n
    src_idx = np.repeat(1 + np.arange(len(packed_videos)), packed_videos)

    features: Dict[str, bytes] = {}
    for i in range(n):
        seg = make_segment_features(
            cfg, rng, i, video_src_index=int(src_idx[i]),
            uid=None if uid_base is None else uid_base + i)
        features.update({f"c{i:02d}/{k}": v for k, v in seg.items()})
    return T.encode_example(features)


def make_vcr_record(cfg: MerlotConfig, rng: np.random.Generator,
                    num_answers: int = 4) -> bytes:
    """One synthetic VCR example: a 200x300 noise image and its left-right
    flip, and per task (qa, qar) a query, ``num_answers`` choices and a label."""
    img = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    feats = {
        "image": T.bytes_feature([_jpeg_bytes(img)]),
        "image_fliplr": T.bytes_feature([_jpeg_bytes(img[:, ::-1])]),
        "id": T.bytes_feature([b"vcr-0"]),
    }
    for prefix in ("qa", "qar"):
        feats[f"{prefix}_query"] = T.int64_feature(rng.integers(100, 1000, 12).tolist())
        for i in range(num_answers):
            feats[f"{prefix}_choice_{i}"] = T.int64_feature(rng.integers(100, 1000, 8).tolist())
        feats[f"{prefix}_label"] = T.int64_feature([int(rng.integers(0, num_answers))])
    return T.encode_example(feats)


def make_tvqa_record(cfg: MerlotConfig, rng: np.random.Generator,
                     num_answers: int = 5, num_segments: int = 7) -> bytes:
    """One synthetic TVQA example: a query, ``num_answers`` choices and a
    label; per segment a 180x320 noise frame, a [3 * 60, 65] noise
    spectrogram (one grayscale JPEG) and subtitle tokens."""
    feats = {
        "id": T.bytes_feature([b"tvqa-0"]),
        "magic_number": T.float_feature([float(rng.uniform(20, 60))]),
        "qa_query": T.int64_feature(rng.integers(100, 1000, 10).tolist()),
        "qa_label": T.int64_feature([int(rng.integers(0, num_answers))]),
        "num_frames": T.int64_feature([num_segments]),
    }
    for i in range(num_answers):
        feats[f"qa_choice_{i}"] = T.int64_feature(rng.integers(100, 1000, 6).tolist())
    for i in range(num_segments):
        img = rng.integers(0, 256, (180, 320, 3), dtype=np.uint8)
        spec = rng.integers(0, 256, (3 * 60, 65), dtype=np.uint8)
        feats[f"c{i:02d}/image_encoded"] = T.bytes_feature([_jpeg_bytes(img)])
        feats[f"c{i:02d}/spec_encoded"] = T.bytes_feature([_jpeg_bytes(spec)])
        feats[f"c{i:02d}/sub"] = T.int64_feature(rng.integers(100, 1000, 8).tolist())
    return T.encode_example(feats)


def write_synthetic_finetune_corpus(path: str, cfg: MerlotConfig, task: str,
                                    num_records: int = 4, seed: int = 0):
    """``num_records`` synthetic ``task`` ('vcr' or 'tvqa') examples to ``path``."""
    rng = np.random.default_rng(seed)
    make = {"vcr": make_vcr_record, "tvqa": make_tvqa_record}[task]
    T.write_records(path, [make(cfg, rng) for _ in range(num_records)])
    return path


def write_synthetic_corpus(path: str, cfg: MerlotConfig, num_records: int = 4,
                           seed: int = 0, structured: bool = False):
    """``structured=True`` writes learnable media (segment-identifying
    image/spectrogram patterns keyed by a corpus-unique uid) instead of iid
    noise — used by the on-chip convergence run (configs/soak_onechip.yaml)
    where contrastive losses must actually descend."""
    rng = np.random.default_rng(seed)
    n = cfg.data.num_segments
    records = []
    for r in range(num_records):
        packed = [n] if r % 2 == 0 else ([n // 2, n - n // 2])
        uid_base = (seed * num_records + r) * n if structured else None
        records.append(make_video_record(cfg, rng, packed, uid_base=uid_base))
    T.write_records(path, records)
    return path
