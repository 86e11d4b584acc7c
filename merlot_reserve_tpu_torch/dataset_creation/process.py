"""Dataset creation: videos (frames, PCM and timed ASR words) to 16-segment
pretraining TFRecords (reference data/process.py).

The port of ``merlot_reserve_tpu/dataset_creation/process.py``. It takes
decoded arrays (``preprocess.py`` decodes files with ffmpeg where there is
one). The pipeline (process.py:318-764):
  * the ASR timing fix through the offset model (optional);
  * adaptive windows of 5 s of playback: where a window holds too few
    words the playback speed rises to 2 or 3 (the audio fast-forwarded,
    the spectrogram's n_fft and hop scaled);
  * per window: the frame resized (shorter side 288, longer at most 512;
    Pillow's bilinear resize, bit for bit, in the data library) and
    JPEG-encoded; the log-mel spectrogram (``ops/audio`` on the card, one
    call for all the windows of one speed) quantized to a grayscale JPEG
    with its percentile-99 magic number; BPE tokens with per-token times;
  * chunks of short videos pack into records of exactly 16 segments, with
    a per-segment ``video_src_index``;
  * one raw-text token blob (The Pile, ``text_corpus.py``) per segment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from merlot_reserve_tpu_torch.data import tfrecord as T
from merlot_reserve_tpu_torch.data.native import encode_jpeg_native, resize_native
from merlot_reserve_tpu_torch.dataset_creation.offset_model import apply_offsets
from merlot_reserve_tpu_torch.dataset_creation.spectrogram import quantize_spectrogram
from merlot_reserve_tpu_torch.ops.audio import mel_power_spectrogram
from merlot_reserve_tpu_torch.tokenizer import get_tokenizer
from merlot_reserve_tpu_torch.utils.device import resolve_device

SEGMENT_LENGTH = 5.0
MIN_WORDS_PER_WINDOW = 3
MAX_PLAYBACK_SPEED = 3


def resize_image_for_storage(img: np.ndarray, shorter_side: int = 288,
                             max_side: int = 512, quality: int = 90) -> bytes:
    """[h, w, 3] uint8 -> JPEG bytes, shrunk (never grown) so that the
    shorter side is 288 and the longer at most 512 (process.py's frame
    storage)."""
    h, w = img.shape[:2]
    scale = min(shorter_side / min(w, h), max_side / max(w, h))
    if scale < 1.0:
        img = resize_native(img, max(int(h * scale), 1), max(int(w * scale), 1))
    return encode_jpeg_native(img, quality)


def split_into_windows(words: List[Dict], duration: float,
                       segment_length: float = SEGMENT_LENGTH) -> List[Dict]:
    """Timed words -> adaptive windows. A window starts at the cursor and
    spans segment_length * playback_speed seconds, with the smallest speed
    (1..3) that takes in at least MIN_WORDS_PER_WINDOW words, by their
    midpoints (process.py:333-391)."""
    windows = []
    cursor = 0.0
    i = 0
    n = len(words)
    while cursor + segment_length <= duration:
        chosen = None
        for speed in range(1, MAX_PLAYBACK_SPEED + 1):
            end = cursor + segment_length * speed
            if end > duration:
                break
            in_window = [w for w in words[i:]
                         if cursor <= (w["start"] + w["end"]) / 2 < end]
            if len(in_window) >= MIN_WORDS_PER_WINDOW or speed == MAX_PLAYBACK_SPEED:
                chosen = {"start_time": cursor, "end_time": end,
                          "playback_speed": speed, "words": in_window}
                break
        if chosen is None:
            break
        windows.append(chosen)
        cursor = chosen["end_time"]
        while i < n and (words[i]["start"] + words[i]["end"]) / 2 < cursor:
            i += 1
    return windows


@dataclass
class VideoChunk:
    """One processed 5-second segment, ready for packing."""

    frame_jpeg: bytes
    spectrogram_jpeg: bytes
    magic_number: float
    tok_ids: List[int]
    tok_start_times: List[float]
    tok_end_times: List[float]
    start_time: float
    end_time: float
    playback_speed: int
    youtube_id: str = ""
    title_toks: List[int] = field(default_factory=list)
    description_toks: List[int] = field(default_factory=list)
    tags_toks: List[int] = field(default_factory=list)
    meta: bytes = b""


def window_waveform(waveform: np.ndarray, window: Dict, sr: int = 22050) -> np.ndarray:
    """The window's samples, zero-padded to exactly 5 s of playback at its
    speed (SEGMENT_LENGTH * sr * playback_speed)."""
    s0 = int(window["start_time"] * sr)
    s1 = int(window["end_time"] * sr)
    wav = np.asarray(waveform[s0:s1], np.float32)
    target = int(SEGMENT_LENGTH * sr) * window["playback_speed"]
    if wav.size < target:
        wav = np.concatenate([wav, np.zeros(target - wav.size, np.float32)])
    return wav[:target]


def window_log_mels(wavs: np.ndarray, speed: int, sr: int = 22050,
                    device="cuda") -> np.ndarray:
    """[n, 5 s * sr * speed] waveforms of one playback speed -> [n, T, 64]
    log-mels (float64, as the JAX package's numpy gives them): one
    ``ops.audio.mel_power_spectrogram`` call on ``device`` at n_fft
    1536 * speed and hop 588 * speed, then log(mel + 0.1) - log(0.1) on the
    host."""
    mel = mel_power_spectrogram(wavs, sr=sr, n_fft=1536 * speed, hop_length=588 * speed,
                                fmax=sr / 2.0, device=device).cpu().numpy()
    return np.log(mel + 0.1) - np.log(0.1)


def build_chunk(frame: np.ndarray, waveform: np.ndarray, window: Dict,
                sr: int = 22050, youtube_id: str = "", title: str = "",
                description: str = "", tags: str = "", encoder=None,
                log_mel: Optional[np.ndarray] = None, device="cuda") -> VideoChunk:
    """One window -> VideoChunk: the spectrogram of the (possibly
    fast-forwarded) waveform slice, and the words' BPE tokens with times
    relative to the window's start in playback seconds. ``log_mel`` [T, 64]
    is the window's ``window_log_mels`` when the caller computed it."""
    enc = encoder or get_tokenizer()
    speed = window["playback_speed"]
    if log_mel is None:
        log_mel = window_log_mels(window_waveform(waveform, window, sr)[None], speed, sr,
                                  device)[0]
    spec_jpeg, magic = quantize_spectrogram(log_mel.T)  # stored [num_mels, T]

    tok_ids, tok_starts, tok_ends = [], [], []
    for w in window["words"]:
        ids = enc.encode(" " + w["word"]).ids
        rel_s = (w["start"] - window["start_time"]) / speed
        rel_e = (w["end"] - window["start_time"]) / speed
        for tid in ids:
            tok_ids.append(tid)
            tok_starts.append(rel_s)
            tok_ends.append(rel_e)

    return VideoChunk(
        frame_jpeg=resize_image_for_storage(frame),
        spectrogram_jpeg=spec_jpeg,
        magic_number=magic,
        tok_ids=tok_ids,
        tok_start_times=tok_starts,
        tok_end_times=tok_ends,
        start_time=window["start_time"],
        end_time=window["end_time"],
        playback_speed=speed,
        youtube_id=youtube_id,
        title_toks=enc.encode(title).ids if title else [],
        description_toks=enc.encode(description).ids if description else [],
        tags_toks=enc.encode(tags).ids if tags else [],
    )


def pack_chunks(video_chunks: Iterator[List[VideoChunk]],
                group_size: int = 16) -> Iterator[List[VideoChunk]]:
    """Pack per-video chunk lists into groups of exactly ``group_size``
    segments; short videos share a record (process.py:506-578, simplified
    buffer heuristics). A remainder below ``group_size`` is dropped."""
    buffer: List[List[VideoChunk]] = []
    buffered = 0
    for chunks in video_chunks:
        while len(chunks) >= group_size:
            yield chunks[:group_size]
            chunks = chunks[group_size:]
        if chunks:
            buffer.append(chunks)
            buffered += len(chunks)
        while buffered >= group_size:
            group: List[VideoChunk] = []
            rest: List[List[VideoChunk]] = []
            for b in buffer:
                take = min(group_size - len(group), len(b))
                group.extend(b[:take])
                if take < len(b):
                    rest.append(b[take:])
            buffer = rest
            buffered = sum(len(b) for b in buffer)
            yield group


def chunks_to_record(group: List[VideoChunk], random_texts: Sequence[Sequence[int]],
                     group_size: int = 16) -> bytes:
    """``group_size`` chunks and per-segment raw-text token blobs -> one
    tf.Example in the pretraining schema."""
    if len(group) != group_size:
        raise ValueError(f"a record holds {group_size} chunks, got {len(group)}")
    # video_src_index: consecutive chunks of one video share an index
    src_idx = []
    current = 0
    last_id = None
    for c in group:
        if c.youtube_id != last_id:
            current += 1
            last_id = c.youtube_id
        src_idx.append(current)

    feats: Dict[str, bytes] = {}
    for i, (c, s) in enumerate(zip(group, src_idx)):
        p = f"c{i:02d}/"
        rt = list(random_texts[i]) if i < len(random_texts) else []
        feats.update({
            p + "image/encoded": T.bytes_feature([c.frame_jpeg]),
            p + "image/format": T.bytes_feature([b"jpeg"]),
            p + "image/key/sha256": T.bytes_feature([b""]),
            p + "image/height": T.int64_feature([0]),
            p + "image/width": T.int64_feature([0]),
            p + "spectrogram/encoded": T.bytes_feature([c.spectrogram_jpeg]),
            p + "spectrogram/format": T.bytes_feature([b"jpeg"]),
            p + "spectrogram/key/sha256": T.bytes_feature([b""]),
            p + "spectrogram/height": T.int64_feature([64]),
            p + "spectrogram/width": T.int64_feature([188]),
            p + "spectrogram/magic_number": T.float_feature([c.magic_number]),
            p + "youtube_id": T.bytes_feature([c.youtube_id.encode()]),
            p + "video_src_index": T.int64_feature([s]),
            p + "title": T.int64_feature(c.title_toks),
            p + "tags": T.int64_feature(c.tags_toks),
            p + "description": T.int64_feature(c.description_toks),
            p + "meta": T.bytes_feature([c.meta]),
            p + "playback_speed": T.int64_feature([c.playback_speed]),
            p + "start_time": T.float_feature([c.start_time]),
            p + "end_time": T.float_feature([c.end_time]),
            p + "tok_ids": T.int64_feature(c.tok_ids),
            p + "tok_start_times": T.float_feature(c.tok_start_times),
            p + "tok_end_times": T.float_feature(c.tok_end_times),
            p + "random_text": T.int64_feature(rt),
        })
    return T.encode_example(feats)


def process_video_arrays(frames: np.ndarray, waveform: np.ndarray,
                         words: List[Dict], duration: float,
                         youtube_id: str = "", sr: int = 22050,
                         fix_asr_timing: bool = False, device="cuda",
                         **meta_kw) -> List[VideoChunk]:
    """The whole per-video path: (frames at the windows, PCM, timed words)
    -> chunks. ``frames`` align 1:1 with the windows ``split_into_windows``
    gives (callers that decode lazily call it first). The log-mels run on
    ``device``, one call per playback speed present."""
    device = resolve_device(device)
    if fix_asr_timing:
        words = apply_offsets(words)
    windows = split_into_windows(words, duration)
    if len(frames) < len(windows):
        raise ValueError(f"{len(windows)} windows but {len(frames)} frames: "
                         "need one frame per window")
    log_mels: Dict[int, np.ndarray] = {}
    for speed in sorted({w["playback_speed"] for w in windows}):
        idx = [i for i, w in enumerate(windows) if w["playback_speed"] == speed]
        wavs = np.stack([window_waveform(waveform, windows[i], sr) for i in idx])
        log_mels.update(zip(idx, window_log_mels(wavs, speed, sr, device)))
    return [build_chunk(frames[i], waveform, w, sr=sr, youtube_id=youtube_id,
                        log_mel=log_mels[i], device=device, **meta_kw)
            for i, w in enumerate(windows)]
