"""Finetuning and zero-shot data: VCR and TVQA records to numpy batches,
the port of ``merlot_reserve_tpu/finetune/data.py``.

Record schemas:
  * VCR: pre-rendered normal and left-right-flipped JPEGs with drawn boxes;
    qa_ and qar_ query, 4 choices and a label each;
  * TVQA: 7 frames (JPEG), each with a [3, 60, 65] spectrogram (one
    grayscale JPEG, quantized by the record's magic number) and subtitle
    tokens; one query, 5 choices and a label.

JPEGs are decoded by the port's native library (``data/native.py``: libjpeg,
or nvJPEG where libjpeg is absent), and frames become patches through its
bilinear resize with no jitter: the eval geometry of the JAX package's
``host_image_to_patches`` (aspect-preserving resize into the grid box, zero
pad, patchify). The preprocessors draw from the numpy ``Generator`` in the
JAX package's order, so the same seed gives the same flips and audio
jitter.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator, List, Optional

import numpy as np

from merlot_reserve_tpu_torch.config import MerlotConfig
from merlot_reserve_tpu_torch.data import native as N
from merlot_reserve_tpu_torch.data.tfrecord import parse_example, read_records
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, MASK, PADDING, get_tokenizer


@functools.lru_cache(maxsize=None)
def _separator(text: str) -> tuple:
    """The token ids of ``text`` (a fixed separator such as "answer: ")."""
    return tuple(get_tokenizer().encode(text).ids)


def _img_to_patches(data: bytes, cfg: MerlotConfig) -> np.ndarray:
    """JPEG bytes -> [grid_h * grid_w, 768] patches in [0, 1] (bilinear, no jitter)."""
    rgb = N.decode_jpeg_native(data, channels=3)
    return N.resize_patchify_native(rgb, tuple(cfg.model.output_grid), N.BILINEAR)


def _pad_to(x, length: int, pad_value: int = 0) -> np.ndarray:
    x = np.asarray(x, np.int32)[:length]
    out = np.full(length, pad_value, np.int32)
    out[:len(x)] = x
    return out


def _ending_in_mask(tokens: np.ndarray, lang_len: int) -> np.ndarray:
    """``tokens`` cut to ``lang_len - 1`` with MASK appended."""
    return np.concatenate([tokens[:lang_len - 1], [MASK]])


def _stream(first: np.ndarray, rows: List[np.ndarray], lang_len: int) -> np.ndarray:
    """[lang_len, 2] (token, segment): ``first`` then each row, the row's
    index as its segment id, cut or zero-padded to ``lang_len``."""
    rows = [first] + rows
    toks = np.concatenate(rows)
    seg = np.repeat(np.arange(len(rows)), [len(r) for r in rows])
    out = np.stack([toks, seg], -1).astype(np.int32)[:lang_len]
    pad = np.zeros((lang_len - len(out), 2), np.int32)
    return np.concatenate([out, pad], 0)


# ---------------------------------------------------------------------------
# VCR
# ---------------------------------------------------------------------------


def preprocess_vcr(raw: Dict, cfg: MerlotConfig, rng: np.random.Generator,
                   num_answers: int = 4, is_training: bool = True) -> Dict:
    """QA and QA->R jointly: ``answers`` [2, num_answers, lang_seq_len],
    each option ending in MASK; ``labels`` [2]. In training the flipped
    image is taken with probability 1/2."""
    lang_len = cfg.data.lang_seq_len
    img_key = "image"
    # the draw happens whenever is_training, as in the JAX package
    if is_training and rng.uniform() < 0.5 and "image_fliplr" in raw:
        img_key = "image_fliplr"
    image = _img_to_patches(bytes(raw[img_key][0]), cfg)

    sep = {"qa": _separator("answer: "), "qar": _separator("rationale: ")}
    answers = []
    for prefix in ("qa", "qar"):
        query = np.asarray(raw[f"{prefix}_query"], np.int64)
        for i in range(num_answers):
            choice = np.asarray(raw[f"{prefix}_choice_{i}"], np.int64)
            option = np.concatenate([query, sep[prefix], choice])
            answers.append(_pad_to(_ending_in_mask(option, lang_len), lang_len))
    return {
        "image": image,
        "answers": np.stack(answers).reshape(2, num_answers, lang_len),
        "labels": np.asarray([int(raw["qa_label"][0]), int(raw["qar_label"][0])], np.int32),
    }


# ---------------------------------------------------------------------------
# TVQA
# ---------------------------------------------------------------------------


def _tvqa_context(raw: Dict, cfg: MerlotConfig, num_segments: int):
    """(frames [S, P, 768], spectrograms [S, 3, 60, 65] f32 / magic number,
    number of valid frames)."""
    images = np.stack([_img_to_patches(bytes(raw[f"c{i:02d}/image_encoded"][0]), cfg)
                       for i in range(num_segments)])
    magic = float(np.asarray(raw["magic_number"]).reshape(-1)[0])
    audio = np.stack([N.decode_jpeg_native(bytes(raw[f"c{i:02d}/spec_encoded"][0]), channels=1)
                      for i in range(num_segments)])
    audio = audio.reshape(num_segments, 3, 60, 65).astype(np.float32) / magic
    num_frames = int(np.asarray(raw.get("num_frames", [num_segments])).reshape(-1)[0])
    return images, audio, num_frames


def preprocess_tvqa(raw: Dict, cfg: MerlotConfig, rng: np.random.Generator,
                    num_answers: int = 5, num_segments: int = 7,
                    is_training: bool = True) -> Dict:
    """7 frames, their audio and subtitles -> two parallel streams per
    answer (subtitles as text, audio as AUDIOSPAN runs), each [lang_seq_len,
    2] (token, segment). In training the audio is jittered: the valid windows
    re-padded with noise of the mel statistics and shifted by a random
    offset."""
    lang_len = cfg.data.lang_seq_len
    atl = cfg.model.audio_token_length
    images, audio, num_frames = _tvqa_context(raw, cfg, num_segments)

    query = np.concatenate([np.asarray(raw["qa_query"], np.int64), _separator("answer: ")])
    subs = [np.asarray(raw[f"c{i:02d}/sub"], np.int64) for i in range(num_segments)]
    audio_full = np.full(3 * atl, AUDIOSPAN, np.int64)
    textonly_seqs, audio_seqs = [], []
    for i in range(num_answers):
        choice = np.asarray(raw[f"qa_choice_{i}"], np.int64)
        option = _ending_in_mask(np.concatenate([query, choice]), lang_len)
        textonly_seqs.append(_stream(option, subs, lang_len))
        audio_seqs.append(_stream(option, [audio_full] * num_segments, lang_len))

    frame_valid = np.arange(num_segments) < num_frames
    features = {
        "images": images * frame_valid[:, None, None],
        "audio_clips": audio,
        "textonly_seqs": np.stack(textonly_seqs),
        "audio_seqs": np.stack(audio_seqs),
        "labels": np.asarray(int(raw["qa_label"][0]), np.int32),
    }
    if is_training:
        ac = features["audio_clips"]
        old_shape = ac.shape
        old_nwindow = old_shape[0] * old_shape[1] * old_shape[2]
        num_mels = old_shape[3]
        giant = ac[:num_frames].reshape(-1, num_mels)
        avg, std = giant.mean(0), giant.std(0)
        start = rng.normal(avg, std, (4, num_mels))
        end = rng.normal(avg, std, (4 + (old_nwindow - len(giant)), num_mels))
        seq = np.concatenate([start, giant, end], 0)
        s = int(rng.integers(0, 5))
        features["audio_clips"] = seq[s:s + old_nwindow].reshape(old_shape).astype(np.float32)

    features["audio_clips"] = features["audio_clips"] * frame_valid[:, None, None, None]
    # the playback-speed channel is always exactly 1
    features["audio_clips"][..., -1] = 1.0
    return features


# ---------------------------------------------------------------------------
# zero-shot variants: MASK in the answer slot, the choices as a span table
# ---------------------------------------------------------------------------


def _answer_table(raw: Dict, prefix: str, num_answers: int, span_len: int) -> np.ndarray:
    """[num_answers, span_len] candidate tokens for the span encoder, padded
    with PADDING: the question's label space."""
    return np.stack([_pad_to(np.asarray(raw[f"{prefix}_choice_{i}"], np.int64), span_len,
                             pad_value=PADDING)
                     for i in range(num_answers)])


def preprocess_vcr_zero_shot(raw: Dict, cfg: MerlotConfig, rng: np.random.Generator,
                             num_answers: int = 4, is_training: bool = False) -> Dict:
    """Zero-shot VCR: per task one statement ending in MASK (the answer
    slot); the choices become the label space. ``statements`` [2,
    lang_seq_len], ``answers`` [2, num_answers, span_len]."""
    lang_len = cfg.data.lang_seq_len
    span_len = cfg.model.text_span_length
    image = _img_to_patches(bytes(raw["image"][0]), cfg)
    sep = {"qa": _separator("answer: "), "qar": _separator("rationale: ")}
    statements, answers = [], []
    for prefix in ("qa", "qar"):
        stmt = np.concatenate([np.asarray(raw[f"{prefix}_query"], np.int64), sep[prefix]])
        statements.append(_pad_to(_ending_in_mask(stmt, lang_len), lang_len))
        answers.append(_answer_table(raw, prefix, num_answers, span_len))
    return {
        "image": image,
        "statements": np.stack(statements),
        "answers": np.stack(answers),
        "labels": np.asarray([int(raw["qa_label"][0]), int(raw["qar_label"][0])], np.int32),
    }


def preprocess_tvqa_zero_shot(raw: Dict, cfg: MerlotConfig, rng: np.random.Generator,
                              num_answers: int = 5, num_segments: int = 7,
                              is_training: bool = False) -> Dict:
    """Zero-shot TVQA: one statement sequence per stream (question,
    'answer:', MASK, then the subtitle or AUDIOSPAN rows), and the 5 choices
    as a span table. The context (frames, spectrograms, frame validity,
    playback channel) is ``preprocess_tvqa``'s without jitter."""
    lang_len = cfg.data.lang_seq_len
    atl = cfg.model.audio_token_length
    span_len = cfg.model.text_span_length
    # num_answers=1: the context decode without the per-answer sequences
    ctx = preprocess_tvqa(raw, cfg, rng, num_answers=1, num_segments=num_segments,
                          is_training=False)
    statement = np.concatenate([np.asarray(raw["qa_query"], np.int64), _separator("answer: ")])
    statement = _ending_in_mask(statement, lang_len)
    subs = [np.asarray(raw[f"c{i:02d}/sub"], np.int64) for i in range(num_segments)]
    audio_full = np.full(3 * atl, AUDIOSPAN, np.int64)
    return {
        "images": ctx["images"],
        "audio_clips": ctx["audio_clips"],
        # one MASK statement per stream: the finetune layout with 1 answer
        "textonly_seqs": _stream(statement, subs, lang_len)[None],
        "audio_seqs": _stream(statement, [audio_full] * num_segments, lang_len)[None],
        "answers": _answer_table(raw, "qa", num_answers, span_len),
        "labels": ctx["labels"],
    }


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

PREPROCESSORS = {"vcr": preprocess_vcr, "tvqa": preprocess_tvqa,
                 "vcr_zero_shot": preprocess_vcr_zero_shot,
                 "tvqa_zero_shot": preprocess_tvqa_zero_shot}


def finetune_batches(file_paths: List[str], cfg: MerlotConfig, task: str, batch_size: int,
                     seed: Optional[int] = 0, is_training: bool = True, repeat: bool = True,
                     return_ids: bool = False) -> Iterator:
    """Collated numpy batches for ``task`` (a key of ``PREPROCESSORS``),
    reading the files in order, one ``Generator(seed)`` for every draw. With
    ``return_ids`` yields ``(ids, batch)``; without ``repeat`` the last
    partial batch is filled with copies of its first example, whose ids are
    'pad'."""
    prep = PREPROCESSORS[task]
    rng = np.random.default_rng(seed)

    def emit(examples, ids):
        batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
        return (ids, batch) if return_ids else batch

    while True:
        examples, ids = [], []
        for path in file_paths:
            for record in read_records(path):
                raw = parse_example(record)
                ids.append(bytes(raw.get("id", [b""])[0]).decode() or "?")
                examples.append(prep(raw, cfg, rng, is_training=is_training))
                if len(examples) == batch_size:
                    yield emit(examples, ids)
                    examples, ids = [], []
        if not repeat:
            if examples:
                while len(examples) < batch_size:
                    examples.append(examples[0])
                    ids.append("pad")
                yield emit(examples, ids)
            return
