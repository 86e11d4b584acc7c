"""ASR word-timing offset model: a numpy MLP with two hidden layers of 32
that predicts per-word start and end corrections from character, BPE,
vowel and punctuation features (reference data/offset_model/model.py, its
weights file format). YouTube's ASR word timings lag the audio; this fixes
them before words are assigned to windows.

The port's copy of ``merlot_reserve_tpu/dataset_creation/offset_model.py``.
It stays numpy on the host: a 32-wide MLP over a handful of features. The
trained weights are ``offset_model_params.json`` next to this module (a
copy of the JAX package's).
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Dict, List

import numpy as np

HIDDEN_SIZE = 32

FEATURE_NAMES = ["charlen", "bpelen", "is_upper", "chunklen", "num_vowels", "num_punct"]

PARAMS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "offset_model_params.json")


def _count_vowels(word: str) -> int:
    return len(re.findall(r"a|e|i|o|u", word.lower()))


def _count_punct(word: str) -> int:
    return len(re.findall(r"\W", word.lower()))


def compute_features(words: List[Dict]) -> np.ndarray:
    """words [{'word', 'start', 'end', 'encoded' (BPE ids)}] -> [N, 18]
    features: each base feature and its left and right neighbours' copies,
    in the trained weights' column order."""
    base = {
        "charlen": np.asarray([len(w["word"]) for w in words], np.float32),
        "bpelen": np.asarray([len(w.get("encoded", [])) for w in words], np.float32),
        "is_upper": np.asarray([w["word"][:1].isupper() for w in words], np.float32),
        "chunklen": np.asarray([w["end"] - w["start"] for w in words], np.float32),
        "num_vowels": np.asarray([_count_vowels(w["word"]) for w in words], np.float32),
        "num_punct": np.asarray([_count_punct(w["word"]) for w in words], np.float32),
    }
    defaults = {"charlen": 1.0, "bpelen": 0.0, "is_upper": 0.0, "chunklen": 0.1,
                "num_vowels": 0.0, "num_punct": 0.0}
    cols = []
    for name in FEATURE_NAMES:
        x = base[name]
        left = np.concatenate([[defaults[name]], x[:-1]])
        right = np.concatenate([x[1:], [defaults[name]]])
        cols.extend([x, left, right])
    return np.stack(cols, axis=1)


@lru_cache(maxsize=1)
def _load_params():
    with open(PARAMS_FILE) as f:
        raw = json.load(f)
    n_feats = 3 * len(FEATURE_NAMES)
    return {
        "mean": np.asarray(raw["mean"], np.float32),
        "std": np.asarray(raw["std"], np.float32),
        "w0": np.asarray(raw["mapping.0.weight"], np.float32).reshape(HIDDEN_SIZE, n_feats),
        "b0": np.asarray(raw["mapping.0.bias"], np.float32),
        "w1": np.asarray(raw["mapping.2.weight"], np.float32).reshape(HIDDEN_SIZE, HIDDEN_SIZE),
        "b1": np.asarray(raw["mapping.2.bias"], np.float32),
        "w2": np.asarray(raw["mapping.4.weight"], np.float32).reshape(2, HIDDEN_SIZE),
        "b2": np.asarray(raw["mapping.4.bias"], np.float32),
        "temperature": np.exp(np.asarray(raw["temp"], np.float32)),
        "bias": np.asarray(raw["bias"], np.float32),
    }


def predict_offsets(words: List[Dict]) -> np.ndarray:
    """-> [N, 2] corrections to add to the (start, end) times."""
    p = _load_params()
    feats = (compute_features(words) - p["mean"][None]) / p["std"][None]
    h0 = np.maximum(feats @ p["w0"].T + p["b0"][None], 0.0)
    h1 = np.maximum(h0 @ p["w1"].T + p["b1"][None], 0.0)
    preds = h1 @ p["w2"].T + p["b2"][None]
    return np.tanh(preds) * p["temperature"] + p["bias"]


def apply_offsets(words: List[Dict]) -> List[Dict]:
    """The words with corrected start and end times."""
    if not words:
        return words
    offsets = predict_offsets(words)
    out = []
    for w, (ds, de) in zip(words, offsets):
        w = dict(w)
        w["start"] = float(w["start"] + ds)
        w["end"] = float(w["end"] + de)
        out.append(w)
    return out
