"""Video quality filters and ASR alignment for dataset creation.

The port's copy of ``merlot_reserve_tpu/dataset_creation/filters.py``:
the static-video filter (mean pairwise cosine of frame embeddings, reference
data/process.py:580-691), the expected-COCO-object filter, and the
edit-distance DTW alignment that moves ASR word times onto cleaned text
(data/video_utils.py:140-184). ``frame_embedder`` is any callable
[N, H, W, 3] uint8 -> [N, D]: ``frame_embedder.MobileNetV2Embedder`` (the
reference's network, on the card) or the cheap ``pixel_embedder``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def pixel_embedder(frames: np.ndarray, size: int = 16) -> np.ndarray:
    """Cheap default frame embedding: bilinear-ish downsample + flatten."""
    n, h, w, c = frames.shape
    ys = (np.arange(size) * (h / size)).astype(int)
    xs = (np.arange(size) * (w / size)).astype(int)
    small = frames[:, ys][:, :, xs].astype(np.float32) / 255.0
    emb = small.reshape(n, -1)
    emb -= emb.mean(axis=1, keepdims=True)
    return emb


def mean_pairwise_cosine(embs: np.ndarray) -> float:
    normed = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
    sim = normed @ normed.T
    n = len(embs)
    return float((sim.sum() - n) / max(n * (n - 1), 1))


def is_static_video(frames: np.ndarray, threshold: float = 0.85,
                    frame_embedder: Optional[Callable] = None) -> bool:
    """True when average pairwise frame similarity >= threshold — the
    reference drops these (process.py:670-686: avg cosine < 0.85 passes)."""
    embedder = frame_embedder or pixel_embedder
    if len(frames) < 2:
        return False
    return mean_pairwise_cosine(embedder(frames)) >= threshold


def passes_object_filter(object_counts: Optional[Sequence[float]],
                         min_expected: float = 1.0) -> bool:
    """Expected #objects per frame >= 1 (process.py:687-691). Counts come
    from any detector; None (no detector available) passes everything."""
    if object_counts is None:
        return True
    return float(np.mean(object_counts)) >= min_expected


# ---------------------------------------------------------------------------
# edit-distance DTW alignment (video_utils.py:140-184)
# ---------------------------------------------------------------------------


def edit_distance(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def align_using_dtw(source_words: List[str], target_words: List[str]
                    ) -> List[Tuple[int, int]]:
    """Monotonic alignment between two word streams minimizing total
    normalized edit distance (DTW over the cost matrix). Returns (i, j)
    index pairs along the warping path."""
    n, m = len(source_words), len(target_words)
    if n == 0 or m == 0:
        return []
    cost = np.zeros((n, m))
    for i, sw in enumerate(source_words):
        for j, tw in enumerate(target_words):
            denom = max(len(sw), len(tw), 1)
            cost[i, j] = edit_distance(sw.lower(), tw.lower()) / denom

    acc = np.full((n, m), np.inf)
    acc[0, 0] = cost[0, 0]
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                continue
            best = np.inf
            if i > 0:
                best = min(best, acc[i - 1, j])
            if j > 0:
                best = min(best, acc[i, j - 1])
            if i > 0 and j > 0:
                best = min(best, acc[i - 1, j - 1])
            acc[i, j] = cost[i, j] + best

    path = []
    i, j = n - 1, m - 1
    while True:
        path.append((i, j))
        if i == 0 and j == 0:
            break
        candidates = []
        if i > 0 and j > 0:
            candidates.append((acc[i - 1, j - 1], i - 1, j - 1))
        if i > 0:
            candidates.append((acc[i - 1, j], i - 1, j))
        if j > 0:
            candidates.append((acc[i, j - 1], i, j - 1))
        _, i, j = min(candidates)
    return path[::-1]


def transfer_timestamps(source: List[Dict], target_words: List[str]
                        ) -> List[Dict]:
    """Give ``target_words`` timestamps by DTW-aligning against timed
    ``source`` words [{'word','start','end'}] (the ASR->cleaned-text timing
    transfer, video_utils.py:140-184)."""
    path = align_using_dtw([w["word"] for w in source], target_words)
    out: List[Optional[Dict]] = [None] * len(target_words)
    for i, j in path:
        if out[j] is None:
            out[j] = {"word": target_words[j], "start": source[i]["start"],
                      "end": source[i]["end"]}
        else:
            out[j]["end"] = source[i]["end"]
    return [w for w in out if w is not None]
