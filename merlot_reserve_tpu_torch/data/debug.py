"""Dataloader debug harness (the port's copy of
``merlot_reserve_tpu/data/debug.py``) — the reference's masking-tuning tooling
(reference pretrain/dataloader.py:792-861,962-1116): decode batches to
readable text, span-length histograms, and KL divergence between the
text2audio / audio2text / random_text span-length distributions (the
heuristics were tuned by minimizing exactly this KL).

Run as a module for a corpus report:
    python -m merlot_reserve_tpu_torch.data.debug CORPUS.tfrecord [config]
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np

from merlot_reserve_tpu_torch.tokenizer import (
    AUDIOSPAN,
    LTOVPOOL,
    MASK,
    MASKAUDIO,
    PADDING,
    decode,
)

_SPECIAL = {PADDING: "<PAD>", MASK: "<MASK>", MASKAUDIO: "<MASKAUDIO>",
            AUDIOSPAN: "<AUDIO>", LTOVPOOL: "<POOL>"}


def tokens_to_readable(tokens: np.ndarray, audio_ptr: Optional[np.ndarray] = None,
                       text_ptr: Optional[np.ndarray] = None) -> str:
    """[L] tokens (+pointers) -> one readable line, collapsing AUDIOSPAN runs
    (the _debug_print_tokens surface)."""
    parts: List[str] = []
    buf: List[int] = []
    i = 0
    L = len(tokens)
    while i < L:
        t = int(tokens[i])
        if t == AUDIOSPAN:
            run = 0
            ptr = int(audio_ptr[i]) if audio_ptr is not None else -1
            while i < L and int(tokens[i]) == AUDIOSPAN:
                run += 1
                i += 1
            parts.append(f"<AUDIO x{run}@{ptr}>")
            continue
        if t in _SPECIAL:
            if buf:
                parts.append(decode(buf))
                buf = []
            tag = _SPECIAL[t]
            if t == MASK and text_ptr is not None:
                tag = f"<MASK->{int(text_ptr[i])}>"
            if t != PADDING:
                parts.append(tag)
        else:
            buf.append(t)
        i += 1
    if buf:
        parts.append(decode(buf))
    return " ".join(parts)


def span_length_histogram(text_spans: np.ndarray) -> Counter:
    """[N, span_len] padded span table -> Counter{length: count} over
    non-empty spans."""
    lengths = (np.asarray(text_spans) != PADDING).sum(-1)
    return Counter(int(x) for x in lengths if x > 0)


def kl_divergence(hist_p: Counter, hist_q: Counter, max_len: int = 15,
                  eps: float = 1e-6) -> float:
    """KL(p || q) between two span-length histograms."""
    p = np.asarray([hist_p.get(i, 0) for i in range(1, max_len + 1)], np.float64)
    q = np.asarray([hist_q.get(i, 0) for i in range(1, max_len + 1)], np.float64)
    p = (p + eps) / (p + eps).sum()
    q = (q + eps) / (q + eps).sum()
    return float((p * np.log(p / q)).sum())


def stream_span_histograms(examples: Iterable[Dict]) -> Dict[str, Counter]:
    """Per-stream span-length histograms over examples: a span belongs to the
    stream whose MASK text_ptr references it."""
    hists = {"text2audio": Counter(), "audio2text": Counter(),
             "random_text": Counter()}
    for ex in examples:
        spans = np.asarray(ex["text_spans"])
        lengths = (spans != PADDING).sum(-1)
        for stream in hists:
            triple = np.asarray(ex[stream]).reshape(-1, 3)
            ptrs = triple[triple[:, 0] == MASK, 2]
            for p in np.unique(ptrs[ptrs >= 0]):
                if p < len(lengths) and lengths[p] > 0:
                    hists[stream][int(lengths[p])] += 1
    return hists


def corpus_report(examples: Iterable[Dict], n_print: int = 2) -> Dict:
    """Aggregate masking statistics + pairwise stream KLs; prints a summary."""
    examples = list(examples)
    hists = stream_span_histograms(examples)
    report = {"num_examples": len(examples)}
    for k, h in hists.items():
        total = sum(h.values())
        mean = (sum(l * c for l, c in h.items()) / total) if total else 0.0
        report[f"{k}/num_spans"] = total
        report[f"{k}/mean_len"] = round(mean, 3)
    for a, b in [("text2audio", "audio2text"), ("text2audio", "random_text"),
                 ("audio2text", "random_text")]:
        report[f"kl({a}||{b})"] = round(kl_divergence(hists[a], hists[b]), 4)

    for ex in examples[:n_print]:
        t2a = np.asarray(ex["text2audio"]).reshape(-1, 3)
        print("text2audio:", tokens_to_readable(t2a[:, 0], t2a[:, 1], t2a[:, 2])[:400])
    for k, v in sorted(report.items()):
        print(f"{k}: {v}")
    return report


def _main():
    import sys

    import merlot_reserve_tpu_torch as mr
    from merlot_reserve_tpu_torch.data.pretrain_pipeline import pretrain_examples_from_file

    corpus = sys.argv[1]
    cfg = mr.load_config(sys.argv[2] if len(sys.argv) > 2 else "base")
    corpus_report(pretrain_examples_from_file(corpus, cfg))


if __name__ == "__main__":
    _main()
