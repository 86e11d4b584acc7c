"""Raw-text corpus for the random_text stream (reference
data/process.py:597-668, The Pile with a source whitelist): stream jsonl
shards, filter by source, clean, tokenize with the port's BPE and emit
fixed-size token blobs, one per record segment. The port's copy of
``merlot_reserve_tpu/dataset_creation/text_corpus.py``."""

from __future__ import annotations

import gzip
import json
from typing import Iterator, List, Optional, Sequence

import numpy as np

from merlot_reserve_tpu_torch.dataset_creation.text import clean_text
from merlot_reserve_tpu_torch.tokenizer import get_tokenizer

DEFAULT_SOURCE_WHITELIST = (
    "Pile-CC", "OpenWebText2", "Books3", "BookCorpus2", "Wikipedia (en)",
)


def iter_text_documents(paths: Sequence[str],
                        source_whitelist: Optional[Sequence[str]] = DEFAULT_SOURCE_WHITELIST
                        ) -> Iterator[str]:
    """Documents from jsonl(.gz) shards in The Pile's layout
    ({'text': ..., 'meta': {'pile_set_name': ...}}) or plain {'text': ...};
    lines that are not JSON are skipped."""
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            for line in f:
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue
                src = (doc.get("meta") or {}).get("pile_set_name")
                if source_whitelist and src and src not in source_whitelist:
                    continue
                text = doc.get("text", "")
                if text:
                    yield text


def token_blob_iterator(paths: Sequence[str], blob_len: int = 1216, encoder=None,
                        source_whitelist: Optional[Sequence[str]] = DEFAULT_SOURCE_WHITELIST,
                        clean: bool = True) -> Iterator[np.ndarray]:
    """int32 token blobs of exactly ``blob_len``, spanning documents, sized
    so that the builder's fake segments have headroom (seq_len plus span
    slack; reference dataloader.py:400-446)."""
    enc = encoder or get_tokenizer()
    buf: List[int] = []
    for text in iter_text_documents(paths, source_whitelist):
        if clean:
            text = clean_text(text)
        buf.extend(enc.encode(text).ids)
        while len(buf) >= blob_len:
            yield np.asarray(buf[:blob_len], np.int32)
            buf = buf[blob_len:]
