"""The 32768-token lowercase byte-level BPE the checkpoints were trained
with, in pure Python, and the special-token ids.

The special ids are baked into the released checkpoints' embedding tables,
so they are part of the compatibility surface. The vocab file
``lowercase_encoder.json`` next to this module is a HuggingFace
``tokenizers`` dump; this module reads it and encodes as that library does
(which the port does not need), stage by stage:

1. the added tokens ``<|PAD|>`` ... (ids 0-9, ``normalized: false``) are
   matched in the raw text first, longest first, and split it;
2. each other piece goes through the ``BertNormalizer``: drop NUL, U+FFFD
   and control characters (categories Cc, Cf, Co, Cs, but not tab, newline
   or carriage return), map whitespace to a space, put spaces around CJK
   ideographs, NFD and drop nonspacing marks (Mn), lowercase each character;
3. the ``ByteLevel`` pre-tokenizer: a space in front unless the piece starts
   with one, then the GPT-2 split
   ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
   and each UTF-8 byte as one of 256 printable characters;
4. BPE by merge rank over the bytes that are in the vocab (the others are
   dropped before merging, as the library does without an unk token).

Python's ``re`` has no ``\\p{L}`` or ``\\p{N}``, so the split is built with
character classes drawn from ``unicodedata`` (the letters L*, the numbers
N* including superscripts and fractions, and Unicode's White_Space).

The library's Unicode tables are of other releases than Python's
``unicodedata``; the tables below the special ids list where they differ,
so every code point encodes as the library encodes it.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PADDING = 0
START = 1
END = 2
MASK = 3
MASKAUDIO = 4
AUDIOSPAN = 5
LTOVPOOL = 6
RESETCTX = 9

PAD_TOKEN = "<|PAD|>"
SPECIAL_TOKENS = (
    ["<|PAD|>", "<|START|>", "<|END|>", "<|MASK|>", "<|MASKAUDIO|>",
     "<|AUDIOSPAN|>", "<|LTOVPOOL|>"]
    + [f"<|unused{i}|>" for i in range(3)]
)

_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lowercase_encoder.json")

# Where the library's Unicode tables (tokenizers 0.22.2) differ from
# Python 3.12's unicodedata (Unicode 15.0): its normalizer's categories are
# Unicode 8.0's, its NFD 9.0's, its lowercase and its \p{L}, \p{N} newer
# (16.0 and later). Each table lists (first, last) code points. Found by
# running every code point, and every pair of combining marks, through
# both (tests/test_torch_tokenizer.py). Another unicodedata would need
# other tables, so the tokenizer refuses to load under one.
_UNICODE_VERSION = "15.0.0"
# Cf and Mn since Unicode 8.0: the library's normalizer keeps them
_KEPT_SINCE_8 = (
    (0x7FD, 0x7FD), (0x890, 0x891), (0x898, 0x89F), (0x8CA, 0x8E2), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C), (0xD00, 0xD00),
    (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA), (0xECE, 0xECE), (0x180F, 0x180F),
    (0x1885, 0x1886), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFB), (0xA82C, 0xA82C),
    (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF), (0xA9BD, 0xA9BD), (0x10D24, 0x10D27),
    (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2), (0x110CD, 0x110CD),
    (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E), (0x11241, 0x11241),
    (0x1133B, 0x1133B), (0x11438, 0x1143F), (0x11442, 0x11444), (0x11446, 0x11446),
    (0x1145E, 0x1145E), (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C),
    (0x1193E, 0x1193E), (0x11943, 0x11943), (0x119D4, 0x119D7), (0x119DA, 0x119DB),
    (0x119E0, 0x119E0), (0x11A01, 0x11A0A), (0x11A33, 0x11A38), (0x11A3B, 0x11A3E),
    (0x11A47, 0x11A47), (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96),
    (0x11A98, 0x11A99), (0x11C30, 0x11C36), (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F),
    (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6),
    (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45),
    (0x11D47, 0x11D47), (0x11D90, 0x11D91), (0x11D95, 0x11D95), (0x11D97, 0x11D97),
    (0x11EF3, 0x11EF4), (0x11F00, 0x11F01), (0x11F36, 0x11F3A), (0x11F40, 0x11F40),
    (0x11F42, 0x11F42), (0x13430, 0x13440), (0x13447, 0x13455), (0x16F4F, 0x16F4F),
    (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46), (0x1E000, 0x1E006),
    (0x1E008, 0x1E018), (0x1E01B, 0x1E021), (0x1E023, 0x1E024), (0x1E026, 0x1E02A),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF),
    (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A),
)
_MARK_IN_8 = "\u1734"  # Mc since Unicode 14.0, Mn before: stripped
_NOT_DECOMPOSED = "\U00011938"  # a canonical decomposition since Unicode 13.0
# a nonzero combining class since Unicode 10.0 (the library's NFD has 9.0's
# classes): starters there, so canonical ordering neither moves them nor
# crosses them
_CCC_SINCE_10 = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xC3C, 0xC3C),
    (0xD3B, 0xD3C), (0xEBA, 0xEBA), (0x1715, 0x1715), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA),
    (0xA82C, 0xA82C), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF),
    (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070), (0x1133B, 0x1133B),
    (0x1145E, 0x1145E), (0x11839, 0x1183A), (0x1193D, 0x1193E), (0x11943, 0x11943),
    (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99),
    (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97), (0x11F41, 0x11F42),
    (0x16FF0, 0x16FF1), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),
)
# upper case since Unicode 15.0 -> lower case; (first, last, offset)
_LOWER_SINCE_15 = ((0x1C89, 0x1C89, 1), (0xA7CB, 0xA7CB, 0x264 - 0xA7CB),
                   (0xA7CC, 0xA7CC, 1), (0xA7CE, 0xA7CE, 1), (0xA7D2, 0xA7D2, 1),
                   (0xA7D4, 0xA7D4, 1), (0xA7DA, 0xA7DA, 1), (0xA7DC, 0xA7DC, 0x19B - 0xA7DC),
                   (0x10D50, 0x10D65, 0x20), (0x16EA0, 0x16EB8, 0x1B))
# letters and numbers since Unicode 15.0, unassigned in Python's tables
_LETTERS_SINCE_15 = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
    (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
    (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
    (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D),
)
_NUMBERS_SINCE_15 = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
    (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),
)

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))

# Unicode's White_Space property (Rust's char::is_whitespace, Oniguruma's \s)
_WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680"
                         + "".join(map(chr, range(0x2000, 0x200B)))
                         + "\u2028\u2029\u202f\u205f\u3000")
_NO_MERGE = float("inf")


def vocab_path() -> str:
    if not os.path.exists(_VOCAB):
        raise FileNotFoundError(f"BPE vocab {_VOCAB} is missing from the package")
    return _VOCAB


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _in_ranges(cp: int, ranges) -> bool:
    return any(lo <= cp <= hi for lo, hi in ranges)


def _category(c: str) -> str:
    """The category the library's normalizer gives ``c``."""
    if c == _MARK_IN_8:
        return "Mn"
    cat = unicodedata.category(c)
    if cat in ("Cf", "Mn") and _in_ranges(ord(c), _KEPT_SINCE_8):
        return "Cn"
    return cat


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and _category(c) in ("Cc", "Cf", "Co", "Cs")


def _lower(c: str) -> str:
    cp = ord(c)
    for lo, hi, offset in _LOWER_SINCE_15:
        if lo <= cp <= hi:
            return chr(cp + offset)
    return c.lower()


@lru_cache(maxsize=1)
def _library_starters() -> Tuple[frozenset, "re.Pattern"]:
    """Characters the library's NFD neither decomposes nor reorders (its
    starters) where Python's does: ``_NOT_DECOMPOSED`` and
    ``_CCC_SINCE_10``. Canonical ordering does not cross a starter, so the
    text is normalized piece by piece between them."""
    starters = {_NOT_DECOMPOSED} | {chr(cp) for lo, hi in _CCC_SINCE_10
                                    for cp in range(lo, hi + 1)}
    return frozenset(starters), re.compile(f"([{''.join(map(re.escape, sorted(starters)))}])")


def _nfd(text: str) -> str:
    starters, split = _library_starters()
    if starters.isdisjoint(text):
        return unicodedata.normalize("NFD", text)
    parts = split.split(text)  # the starters at the odd places
    return "".join(part if i % 2 else unicodedata.normalize("NFD", part)
                   for i, part in enumerate(parts))


def normalize(text: str) -> str:
    """The ``BertNormalizer`` (clean_text, handle_chinese_chars,
    strip_accents, lowercase, in that order)."""
    out = []
    for c in text:
        if c in "\x00\ufffd" or _is_control(c):
            continue
        if c in _WHITE_SPACE:
            out.append(" ")
        elif _in_ranges(ord(c), _CJK_RANGES):
            out.append(f" {c} ")
        else:
            out.append(c)
    return "".join(_lower(c) for c in _nfd("".join(out)) if _category(c) != "Mn")


def _letter_and_number_classes() -> Tuple[str, str]:
    """Regex character class bodies of \\p{L} and \\p{N}, as ranges."""
    kinds = [unicodedata.category(chr(cp))[0] for cp in range(sys.maxunicode + 1)]
    for kind, since in (("L", _LETTERS_SINCE_15), ("N", _NUMBERS_SINCE_15)):
        for lo, hi in since:
            kinds[lo:hi + 1] = kind * (hi + 1 - lo)
    kinds = "".join(kinds)

    def ranges(kind):
        return "".join(
            re.escape(chr(m.start())) if m.end() - m.start() == 1
            else f"{re.escape(chr(m.start()))}-{re.escape(chr(m.end() - 1))}"
            for m in re.finditer(f"{kind}+", kinds))

    return ranges("L"), ranges("N")


@lru_cache(maxsize=1)
def _split_pattern() -> "re.Pattern":
    """The GPT-2 pre-tokenizer split with \\p{L}, \\p{N} and \\s spelled out."""
    letters, numbers = _letter_and_number_classes()
    space = "".join(re.escape(c) for c in sorted(_WHITE_SPACE))
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"
        rf"| ?[^{space}{letters}{numbers}]+|[{space}]+(?![^{space}])|[{space}]+")


@dataclass
class Encoding:
    ids: List[int]


class BPETokenizer:
    """Byte-level BPE over a HuggingFace ``tokenizers`` JSON dump, with the
    library's ``encode(text).ids``, ``decode`` and ``get_vocab_size``."""

    def __init__(self, spec: Dict):
        if unicodedata.unidata_version != _UNICODE_VERSION:
            raise RuntimeError(f"the tokenizer's Unicode tables are drawn against unicodedata "
                               f"{_UNICODE_VERSION} (Python 3.12), not "
                               f"{unicodedata.unidata_version}")
        model = spec["model"]
        if model["type"] != "BPE" or spec["pre_tokenizer"]["type"] != "ByteLevel":
            raise ValueError("want a byte-level BPE tokenizer")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.added = {t["content"]: t["id"] for t in spec["added_tokens"]}
        self.special_ids = {t["id"] for t in spec["added_tokens"] if t["special"]}
        self.vocab.update(self.added)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        merges = [m.split(" ") if isinstance(m, str) else m for m in model["merges"]]
        self.ranks = {(a, b): r for r, (a, b) in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self.add_prefix_space = spec["pre_tokenizer"].get("add_prefix_space", False)
        self._added_pattern = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
        self._cache: Dict[str, Tuple[int, ...]] = {}

    def get_vocab_size(self) -> int:
        return len(self.id_to_token)

    def _bpe(self, word: str) -> Tuple[int, ...]:
        """Ids of one pre-token (already in byte characters)."""
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        symbols = [c for c in word if c in self.vocab]
        while len(symbols) > 1:
            # a rank names one pair, so the least rank picks the pair to merge
            rank, first, second = min((self.ranks.get(p, _NO_MERGE), *p)
                                      for p in zip(symbols, symbols[1:]))
            if rank == _NO_MERGE:
                break
            merged, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and symbols[i] == first and symbols[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        ids = tuple(self.vocab[s] for s in symbols)
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    def _encode_piece(self, piece: str, ids: List[int]):
        text = normalize(piece)
        if not text:
            return
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        for word in _split_pattern().findall(text):
            ids.extend(self._bpe("".join(self.byte_encoder[b] for b in word.encode("utf-8"))))

    def encode(self, text: str) -> Encoding:
        ids: List[int] = []
        start = 0
        for m in self._added_pattern.finditer(text):
            self._encode_piece(text[start:m.start()], ids)
            ids.append(self.added[m.group()])
            start = m.end()
        self._encode_piece(text[start:], ids)
        return Encoding(ids)

    def encode_batch(self, texts: Sequence[str]) -> List[Encoding]:
        return [self.encode(t) for t in texts]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        """Ids -> text; bytes that are not valid UTF-8 become U+FFFD. Ids
        outside the vocab are skipped."""
        out = bytearray()
        for i in ids:
            token = self.id_to_token.get(int(i))
            if token is None or (skip_special_tokens and int(i) in self.special_ids):
                continue
            if all(c in self.byte_decoder for c in token):
                out.extend(self.byte_decoder[c] for c in token)
            else:
                out.extend(token.encode("utf-8"))
        return out.decode("utf-8", errors="replace")


@lru_cache(maxsize=4)
def get_tokenizer(path: Optional[str] = None) -> BPETokenizer:
    """Load the BPE tokenizer (the package's vocab unless ``path`` is given)."""
    with open(path or vocab_path(), encoding="utf-8") as f:
        return BPETokenizer(json.load(f))


def encode(text: str, tokenizer=None) -> List[int]:
    tok = tokenizer or get_tokenizer()
    return tok.encode(text).ids


def decode(ids: Sequence[int], tokenizer=None, skip_special_tokens: bool = False) -> str:
    tok = tokenizer or get_tokenizer()
    return tok.decode(list(ids), skip_special_tokens=skip_special_tokens)


def encode_batch_padded(texts: Sequence[str], length: int, tokenizer=None) -> np.ndarray:
    """Encode ``texts`` into an [B, length] int32 matrix, padded with PADDING
    or truncated to ``length``: the label-space encoding of zero-shot."""
    tok = tokenizer or get_tokenizer()
    out = np.full((len(texts), length), PADDING, dtype=np.int32)
    for row, enc in zip(out, tok.encode_batch(list(texts))):
        ids = enc.ids[:length]
        row[:len(ids)] = ids
    return out


_BANNED_MASK_TOKENS = (149, 4858, 9504, 15162, 22312, 22433, 32156)


@lru_cache(maxsize=1)
def token_is_valid_table() -> np.ndarray:
    """Boolean [vocab] table of tokens eligible for span masking: id > 10 and
    the surface form matches ^[ A-Za-z0-9']*$, minus 7 hand-banned ids."""
    tok = get_tokenizer()
    pattern = re.compile(r"^[ A-Za-z0-9']*$")
    ok = np.array([tid > 10 and bool(pattern.match(tok.decode([tid])))
                   for tid in range(tok.get_vocab_size())], dtype=bool)
    ok[list(_BANNED_MASK_TOKENS)] = False
    return ok
