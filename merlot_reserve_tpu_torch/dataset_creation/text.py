"""Text cleaning for dataset creation (reference data/clean_text.py):
ASCII-fication, emoji and control stripping, and randomized number
spell-out so ASR-style text looks uniform. The port's copy of
``merlot_reserve_tpu/dataset_creation/text.py``."""

from __future__ import annotations

import random
import re
import unicodedata
from typing import Optional

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def number_to_words(n: int) -> str:
    """Spell out 0..999999 in words."""
    if n < 0:
        return "negative " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + ("" if o == 0 else " " + _ONES[o])
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + ("" if r == 0 else " " + number_to_words(r))
    if n < 1_000_000:
        th, r = divmod(n, 1000)
        return number_to_words(th) + " thousand" + (
            "" if r == 0 else " " + number_to_words(r))
    return str(n)


def asciify(text: str) -> str:
    """Strip accents, emoji and control characters down to printable ASCII."""
    text = unicodedata.normalize("NFKD", text)
    text = text.encode("ascii", "ignore").decode("ascii")
    return re.sub(r"[\x00-\x08\x0b-\x1f\x7f]", "", text)


def spell_out_numbers(text: str, rng: Optional[random.Random] = None,
                      prob: float = 0.5) -> str:
    """Replace each run of 1-6 digits by its words with probability ``prob``
    (the reference's randomized convention, clean_text.py:81-115)."""
    rng = rng or random

    def _sub(m):
        if rng.random() > prob:
            return m.group(0)
        return number_to_words(int(m.group(0)))

    return re.sub(r"\b\d{1,6}\b", _sub, text)


def clean_text(text: str, rng: Optional[random.Random] = None) -> str:
    """The whole chain: asciify, spell out numbers, collapse whitespace."""
    text = asciify(text)
    text = spell_out_numbers(text, rng)
    return re.sub(r"\s+", " ", text).strip()
