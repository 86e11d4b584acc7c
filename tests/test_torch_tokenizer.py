"""Port parity: the port's pure-Python byte-level BPE
(merlot_reserve_tpu_torch.tokenizer) against HuggingFace ``tokenizers``
loading the same vocab file (the JAX package's tokenizer), and against the
JAX package's wrappers. The library is imported here only: the port never
needs it.

Tolerance: none. Ids, decoded text, padded batches and the masking table
are compared for equality."""

import json
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
import tokenizers
from tokenizers import Tokenizer

import merlot_reserve_tpu.tokenizer as jtok
import merlot_reserve_tpu_torch.tokenizer as ttok

ROOT = Path(__file__).resolve().parent.parent
CORPUS = [
    "", " ", "hello world", "Hello, World!", "the quick brown fox jumps over the lazy dog.",
    "don't you think it's what they've said? I'm sure we'll see, he'd go", "IT'S 'TIS y'all",
    "rock 'n' roll", "it''s", "'s 't 're 've 'm 'll 'd", "a-b_c/d\\e|f@g#h$i%j^k&l*m(n)o[p]",
    "... !!! ??? ;;; ::: \"quoted\" «guillemets» — dash – en",
    "Café naïve résumé Ångström façade jalapeño Øresund straße ŁÓDŹ İstanbul ΣΊΣΥΦΟΣ",
    "中文字 日本語のテキスト 한국어 텍스트 中a文b", "x² y³ ½ ¾ ⅓ ① Ⅻ ٣ ५ 𝟙 10⁻³",
    "emoji 😀 🎉👍🏽 👨‍👩‍👧 🥰 🇺🇸 ❤️", "tab\there\nnew\r\nline\x0bvt\x0cff\x85nel",
    "control\x00\x01\x02\x7f\x1b[0m and format​‍﻿­ chars", "��",
    "  leading and   runs   of   spaces  ", "\n\n\n paragraphs \n\n", "trailing   ",
    " nbsp em　ideographic space", "<|MASK|>", "the next action is <|MASK|>",
    "a<|MASK|>b", "word<|START|>inside<|END|>words", "<|PAD|><|PAD|>x", "<|MASKAUDIO|> <|MASK|>",
    "<|AUDIOSPAN|>x<|LTOVPOOL|>y<|unused0|>z<|UNK|><|RESETCTX|>", "<|mask|> <|MASK", "<|MASK||>",
    "numbers 1234567890 3.14159 1,000,000 2024-10-17", "Ⅷ ⅷ ﬁ ﬀ ẞ ǅ Ǆ", "ǰ̣ é ä́",
    "᜴\U00011938\U00010d50Ᲊ ꟋꟌ", "http://example.com/path?query=1&b=2#frag",
    "مرحبا بالعالم שלום עולם नमस्ते दुनिया สวัสดีชาวโลก",
]
SPECIAL_WORDS = ["<|MASK|>", "<|PAD|>", "<|START|>", "<|AUDIOSPAN|>", "a", "dog", " ", "é",
                 "'s", "中", "x²", "\t", "  "]


@pytest.fixture(scope="module")
def hf():
    return Tokenizer.from_file(str(ROOT / "merlot_reserve_tpu" / "lowercase_encoder.json"))


@pytest.fixture(scope="module")
def tok():
    return ttok.get_tokenizer()


def test_the_vocab_is_the_jax_packages_and_read_from_the_port():
    assert Path(ttok.vocab_path()).parent == ROOT / "merlot_reserve_tpu_torch"
    assert (Path(ttok.vocab_path()).read_bytes()
            == (ROOT / "merlot_reserve_tpu" / "lowercase_encoder.json").read_bytes())


def test_special_ids_match_jax(tok):
    for name in ("PADDING", "START", "END", "MASK", "MASKAUDIO", "AUDIOSPAN", "LTOVPOOL",
                 "RESETCTX", "PAD_TOKEN", "SPECIAL_TOKENS"):
        assert getattr(ttok, name) == getattr(jtok, name)
    spec = json.loads(Path(ttok.vocab_path()).read_text())
    for added in spec["added_tokens"]:
        assert tok.encode(added["content"]).ids == [added["id"]]


def test_the_unicode_tables_are_for_these_versions(monkeypatch):
    # the port's tables of where the library's Unicode data differs from
    # Python's were drawn against exactly these two
    assert tokenizers.__version__ == "0.22.2"
    assert unicodedata.unidata_version == ttok._UNICODE_VERSION == "15.0.0"
    monkeypatch.setattr(ttok, "_UNICODE_VERSION", "16.0.0")
    with pytest.raises(RuntimeError, match="Unicode tables"):
        ttok.BPETokenizer(json.loads(Path(ttok.vocab_path()).read_text()))


def test_ids_match_the_library_on_every_code_point(hf, tok):
    # every code point but the surrogates, 64 to a text: each in its own
    # right and next to its neighbours
    cps = [cp for cp in range(sys.maxunicode + 1) if not 0xD800 <= cp <= 0xDFFF]
    texts = ["".join(map(chr, cps[i:i + 64])) for i in range(0, len(cps), 64)]
    want = [e.ids for e in hf.encode_batch(texts)]
    assert [i for i, text in enumerate(texts) if tok.encode(text).ids != want[i]] == []


def test_ids_match_the_library_on_every_pair_of_combining_marks(hf, tok):
    # canonical ordering: every pair of characters with a combining class
    # that the normalizer keeps, after a letter
    marks = [chr(cp) for cp in range(sys.maxunicode + 1)
             if not 0xD800 <= cp <= 0xDFFF and unicodedata.combining(chr(cp))]
    marks = [c for c in marks if ttok.normalize(c)]
    texts = [f"a{a}{b}" for a in marks for b in marks]
    want = [e.ids for e in hf.encode_batch(texts)]
    assert [t for t, ids in zip(texts, want) if tok.encode(t).ids != ids] == []


@pytest.mark.parametrize("text", CORPUS)
def test_ids_match_the_library_on_the_corpus(hf, tok, text):
    assert tok.encode(text).ids == hf.encode(text).ids


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.text(max_size=40))
def test_ids_match_the_library_on_any_text(hf, tok, text):
    assert tok.encode(text).ids == hf.encode(text).ids


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(SPECIAL_WORDS) | st.text(max_size=4), max_size=12))
def test_ids_match_the_library_around_special_tokens(hf, tok, words):
    text = "".join(words)
    assert tok.encode(text).ids == hf.encode(text).ids


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 32800), max_size=12), st.booleans())
def test_decode_matches_the_library(hf, tok, ids, skip):
    assert tok.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip)


def test_decode_of_every_token_matches_the_library(hf, tok):
    assert tok.get_vocab_size() == hf.get_vocab_size() == 32768
    ids = range(tok.get_vocab_size())
    assert ([tok.decode([i], skip_special_tokens=False) for i in ids]
            == [hf.decode([i], skip_special_tokens=False) for i in ids])


def test_module_functions_match_jax(tok):
    text = "A dog's <|MASK|> jumps over ½ of 中文 fences\t\n"
    ids = jtok.encode(text)
    assert ttok.encode(text) == ids
    assert ttok.decode(ids) == jtok.decode(ids)
    assert ttok.decode(ids, skip_special_tokens=True) == jtok.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("length", [1, 5, 15, 40])
def test_encode_batch_padded_matches_jax(length):
    texts = ["", "a dog", "the next action is <|MASK|>", " ".join(CORPUS[4:8]), "café 中"]
    ours = ttok.encode_batch_padded(texts, length)
    theirs = jtok.encode_batch_padded(texts, length)
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)


def test_token_is_valid_table_matches_jax():
    ours = ttok.token_is_valid_table()
    np.testing.assert_array_equal(ours, jtok.token_is_valid_table())
    assert ours.shape == (32768,) and not ours[:11].any()
