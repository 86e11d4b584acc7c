"""Port parity: the finetuning and zero-shot data (finetune/data.py) and the
VCR and TVQA synthetic writers (data/synthetic.py) against the JAX
package's, on records written by each package's writer, at tiny widths
(grid (4, 4), lang_seq_len 48, 7 TVQA segments).

Tolerances:
  * tokens, segment ids, answer tables, labels and ids exactly; the
    training draws (the VCR flip, the TVQA audio jitter) exactly for the same
    seed, the jitter held with both packages decoding through the port's
    library, so that only the draws and the arithmetic are compared;
  * patches and spectrograms: the JAX package decodes with PIL and resizes
    with PIL's bilinear filter, the port with its native library, so they
    are held to what tests/test_native.py allows native resize against PIL
    (mean |difference| below 0.01, and at least 95% of the values within
    0.05; measured here: patches within 3.6e-3 at most, spectrograms equal);
  * the writers: every feature but the JPEGs equal; the JPEGs (PIL's
    encoder against the port's) decode to pixels within a mean of 1 level of
    255 of each other.
"""

import numpy as np
import pytest

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.synthetic import write_synthetic_finetune_corpus as jax_write
from merlot_reserve_tpu.data.tfrecord import parse_example as jax_parse
from merlot_reserve_tpu.data.tfrecord import read_records as jax_read
from merlot_reserve_tpu.finetune import data as jd
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.native import decode_jpeg_native
from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_finetune_corpus
from merlot_reserve_tpu_torch.data.tfrecord import parse_example, read_records
from merlot_reserve_tpu_torch.finetune import data as td

TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(lang_seq_len=48, num_segments=7)
FLOATS = {"image", "images", "audio_clips"}
WRITERS = ("jax", "port")


def _configs():
    return (mr.load_config("base", **TINY).replace_data(**DATA),
            load_config("base", **TINY).replace_data(**DATA))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(task, writer): path} of 3 records each."""
    jcfg, tcfg = _configs()
    d = tmp_path_factory.mktemp("finetune_data")
    out = {}
    for task in ("vcr", "tvqa"):
        out[(task, "jax")] = jax_write(str(d / f"{task}_jax.tfrecord"), jcfg, task,
                                       num_records=3, seed=1)
        out[(task, "port")] = write_synthetic_finetune_corpus(
            str(d / f"{task}_port.tfrecord"), tcfg, task, num_records=3, seed=1)
    return out


def _assert_close_to_pil(ours, theirs, key):
    err = np.abs(ours - theirs)
    assert err.mean() < 0.01, (key, err.mean())
    assert (err < 0.05).mean() > 0.95, (key, (err < 0.05).mean())


def _assert_batches_match(ours, theirs):
    assert len(ours) == len(theirs)
    for (ids, batch), (j_ids, j_batch) in zip(ours, theirs):
        assert ids == j_ids
        assert sorted(batch) == sorted(j_batch)
        for k, v in j_batch.items():
            assert batch[k].shape == v.shape and batch[k].dtype == v.dtype, k
            if k in FLOATS:
                _assert_close_to_pil(batch[k], v, k)
            else:
                np.testing.assert_array_equal(batch[k], v, err_msg=k)


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("task", ["vcr", "tvqa", "vcr_zero_shot", "tvqa_zero_shot"])
@pytest.mark.parametrize("is_training", [True, False])
def test_finetune_batches_match_jax(records, task, writer, is_training):
    """Every preprocessor through finetune_batches: 3 records in batches of
    2, the last one filled with 'pad' rows."""
    jcfg, tcfg = _configs()
    path = [records[(task.split("_")[0], writer)]]
    kw = dict(seed=5, is_training=is_training, repeat=False, return_ids=True)
    ours = list(td.finetune_batches(path, tcfg, task, 2, **kw))
    theirs = list(jd.finetune_batches(path, jcfg, task, 2, **kw))
    _assert_batches_match(ours, theirs)
    assert [ids for ids, _ in ours][-1][-1] == "pad"


def test_repeat_starts_each_pass_anew(records):
    """repeat=True: each pass over the files yields whole batches only (3
    records in batches of 2: the third is dropped every pass), the draws
    going on from one Generator, as in the JAX package."""
    jcfg, tcfg = _configs()
    path = [records[("vcr", "port")]]
    ours = td.finetune_batches(path, tcfg, "vcr", 2, seed=0, return_ids=True)
    theirs = jd.finetune_batches(path, jcfg, "vcr", 2, seed=0, return_ids=True)
    got = [next(ours) for _ in range(3)]
    _assert_batches_match(got, [next(theirs) for _ in range(3)])
    np.testing.assert_array_equal(got[0][1]["answers"], got[2][1]["answers"])


@pytest.mark.parametrize("writer", WRITERS)
def test_tvqa_jitter_is_jax_bit_for_bit(records, writer, monkeypatch):
    """With both packages decoding the spectrograms through the port's
    library, the jittered audio of a training batch is the JAX package's
    exactly: the same draws from the same Generator, in the same order."""
    monkeypatch.setattr(jd, "_decode_jpeg", lambda data, channels=3: decode_jpeg_native(
        data, channels))
    jcfg, tcfg = _configs()
    for (raw, j_raw) in zip((parse_example(r) for r in read_records(records[("tvqa", writer)])),
                            (jax_parse(r) for r in jax_read(records[("tvqa", writer)]))):
        ours = td.preprocess_tvqa(raw, tcfg, np.random.default_rng(9))
        theirs = jd.preprocess_tvqa(j_raw, jcfg, np.random.default_rng(9))
        np.testing.assert_array_equal(ours["audio_clips"], theirs["audio_clips"])
        plain = td.preprocess_tvqa(raw, tcfg, np.random.default_rng(9), is_training=False)
        assert not np.array_equal(ours["audio_clips"], plain["audio_clips"])


@pytest.mark.parametrize("task", ["vcr", "tvqa"])
def test_synthetic_writers_match_jax(records, task):
    a = [parse_example(r) for r in read_records(records[(task, "port")])]
    b = [jax_parse(r) for r in jax_read(records[(task, "jax")])]
    assert len(a) == len(b) == 3
    for ours, theirs in zip(a, b):
        assert sorted(ours) == sorted(theirs)
        for k, v in theirs.items():
            if k.endswith(("image", "image_fliplr", "image_encoded", "spec_encoded")):
                channels = 1 if k.endswith("spec_encoded") else 3
                pix = [decode_jpeg_native(bytes(x[0]), channels).astype(np.float64)
                       for x in (ours[k], v)]
                assert pix[0].shape == pix[1].shape
                assert np.abs(pix[0] - pix[1]).mean() < 1.0, k
            elif isinstance(v, list):
                assert ours[k] == v, k
            else:
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
