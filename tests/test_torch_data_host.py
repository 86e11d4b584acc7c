"""Port parity: the port's host data plane (data/tfrecord.py, data/native.py
and csrc/merlot_native.cc, data/pretrain_pipeline.py, data/masking.py,
data/synthetic.py, data/loader.py) against the JAX package's, at tiny widths
(hidden 128, 2 layers per tower, 4 segments, seq_len 80, a 4x4 grid).

Tolerances: none. Everything here is bit for bit: the record and Example
codecs both ways, the native reader, parser, JPEG decode (both libraries are
built against the same libjpeg) and resize (the same C++ with the same
flags), the host example builder under the same numpy seed, the collation,
and the loader's record order, also after ``load_state_dict``, on threads
and on a pool of spawned processes.
"""

import os

import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data import native as jnative
from merlot_reserve_tpu.data import tfrecord as jtf
from merlot_reserve_tpu.data.loader import PretrainLoader as JaxLoader
from merlot_reserve_tpu.data.pretrain_pipeline import PretrainExampleBuilder as JaxBuilder
from merlot_reserve_tpu.data.pretrain_pipeline import collate_batch as jax_collate
from merlot_reserve_tpu.data.pretrain_pipeline import parse_segment_record as jax_parse
from merlot_reserve_tpu.data.synthetic import write_synthetic_corpus as jax_write_corpus
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data import native
from merlot_reserve_tpu_torch.data import tfrecord as ttf
from merlot_reserve_tpu_torch.data.loader import PretrainLoader
from merlot_reserve_tpu_torch.data.pretrain_pipeline import (
    PretrainExampleBuilder,
    collate_batch,
    parse_segment_record,
)
from merlot_reserve_tpu_torch.data.synthetic import make_video_record, write_synthetic_corpus
from _torch_jax_native import use_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX side decodes through its own native library, built once and
    loaded here (tests/_torch_jax_native.py), never through a PIL fallback."""
    use_jax_native()


TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
# text_span_budget 10: every random text then has more fake rows than the
# budget, so each example's span table has the same number of rows (the
# host loader stacks them)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8,
            text_span_budget=10, frame_buffer_size=328)


def configs():
    return (mr.load_config("base", **TINY).replace_data(**DATA),
            load_config("base", **TINY).replace_data(**DATA))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two shards written by the JAX package's writer (PIL JPEGs)."""
    jcfg, _ = configs()
    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i in range(2):
        p = str(d / f"shard{i}.tfrecord")
        jax_write_corpus(p, jcfg, num_records=3, seed=i)
        paths.append(p)
    return paths


def _example_features(rng):
    return {"a/bytes": ttf.bytes_feature([b"x", b"", bytes(range(256))]),
            "b/floats": ttf.float_feature(rng.standard_normal(5).tolist()),
            "c/ints": ttf.int64_feature([0, -1, 2**40, -(2**62), 7]),
            "d/empty": ttf.int64_feature([])}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfrecord_and_example_codecs_agree_both_ways(tmp_path, writer):
    """Records and Examples written by one package read back identically,
    CRCs checked, through the other package's codec and the port's native
    reader and parser."""
    rng = np.random.default_rng(0)
    w, r = (ttf, jtf) if writer == "port" else (jtf, ttf)
    records = [w.encode_example(_example_features(rng)) for _ in range(3)] + [b"", b"\x00" * 70]
    path = str(tmp_path / "r.tfrecord")
    w.write_records(path, records)
    assert list(r.read_records(path, check_crc=True)) == records
    assert list(native.read_records_native(path)) == records
    ex = records[0]
    assert ttf.encode_example(_example_features(np.random.default_rng(0))) == \
        jtf.encode_example(_example_features(np.random.default_rng(0)))
    parsed_t, parsed_j = ttf.parse_example(ex), jtf.parse_example(ex)
    assert parsed_t.keys() == parsed_j.keys()
    for k in parsed_j:
        np.testing.assert_array_equal(np.asarray(parsed_t[k], dtype=object),
                                      np.asarray(parsed_j[k], dtype=object))
    nat = native.NativeExample(ex)
    assert nat.bytes_list("a/bytes") == parsed_j["a/bytes"]
    np.testing.assert_array_equal(nat.floats("b/floats"), parsed_j["b/floats"])
    np.testing.assert_array_equal(nat.int64s("c/ints"), parsed_j["c/ints"])
    assert nat.int64s("d/empty").shape == (0,) and nat.int64s("missing").shape == (0,)


def test_native_library_matches_the_jax_one(corpus):
    """The native reader, the per-segment parse, the JPEG decode (RGB and
    grayscale) and the resize (all six kernels, with and without a crop)
    against the JAX package's library, bit for bit."""
    _, tcfg = configs()
    assert native.jpeg_codec() == "libjpeg"
    assert list(native.read_records_native(corpus[0])) == list(jtf.read_records(corpus[0]))
    record = next(jtf.read_records(corpus[0]))
    segs_t = parse_segment_record(record, tcfg.data.num_segments)
    segs_j = jax_parse(record, tcfg.data.num_segments)
    for st, sj in zip(segs_t, segs_j):
        assert st.keys() == sj.keys()
        for k in sj:
            if k.endswith("encoded"):
                assert st[k] == sj[k]
            else:
                np.testing.assert_array_equal(st[k], sj[k])
    rgb = native.decode_jpeg_native(segs_t[0]["image/encoded"][0])
    np.testing.assert_array_equal(rgb, jnative.decode_jpeg_native(segs_t[0]["image/encoded"][0]))
    spec = segs_t[0]["spectrogram/encoded"][0]
    np.testing.assert_array_equal(native.decode_jpeg_native(spec, 1),
                                  jnative.decode_jpeg_native(spec, 1))
    portrait = np.ascontiguousarray(np.rot90(rgb))
    for img in (rgb, portrait):
        for kernel in range(len(native.RESIZE_KERNELS)):
            for mult, oy, ox in ((1.0, 0, 0), (1.1, 3, 7)):
                np.testing.assert_array_equal(
                    native.resize_patchify_native(img, (12, 20), kernel, scale_mult=mult,
                                                  off_y=oy, off_x=ox),
                    jnative.resize_patchify_native(img, (12, 20), scale_mult=mult, off_y=oy,
                                                   off_x=ox, kernel=kernel))


def test_native_jpeg_encode(tmp_path):
    """The port's encoder (no PIL): JPEGs the JAX package's library decodes
    as the port's does, near the pixels encoded (quality 90 on smooth
    content: within 3 levels on average)."""
    yy, xx = np.mgrid[0:48, 0:80]
    img = np.stack([yy * 5, xx * 3, (yy + xx) * 2], -1).astype(np.uint8)
    for pixels in (img, img[..., 1]):
        data = native.encode_jpeg_native(pixels, quality=90)
        assert data[:2] == b"\xff\xd8"
        ch = 3 if pixels.ndim == 3 else 1
        out = native.decode_jpeg_native(data, ch)
        np.testing.assert_array_equal(out, jnative.decode_jpeg_native(data, ch))
        assert out.shape == pixels.shape
        assert np.abs(out.astype(int) - pixels).mean() < 3.0
    with pytest.raises(RuntimeError, match="jpeg decode failed"):
        native.decode_jpeg_native(b"\xff\xd8 not a jpeg")
    with pytest.raises(ValueError):
        native.encode_jpeg_native(np.zeros((4, 4, 2), np.uint8))


def test_native_library_raises_without_a_codec_or_a_build(monkeypatch, tmp_path):
    """No fallback: no JPEG codec, or a source that does not compile, raises."""
    import subprocess

    real_run = subprocess.run

    def no_jpeglib(cmd, *a, **kw):
        if "-E" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "jpeglib.h: No such file")
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", no_jpeglib)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="no JPEG codec"):
        native.build()
    monkeypatch.undo()
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.fixture(scope="module")
def host_examples(corpus):
    """(JAX examples, port examples) from the same records and seeds."""
    jcfg, tcfg = configs()
    jb, tb = JaxBuilder(jcfg), PretrainExampleBuilder(tcfg)
    out_j, out_t = [], []
    for i, record in enumerate(jtf.read_records(corpus[0])):
        out_j.append(jb.build(jax_parse(record, 4), np.random.default_rng(i)))
        out_t.append(tb.build(parse_segment_record(record, 4), np.random.default_rng(i)))
    return out_j, out_t


def test_host_builder_matches_jax_bit_for_bit(host_examples):
    for ej, et in zip(*host_examples):
        assert ej.keys() == et.keys()
        for k in ej:
            assert et[k].dtype == ej[k].dtype, k
            np.testing.assert_array_equal(et[k], ej[k], err_msg=k)


@pytest.mark.parametrize("bf16", [False, True])
def test_collate_matches_jax(host_examples, bf16):
    """collate_batch as the JAX package's; with use_bfloat16 the images and
    audio come as bf16 tensors equal to the f32 batch rounded to bf16."""
    ej, et = host_examples
    bj, bt = jax_collate(ej), collate_batch(et, use_bfloat16=bf16)
    assert bj.keys() == bt.keys()
    for k in bj:
        if bf16 and k in ("images", "audio_clips"):
            assert bt[k].dtype == torch.bfloat16
            assert torch.equal(bt[k], torch.from_numpy(bj[k]).to(torch.bfloat16))
        else:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def test_loader_gives_jax_record_order_and_resumes(corpus):
    """PretrainLoader (2 shards, a cycle of 2 files read in parallel, a
    shuffle buffer of 4) gives the JAX loader's batches, and the same
    continuation after state_dict / load_state_dict."""
    jcfg, tcfg = configs()
    kw = dict(batch_size=2, seed=11, num_workers=2, repeat=True, files_per_cycle=2,
              parallel_reads=2, shuffle_buffer=4)
    want = _batches(JaxLoader(corpus, jcfg, **kw), 4)
    got = _batches(PretrainLoader(corpus, tcfg, **kw), 4)
    for bj, bt in zip(want, got):
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    first = PretrainLoader(corpus, tcfg, **kw)
    _batches(first, 2)
    state = first.state_dict()
    assert state["records_consumed"] == 4
    resumed = PretrainLoader(corpus, tcfg, **kw)
    resumed.load_state_dict(state)
    for bj, bt in zip(want[2:], _batches(resumed, 2)):
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_process_pool_gives_the_threads_and_jax_batches_and_resumes(corpus):
    """use_processes=True (2 spawned workers): the JAX loader's batches, the
    same as the threads', and the same continuation after state_dict /
    load_state_dict across a new pool; the workers are gone when the
    iteration ends."""
    import multiprocessing

    jcfg, tcfg = configs()
    kw = dict(batch_size=2, seed=11, num_workers=2, repeat=True, files_per_cycle=2,
              parallel_reads=2, shuffle_buffer=4)
    want = _batches(JaxLoader(corpus, jcfg, **kw), 4)
    threads = _batches(PretrainLoader(corpus, tcfg, **kw), 4)
    first = PretrainLoader(corpus, tcfg, use_processes=True, **kw)
    it = iter(first)
    got = [next(it) for _ in range(2)]
    it.close()
    assert multiprocessing.active_children() == []
    resumed = PretrainLoader(corpus, tcfg, use_processes=True, **kw)
    resumed.load_state_dict(first.state_dict())
    got += _batches(resumed, 2)
    for bj, bth, bp in zip(want, threads, got):
        assert bp.keys() == bj.keys()
        for k in bj:
            np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)
            np.testing.assert_array_equal(bp[k], bth[k], err_msg=k)


def test_a_dead_worker_process_fails_the_loader_and_skips_no_record(corpus, capsys):
    """A worker process that dies (here at start-up) ends the iteration with
    the producer's error; it is not counted or logged as a corrupt record."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool

    class DyingPool(PretrainLoader):
        def _pool(self):
            return ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                                       initializer=os._exit, initargs=(1,))

    _, tcfg = configs()
    loader = DyingPool(corpus, tcfg, batch_size=2, seed=11, num_workers=1, repeat=False,
                       files_per_cycle=2, parallel_reads=2, shuffle_buffer=4,
                       use_processes=True)
    with pytest.raises(RuntimeError, match="loader producer failed") as err:
        next(iter(loader))
    assert isinstance(err.value.__cause__, BrokenProcessPool)
    assert loader._skipped == 0
    assert "skipping corrupt record" not in capsys.readouterr().out
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("on_device_frames", [False, True])
def test_fused_device_loader_process_pool_gives_the_threads_raw_batches(corpus,
                                                                         on_device_frames):
    """DevicePretrainLoader(fused=True) on 2 spawned workers yields the raw
    batches its threads yield (host_prepare's arrays, and the decoded
    images unless on_device_frames), and its device builder's stats count
    the workers' records."""
    from merlot_reserve_tpu_torch.data.loader import DevicePretrainLoader

    _, tcfg = configs()
    kw = dict(batch_size=2, seed=5, num_workers=2, files_per_cycle=2, parallel_reads=2,
              shuffle_buffer=4, fused=True, on_device_frames=on_device_frames, device="cpu")
    threads = DevicePretrainLoader(corpus, tcfg, **kw)
    procs = DevicePretrainLoader(corpus, tcfg, use_processes=True, **kw)
    for bt, bp in zip(_batches(threads, 3), _batches(procs, 3)):
        assert bp.keys() == bt.keys() and ("images" in bp) != on_device_frames
        for k in bt:
            np.testing.assert_array_equal(np.asarray(bp[k]), np.asarray(bt[k]), err_msg=k)
    assert procs._dev_builder.stats == threads._dev_builder.stats


def test_port_corpus_reads_in_both_packages(tmp_path):
    """The port's writer (JPEGs through the native library) gives records
    with the JAX package's schema: JAX's parser and host builder read them,
    and the two builders agree on them bit for bit."""
    jcfg, tcfg = configs()
    path = str(tmp_path / "port.tfrecord")
    write_synthetic_corpus(path, tcfg, num_records=2, seed=3, structured=True)
    records = list(jtf.read_records(path, check_crc=True))
    assert len(records) == 2
    want_keys = set(jtf.parse_example(records[0]))
    rec = make_video_record(tcfg, np.random.default_rng(0))
    assert set(jtf.parse_example(rec)) == want_keys
    ej = JaxBuilder(jcfg).build(jax_parse(records[1], 4), np.random.default_rng(5))
    et = PretrainExampleBuilder(tcfg).build(parse_segment_record(records[1], 4),
                                            np.random.default_rng(5))
    for k in ej:
        np.testing.assert_array_equal(et[k], ej[k], err_msg=k)
