"""Port parity: ``dataset_creation/`` (text, text_corpus, offset_model,
spectrogram, process, filters, youtube) and ``data/tfrecord``'s
``ShufflingRecordWriter`` against the JAX package's, and the port's records
read through the JAX package's parser and example builder.

Tolerances, each stated where it is used:
- exact: text cleaning under a seeded ``random.Random``, token blobs, the
  offset model's features, windows, token ids and times, packing, the
  shuffled shard's bytes, the uint8 spectrogram plane before encoding,
  the resized frame's pixels (Pillow's, bit for bit), youtube screening;
- offsets within 1e-6 (the same numpy MLP; measured equal);
- log-mel within 1e-5 absolute against the JAX package's
  ``mel_power_spectrogram`` in f32 (the DFT products summed in another
  order; measured 1.1e-6 on values up to about 10), at speeds 1, 2 and 3;
- magic numbers within 1e-6 relative (measured 5e-8 from the log-mel's
  last bits);
- decoded JPEG pixels (the data library's encoder against PIL's): the
  mean absolute difference below ``tests/test_native.py``'s native-vs-PIL
  limit of 2 levels.
"""

import gzip
import json
import random

import numpy as np
import pytest

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data import tfrecord as jtf
from merlot_reserve_tpu.data.pretrain_pipeline import \
    pretrain_examples_from_file as jax_examples_from_file
from merlot_reserve_tpu.dataset_creation import filters as JF
from merlot_reserve_tpu.dataset_creation import offset_model as JO
from merlot_reserve_tpu.dataset_creation import process as JP
from merlot_reserve_tpu.dataset_creation import spectrogram as JS
from merlot_reserve_tpu.dataset_creation import text as JT
from merlot_reserve_tpu.dataset_creation import text_corpus as JC
from merlot_reserve_tpu.dataset_creation import youtube as JY
from merlot_reserve_tpu.ops.audio import mel_power_spectrogram as jax_mel
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data import tfrecord as ttf
from merlot_reserve_tpu_torch.data.native import decode_jpeg_native, resize_native
from merlot_reserve_tpu_torch.data.pretrain_pipeline import pretrain_examples_from_file
from merlot_reserve_tpu_torch.dataset_creation import filters, offset_model, spectrogram
from merlot_reserve_tpu_torch.dataset_creation import process as P
from merlot_reserve_tpu_torch.dataset_creation import text, text_corpus, youtube
from merlot_reserve_tpu_torch.tokenizer import get_tokenizer
from _torch_jax_native import use_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX side decodes through its own native library, built once and
    loaded here (tests/_torch_jax_native.py), never through a PIL fallback."""
    use_jax_native()


SR = 22050
LOG_MEL_TOL = 1e-5
MAGIC_RTOL = 1e-6
OFFSET_TOL = 1e-6
JPEG_MEAN_TOL = 2.0  # tests/test_native.py's native-vs-PIL decode limit, in levels


def _jpeg_mean_diff(a: bytes, b: bytes, channels: int) -> float:
    da, db = decode_jpeg_native(a, channels), decode_jpeg_native(b, channels)
    assert da.shape == db.shape
    return float(np.abs(da.astype(np.int64) - db).mean())


TEXTS = ["  Café ☕ costs 3 dollars,\tnot 42!  ", "in 1999 we had 123456 and 1234567 rows",
         "Ångström 7 8 9 10 11 12 13 20 21 99 100 101 999 1000 1001",
         "ctrl\x01chars\x7f and 0 zero", "plain text"]


def test_text_cleaning_matches_jax():
    for n in list(range(0, 1200, 7)) + [12345, 99999, 100000, 999999, 1000000, -5]:
        assert text.number_to_words(n) == JT.number_to_words(n)
    for s in TEXTS:
        assert text.asciify(s) == JT.asciify(s)
        for seed in range(4):
            assert text.clean_text(s, random.Random(seed)) == JT.clean_text(s, random.Random(seed))
            assert text.spell_out_numbers(s, random.Random(seed), prob=0.7) == \
                JT.spell_out_numbers(s, random.Random(seed), prob=0.7)


def _write_corpus(path):
    docs = [{"text": "Hello world, this is document %d with 12 words. " % i * 12,
             "meta": {"pile_set_name": src}}
            for i, src in enumerate(["Pile-CC", "GitHub", "Wikipedia (en)", "Books3"])]
    docs += [{"text": "no meta here, 7 days"}, {"text": ""}]
    with gzip.open(path, "wt") as f:
        for d in docs:
            f.write(json.dumps(d) + "\n")
        f.write("not json\n")


def test_token_blobs_match_jax(tmp_path):
    path = str(tmp_path / "pile.jsonl.gz")
    _write_corpus(path)
    assert list(text_corpus.iter_text_documents([path])) == list(JC.iter_text_documents([path]))
    assert list(text_corpus.iter_text_documents([path], None)) == \
        list(JC.iter_text_documents([path], None))
    for clean in (True, False):
        # the cleaning spells numbers out under the global random module
        random.seed(7)
        got = list(text_corpus.token_blob_iterator([path], blob_len=48, clean=clean))
        random.seed(7)
        want = list(JC.token_blob_iterator([path], blob_len=48, clean=clean))
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == (48,)
            np.testing.assert_array_equal(g, w)


def _timed_words(seed, n=30):
    rng = np.random.default_rng(seed)
    enc = get_tokenizer()
    t = np.cumsum(rng.uniform(0.1, 0.9, n))
    words = ["Hello", "WORLD", "it's", "x", "banana!", "Queue", "a-b", "rhythm"]
    out = []
    for i in range(n):
        w = words[i % len(words)]
        out.append({"word": w, "start": float(t[i]), "end": float(t[i] + rng.uniform(0.05, 0.5)),
                    "encoded": enc.encode(" " + w).ids})
    return out


def test_offset_model_matches_jax():
    """The port's copy of the weights is the JAX package's file; features
    exactly, offsets within 1e-6."""
    with open(offset_model.PARAMS_FILE, "rb") as a, \
            open(JO._PARAM_SEARCH[1], "rb") as b:
        assert a.read() == b.read()
    words = _timed_words(0)
    np.testing.assert_array_equal(offset_model.compute_features(words),
                                  JO.compute_features(words))
    np.testing.assert_allclose(offset_model.predict_offsets(words), JO.predict_offsets(words),
                               rtol=0, atol=OFFSET_TOL)
    for got, want in zip(offset_model.apply_offsets(words), JO.apply_offsets(words)):
        assert got.keys() == want.keys()
        assert abs(got["start"] - want["start"]) <= OFFSET_TOL
        assert abs(got["end"] - want["end"]) <= OFFSET_TOL
    assert offset_model.apply_offsets([]) == []


def _video_words(duration, sparse_from, sparse_to, seed, sparse_step=3.1):
    """Dense words (about 2.5 a second) except a sparse stretch, where the
    windows run at speed 2 (words 3.1 s apart) or 3 (8 s apart)."""
    rng = np.random.default_rng(seed)
    words, t = [], 0.0
    while t < duration:
        step = sparse_step if sparse_from <= t < sparse_to else rng.uniform(0.25, 0.55)
        words.append({"word": f"w{len(words)}", "start": t, "end": t + 0.2})
        t += step
    return words


def test_windows_match_jax():
    cases = [(_video_words(70.0, 20.0, 45.0, 0), 70.0), (_video_words(33.0, 0.0, 33.0, 1), 33.0),
             ([{"word": f"w{i}", "start": 0.8 * i, "end": 0.8 * i + 0.4} for i in range(40)],
              32.0), ([], 17.0)]
    speeds = set()
    for words, duration in cases:
        got = P.split_into_windows(words, duration)
        assert got == JP.split_into_windows(words, duration)
        speeds |= {w["playback_speed"] for w in got}
    assert speeds == {1, 2, 3}


def _chunk(mod, vid, i):
    return mod.VideoChunk(b"", b"", 1.0, [], [], [], 0.0, 5.0, 1, youtube_id=vid,
                          meta=f"{vid}:{i}".encode())


def test_pack_chunks_matches_jax():
    lengths = [("a", 20), ("b", 7), ("c", 9), ("d", 3), ("e", 16), ("f", 5), ("g", 12),
               ("h", 1), ("i", 15)]

    def groups(mod):
        videos = iter([[_chunk(mod, v, i) for i in range(n)] for v, n in lengths])
        return [[c.meta for c in g] for g in mod.pack_chunks(videos, group_size=16)]

    got = groups(P)
    assert got == groups(JP)
    assert len(got) == 5 and all(len(g) == 16 for g in got)


def test_shuffling_writer_matches_jax(tmp_path):
    records = [bytes([i]) * (i % 7 + 1) for i in range(37)]
    paths = [str(tmp_path / f"{name}.tfrecord") for name in ("port", "jax")]
    for mod, path in zip((ttf, jtf), paths):
        with mod.ShufflingRecordWriter(path, buffer_size=8, seed=3) as w:
            for r in records:
                w.write(r)
        assert w.num_written == len(records)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert sorted(ttf.read_records(paths[0], check_crc=True)) == sorted(records)


def test_quantize_spectrogram_matches_jax(monkeypatch):
    """The uint8 plane handed to the encoder is the JAX package's; the magic
    number within 1e-6 relative; the decoded pixels within the codec limit;
    dequantize is decode / magic."""
    import PIL.Image

    planes = []
    real = PIL.Image.fromarray

    def capture(arr, *a, **kw):
        planes.append(np.array(arr))
        return real(arr, *a, **kw)

    monkeypatch.setattr(PIL.Image, "fromarray", capture)
    rng = np.random.default_rng(0)
    for log_mel in (np.abs(rng.standard_normal((64, 188))) * 2, rng.random((64, 188)) * 0.5):
        jpeg_j, magic_j = JS.quantize_spectrogram(log_mel)
        plane, magic = spectrogram.quantize_plane(log_mel)
        np.testing.assert_array_equal(plane, planes[-1])
        jpeg, magic_t = spectrogram.quantize_spectrogram(log_mel)
        assert magic_t == magic
        np.testing.assert_allclose(magic, magic_j, rtol=MAGIC_RTOL)
        assert _jpeg_mean_diff(jpeg, jpeg_j, 1) < JPEG_MEAN_TOL
        np.testing.assert_array_equal(spectrogram.dequantize_spectrogram(jpeg, magic),
                                      decode_jpeg_native(jpeg, 1).astype(np.float32) / magic)


@pytest.mark.parametrize("speed", [1, 2, 3])
def test_log_mels_match_jax(speed):
    """window_log_mels (one batched call per speed) against the JAX
    package's build_chunk arithmetic: mel_power_spectrogram in f32, then
    log(mel + 0.1) - log(0.1) in numpy; batched equals window by window."""
    rng = np.random.default_rng(speed)
    wavs = (0.1 * rng.standard_normal((2, int(5 * SR) * speed))).astype(np.float32)
    got = P.window_log_mels(wavs, speed, SR, device="cpu")
    want = np.stack([np.log(np.asarray(jax_mel(w, sr=SR, n_fft=1536 * speed,
                                               hop_length=588 * speed, fmax=SR / 2.0)) + 0.1)
                     - np.log(0.1) for w in wavs])
    assert got.shape == want.shape == (2, 188, 64) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG_MEL_TOL)
    for i in range(2):
        np.testing.assert_array_equal(P.window_log_mels(wavs[i:i + 1], speed, SR, "cpu")[0],
                                      got[i])


def test_frame_storage_is_pillows_resize():
    """The stored frame: Pillow's bilinear resize bit for bit (360x640 ->
    288x512, and a portrait frame), then JPEG within the codec limit of the
    JAX package's."""
    from PIL import Image

    rng = np.random.default_rng(4)
    for shape in ((360, 640, 3), (700, 300, 3), (200, 280, 3)):
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        got, want = P.resize_image_for_storage(frame), JP.resize_image_for_storage(frame)
        assert _jpeg_mean_diff(got, want, 3) < JPEG_MEAN_TOL
        h, w = shape[:2]
        scale = min(288 / min(h, w), 512 / max(h, w))
        if scale < 1:
            size = (max(int(w * scale), 1), max(int(h * scale), 1))
            np.testing.assert_array_equal(resize_native(frame, size[1], size[0]),
                                          np.asarray(Image.fromarray(frame).resize(
                                              size, Image.BILINEAR)))


def _videos(rng):
    """Two short videos with a sparse stretch each (speed 3 in the first,
    2 in the second) as arrays: frames, PCM, timed words."""
    out = []
    for vid, duration, sparse in (("vidA", 70.0, (19.0, 36.0, 8.0)),
                                  ("vidB", 40.0, (10.0, 30.0, 3.1))):
        words = _video_words(duration, *sparse[:2], seed=len(out), sparse_step=sparse[2])
        frames = rng.integers(0, 256, (len(P.split_into_windows(words, duration)), 90, 160, 3),
                              dtype=np.uint8)
        wav = (0.1 * rng.standard_normal(int(SR * duration))).astype(np.float32)
        out.append((vid, frames, wav, words, duration))
    return out


def test_created_records_read_through_both_packages(tmp_path):
    """process_video_arrays against the JAX package's on the same arrays
    (speeds 1-3 present): every chunk's ints and times exactly, magic
    numbers within 1e-6 relative, JPEGs within the codec limit. Then the
    port's packing, record and shuffled shard: the JAX package's parser
    reads the same keys and ints as from its own record, and its
    ``pretrain_examples_from_file`` and the port's give the same examples."""
    rng = np.random.default_rng(0)
    chunks_t, chunks_j = [], []
    for vid, frames, wav, words, duration in _videos(rng):
        kw = dict(youtube_id=vid, title=f"title of {vid}", tags="a tag")
        got = P.process_video_arrays(frames, wav, words, duration, device="cpu", **kw)
        want = JP.process_video_arrays(frames, wav, words, duration, **kw)
        assert len(got) == len(want) == len(frames)
        for c, cj in zip(got, want):
            for f in ("tok_ids", "tok_start_times", "tok_end_times", "start_time", "end_time",
                      "playback_speed", "youtube_id", "title_toks", "description_toks",
                      "tags_toks", "meta"):
                assert getattr(c, f) == getattr(cj, f), f
            np.testing.assert_allclose(c.magic_number, cj.magic_number, rtol=MAGIC_RTOL)
            assert _jpeg_mean_diff(c.spectrogram_jpeg, cj.spectrogram_jpeg, 1) < JPEG_MEAN_TOL
            assert _jpeg_mean_diff(c.frame_jpeg, cj.frame_jpeg, 3) < JPEG_MEAN_TOL
        chunks_t.append(got)
        chunks_j.append(want)
    assert {c.playback_speed for g in chunks_t for c in g} == {1, 2, 3}

    texts = [rng.integers(100, 30000, 600).tolist() for _ in range(16)]
    group_t = next(P.pack_chunks(iter(chunks_t)))
    group_j = next(JP.pack_chunks(iter(chunks_j)))
    record = P.chunks_to_record(group_t, texts)
    parsed, parsed_j = jtf.parse_example(record), jtf.parse_example(
        JP.chunks_to_record(group_j, texts))
    assert parsed.keys() == parsed_j.keys()
    for k, v in parsed_j.items():
        if isinstance(v, np.ndarray) and v.dtype == np.int64:
            np.testing.assert_array_equal(parsed[k], v, err_msg=k)
    assert parsed["c15/video_src_index"][0] == 2  # the group mixes the two videos

    path = str(tmp_path / "created.tfrecord")
    with ttf.ShufflingRecordWriter(path, buffer_size=4, seed=0) as w:
        w.write(record)
    kw = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
              span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
    data = dict(num_segments=16, num_segment_groups=2, seq_len=320, lang_seq_len=48,
                text_span_budget=10)
    jcfg = mr.load_config("base", **kw).replace_data(**data)
    tcfg = load_config("base", **kw).replace_data(**data)
    ej = next(iter(jax_examples_from_file(path, jcfg, seed=0)))
    et = next(iter(pretrain_examples_from_file(path, tcfg, seed=0)))
    assert ej.keys() == et.keys()
    for k in ej:
        assert et[k].dtype == ej[k].dtype, k
        np.testing.assert_array_equal(et[k], ej[k], err_msg=k)
    assert et["images"].shape == (16, 16, 768) and et["audio_clips"].shape == (16, 3, 60, 65)
    assert np.isfinite(et["audio_clips"]).all() and et["video_src_index"].max() >= 1


def test_filters_match_jax():
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (5, 40, 60, 3), dtype=np.uint8)
    static = np.stack([frames[0]] * 3)
    np.testing.assert_array_equal(filters.pixel_embedder(frames), JF.pixel_embedder(frames))
    for clip in (frames, static, frames[:1]):
        assert filters.is_static_video(clip) == JF.is_static_video(clip)
    assert filters.is_static_video(static) and not filters.is_static_video(frames)
    for counts in (None, [0.5, 0.7], [1.0, 3.0]):
        assert filters.passes_object_filter(counts) == JF.passes_object_filter(counts)
    vocab = ["the", "cat", "sat", "on", "a", "mat", "hello", "world", "Matt", "kat"]
    for seed in range(3):
        r = random.Random(seed)
        src = [{"word": r.choice(vocab), "start": float(i), "end": i + 0.5}
               for i in range(r.randint(4, 12))]
        tgt = [r.choice(vocab) for _ in range(r.randint(3, 10))]
        assert filters.edit_distance(src[0]["word"], tgt[0]) == \
            JF.edit_distance(src[0]["word"], tgt[0])
        assert filters.align_using_dtw([w["word"] for w in src], tgt) == \
            JF.align_using_dtw([w["word"] for w in src], tgt)
        assert filters.transfer_timestamps(src, tgt) == JF.transfer_timestamps(src, tgt)


VTT = """WEBVTT
Kind: captions

00:00:01.000 --> 00:00:03.500
so<00:00:01.400><c> this</c><00:00:01.900><c> is</c><00:00:02.300><c> the</c>

00:00:03.500 --> 00:00:05.000
thing we do
"""


def test_youtube_screening_matches_jax(tmp_path):
    """The acquisition gates (JAX's own cases and a few more) and the VTT
    reading give the JAX package's decisions; nothing is fetched."""

    def transcript(n, rate_per_30s, english=True):
        words = ("so this is the thing that we are going to do now and then we will see "
                 "what it does").split() if english else ["zxqv%d" % i for i in range(20)]
        return [{"word": words[i % len(words)], "start": i * 30.0 / rate_per_30s,
                 "end": i * 30.0 / rate_per_30s + 0.2} for i in range(n)]

    meta = {"title": "How to cook the best pasta at home",
            "description": "In this video we show you the way to do it http://x.y #tag",
            "tags": "cooking pasta", "duration": 300.0, "categories": []}
    cases = [(meta, transcript(600, 60)), (meta, []), (dict(meta, duration=0), transcript(9, 9)),
             (dict(meta, duration=30 * 60), transcript(600, 60)),
             (dict(meta, categories=["Gaming"]), transcript(600, 60)),
             (dict(meta, title="Minecraft speedrun"), transcript(600, 60)),
             (meta, transcript(100, 10)),
             (dict(meta, title="zxq vbn", description=""), transcript(600, 60, english=False))]
    reasons = []
    for m, tr in cases:
        got = youtube.screen_video(m, tr)
        assert got == JY.screen_video(m, tr)
        reasons.append(got["fail_reason"])
        assert youtube.is_gaming_video(m) == JY.is_gaming_video(m)
        assert youtube.is_probably_english(m) == JY.is_probably_english(m)
    assert reasons == [None, "no transcript", "unknown duration", "video too long", "gaming",
                       "gaming", "word density too low", "maybe not english"]
    for times in ([], [0.0, 1.0, 31.0], [95.5, 3.0]):
        assert youtube.words_per_30s(times) == JY.words_per_30s(times)
    (tmp_path / "vid.en.vtt").write_text(VTT)
    words = youtube.load_subtitle_words(str(tmp_path), "vid")
    assert words == JY.load_subtitle_words(str(tmp_path), "vid") and len(words) == 7
    assert youtube.load_subtitle_words(str(tmp_path), "other") == []
    with pytest.raises(RuntimeError, match="yt-dlp"):
        youtube._ytdlp()
