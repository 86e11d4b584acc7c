"""Port parity: preprocessing (merlot_reserve_tpu_torch.preprocess), the
zero-shot toolkit (zero_shot, get_label_space), subtitles and the FLOP
counts against the JAX package on the same numpy inputs and, for the model,
the same weights (carried across by utils.weights.load_flax_params), at
tiny widths on the CPU.

Tolerances: patches within 1e-6 and log-mel within 1e-3 absolute (as in
tests/test_torch_frontend.py); tokens and subsegment ids equal. Label
spaces and MASK features within 1e-4 of JAX's f32 unit vectors; option
probabilities within 1e-4 and logits within 1e-2 (temperature 100 scales
the 1e-4 of the embeddings)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu import preprocess as JP
from merlot_reserve_tpu import zero_shot as JZ
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.models.model import PretrainedMerlotReserve as JaxPretrained
from merlot_reserve_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from merlot_reserve_tpu.utils import profiling as JPROF
from merlot_reserve_tpu.utils import subtitles as JSUB
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch import preprocess as TP
from merlot_reserve_tpu_torch import zero_shot as TZ
from merlot_reserve_tpu_torch.models import MerlotReserve, PretrainedMerlotReserve
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, MASK
from merlot_reserve_tpu_torch.utils import profiling as TPROF
from merlot_reserve_tpu_torch.utils import subtitles as TSUB
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

VISION_ATOL = 1e-6
LOGMEL_ATOL = 1e-3
EMBED_ATOL = 1e-4
PROB_ATOL = 1e-4
LOGIT_ATOL = 1e-2
TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
OPTIONS = ["cooking pasta", "a dog running on the beach", "playing the guitar", "", "x² ½ café"]


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def test_detect_black_bars_matches_jax():
    rng = np.random.RandomState(0)
    frames = np.zeros((2, 100, 200, 3), np.uint8)
    frames[:, 20:80, 30:170] = rng.randint(40, 255, (2, 60, 140, 3))
    assert TP.detect_black_bars(frames) == JP.detect_black_bars(frames) == (20, 80, 30, 170)


def test_detect_black_bars_caps_trim_as_jax():
    frames = np.zeros((1, 100, 100, 3), np.uint8)
    frames[:, 45:55, 45:55] = 200
    assert TP.detect_black_bars(frames) == JP.detect_black_bars(frames) == (20, 80, 20, 80)


def test_file_entry_points_need_ffmpeg(monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        TP.video_to_segments("missing.mp4", device="cpu")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        TP.extract_audio_waveform("missing.mp4")


def _raw_video(seed, n=4, h=120, w=160, seconds=21):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    waveform = (0.1 * rng.randn(22050 * seconds)).astype(np.float32)
    times = [{"start_time": 5.0 * i, "end_time": 5.0 * (i + 1), "mid_time": 5.0 * i + 2.5}
             for i in range(n)]
    return frames, waveform, times


def _assert_segments_match(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if k == "spectrogram":
                assert a[k].shape == b[k].shape
                np.testing.assert_allclose(a[k], b[k], atol=LOGMEL_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def segments():
    frames, waveform, times = _raw_video(1)
    ours = TP.segments_from_arrays(frames, waveform, times, device="cpu")
    _assert_segments_match(ours, JP.segments_from_arrays(frames, waveform, times))
    return ours


def test_segments_from_arrays_matches_jax(segments):
    assert [s["spectrogram"].shape for s in segments] == [(3, 60, 65)] * 4
    for seg in segments:
        np.testing.assert_array_equal(seg["spectrogram"][..., 64], 1.0)


def test_short_segments_are_center_padded_as_jax():
    frames, waveform, _ = _raw_video(2, n=2, seconds=4)
    times = [{"start_time": 0.5, "end_time": 2.0, "mid_time": 1.25},
             {"start_time": 2.0, "end_time": 3.0, "mid_time": 2.5}]
    _assert_segments_match(TP.segments_from_arrays(frames, waveform, times, device="cpu"),
                           JP.segments_from_arrays(frames, waveform, times))


@pytest.mark.parametrize("n", [4, 5])
def test_dense_segments_match_jax(n):
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (n, 120, 160, 3), dtype=np.uint8)
    waveform = (0.1 * rng.randn(22050 * 8)).astype(np.float32)
    times = [{"start_time": 0.5 + i, "end_time": 1.5 + i, "mid_time": 1.0 + i}
             for i in range(n)]
    ours = TP.dense_segments_from_arrays(frames, waveform, times, device="cpu")
    _assert_segments_match(ours, JP.dense_segments_from_arrays(frames, waveform, times))
    assert [s["spectrogram"].shape for s in ours] == [(1, 60, 65)] * n


def _video_pre_inputs(segments, text):
    segs = [dict(s) for s in segments]
    segs[-1]["text"] = text
    for s in segs[:-1]:
        s["use_text_as_input"] = False
    return segs


def _assert_pre_match(ours, theirs):
    assert ours.keys() == theirs.keys()
    np.testing.assert_allclose(ours["images"], theirs["images"], atol=VISION_ATOL, rtol=0)
    np.testing.assert_allclose(ours["audio_clips"], theirs["audio_clips"], atol=LOGMEL_ATOL,
                               rtol=0)
    for k in ("tokens", "subseg_idxs"):
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("grid", [(12, 20), (4, 4)])
def test_preprocess_video_matches_jax(segments, grid):
    segs = _video_pre_inputs(segments, "A person is Cooking <|MASK|> now")
    ours = TP.preprocess_video(segs, output_grid_size=grid, device="cpu")
    _assert_pre_match(ours, JP.preprocess_video(segs, output_grid_size=grid))
    assert ours["images"].shape == (4, grid[0] * grid[1], 768)
    assert ours["audio_clips"].shape == (12, 60, 65) and ours["tokens"].shape == (160,)
    assert int((ours["tokens"] == AUDIOSPAN).sum()) == 3 * 18
    assert int((ours["tokens"] == MASK).sum()) == 1


def test_preprocess_video_token_lists_and_limits(segments):
    segs = [dict(s, text=list(range(10, 60))) for s in segments]  # 4 x 50 tokens, cut at 160
    ours = TP.preprocess_video(segs, output_grid_size=(4, 4), device="cpu")
    _assert_pre_match(ours, JP.preprocess_video(segs, output_grid_size=(4, 4)))
    with pytest.raises(ValueError, match="at most 8"):
        TP.preprocess_video(segments * 3, output_grid_size=(4, 4), device="cpu")


# ---------------------------------------------------------------------------
# zero-shot on shared weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """The JAX wrapper and the port's on the same weights."""
    cfg = mr.load_config("base", **TINY)
    jmodel = JaxMerlotReserve.from_config(cfg)
    params = jmodel.init_params_full()
    jax_pre = JaxPretrained(encoder=jax_get_tokenizer(), params=jax.tree.map(jnp.array, params),
                            model=jmodel)
    model = MerlotReserve(load_config("base", **TINY), device="cpu")
    load_flax_params(model, params)
    return jax_pre, PretrainedMerlotReserve(model)


def test_get_label_space_matches_jax(models):
    jax_pre, pre = models
    ours = pre.get_label_space(OPTIONS)
    assert ours.shape == (len(OPTIONS), 128) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_pre.get_label_space(OPTIONS)),
                               atol=EMBED_ATOL, rtol=0)
    assert "get_label_space" in type(pre).__dict__  # a method, not __getattr__'s


@pytest.fixture(scope="module")
def video_pres(segments):
    return [TP.preprocess_video(_video_pre_inputs(segments, text), (4, 4), device="cpu")
            for text in ("the next action is <|MASK|>", "<|MASK|> is what she is holding")]


def test_rank_options_matches_jax(models, video_pres):
    jax_pre, pre = models
    ours = TZ.rank_options(pre, video_pres[0], OPTIONS)
    theirs = JZ.rank_options(jax_pre, video_pres[0], OPTIONS)
    assert ours.shape == theirs.shape == (1, len(OPTIONS))
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(ours, theirs, atol=PROB_ATOL, rtol=0)


def test_extract_mask_features_and_scores_match_jax(models, video_pres):
    jax_pre, pre = models
    pres = [dict(vp, video_id=i) for i, vp in enumerate(video_pres)]  # extra fields are kept out
    ours = TZ.extract_mask_features(pre, pres)
    theirs = JZ.extract_mask_features(jax_pre, pres)
    assert ours.shape == (2, 128) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=EMBED_ATOL, rtol=0)
    np.testing.assert_allclose(TZ.score_label_space(pre, ours, OPTIONS),
                               JZ.score_label_space(jax_pre, theirs, OPTIONS),
                               atol=LOGIT_ATOL, rtol=0)


def test_accuracy_helpers_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(32, 12).astype(np.float32)
    labels = rng.randint(0, 12, 32)
    assert TZ.topk_accuracy(logits, labels, ks=(1, 3)) == JZ.topk_accuracy(logits, labels,
                                                                           ks=(1, 3))
    a2v, a2n = rng.randint(0, 4, 12), rng.randint(0, 5, 12)
    assert (TZ.verb_noun_action_accuracy(logits, labels, a2v, a2n)
            == JZ.verb_noun_action_accuracy(logits, labels, a2v, a2n))


@pytest.mark.parametrize("item", [
    {"question": "a car is being driven through <|MASK|>."},
    {"question": "x?", "statement": "y <|MASK|>"},
    {"question": "What is the man holding?"},
    {"question": "How many dogs are there?"},
    {"question": "Why did she leave?"},
])
def test_statements_match_jax(item):
    assert TZ.statement_for_qa_item(item) == JZ.statement_for_qa_item(item)
    assert TZ.question_to_statement(item["question"]) == JZ.question_to_statement(
        item["question"])


VTT = """WEBVTT
Kind: captions
Language: en

00:00:00.000 --> 00:00:02.000
hello<00:00:00.500><c> world</c><00:00:01.000><c> again</c>

00:00:02.000 --> 00:00:04.000
plain cue words here

00:00:03.500 --> 00:00:05,250
plain cue words here and more
"""


def test_subtitles_match_jax():
    words = TSUB.parse_vtt(VTT)
    assert words == JSUB.parse_vtt(VTT)
    bounds = [{"start_time": 0.0, "end_time": 2.0}, {"start_time": 2.0, "end_time": 6.0}]
    assert TSUB.words_to_segments(words, bounds) == JSUB.words_to_segments(words, bounds)
    assert [w["word"] for w in words[:3]] == ["hello", "world", "again"]


# ---------------------------------------------------------------------------
# FLOP counts and meters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["base", "large"])
def test_flop_counts_match_jax(name):
    ours, theirs = load_config(name), mr.load_config(name)
    for pre in (False, True):
        assert (TPROF.encode_flops(ours, 8, 8, include_preprocess=pre)
                == JPROF.encode_flops(theirs, 8, 8, include_preprocess=pre))
    assert TPROF.pretrain_step_flops(ours, 8) == JPROF.pretrain_step_flops(theirs, 8)
    assert TPROF.transformer_layer_flops(640, 768) == JPROF.transformer_layer_flops(640, 768)


def test_device_peak_flops_knows_only_cuda_cards(monkeypatch):
    assert TPROF.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert TPROF.device_peak_flops("cuda:0") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other Card")
    assert TPROF.device_peak_flops("cuda:0") is None


def test_meter_and_jsonl(tmp_path):
    meter = TPROF.ThroughputMeter(window=2, batch_size=4)
    assert meter.step() is None
    out = meter.step()
    assert set(out) == {"it_per_sec", "examples_per_sec"} and out["it_per_sec"] > 0
    path = tmp_path / "m.jsonl"
    TPROF.log_jsonl(str(path), {"a": 1})
    TPROF.log_jsonl(str(path), {"b": 2})
    assert [json.loads(x) for x in path.read_text().splitlines()] == [{"a": 1}, {"b": 2}]
