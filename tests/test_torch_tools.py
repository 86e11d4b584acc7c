"""Port parity: the checkpoint tools, the VCR leaderboard, the serving
export script and the demos of the PyTorch port (scripts/*_torch.py,
demo/*_torch.py, utils.checkpoint.param_overview) at tiny widths (hidden
128, 1 layer per tower, f32).

Tolerances:
  * scripts/convert_checkpoint_torch.py against scripts/convert_checkpoint.py
    on checkpoints the JAX package wrote: every leaf of the written trees
    bit for bit (dtype and bits), in every mode;
  * scripts/vcr_leaderboard_torch.py against scripts/vcr_leaderboard.py on
    the same records and checkpoint: annot ids, columns and their order
    exactly, probabilities within 1e-5. Both run dense attention on the CPU
    (the config's 'auto'; JAX's Pallas kernel runs there only in interpret
    mode). The records' images are at the grid's size (64x64 for 4x4), so
    neither resize (the JAX package's PIL, the port's native one) moves a
    pixel; what is left is f32 arithmetic in another order;
  * the demos against the JAX package's demos (demo/*.py), run on the same
    media (both packages' ffmpeg helpers answer with the same arrays) and
    the same checkpoint (f16 on disk; the JAX demos' ``from_pretrained``
    hands back the JAX wrapper on it): segment times, vocabularies, label
    spaces, ids, rankings, metrics and printed lines exactly; each package
    computes its own log-mels (within 1e-3 of each other,
    tests/test_torch_frontend.py), so MASK features agree within
    DEMO_EMBED_ATOL and option probabilities within DEMO_PROB_ATOL; label
    space logits from one shared features file within LOGIT_ATOL (1e-2:
    temperature 100 on 1e-4 embeddings, as tests/test_torch_zero_shot.py).
"""

import contextlib
import csv
import json
import os
import pickle
import subprocess
import sys
import zlib
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import merlot_reserve_tpu as mr
import merlot_reserve_tpu.preprocess as jax_preprocess
import merlot_reserve_tpu.zero_shot as jax_zero_shot
import merlot_reserve_tpu_torch.preprocess as port_preprocess
import merlot_reserve_tpu_torch.zero_shot as port_zero_shot
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.models.model import PretrainedMerlotReserve as JaxPretrained
from merlot_reserve_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from merlot_reserve_tpu.utils import checkpoint as jck
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.finetune.models import MerlotReserveVCR
from merlot_reserve_tpu_torch.models import MerlotReserve, PretrainedMerlotReserve
from merlot_reserve_tpu_torch.utils import checkpoint as tck
from merlot_reserve_tpu_torch.utils import msgpack
from merlot_reserve_tpu_torch.utils.weights import flax_tensors_from_state_dict

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(hidden_size=128, joint_num_layers=1, vit_num_layers=1, audio_num_layers=1,
            span_num_layers=1, use_bfloat16=False)
PROBS_ATOL = 1e-5
DEMO_EMBED_ATOL = 1e-4
DEMO_PROB_ATOL = 1e-4
LOGIT_ATOL = 1e-2
GRID = (12, 20)  # the QA and EK100 demos' grid


@contextlib.contextmanager
def flax_msgpack_writer():
    """flax's legacy msgpack checkpoint writer, for the JAX package's writes."""
    old = flax.config.flax_use_orbax_checkpointing
    flax.config.update("flax_use_orbax_checkpointing", False)
    try:
        yield
    finally:
        flax.config.update("flax_use_orbax_checkpointing", old)


def _run_jax_script(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    with flax_msgpack_writer():
        module.main()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny YAML config (grid 4x4), its MerlotReserve checkpoint written by
    the port, and a VCR head's."""
    d = tmp_path_factory.mktemp("tools")
    cfg_path = str(d / "tiny.yaml")
    Path(cfg_path).write_text(yaml.safe_dump({"model": {**TINY, "output_grid": [4, 4]}}))
    cfg = load_config(cfg_path)
    for name, model in (("model", MerlotReserve(cfg, device="cpu", seed=1)),
                        ("vcr", MerlotReserveVCR(cfg.replace_data(lang_seq_len=144),
                                                 device="cpu", seed=2))):
        tree = flax_tensors_from_state_dict(dict(model.named_parameters()))
        tck.save_checkpoint({"step": torch.tensor(0, dtype=torch.int32), "params": tree},
                            str(d / name))
    return d, cfg_path


# ---------------------------------------------------------------------------
# convert_checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """Two train-state checkpoints the JAX package wrote: params stacked
    ('layers') and in the layer_NN layout, with bf16 moments and counts."""
    d = tmp_path_factory.mktemp("jax_ckpts")
    jmodel = JaxMerlotReserve.from_config(mr.load_config("base", output_grid=(4, 4), **TINY))
    params = jax.tree.map(np.asarray, jmodel.init_params_full())
    moment = lambda s: jax.tree.map(lambda x: np.asarray(jnp.asarray(x * s, jnp.bfloat16)),
                                    params)
    count = np.asarray(3, np.int32)
    paths = {}
    for layout, tree in (("stacked", params), ("layer_NN", jck.unstack_layer_params(params))):
        state = {"step": np.asarray(7, np.int32), "params": tree,
                 "opt_state": {"0": {"count": count, "mu": moment(0.5), "nu": moment(1e-3)},
                               "1": {"inner_state": {}}, "2": {"count": count}, "3": {}}}
        with flax_msgpack_writer():
            jck.save_checkpoint(state, str(d / layout))
        paths[layout] = str(d / layout)
    return paths


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        assert torch.equal(a.contiguous().view(bits), b.contiguous().view(bits)), path
    else:
        assert a == b, path


CONVERT_MODES = {
    "plain": ("stacked", ["--step", "7"]),
    "to_scan": ("layer_NN", ["--to-scan"]),
    "to_layers": ("stacked", ["--to-layers"]),
    "no_optimizer": ("stacked", ["--no-optimizer"]),
    "bfloat16": ("stacked", ["--bfloat16"]),
    "all": ("stacked", ["--to-layers", "--no-optimizer", "--bfloat16"]),
}


@pytest.mark.parametrize("mode", sorted(CONVERT_MODES))
def test_convert_checkpoint_matches_jax_script(jax_checkpoints, mode, tmp_path, monkeypatch):
    from scripts import convert_checkpoint as jax_convert
    from scripts.convert_checkpoint_torch import main

    layout, flags = CONVERT_MODES[mode]
    src = jax_checkpoints[layout]
    _run_jax_script(monkeypatch, jax_convert, [src, str(tmp_path / "jax"), *flags])
    written = main([src, str(tmp_path / "port"), *flags])
    assert written == str(tmp_path / "port" / "ckpt_7")
    _assert_same_tree(msgpack.load(written), msgpack.load(tmp_path / "jax" / "ckpt_7"))
    out = tck.load_checkpoint(written)
    if "--no-optimizer" in flags:
        assert out["opt_state"] is None
    if mode == "to_scan":  # and back: the JAX package's own stacked file
        _assert_same_tree(out["params"], tck.load_checkpoint(jax_checkpoints["stacked"])["params"])


def test_param_overview_of_a_checkpoint_is_jax_text(jax_checkpoints):
    for layout, path in jax_checkpoints.items():
        port = tck.load_checkpoint(path)["params"]
        jax_tree = jck.load_checkpoint(path)["params"]
        assert tck.param_overview(port) == jck.param_overview(jax_tree), layout


# ---------------------------------------------------------------------------
# vcr_leaderboard
# ---------------------------------------------------------------------------

ANNOTS = (10, 2, 7)  # out of order: rows sort by the annot number


def _leaderboard_records(path):
    """Per annot 4 records, the rationale query conditioned on each answer;
    64x64 images (the 4x4 grid's size)."""
    from merlot_reserve_tpu_torch.data.tfrecord import write_records
    from scripts.prep_vcr_torch import vcr_record

    rng = np.random.default_rng(3)
    words = "the a person dog cup why is looking at because it they so".split()
    say = lambda n: [str(w) for w in rng.choice(words, n)]
    records = []
    for n in ANNOTS:
        image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        for c in range(4):
            ann = {"id": f"test-{n}-cond_{c}", "boxes": [[4, 4, 30, 40]], "names": ["person"],
                   "qa_query": ["Why", "is", [0], "here", "?"],
                   "qa_choices": [say(3) for _ in range(4)], "qa_label": 0,
                   "qar_query": say(4) + ["?"], "qar_choices": [say(5) for _ in range(4)],
                   "qar_label": 0}
            records.append(vcr_record(ann, image))
    write_records(path, records)
    return path


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.asarray([r[1:] for r in rows[1:]], np.float64)


def test_vcr_leaderboard_matches_jax_script(tiny, tmp_path, monkeypatch, capsys):
    from scripts import vcr_leaderboard as jax_leaderboard
    from scripts.vcr_leaderboard_torch import main

    d, cfg_path = tiny
    records = _leaderboard_records(str(tmp_path / "test.tfrecord"))
    common = ["-ckpt", str(d / "vcr"), "-test_fns", records, "-batch_size", "5",
              "-output_grid_h", "4", "-output_grid_w", "4"]
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    _run_jax_script(monkeypatch, jax_leaderboard,
                    [cfg_path, *common, "-out", str(tmp_path / "jax.csv")])
    out = main([cfg_path, *common, "-out", str(tmp_path / "port.csv"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith(f"wrote {len(ANNOTS)} rows to "
                                                    f"{tmp_path / 'port.csv'}")
    cols, ids, probs = _read_csv(tmp_path / "port.csv")
    jcols, jids, jprobs = _read_csv(tmp_path / "jax.csv")
    assert cols == jcols and ids == jids == [f"test-{n}" for n in sorted(ANNOTS)]
    assert len(cols) == 1 + 4 + 16 and set(out) == set(ids)
    np.testing.assert_allclose(probs, jprobs, atol=PROBS_ATOL, rtol=0)
    np.testing.assert_allclose(probs[:, :4].sum(1), 1.0, atol=1e-5)


def test_leaderboard_merge_leaves_padding_out(tmp_path):
    from collections import defaultdict

    from scripts.vcr_leaderboard_torch import merge_predictions, write_submission

    out = defaultdict(dict)
    probs = np.tile(np.linspace(0.1, 0.4, 4), (3, 2, 1))
    merge_predictions(out, ["val-3-x_1", "pad", "val-3-x_0"], probs)
    assert list(out) == ["val-3"] and len(out["val-3"]) == 4 + 8
    assert write_submission(out, str(tmp_path / "s.csv")) == 1
    merge_predictions(out, ["val-1-x_0"], probs[:1])  # no rationale under answer 1
    with pytest.raises(ValueError, match="missing columns for val-1"):
        write_submission(out, str(tmp_path / "s.csv"))


# ---------------------------------------------------------------------------
# export_serving_torch
# ---------------------------------------------------------------------------


def test_export_serving_script_on_the_cpu(tiny, tmp_path):
    from merlot_reserve_tpu_torch.export import load_serving_artifact
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params
    from scripts.export_serving_torch import main

    d, cfg_path = tiny
    manifest = main([cfg_path, "-ckpt", str(d / "model"), "-out", str(tmp_path / "art"),
                     "-batch_size", "2", "-num_segments", "2", "-num_options", "4",
                     "-output_grid_h", "4", "-output_grid_w", "4", "--device", "cpu"])
    assert manifest["platforms"] == ["cpu"]
    assert manifest["input_shapes"]["tokens"] == [2, 160]
    svc = load_serving_artifact(str(tmp_path / "art"), device="cpu")
    model = MerlotReserve(load_config(cfg_path, output_grid=(4, 4)), device="cpu")
    load_flax_params(model, tck.load_checkpoint(str(d / "model"))["params"])
    opts = np.zeros((3, 15), np.int64)
    opts[:, :2] = [[11, 2], [22, 2], [33, 2]]
    with torch.no_grad():
        live = model.embed_text_spans_only(torch.from_numpy(opts)).numpy()
    np.testing.assert_allclose(svc.label_space(opts), live, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the demos, against the JAX package's demos on the same media and weights
# ---------------------------------------------------------------------------

ENTRY_POINTS = ["demo/demo_video_torch.py", "demo/zero_shot_qa_torch.py",
                "demo/zero_shot_ek100_torch.py", "demo/load_video_torch.py",
                "scripts/export_serving_torch.py", "scripts/convert_checkpoint_torch.py",
                "scripts/vcr_leaderboard_torch.py"]


@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_help(path):
    res = subprocess.run([sys.executable, str(ROOT / path), "--help"], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-500:]
    assert "usage" in res.stdout.lower()


class _Recorded:
    """``fn``, keeping each call's (args, kwargs, result)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


@pytest.fixture(scope="module")
def demo_ckpt(tiny):
    """A checkpoint at the demos' 12x20 grid written by the port (f16 on
    disk), and the JAX package's wrapper on the parameters JAX reads from it.
    Every matrix but the embeddings is scaled by 4: at the initial scale
    the MASK state of one layer hardly sees its context (1e-5 in the
    probabilities when the frames or the prompt's segment change, below
    the tolerance), at 4x it does (5e-3 to 1e-2)."""
    d, cfg_path = tiny
    model = MerlotReserve(load_config(cfg_path, output_grid=GRID), device="cpu", seed=3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and "embed" not in name:
                p.mul_(4.0)
    tree = flax_tensors_from_state_dict(dict(model.named_parameters()))
    tck.save_checkpoint({"step": torch.tensor(0, dtype=torch.int32), "params": tree},
                        str(d / "demo"))
    params = jck.stack_layer_params(jck.load_checkpoint(str(d / "demo"))["params"])
    jmodel = JaxMerlotReserve.from_config(mr.load_config("base", output_grid=GRID, **TINY))
    jax_pre = JaxPretrained(encoder=jax_get_tokenizer(), model=jmodel,
                            params=jax.tree.map(jnp.asarray, params))
    return str(d / "demo"), cfg_path, jax_pre


def _fake_media(monkeypatch, durations=None):
    """Both packages' ffmpeg helpers answer with arrays made from the file's
    name (and the frames' times): 192x320 frames, the 12x20 grid's size, so
    neither package's resize moves a pixel; 51 s unless ``durations`` says."""
    durations = durations or {}
    seed = lambda *parts: zlib.crc32("|".join(map(str, parts)).encode())
    duration = lambda fn: durations.get(os.path.basename(fn), 51.0)

    def frames(fn, times, **_):
        rng = np.random.default_rng(seed(os.path.basename(fn), [round(t, 6) for t in times]))
        return rng.integers(0, 256, (len(times), 192, 320, 3), dtype=np.uint8)

    def audio(fn, sr=22050):
        rng = np.random.default_rng(seed(os.path.basename(fn)))
        return (0.1 * rng.standard_normal(int(sr * duration(fn)))).astype(np.float32)

    for module in (jax_preprocess, port_preprocess):
        monkeypatch.setattr(module, "video_duration", duration)
        monkeypatch.setattr(module, "extract_frames_from_video", frames)
        monkeypatch.setattr(module, "extract_audio_waveform", audio)


def _run_jax_demo(monkeypatch, jax_pre, module, argv):
    """A JAX demo's ``main`` on ``argv``, its ``from_pretrained`` handing
    back ``jax_pre`` (no download)."""
    monkeypatch.setattr(JaxPretrained, "from_pretrained",
                        classmethod(lambda cls, *a, **k: jax_pre))
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


def _record(monkeypatch, module, name):
    recorded = _Recorded(getattr(module, name))
    monkeypatch.setattr(module, name, recorded)
    return recorded


def _printed_probs(text):
    """demo_video's printout -> per MASK {option: printed percent}."""
    masks = []
    for line in text.splitlines():
        if line.startswith("MASK "):
            masks.append({})
        elif masks and line.startswith("  ") and "%" in line:
            pct, option = line.strip().split("%", 1)
            masks[-1][option.strip()] = float(pct)
    return masks


def test_demo_video_mask_infill(demo_ckpt, monkeypatch, capsys):
    """demo_video_torch against demo/demo_video.py on one 51-s video (9
    segments, 8 of them from the second on): the same segment lines, and
    each option's probability within the printed percentage's rounding
    (0.05) plus DEMO_PROB_ATOL."""
    import demo.demo_video as jax_demo
    from demo.demo_video_torch import main

    ckpt, cfg_path, jax_pre = demo_ckpt
    _fake_media(monkeypatch)
    options = ["making coffee", "going backpacking", "a cat", "cooking pasta", "the beach"]
    argv = ["v.mp4", "--grid", "12,20", "--options", ",".join(options), "--start_segment", "1"]
    _run_jax_demo(monkeypatch, jax_pre, jax_demo, [*argv, "--model", "base"])
    jax_out = capsys.readouterr().out
    probs = main([*argv, "-ckpt", ckpt, "--model", cfg_path, "--device", "cpu"])
    port_out = capsys.readouterr().out
    segment_lines = lambda text: [ln for ln in text.splitlines() if ln.startswith("Segment")]
    assert len(segment_lines(jax_out)) == 8
    assert segment_lines(port_out) == segment_lines(jax_out)
    (printed,) = _printed_probs(jax_out)
    assert probs.shape == (1, len(options)) and sorted(printed) == sorted(options)
    np.testing.assert_allclose(100 * probs[0], [printed[o] for o in options],
                               atol=0.05 + 100 * DEMO_PROB_ATOL, rtol=0)
    (port_printed,) = _printed_probs(port_out)
    assert sorted(port_printed) == sorted(options)


def test_zero_shot_qa_demo_core(demo_ckpt, tmp_path, monkeypatch, capsys):
    """build_vocab and infer of zero_shot_qa_torch against
    demo/zero_shot_qa.py: the vocabulary file exactly (ties in first-seen
    order), each item's probabilities within DEMO_PROB_ATOL and its answer
    equal, every printed line (the skipped video, the accuracy) equal; and
    ``answer`` on its own gives the JAX demo's answer."""
    import demo.zero_shot_qa as jax_demo
    from demo.zero_shot_qa_torch import answer, build_vocab, main

    ckpt, cfg_path, jax_pre = demo_ckpt
    answers = ["dog", "cat", "car", "dog", "cup", "cat", "man", "dog", "car", "cup"]
    (tmp_path / "train.json").write_text(json.dumps([{"answer": a} for a in answers]))
    vocab_argv = ["build_vocab", "--train_qa", str(tmp_path / "train.json"), "--top_k", "4"]
    _run_jax_demo(monkeypatch, jax_pre, jax_demo,
                  [*vocab_argv, "--out", str(tmp_path / "jax_vocab.txt")])
    vocab = main([*vocab_argv, "--out", str(tmp_path / "vocab.txt")])
    assert (tmp_path / "vocab.txt").read_text() == (tmp_path / "jax_vocab.txt").read_text()
    assert vocab == build_vocab([{"answer": a} for a in answers], 4) == ["dog", "cat", "car",
                                                                         "cup"]
    assert capsys.readouterr().out.count("wrote 4 answers to") == 2

    qa = [{"video_id": 1, "question": "what is the man holding?", "answer": "cup"},
          {"video_id": 2, "question": "a car is being driven through <|MASK|>.",
           "answer": "dog"},
          {"video_id": 3, "question": "what is it?", "answer": "cat"},  # 4 s: skipped
          {"video_id": 4, "question": "x?", "statement": "the animal is a <|MASK|>",
           "answer": "cat"}]
    (tmp_path / "qa.json").write_text(json.dumps(qa))
    _fake_media(monkeypatch, {"video3.mp4": 4.0})
    argv = ["infer", "--videos", str(tmp_path), "--qa", str(tmp_path / "qa.json"),
            "--vocab", str(tmp_path / "vocab.txt")]
    jax_rank = _record(monkeypatch, jax_zero_shot, "rank_options")
    _run_jax_demo(monkeypatch, jax_pre, jax_demo, argv)
    jax_out = capsys.readouterr().out
    port_rank = _record(monkeypatch, port_zero_shot, "rank_options")
    n_correct, n_total = main([*argv, "-ckpt", ckpt, "--model", cfg_path, "--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    assert "skip " in jax_out and f"accuracy: {n_correct}/3 " in jax_out and n_total == 3
    assert len(port_rank.calls) == len(jax_rank.calls) == 3
    jax_answers = [vocab[int(np.argmax(out[0]))] for _, _, out in jax_rank.calls]
    for (_, _, ours), (_, _, theirs) in zip(port_rank.calls, jax_rank.calls):
        assert ours.shape == theirs.shape == (1, len(vocab))
        np.testing.assert_allclose(ours, theirs, atol=DEMO_PROB_ATOL, rtol=0)
    assert [vocab[int(np.argmax(out[0]))] for _, _, out in port_rank.calls] == jax_answers

    model = PretrainedMerlotReserve.from_params(cfg_path, tck.pretrained_params(ckpt), GRID,
                                                device="cpu")
    segments = port_preprocess.video_to_segments(str(tmp_path / "video1.mp4"),
                                                 num_segments_max=8, device="cpu")
    assert answer(model, segments, qa[0], vocab, device="cpu") == jax_answers[0]


EK_ANNOTATIONS = [  # (narration, video, start_frame, fps, verb, noun)
    ("P01_n0", "P01", "600", "30", 0, 3), ("P01_n1", "P01", "1380", "59.94", 4, 1),
    ("P02_n0", "P02", "45", "25", 1, 0), ("P02_n1", "P02", "9999", "50", 2, 2)]


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


def test_zero_shot_ek100_demo_extract_matches_jax(demo_ckpt, tmp_path, monkeypatch, capsys):
    """extract of zero_shot_ek100_torch against demo/zero_shot_ek100.py on
    the same annotations, in batches of 2: each annotation's 8 segment times
    exactly (the anticipation formula at several start frames and rates,
    clamped near the video's start), the ids exactly, the MASK features
    within DEMO_EMBED_ATOL."""
    import demo.zero_shot_ek100 as jax_demo
    from demo.zero_shot_ek100_torch import anticipation_times, main

    ckpt, cfg_path, jax_pre = demo_ckpt
    anns = [{"narration_id": n, "video_id": v, "start_frame": f, "fps": fps,
             "verb_class": str(vc), "noun_class": str(nc)}
            for n, v, f, fps, vc, nc in EK_ANNOTATIONS]
    argv = ["extract", "--videos", str(tmp_path), "--annotations",
            _write_csv(tmp_path / "ann.csv", anns), "--batch_size", "2"]
    _fake_media(monkeypatch)
    jax_segments = _record(monkeypatch, jax_preprocess, "video_to_segments_zero_shot")
    port_segments = _record(monkeypatch, port_preprocess, "video_to_segments_zero_shot")
    _run_jax_demo(monkeypatch, jax_pre, jax_demo, [*argv, "--out", str(tmp_path / "jax.pkl")])
    ids = main([*argv, "--out", str(tmp_path / "port.pkl"), "-ckpt", ckpt, "--model", cfg_path,
                "--device", "cpu"])
    assert capsys.readouterr().out.count("wrote 4 features to") == 2
    jax_times = [kw["times"] for _, kw, _ in jax_segments.calls]
    assert [kw["times"] for _, kw, _ in port_segments.calls] == jax_times
    assert [anticipation_times(a) for a in anns] == jax_times
    assert jax_times[2][0] == {"start_time": 0.0, "end_time": 0.5, "mid_time": 0.25}
    with open(tmp_path / "jax.pkl", "rb") as f:
        theirs = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        ours = pickle.load(f)
    assert ours["ids"] == theirs["ids"] == ids == [a["narration_id"] for a in anns]
    assert ours["features"].shape == theirs["features"].shape == (4, 128)
    np.testing.assert_allclose(ours["features"], theirs["features"], atol=DEMO_EMBED_ATOL,
                               rtol=0)


def test_zero_shot_ek100_demo_eval(demo_ckpt, tmp_path, monkeypatch, capsys):
    """eval of zero_shot_ek100_torch against demo/zero_shot_ek100.py on one
    features pickle: the label space's text and order exactly (class keys
    with '-' and ':'), its logits within LOGIT_ATOL, each item's ranking,
    label and metrics exactly, and the printed lines equal. Two
    annotations lie outside the features and only widen the label space."""
    import demo.zero_shot_ek100 as jax_demo
    from demo.zero_shot_ek100_torch import main

    ckpt, cfg_path, jax_pre = demo_ckpt
    verbs = [{"id": "0", "key": "take"}, {"id": "1", "key": "put-down"},
             {"id": "2", "key": "turn-on"}, {"id": "3", "key": "wash"}]
    nouns = [{"id": "0", "key": "cup"}, {"id": "1", "key": "knife:chef"},
             {"id": "2", "key": "pan:frying"}, {"id": "3", "key": "oil-olive"}]
    pairs = [(3, 1), (0, 3), (1, 0), (2, 2), (0, 3), (2, 1), (3, 3), (1, 2)]
    anns = [{"narration_id": f"n{i}", "video_id": "v", "verb_class": str(v),
             "noun_class": str(n)} for i, (v, n) in enumerate(pairs)]
    ids = [f"n{i}" for i in range(6)]
    feats = np.random.default_rng(8).standard_normal((len(ids), 128)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    with open(tmp_path / "feats.pkl", "wb") as f:
        pickle.dump({"ids": ids, "features": feats}, f)
    argv = ["eval", "--feats", str(tmp_path / "feats.pkl"),
            "--annotations", _write_csv(tmp_path / "ann.csv", anns),
            "--verb_classes", _write_csv(tmp_path / "verbs.csv", verbs),
            "--noun_classes", _write_csv(tmp_path / "nouns.csv", nouns)]
    recorded = {(name, fn): _record(monkeypatch, module, fn)
                for name, module in (("jax", jax_zero_shot), ("port", port_zero_shot))
                for fn in ("score_label_space", "verb_noun_action_accuracy")}
    _run_jax_demo(monkeypatch, jax_pre, jax_demo, argv)
    jax_out = capsys.readouterr().out
    metrics = main([*argv, "-ckpt", ckpt, "--model", cfg_path, "--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    (jax_args, _, jax_logits), = recorded["jax", "score_label_space"].calls
    (port_args, _, port_logits), = recorded["port", "score_label_space"].calls
    assert port_args[2] == jax_args[2] == [
        "take oil olive", "put down cup", "put down pan", "turn on knife", "turn on pan",
        "wash knife", "wash oil olive"]
    np.testing.assert_allclose(port_logits, jax_logits, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(np.argsort(-port_logits, -1), np.argsort(-jax_logits, -1))
    (jax_acc_args, _, jax_metrics), = recorded["jax", "verb_noun_action_accuracy"].calls
    (port_acc_args, _, _), = recorded["port", "verb_noun_action_accuracy"].calls
    for ours, theirs in zip(port_acc_args[1:], jax_acc_args[1:]):  # labels, action maps
        np.testing.assert_array_equal(ours, theirs)
    assert metrics == jax_metrics


def test_load_video_demo(tmp_path, monkeypatch):
    """load_video on a local video (the ffmpeg helpers return the test's
    arrays) and a local VTT; the subtitles bucketed as the JAX demo does."""
    import demo.load_video as jax_load_video
    from demo.load_video_torch import attach_subtitles, load_video
    from merlot_reserve_tpu_torch.utils.subtitles import parse_vtt

    rng = np.random.default_rng(6)
    monkeypatch.setattr(port_preprocess, "video_duration", lambda fn: 31.0)
    monkeypatch.setattr(port_preprocess, "extract_frames_from_video",
                        lambda fn, times: rng.integers(0, 256, (len(times), 36, 64, 3),
                                                       dtype=np.uint8))
    monkeypatch.setattr(port_preprocess, "extract_audio_waveform",
                        lambda fn, sr=22050: np.zeros(sr * 31, np.float32))
    vtt = tmp_path / "v.vtt"
    vtt.write_text("WEBVTT\n\n00:00:01.000 --> 00:00:04.000\nhello there\n\n"
                   "00:00:06.000 --> 00:00:09.500\ngeneral kenobi\n\n"
                   "00:00:12.000 --> 00:00:13.000\nyou are\n")
    segments = load_video("v.mp4", str(vtt), start_time=0.0, num_segments_max=3, device="cpu")
    assert [s["sub"] for s in segments] == ["hello there", "general kenobi", "you are"]
    words = parse_vtt(vtt.read_text())
    bounds = [{k: s[k] for k in ("start_time", "end_time")} for s in segments]
    assert [s["sub"] for s in attach_subtitles([dict(b) for b in bounds], words)] == \
        [s["sub"] for s in jax_load_video.attach_subtitles([dict(b) for b in bounds], words)]
