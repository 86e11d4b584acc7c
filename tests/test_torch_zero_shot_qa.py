"""Port parity: the zero-shot rankers (finetune/models.py
MerlotReserveVCRZeroShot and MerlotReserveTVQAZeroShot) and
zero_shot_qa_eval (zero_shot.py) against the JAX package's, the heads'
tower sets, and the finetuning and zero-shot scripts on the CPU, at tiny
widths (hidden 64, 2 layers per tower, grid (4, 4), f32).

Tolerances:
  * the rankers' cosine logits within 1e-6 of JAX's on the same weights
    (the same operations in f32, measured within 7e-8); the JAX module's
    parameter tree loads strictly into the port's (no parameter missing or
    left over: the port builds the towers the JAX module creates
    parameters for);
  * zero_shot_qa_eval: metrics and rows equal to JAX's, on the same
    records and weights (a full pretrained tree, whose audio tower the VCR
    ranker leaves out, as flax's apply ignores unused parameters).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.finetune import models as jm
from merlot_reserve_tpu.zero_shot import zero_shot_qa_eval as jax_zero_shot_qa_eval
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_finetune_corpus
from merlot_reserve_tpu_torch.finetune import models as tm
from merlot_reserve_tpu_torch.finetune.data import finetune_batches
from merlot_reserve_tpu_torch.models.model import OPTIONAL_TOWERS, MerlotReserve
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.training.trainer import create_train_state
from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from merlot_reserve_tpu_torch.utils.weights import flax_from_state_dict, load_flax_params
from merlot_reserve_tpu_torch.zero_shot import zero_shot_qa_eval
from test_torch_data_train import one_torch_thread  # noqa: F401

TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(lang_seq_len=48, num_segments=7)
HEADS = {"vcr": (jm.MerlotReserveVCRZeroShot, tm.MerlotReserveVCRZeroShot),
         "tvqa": (jm.MerlotReserveTVQAZeroShot, tm.MerlotReserveTVQAZeroShot)}


def _configs():
    return (mr.load_config("base", **TINY).replace_data(**DATA),
            load_config("base", **TINY).replace_data(**DATA))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{task: path} of 3 synthetic records (batches of 2: one 'pad' row)."""
    _, tcfg = _configs()
    d = tmp_path_factory.mktemp("zero_shot_qa")
    return {task: write_synthetic_finetune_corpus(str(d / f"{task}.tfrecord"), tcfg, task,
                                                  num_records=3, seed=2)
            for task in HEADS}


def _batches(path, cfg, task):
    return finetune_batches([path], cfg, f"{task}_zero_shot", 2, is_training=False,
                            repeat=False, return_ids=True)


@pytest.mark.parametrize("task", sorted(HEADS))
def test_rankers_match_jax(records, task):
    jcfg, tcfg = _configs()
    j_cls, t_cls = HEADS[task]
    _, batch = next(_batches(records[task], tcfg, task))
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    j_model = j_cls.from_config(jcfg)
    # the JAX module's parameter tree (traced, not run) loads strictly into
    # the port's head: the same towers, names and shapes
    shapes = jax.eval_shape(lambda: j_model.init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v[:1]) for k, v in inputs.items()}))["params"]
    load_flax_params(t_cls(tcfg, device="cpu"),
                     jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes))
    # the weights: the port's random init, read into both
    model = t_cls(tcfg, device="cpu", seed=4)
    params = flax_from_state_dict(model.state_dict(), TINY["size_per_head"])
    j_out = jax.jit(lambda p, b: j_model.apply({"params": p}, b))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        out = model(batch_to_tensors(inputs, "cpu"))
    j_out, out = (j_out, out) if task == "tvqa" else ((j_out,), (out,))
    for j, t in zip(j_out, out):
        assert tuple(t.shape) == j.shape == ((2, 5) if task == "tvqa" else (2, 2, 4))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
        assert t.abs().max() <= 1.0 + 1e-6  # cosines


@pytest.mark.parametrize("task", sorted(HEADS))
def test_zero_shot_qa_eval_matches_jax(records, task):
    """A full pretrained tree (every tower) from the port's random weights,
    evaluated by both packages on the same records."""
    jcfg, tcfg = _configs()
    j_cls, t_cls = HEADS[task]
    pretrained = MerlotReserve(tcfg, device="cpu", seed=3)
    params = flax_from_state_dict(pretrained.state_dict(), TINY["size_per_head"])
    temperature = 10.0
    j_metrics, j_rows = jax_zero_shot_qa_eval(j_cls.from_config(jcfg), params,
                                              _batches(records[task], tcfg, task), task,
                                              temperature=temperature)
    model = t_cls(tcfg, device="cpu")
    metrics, rows = zero_shot_qa_eval(model, params, _batches(records[task], tcfg, task), task,
                                      temperature=temperature)
    assert metrics == j_metrics and rows == j_rows
    assert metrics["n"] == 3 and len(rows) == 3  # the 'pad' row is skipped
    # the weights stay loaded: a second pass with params=None gives the same
    again = zero_shot_qa_eval(model, None, _batches(records[task], tcfg, task), task,
                              temperature=temperature)
    assert again == (metrics, rows)


def test_each_head_builds_only_its_towers():
    """Finetune heads: no span tower, no contrastive head (VCR: no audio
    tower), plus proj; zero-shot rankers: the span tower and head, no proj
    (VCR: no audio tower); nothing built on the meta device holds storage."""
    _, tcfg = _configs()
    have = {cls: {t for t in OPTIONAL_TOWERS if hasattr(cls(tcfg, device="meta"), t)}
            for cls in (tm.MerlotReserveVCR, tm.MerlotReserveTVQA,
                        tm.MerlotReserveVCRZeroShot, tm.MerlotReserveTVQAZeroShot)}
    assert have[tm.MerlotReserveVCR] == {"vision_encoder"}
    assert have[tm.MerlotReserveTVQA] == {"vision_encoder", "audio_encoder"}
    assert have[tm.MerlotReserveVCRZeroShot] == {"vision_encoder", "span_encoder", "head"}
    assert have[tm.MerlotReserveTVQAZeroShot] == set(OPTIONAL_TOWERS)
    assert hasattr(tm.MerlotReserveVCR(tcfg, device="meta"), "proj")
    assert not hasattr(tm.MerlotReserveVCRZeroShot(tcfg, device="meta"), "proj")
    meta = MerlotReservePretrainer(tcfg, device="meta")
    assert all(p.is_meta for p in meta.parameters())
    with pytest.raises(ValueError, match="unknown towers"):
        MerlotReserve(tcfg, device="meta", towers=("proj",))


# ---------------------------------------------------------------------------
# the scripts on the CPU: finetuning on records, then zero-shot QA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A tiny YAML config and a pretraining checkpoint of it."""
    d = tmp_path_factory.mktemp("scripts")
    cfg_path = d / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({"model": {**TINY, "output_grid": [4, 4]}}))
    cfg = load_config(str(cfg_path))
    save_checkpoint(create_train_state(cfg, MerlotReservePretrainer(cfg, device="cpu")),
                    str(d / "pretrained"))
    return d, str(cfg_path), str(d / "pretrained" / "ckpt_0")


def test_finetune_scripts_on_the_cpu(records, pretrained, capsys):
    """scripts/finetune_{vcr,tvqa}_torch.py: one step on the synthetic
    records from the pretraining checkpoint, a validation pass over 3
    records (the 'pad' row left out), a checkpoint without the optimizer."""
    from scripts.finetune_tvqa_torch import main as tvqa_main
    from scripts.finetune_vcr_torch import main as vcr_main

    d, cfg_path, ckpt = pretrained
    for task, main, extra in (("vcr", vcr_main, ["-output_grid_h", "4", "-output_grid_w", "4"]),
                              ("tvqa", tvqa_main, ["-test_fns", records["tvqa"]])):
        out = str(d / f"finetuned_{task}")
        os.makedirs(out, exist_ok=True)
        record = main([cfg_path, "-ckpt", ckpt, "-train_fns", records[task], "-val_fns",
                       records[task], "-output_dir", out, "-ne", "1", "-batch_size", "2",
                       "-train_size", "2", "-log_every", "1", "-scan_minibatch",
                       "--device", "cpu", *extra])
        (step,) = record["steps"]
        assert step["step"] == 0 and all(np.isfinite(v) for v in step["metrics"].values())
        (acc,) = record["evaluations"]
        assert set(acc) == ({"qa", "qar"} if task == "vcr" else {"audio", "text", "joint"})
        assert all(v in (0.0, 1 / 3, 2 / 3, 1.0) for v in acc.values())  # 3 rows, not 4
        assert load_checkpoint(out)["opt_state"] is None
        assert "proj" in load_checkpoint(out)["params"]
    printed = capsys.readouterr().out
    assert "epoch 0 it 1: " in printed and "epoch 0: qa acc " in printed
    with open(d / "finetuned_tvqa" / "prediction_test_public_joint.json") as f:
        assert list(json.load(f)) == ["tvqa-0"]  # one id: the records share it


@pytest.mark.parametrize("task", sorted(HEADS))
def test_zero_shot_scripts_on_the_cpu(records, pretrained, task, capsys):
    """scripts/zero_shot_{vcr,tvqa}_torch.py from the pretraining checkpoint:
    the metrics printed as JSON and the rows written, equal to
    zero_shot_qa_eval called directly."""
    import importlib

    main = importlib.import_module(f"scripts.zero_shot_{task}_torch").main
    d, cfg_path, ckpt = pretrained
    rows_path = str(d / f"rows_{task}.json")
    extra = ["-grid", "4,4"] if task == "tvqa" else []
    metrics, rows = main([cfg_path, "-ckpt", ckpt, "-val_fns", records[task], "-batch_size",
                          "2", "-out", rows_path, "--device", "cpu", *extra])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == metrics
    with open(rows_path) as f:
        assert json.load(f) == rows
    cfg = load_config(cfg_path).replace_data(
        **({"lang_seq_len": 144} if task == "vcr" else {"lang_seq_len": 256, "num_segments": 7}))
    direct = zero_shot_qa_eval(HEADS[task][1](cfg, device="cpu"),
                               load_checkpoint(ckpt)["params"],
                               _batches(records[task], cfg, task), task)
    assert direct == (metrics, rows) and metrics["n"] == 3
