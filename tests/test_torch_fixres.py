"""Port parity: the mixed-resolution (fixres) step
(training/trainer.make_mixed_res_train_step) against the JAX package's
make_jit_mixed_res_train_step, and the fixres and validation scripts, at
tiny widths (hidden 64, 2 layers per tower, grids (4, 4) and (2, 2), 4
segments in 2 groups, batch 2 per grid, f32 compute).

Tolerances, those of tests/test_torch_training.py's train_step (one Adam
step from the same weights, warmup 0, both halves' draws injected as JAX
draws them from its content keys):
  * f32 gradients: the loss terms within 2e-6, every parameter within 1e-5
    absolute after the update;
  * bf16 gradients (parameters cast to bf16 once, both halves on the same
    bf16 tensors): the loss terms within 1e-2; over the towers whose
    gradient carries signal at this init (test_torch_training._SIGNAL), the
    cosine between the port's and JAX's whole update at least 0.97; and the
    mean over all tensors of 1 - cosine to JAX's bf16 step below that to
    JAX's f32 step.
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.parallel import make_mesh as jax_make_mesh
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.training.trainer import make_jit_mixed_res_train_step
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.synthetic import (
    write_synthetic_corpus,
    write_synthetic_finetune_corpus,
)
from merlot_reserve_tpu_torch.models.pretrainer import (
    MerlotReservePretrainer,
    batch_to_tensors,
    concat_preds,
    loss_fn_given_preds,
)
from merlot_reserve_tpu_torch.training.pretrain import evaluate_loss
from merlot_reserve_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    make_mixed_res_train_step,
)
from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax
from test_torch_data_train import _model_draws, one_torch_thread  # noqa: F401
from test_torch_training import _SIGNAL, _one_minus_cos

TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, size_per_head=32, use_bfloat16=False)
GRIDS = ((4, 4), (2, 2))
DATA = dict(num_segments=4, num_segment_groups=2, lang_seq_len=76, num_text_spans_to_include=8,
            text_span_budget=10)
BATCH = 2


def _configs(grid, **optimizer):
    """(JAX config, port config) at ``grid``, seq_len its joint length."""
    out = []
    for load in (mr.load_config, load_config):
        c = load("base", output_grid=grid, **TINY).replace_data(**DATA)
        c = c.replace_data(seq_len=c.joint_seq_len)
        out.append(dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer,
                                                                        **optimizer)))
    return out


@pytest.fixture(scope="module")
def setup():
    (jcfg_a, tcfg_a), (jcfg_b, tcfg_b) = (_configs(g, num_warmup_steps=0) for g in GRIDS)
    batch_a = jax_make_dummy_batch(jcfg_a, batch_size=BATCH, seed=0, num_text_spans=16)
    batch_b = jax_make_dummy_batch(jcfg_b, batch_size=BATCH, seed=1, num_text_spans=16)
    params = jax.tree.map(np.asarray, JaxPretrainer.from_config(jcfg_a).init_params(batch_a))
    return {"cfgs": ((jcfg_a, tcfg_a), (jcfg_b, tcfg_b)), "batches": (batch_a, batch_b),
            "params": params,
            "draws": (_model_draws(batch_a, jcfg_a), _model_draws(batch_b, jcfg_b))}


def _jax_step(setup, bf16):
    """JAX's mixed step on a one-device mesh: (updated params as a port
    state_dict, loss terms)."""
    (jcfg_a, _), (jcfg_b, _) = setup["cfgs"]
    model_a, model_b = JaxPretrainer.from_config(jcfg_a), JaxPretrainer.from_config(jcfg_b)
    state = jopt.construct_train_state(jcfg_a.optimizer, model_a,
                                       jax.tree.map(np.array, setup["params"]))
    step_fn, state = make_jit_mixed_res_train_step(
        jax_make_mesh(dp=1, devices=jax.devices("cpu")[:1]), state, model_b.apply,
        donate=False, use_bfloat16_grads=bf16)
    state, info = step_fn(state, *({k: jnp.asarray(v) for k, v in b.items()}
                                   for b in setup["batches"]))
    return (state_dict_from_flax(jax.tree.map(np.asarray, state.params)),
            {k: float(v) for k, v in info.items()})


def _port(setup, bf16=False):
    """(state, model_b, step) of the port at grid A with JAX's initial
    weights, model B on the meta device."""
    (_, tcfg_a), (_, tcfg_b) = setup["cfgs"]
    model = MerlotReservePretrainer(tcfg_a, device="cpu")
    load_flax_params(model, setup["params"])
    state = create_train_state(tcfg_a, model)
    model_b = MerlotReservePretrainer(tcfg_b, device="meta")
    return state, model_b, make_mixed_res_train_step(tcfg_a, state, model_b,
                                                     use_bfloat16_grads=bf16)


def _port_step(setup, bf16):
    state, _, step = _port(setup, bf16)
    (split_a, gumbel_a), (split_b, gumbel_b) = setup["draws"]
    state, info = step(state, *(batch_to_tensors(b, "cpu") for b in setup["batches"]),
                       split_at=(split_a, split_b), gumbel=(gumbel_a, gumbel_b))
    return state, {k: float(v) for k, v in info.items()}


@pytest.fixture(scope="module")
def f32_steps(setup):
    return _port_step(setup, bf16=False), _jax_step(setup, bf16=False)


def test_mixed_step_matches_jax_in_f32(setup, f32_steps):
    (state, info), (j_params, j_info) = f32_steps
    assert set(j_info) <= set(info)
    for k, v in j_info.items():
        assert abs(info[k] - v) <= 2e-6, (k, info[k], v)
    assert state.step == 1 and state.optimizer.count == 1
    start = state_dict_from_flax(setup["params"])
    for name, p in state.model.named_parameters():
        assert not torch.equal(p.detach(), start[name]) or name == "contrastive_scales"
        assert (p.detach() - j_params[name]).abs().max().item() <= 1e-5, name


def test_mixed_step_bf16_follows_jax_bf16(setup, f32_steps):
    """Under use_bfloat16_grads both halves run on the same bf16 copies (made
    once), as JAX's one cast, so their gradients sum in bf16: the update
    follows JAX's bf16 mixed step closer than JAX's f32 one."""
    state, info = _port_step(setup, bf16=True)
    j_params, j_info = _jax_step(setup, bf16=True)
    _, (j32_params, _) = f32_steps
    start = state_dict_from_flax(setup["params"])
    for k, v in j_info.items():
        assert abs(info[k] - v) <= 1e-2, (k, info[k], v)
    to_bf16, to_f32, signal = [], [], []
    for name, p in state.model.named_parameters():
        upd, j_upd = p.detach() - start[name], j_params[name] - start[name]
        to_bf16.append(_one_minus_cos(upd, j_upd))
        to_f32.append(_one_minus_cos(upd, j32_params[name] - start[name]))
        if name.startswith(_SIGNAL):
            signal.append((upd.flatten(), j_upd.flatten()))
    signal_upd, signal_j = (torch.cat(x) for x in zip(*signal))
    assert _one_minus_cos(signal_upd, signal_j) <= 3e-2
    assert np.mean(to_bf16) < np.mean(to_f32)


@pytest.mark.parametrize("bf16", [False, True])
def test_both_halves_run_on_the_same_tensors(setup, bf16):
    """Model B owns no storage (every parameter on the meta device) and both
    halves' forwards see the very tensors of one cast: the same data_ptr
    for every parameter, bf16 under use_bfloat16_grads."""
    state, model_b, step = _port(setup, bf16)
    assert all(p.is_meta for p in model_b.parameters())
    assert [(n, p.shape) for n, p in model_b.named_parameters()] == \
        [(n, p.shape) for n, p in state.model.named_parameters()]
    seen = []

    def hook(module, args, out):
        seen.append({n: (p.data_ptr(), p.dtype) for n, p in module.named_parameters()})

    handles = [m.joint_transformer.register_forward_hook(hook) for m in (state.model, model_b)]
    try:
        step(state, *(batch_to_tensors(b, "cpu") for b in setup["batches"]))
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == 2 and seen[0] == seen[1]
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert all(d == dtype for _, d in seen[0].values())
    masters = {n: p.data_ptr() for n, p in state.model.joint_transformer.named_parameters()}
    assert all((seen[0][n][0] == ptr) != bf16 for n, ptr in masters.items())


def _head_rows_lse(preds_a, preds_other):
    """Half A's rows of the imgs_to_audio head: logsumexp of x_a against
    every y target of A and of the other half."""
    x = preds_a["imgs_to_audio"]["x"]
    y = torch.cat([preds_a["imgs_to_audio"]["y"], preds_other["imgs_to_audio"]["y"]])
    return torch.logsumexp(x @ y.T, -1)


def test_the_halves_share_their_denominators(setup):
    """Half A's InfoNCE terms count grid B's targets as negatives: another
    batch_b moves them. And the mixed loss exceeds the mean of the two
    halves' own losses (the JAX package's property)."""
    state, model_b, _ = _port(setup)
    batch_a, batch_b = (batch_to_tensors(b, "cpu") for b in setup["batches"])
    other_b = dict(batch_b, images=1.0 - batch_b["images"])
    (split_a, gumbel_a), (split_b, gumbel_b) = setup["draws"]
    params = dict(state.model.named_parameters())
    with torch.no_grad():
        preds_a = state.model(batch_a, split_at=split_a, gumbel=gumbel_a)
        preds_b, preds_b2 = (torch.func.functional_call(
            model_b, params, (b,), {"split_at": split_b, "gumbel": gumbel_b})
            for b in (batch_b, other_b))
        lse, lse2 = _head_rows_lse(preds_a, preds_b), _head_rows_lse(preds_a, preds_b2)
        assert (lse - lse2).abs().max() > 1e-4
        mixed, _ = loss_fn_given_preds(concat_preds([preds_a, preds_b]))
        halves = [loss_fn_given_preds(p)[0] for p in (preds_a, preds_b)]
    assert float(mixed) > (float(halves[0]) + float(halves[1])) / 2 + 1e-3


def test_grid_dependent_parameters_are_refused(setup):
    """Learned positions (do_rotary off) tie the parameters to a grid."""
    (_, tcfg_a), (_, tcfg_b) = setup["cfgs"]
    cfg_a, cfg_b = (c.replace_model(do_rotary=False) for c in (tcfg_a, tcfg_b))
    state = TrainState(model=MerlotReservePretrainer(cfg_a, device="cpu"), optimizer=None)
    with pytest.raises(ValueError, match="resolution-independent"):
        make_mixed_res_train_step(cfg_a, state, MerlotReservePretrainer(cfg_b, device="meta"))


# ---------------------------------------------------------------------------
# the scripts: pretrain_fixres_torch.py and validate_torch.py
# ---------------------------------------------------------------------------


def _tiny_yaml(path):
    """A YAML config at the tiny widths (grid A's, batch 4)."""
    model = {**TINY, "output_grid": list(GRIDS[0])}
    path.write_text(yaml.safe_dump({"model": model, "data": {**DATA, "seq_len": 84},
                                    "device": {"batch_size": 4}}))
    return str(path)


@pytest.fixture(scope="module")
def scripted(setup, tmp_path_factory):
    """A pretrained checkpoint, four shards, the YAML config and the grids
    that the fixres script trains (its POSSIBLE_RES cut to the tiny ones)."""
    d = tmp_path_factory.mktemp("fixres")
    _, tcfg_a = setup["cfgs"][0]
    model = MerlotReservePretrainer(tcfg_a, device="cpu")
    load_flax_params(model, setup["params"])
    save_checkpoint(create_train_state(tcfg_a, model), str(d / "pretrained"))
    shards = [write_synthetic_corpus(str(d / f"s{i}.tfrecord"), tcfg_a, num_records=2, seed=i)
              for i in range(4)]
    return {"dir": d, "ckpt": str(d / "pretrained" / "ckpt_0"), "shards": shards,
            "config": _tiny_yaml(d / "tiny.yaml")}


def test_the_two_loaders_read_disjoint_shards(scripted):
    from scripts.pretrain_fixres_torch import fixres_config, fixres_loaders

    cfgs = [fixres_config(scripted["config"], g, 10, 1, 0.02) for g in GRIDS]
    assert [c.data.seq_len for c in cfgs] == [76 + 2 * 4, 76 + 2 * 1]
    assert cfgs[0].optimizer.final_lr_scale == 0.0
    assert cfgs[0].optimizer.learning_rate == pytest.approx(4e-4 * 0.02)
    loaders = fixres_loaders(cfgs, scripted["shards"], base_seed=100)
    assert not set(loaders[0].files) & set(loaders[1].files)
    assert set(loaders[0].files) | set(loaders[1].files) == set(scripted["shards"])
    assert [ld.batch_size for ld in loaders] == [2, 2]
    assert [ld.seed for ld in loaders] == [100, 101]
    with pytest.raises(ValueError, match="divide"):  # 2 x num_hosts must divide the batch
        fixres_loaders([c.replace_device(batch_size=3) for c in cfgs], scripted["shards"], 0)


def test_fixres_then_validate_scripts_on_the_cpu(scripted, monkeypatch, capsys):
    """The chain on the CPU: scripts/pretrain_fixres_torch.py in mixed mode
    (2 steps, a checkpoint after each) from the pretrained checkpoint;
    scripts/validate_torch.py over its checkpoints, each checkpoint's
    losses equal to evaluate_loss called directly on it; then finetuning
    VCR and zero-shot VCR and TVQA from the adapted checkpoint; last, the
    single-grid mode."""
    import scripts.pretrain_fixres_torch as fixres
    from scripts.validate_torch import main as validate_main

    monkeypatch.setattr(fixres, "POSSIBLE_RES", list(GRIDS))
    out = str(scripted["dir"] / "adapted")
    yaml_path = scripted["config"]
    cfg_path = scripted["dir"] / "save_every.yaml"
    raw = yaml.safe_load(Path(yaml_path).read_text())
    raw["device"]["iterations_per_loop"] = 1
    cfg_path.write_text(yaml.safe_dump(raw))
    state, logged = fixres.main([str(cfg_path), "-ckpt", scripted["ckpt"], "-train_fns",
                                 str(scripted["dir"] / "s*.tfrecord"), "-output_dir", out,
                                 "-num_steps", "2", "-warmup", "1", "-seed", "3",
                                 "-log_every", "1", "--device", "cpu"])
    assert [s for s, _ in logged] == [0, 1] and state.step == 2
    assert all(np.isfinite(v) for _, m in logged for v in m.values())
    assert sorted(os.listdir(out)) == ["ckpt_1", "ckpt_2"]
    assert load_checkpoint(out)["opt_state"] is None  # saved without the optimizer
    assert "step 2: " in capsys.readouterr().out

    losses = validate_main([yaml_path, "-ckpt_dir", out, "-val_fns",
                            str(scripted["dir"] / "s*.tfrecord"), "-num_batches", "2",
                            "-batch_size", "2", "-every", "2", "--device", "cpu"])
    assert list(losses) == [2]
    assert "ckpt step 2: " in capsys.readouterr().out
    from merlot_reserve_tpu_torch.data.loader import PretrainLoader

    cfg = load_config(yaml_path)
    model = MerlotReservePretrainer(cfg, device="cpu")
    load_flax_params(model, load_checkpoint(out, step=2)["params"])
    direct = evaluate_loss(cfg, TrainState(model=model, optimizer=None),
                           PretrainLoader(sorted(scripted["shards"]), cfg, 2, seed=0,
                                          repeat=False),
                           num_batches=2)
    assert losses[2] == direct
    # on from the adapted checkpoint: finetuning VCR on records, then
    # zero-shot VCR and TVQA (the finetuning and zero-shot scripts alone:
    # tests/test_torch_zero_shot_qa.py)
    from scripts.finetune_vcr_torch import main as finetune_vcr_main
    from scripts.zero_shot_tvqa_torch import main as zero_shot_tvqa_main
    from scripts.zero_shot_vcr_torch import main as zero_shot_vcr_main

    records = {task: write_synthetic_finetune_corpus(
        str(scripted["dir"] / f"{task}.tfrecord"), cfg, task, num_records=2, seed=1)
        for task in ("vcr", "tvqa")}
    adapted = os.path.join(out, "ckpt_2")
    record = finetune_vcr_main([yaml_path, "-ckpt", adapted, "-train_fns", records["vcr"],
                                "-ne", "1", "-batch_size", "2", "-train_size", "2",
                                "-output_grid_h", "4", "-output_grid_w", "4", "-log_every",
                                "1", "--device", "cpu"])
    assert all(np.isfinite(v) for v in record["steps"][0]["metrics"].values())
    for task, main in (("vcr", zero_shot_vcr_main), ("tvqa", zero_shot_tvqa_main)):
        metrics, rows = main([yaml_path, "-ckpt", adapted, "-val_fns", records[task],
                              "-batch_size", "2", "--device", "cpu"])
        assert metrics["n"] == len(rows) == 2
    # single-grid mode, the first grid of its -res
    state, _ = fixres.main([yaml_path, "-ckpt", scripted["ckpt"], "-train_fns",
                            str(scripted["dir"] / "s*.tfrecord"), "-num_steps", "1", "-warmup", "0",
                            "-res", "4,4", "-seed", "3", "-log_every", "0", "--device", "cpu"])
    assert state.step == 1
