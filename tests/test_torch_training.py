"""Port parity: merlot_reserve_tpu_torch's training (training/optimization.py,
training/trainer.py, training/pretrain.py) against the JAX package's optax
chain and train_step, at the tiny widths of test_torch_pretrainer.py.

Tolerances:
  * the bf16 moment encoding: bit-exact encode; decode within 2 f32 ulp
    (rtol 2.4e-7: torch has no cbrt, the port takes pow(x, 1/3));
  * schedules: rtol 1e-6 (both f32);
  * 5 chained optimizer updates on the same grads: mu bit-exact, decoded
    nu within a relative 2^-8, parameters within 2 ulp plus 2e-3 * lr.
    The decode's last ulp (pow against cbrt) can flip nu's half-step bit
    where v^3 sits at a bf16 tie: nu then moves by 2^-9, sqrt(nu) by 1e-3
    and that element's update (about lr) by 1e-3 * lr;
  * one f32 train_step: losses within 2e-6, every parameter within 1e-5
    absolute (2.5% of lr 4e-4). Adam's first update is about
    lr * (1 - b1) * g / (sqrt(1 - b2) |g| + eps): for a gradient near eps
    (1e-6) a difference at the f32 floor of the loss (about 1.5e-7, see
    test_torch_pretrainer.py) moves it by up to lr * 0.1 * 1.5e-7 / eps =
    6e-6, and by far less elsewhere;
  * 3 chained updates of the finetuning chain, the parameters moved off
    the anchor: as the 5 of the pretraining chain above;
  * resume: bit for bit (4 steps against 2 and 2 resumed, with the f16
    round trip of the parameters that the checkpoint applies);
  * one bf16 train_step (use_bfloat16_grads, bf16 compute): losses within
    1e-2; over the towers whose gradient carries signal at this init (see
    _SIGNAL), the cosine between the port's and JAX's whole update is at
    least 0.97; and the mean over all tensors of 1 - cosine to JAX's bf16
    step is below that to JAX's f32 step (the port rounds where JAX
    rounds). A tensor with a small gradient moves by about lr * sign(grad)
    in Adam's first step, so per-tensor cosines of one step are noise.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.training.trainer import train_step as jax_train_step
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.training import optimization as topt
from merlot_reserve_tpu_torch.training.pretrain import evaluate_loss, run_pretraining
from merlot_reserve_tpu_torch.training.trainer import (
    create_train_state,
    train_step,
    weight_decay_names,
)
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax
from test_torch_pretrainer import jax_draws

TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)


def _configs(optimizer=None, **model):
    """(JAX config, port config) at the tiny widths, with overrides."""
    kw = dict(TINY, **model)
    cfgs = [mr.load_config("base", **kw).replace_data(**DATA),
            load_config("base", **kw).replace_data(**DATA)]
    return [dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer, **(optimizer or {})))
            for c in cfgs]


@pytest.fixture(scope="module")
def init():
    jcfg, _ = _configs()
    batch = jax_make_dummy_batch(jcfg, batch_size=2, seed=0, num_text_spans=16)
    params = JaxPretrainer.from_config(jcfg).init_params(batch)
    return batch, jax.tree.map(np.asarray, params)


def _port_model(tcfg, params):
    model = MerlotReservePretrainer(tcfg, device="cpu")
    load_flax_params(model, params)
    return model


def test_unsigned_bfloat16_encoding_matches_jax():
    # down to where v^3 and the error terms are subnormal: the port flushes
    # them as XLA does
    rng = np.random.RandomState(0)
    v = np.abs(rng.randn(4096)) * 10.0 ** rng.randint(-15, 2, 4096)
    v = np.concatenate([v, np.zeros(4)]).astype(np.float32)
    j_enc = np.asarray(jopt.unsigned_bfloat16_encode(jnp.asarray(v)).astype(jnp.float32))
    t_enc = topt.unsigned_bfloat16_encode(torch.from_numpy(v))
    assert t_enc.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_enc.float().numpy(), j_enc)
    j_dec = np.asarray(jopt.unsigned_bfloat16_decode(jnp.asarray(j_enc, jnp.bfloat16)))
    t_dec = topt.unsigned_bfloat16_decode(t_enc).numpy()
    np.testing.assert_allclose(t_dec, j_dec, rtol=2.4e-7, atol=0)
    # the sign bit is the extra half-step: the round trip is closer than bf16
    nz = v > 0
    assert np.median(np.abs(t_dec[nz] - v[nz]) / v[nz]) < 2 ** -9


@pytest.mark.parametrize("which", ["cosine", "linear"])
def test_lr_schedules_match_jax(which):
    steps = list(range(0, 40))
    if which == "cosine":
        j = jopt.lr_scale_linearwarmup_cosinedecay(5, 30, final_lr_scale=0.02)
        t = topt.lr_scale_linearwarmup_cosinedecay(5, 30, final_lr_scale=0.02)
    else:
        j = jopt.lr_scale_linearwarmup_lineardecay(5, 30)
        t = topt.lr_scale_linearwarmup_lineardecay(5, 30)
    j_vals = np.array([float(j(jnp.asarray(s, jnp.int32))) for s in steps], np.float32)
    t_vals = np.array([float(t(s)) for s in steps], np.float32)
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-6, atol=0)
    assert t_vals[0] == 0.0 and t_vals[5] == 1.0 and t_vals[-1] == t_vals[-2]


def test_weight_decay_follows_the_flax_leaf_ndim(init):
    """ndim > 1 on the JAX package's (scan-stacked) leaves: the qkv and
    attention-pool biases ([3 heads, d] / [heads, d]) and every per-layer
    leaf decay; top-level biases, LayerNorms, CLS and the temperatures do not."""
    _, params = init
    _, tcfg = _configs()
    names = set(weight_decay_names(_port_model(tcfg, params)))
    expected = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        if leaf.ndim > 1:
            one = jax.tree_util.tree_map_with_path(
                lambda p, x: np.ones_like(x) if p == path else np.zeros_like(x), params)
            expected |= {k for k, v in state_dict_from_flax(one).items() if v.any()}
    assert names == expected
    assert "joint_transformer.layers.0.pre_attn_ln.weight" in names  # stacked [layers, H]
    assert "vision_encoder.seq_attnpool.query.bias" in names  # [heads, d]
    assert "joint_transformer.pre_ln.weight" not in names and "head.bias" not in names
    assert "contrastive_scales" not in names


def test_five_chained_updates_match_the_optax_chain(init):
    _, params = init
    opt = dict(learning_rate=1e-2, num_warmup_steps=2, num_train_steps=8)
    jcfg, tcfg = _configs(opt)
    tx = jopt.construct_train_state(jcfg.optimizer, JaxPretrainer.from_config(jcfg), params).tx
    model = _port_model(tcfg, params)
    state = create_train_state(tcfg, model)
    j_params = jax.tree.map(jnp.asarray, params)
    j_opt = tx.init(j_params)
    rng = np.random.RandomState(1)
    for step in range(5):
        grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * 10.0 ** rng.randint(-6, 0))
                             .astype(np.float32), params)
        updates, j_opt = tx.update(jax.tree.map(jnp.asarray, grads), j_opt, j_params)
        j_params = optax.apply_updates(j_params, updates)
        state.optimizer.step(state_dict_from_flax(grads))
        j_sd = state_dict_from_flax(jax.tree.map(np.asarray, j_params))
        mu = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), j_opt[0].mu))
        nu = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), j_opt[0].nu))
        for name, p in model.named_parameters():
            err = (p.detach() - j_sd[name]).abs() - 2.4e-7 * j_sd[name].abs()
            assert err.max().item() <= 2e-3 * opt["learning_rate"], (step, name)
            assert torch.equal(state.optimizer.mu[name].float(), mu[name]), (step, name)
            # nu: the decoded second moments within a bf16 step (the sign bit
            # can flip where a last-ulp difference of the decode crosses a tie)
            t_nu = topt.unsigned_bfloat16_decode(state.optimizer.nu[name])
            j_nu = topt.unsigned_bfloat16_decode(nu[name].to(torch.bfloat16))
            assert ((t_nu - j_nu).abs() <= 2 ** -8 * j_nu).all(), (step, name)
    assert state.optimizer.count == 5


def _one_step(init, bf16):
    """(port state, port info, JAX params and info) after one train_step
    from the same weights and batch, with warmup 0 so the step moves."""
    batch, params = init
    jcfg, tcfg = _configs({"num_warmup_steps": 0}, use_bfloat16=bf16)
    j_model = JaxPretrainer.from_config(jcfg)
    j_state = jopt.construct_train_state(jcfg.optimizer, j_model, params)
    j_state, j_info = jax.jit(jax_train_step, static_argnums=2)(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, bf16)
    state = create_train_state(tcfg, _port_model(tcfg, params))
    # the port's content generator cannot reproduce jax.random: inject JAX's draws
    split_at, gumbel = jax_draws(batch, jcfg)
    state, info = train_step(state, batch_to_tensors(batch, "cpu"), use_bfloat16_grads=bf16,
                             split_at=split_at, gumbel=gumbel)
    return (state, info, state_dict_from_flax(jax.tree.map(np.asarray, j_state.params)),
            {k: float(v) for k, v in j_info.items()})


@pytest.fixture(scope="module")
def f32_step(init):
    return _one_step(init, bf16=False)


def test_train_step_matches_jax_in_f32(init, f32_step):
    state, info, j_params, j_info = f32_step
    for k, v in j_info.items():
        assert abs(float(info[k]) - v) <= 2e-6, k
    assert state.step == 1 and state.optimizer.count == 1
    start = state_dict_from_flax(init[1])
    for name, p in state.model.named_parameters():
        assert not torch.equal(p.detach(), start[name]) or name == "contrastive_scales"
        assert (p.detach() - j_params[name]).abs().max().item() <= 1e-5, name


# the towers whose gradient carries signal at this init: the text -> audio
# head's. The vision and span towers feed heads that sit at ln N to 1e-7
# (nearly equal CLS embeddings), so their gradients are differences of equal
# logits at the floor of bf16 rounding, and one Adam step there (about
# lr * sign(grad)) is noise in both packages
_SIGNAL = ("joint_transformer.", "audio_encoder.", "head.", "token_encoder.")


def _one_minus_cos(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return 1.0 - float(a @ b / (a.norm() * b.norm() + 1e-30))


def test_train_step_bf16_follows_jax_bf16_policy(init, f32_step):
    state, info, j_params, j_info = _one_step(init, bf16=True)
    _, _, j32_params, _ = f32_step
    start = state_dict_from_flax(init[1])
    for k, v in j_info.items():
        assert abs(float(info[k]) - v) <= 1e-2, (k, float(info[k]), v)
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


def test_run_pretraining_descends_on_a_repeated_batch(tmp_path):
    """3 steps on the CPU with warmup 1 (the first update has lr scale 0)
    and lr 1e-5: Adam's early updates are about lr * sign(grad) on every
    weight, and at this lr they stay in the first-order regime."""
    _, tcfg = _configs({"num_warmup_steps": 1, "learning_rate": 1e-5})
    batch = make_dummy_batch(tcfg, 2, seed=0, num_text_spans=16)
    logged = []
    state = run_pretraining(tcfg, itertools.repeat(batch), num_steps=3, device="cpu",
                            log_fn=lambda step, m: logged.append((step, m)))
    assert [s for s, _ in logged] == [0, 1, 2] and state.step == 3
    assert all(np.isfinite(v) for _, m in logged for v in m.values())
    totals = [m["total"] for _, m in logged]
    assert totals[1] == totals[0]  # schedule(0) = 0: the first update moves nothing
    assert totals[2] < totals[1]
    after = evaluate_loss(tcfg, state, itertools.repeat(batch), num_batches=1)
    assert after["total"] < totals[2]
    # with an output_dir the run checkpoints at its end
    run_pretraining(tcfg, [batch], num_steps=1, device="cpu", output_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1", "run"]


def test_finetuning_chain_matches_optax(init):
    """subtract_old_weights toward a bf16 anchor on the ndim > 1, size > 4096
    leaves, then the linear schedule: 3 updates on random gradients against
    the optax chain, from parameters moved off the anchor."""
    _, params = init
    opt = dict(learning_rate=1e-2, num_warmup_steps=2, num_train_steps=8,
               do_bias_correction=True)
    jcfg, tcfg = _configs(opt)
    tx = jopt.construct_finetuning_train_state(jcfg.optimizer, JaxPretrainer.from_config(jcfg),
                                               params).tx
    model = _port_model(tcfg, params)
    optimizer = topt.PretrainOptimizer(model.named_parameters(),
                                       weight_decay_names(model, 4096), tcfg.optimizer,
                                       chain="finetune")
    j_params = jax.tree.map(jnp.asarray, params)
    j_opt = tx.init(j_params)
    rng = np.random.RandomState(2)
    moved = jax.tree.map(lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32), params)
    load_flax_params(model, moved)
    j_params = jax.tree.map(jnp.asarray, moved)
    for _ in range(3):
        grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * 10.0 ** rng.randint(-6, 0))
                             .astype(np.float32), params)
        updates, j_opt = tx.update(jax.tree.map(jnp.asarray, grads), j_opt, j_params)
        j_params = optax.apply_updates(j_params, updates)
        optimizer.step(state_dict_from_flax(grads))
    j_sd = state_dict_from_flax(jax.tree.map(np.asarray, j_params))
    anchor = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                               j_opt[1].orig_params))
    mu = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), j_opt[0].mu))
    for name, p in model.named_parameters():
        err = (p.detach() - j_sd[name]).abs() - 2.4e-7 * j_sd[name].abs()
        assert err.max().item() <= 2e-3 * opt["learning_rate"], name
        assert torch.equal(optimizer.anchor[name].float(), anchor[name]), name
        assert torch.equal(optimizer.mu[name].float(), mu[name]), name
    assert optimizer.count == 3 and optimizer.anchor is not None


def test_finetuning_decay_pulls_toward_the_anchor(init):
    """With zero gradients Adam's update is 0, so a step is the decay alone:
    p -= lr * scale * wd * (p - anchor) on the masked tensors, nothing on
    the rest."""
    _, params = init
    _, tcfg = _configs(dict(num_warmup_steps=0, num_train_steps=10))
    model = _port_model(tcfg, params)
    mask = set(weight_decay_names(model, 4096))
    optimizer = topt.PretrainOptimizer(model.named_parameters(), mask, tcfg.optimizer,
                                       chain="finetune")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.25)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer.step({n: torch.zeros_like(p) for n, p in model.named_parameters()})
    cfg = tcfg.optimizer
    for n, p in model.named_parameters():
        if n in mask:
            pull = cfg.learning_rate * cfg.weight_decay_rate * (before[n]
                                                                - optimizer.anchor[n].float())
            # the new p is rounded to f32: one ulp of |p| < 0.5 is at most 3e-8
            torch.testing.assert_close(before[n] - p.detach(), pull, rtol=1e-5, atol=6e-8)
        else:
            assert torch.equal(p.detach(), before[n]), n
    assert "joint_transformer.layers.0.attention_layer.qkv.weight" in mask
    assert "joint_transformer.layers.0.pre_attn_ln.weight" not in mask  # [2, 128]: 256


def test_metrics_queue_reads_late_like_jax():
    from merlot_reserve_tpu.training.trainer import MetricsQueue as JaxQueue
    from merlot_reserve_tpu_torch.training.trainer import MetricsQueue

    for delay in (0, 1, 3):
        ours, theirs = MetricsQueue(delay), JaxQueue(delay)
        got, want = [], []
        for step in range(5):
            m = {"loss": 1.0 / (step + 1), "acc": float(step)}
            got.append(ours.push(step, {k: torch.tensor(v) for k, v in m.items()}))
            want.append(theirs.push(step, {k: jnp.asarray(v) for k, v in m.items()}))
        got += list(ours.drain())
        want += list(theirs.drain())
        assert got == want and got[-1][0] == 4


def test_jsonl_tracker_writes_the_jax_lines(tmp_path):
    from merlot_reserve_tpu.utils import experiment as jexp
    from merlot_reserve_tpu_torch.utils import experiment as texp

    config = {"model": {"hidden_size": 64}, "grid": (4, 4), "fn": len}
    for mod, d in ((jexp, tmp_path / "jax"), (texp, tmp_path / "port")):
        t = mod.make_tracker(f"jsonl:{d}", run_name="r")
        t.log_config(config)
        t.log(0, {"loss": 1.5, "x": np.float32(2.25)})
        t.log(50, {"loss": torch.tensor(1.25) if mod is texp else 1.25, "x": 3})
        t.finish()

    def read(d):
        recs = [json.loads(line) for line in open(d / "metrics.jsonl")]
        return [{k: v for k, v in r.items() if k not in ("wall", "steps_per_sec")} for r in recs]

    assert read(tmp_path / "port") == read(tmp_path / "jax")
    for name in ("config.json",):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert json.load(open(tmp_path / "port" / "run.json"))["run_name"] == "r"
    assert isinstance(texp.make_tracker(None), texp.NullTracker)
    assert isinstance(texp.make_tracker(f"jsonl:{tmp_path}/x", host_index=1), texp.NullTracker)
    with pytest.raises(ValueError):
        texp.make_tracker("tensorboard:/nope")
    with pytest.raises(ImportError):
        texp.make_tracker("wandb:proj")  # wandb is not installed
    multi = texp.make_tracker(f"jsonl:{tmp_path}/a+jsonl:{tmp_path}/b")
    assert isinstance(multi, texp.MultiTracker)
    multi.finish()


def _resume_config():
    _, tcfg = _configs({"num_warmup_steps": 1, "learning_rate": 1e-4})
    return tcfg


def test_resume_is_bit_exact_on_the_cpu(tmp_path):
    """4 steps in one run equal 2 steps, a checkpoint, and 2 resumed steps,
    once the parameters take the f16 round trip the checkpoint applies."""
    tcfg = _resume_config()
    batches = [make_dummy_batch(tcfg, 2, seed=i, num_text_spans=16) for i in range(4)]
    model = MerlotReservePretrainer(tcfg, device="cpu", seed=0)
    ref = create_train_state(tcfg, model)
    ref_totals = []
    for i, b in enumerate(batches):
        if i == 2:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(p.half().float())
        ref, info = train_step(ref, batch_to_tensors(b, "cpu"))
        ref_totals.append(float(info["total"]))

    d = str(tmp_path)
    logged = []
    first = run_pretraining(tcfg, iter(batches[:2]), num_steps=2, device="cpu", output_dir=d,
                            save_every=1, log_fn=lambda s, m: logged.append((s, m["total"])))
    assert first.step == 2 and sorted(os.listdir(d)) == ["ckpt_1", "ckpt_2", "run"]
    state = run_pretraining(tcfg, iter(batches[2:]), num_steps=4, device="cpu", output_dir=d,
                            log_fn=lambda s, m: logged.append((s, m["total"])))
    assert [s for s, _ in logged] == [0, 1, 2, 3] and state.step == 4
    assert [t for _, t in logged] == ref_totals
    ref_params = dict(ref.model.named_parameters())
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach().view(torch.int32), ref_params[n].detach().view(torch.int32)), n
    for n in ref.optimizer.mu:
        assert torch.equal(state.optimizer.mu[n].view(torch.int16),
                           ref.optimizer.mu[n].view(torch.int16)), n
        assert torch.equal(state.optimizer.nu[n].view(torch.int16),
                           ref.optimizer.nu[n].view(torch.int16)), n
    assert state.optimizer.count == ref.optimizer.count == 4


class _Positioned:
    """A batch iterator that knows its position (as the JAX package's
    PretrainLoader does), for the loader-state sidecar."""

    def __init__(self, batches):
        self.batches, self.pos = batches, 0

    def __iter__(self):
        while self.pos < len(self.batches):
            self.pos += 1
            yield self.batches[self.pos - 1]

    def state_dict(self):
        return {"position": self.pos}

    def load_state_dict(self, state):
        if state["position"] > len(self.batches):
            raise ValueError("position past the end")
        self.pos = state["position"]


def test_loader_state_sidecar_round_trips(tmp_path):
    tcfg = _resume_config()
    batches = [make_dummy_batch(tcfg, 2, seed=i, num_text_spans=16) for i in range(4)]
    d = str(tmp_path)
    run_pretraining(tcfg, _Positioned(batches), num_steps=2, device="cpu", output_dir=d,
                    save_every=1)
    assert json.load(open(tmp_path / "loader_state.json")) == {"position": 2}
    loader = _Positioned(batches)
    seen = []
    state = run_pretraining(tcfg, loader, num_steps=4, device="cpu", output_dir=d,
                            log_fn=lambda s, m: seen.append(s))
    assert state.step == 4 and seen == [2, 3]
    assert json.load(open(tmp_path / "loader_state.json")) == {"position": 4}


_SIGTERM_SCRIPT = """
import dataclasses, signal, sys
sys.path.insert(0, {root!r})
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

cfg = load_config("base", hidden_size=64, joint_num_layers=1, vit_num_layers=1,
                  audio_num_layers=1, span_num_layers=1, size_per_head=32,
                  output_grid=(4, 4), use_bfloat16=False)
cfg = cfg.replace_data(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)
batch = make_dummy_batch(cfg, 2, seed=0, num_text_spans=16)

def log_fn(step, metrics):
    if step == 1:
        signal.raise_signal(signal.SIGTERM)

state = run_pretraining(cfg, iter([batch] * 50), num_steps=50, device="cpu",
                        output_dir={out!r}, log_every=0, save_every=1000, log_fn=log_fn)
print("STOPPED_AT", state.step)
"""


def test_sigterm_finishes_the_step_checkpoints_and_stops(tmp_path):
    """In a subprocess: SIGTERM from log_fn at step 1 (the second step)
    stops the run after that step with ckpt_2 written, and the handler is
    restored after the run."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "ckpts")
    script = _SIGTERM_SCRIPT.format(root=root, out=out)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "STOPPED_AT 2" in proc.stdout and "signal" in proc.stdout
    assert sorted(os.listdir(out)) == ["ckpt_2", "run"]
