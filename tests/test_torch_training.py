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


def test_run_pretraining_descends_on_a_repeated_batch():
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
    with pytest.raises(NotImplementedError, match="checkpointing"):
        run_pretraining(tcfg, [batch], num_steps=1, device="cpu", output_dir="ckpts")
