"""Port parity: f32 Adam (``use_bfloat16_adam: false``) in both chains of
merlot_reserve_tpu_torch/training/optimization.py against the JAX
package's ``construct_train_state`` and ``construct_finetuning_train_state``
(optax's ``scale_by_adam``), and the msgpack checkpoint of an f32-moment
state both ways, at the tiny widths of test_torch_training.py.

Tolerances:
  * 3 chained updates on random gradients (magnitudes 1e-6 to 1e-1):
    mu and nu within a relative 1e-6 of optax's (the same f32 operations in
    the same order: they came out equal), parameters within 2 f32 ulp plus
    1e-6 * lr (XLA fuses the update's division, schedule and -lr its own
    way: 2e-7 * lr beyond the 2 ulp was the worst seen);
  * the checkpoint: bit for bit (the file stores every f32 leaf as f16, the
    moments included, as the JAX package's ``compress_state`` does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.utils import checkpoint as jck
from merlot_reserve_tpu_torch.training import optimization as topt
from merlot_reserve_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    weight_decay_names,
)
from merlot_reserve_tpu_torch.utils import checkpoint as tck
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from test_torch_checkpoint import flax_msgpack_writer
from test_torch_training import _configs, _port_model

F32_ADAM = dict(use_bfloat16_adam=False, do_bias_correction=True, learning_rate=1e-2,
                num_warmup_steps=1, num_train_steps=8)
MOMENT_RTOL = 1e-6
PARAM_ULPS = 2.4e-7  # 2 f32 ulp, relative
UPDATES = 3


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _configs(F32_ADAM)
    batch = jax_make_dummy_batch(jcfg, batch_size=2, seed=0, num_text_spans=16)
    return jax.tree.map(np.asarray, JaxPretrainer.from_config(jcfg).init_params(batch))


def _grads(params, rng):
    return jax.tree.map(lambda x: (rng.randn(*x.shape) * 10.0 ** rng.randint(-6, 0))
                        .astype(np.float32), params)


def _chain(chain, params):
    """(JAX's optax transformation and state, the port's model and
    optimizer) for ``chain``, from the same parameters."""
    jcfg, tcfg = _configs(F32_ADAM)
    construct = (jopt.construct_train_state if chain == "pretrain"
                 else jopt.construct_finetuning_train_state)
    j_state = construct(jcfg.optimizer, JaxPretrainer.from_config(jcfg), params)
    model = _port_model(tcfg, params)
    decay = weight_decay_names(model, 0 if chain == "pretrain" else 4096)
    optimizer = topt.PretrainOptimizer(model.named_parameters(), decay, tcfg.optimizer, chain)
    return tcfg, j_state, model, optimizer


def _run(chain, params):
    """UPDATES chained updates on both sides; returns the JAX state and the
    port's (model, optimizer)."""
    tcfg, j_state, model, optimizer = _chain(chain, params)
    rng = np.random.RandomState(3)
    if chain == "finetune":  # move the parameters off the anchor
        moved = jax.tree.map(lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32),
                             params)
        load_flax_params(model, moved)
        j_state = j_state.replace(params=jax.tree.map(jnp.asarray, moved))
    j_params, j_opt = j_state.params, j_state.opt_state
    for _ in range(UPDATES):
        grads = _grads(params, rng)
        updates, j_opt = j_state.tx.update(jax.tree.map(jnp.asarray, grads), j_opt, j_params)
        j_params = optax.apply_updates(j_params, updates)
        optimizer.step(state_dict_from_flax(grads))
    return (tcfg, j_state.replace(step=UPDATES, params=j_params, opt_state=j_opt), model,
            optimizer)


def _sd(tree):
    return state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))


@pytest.mark.parametrize("chain", topt.CHAINS)
def test_f32_adam_matches_optax_scale_by_adam(params, chain):
    _, j_state, model, optimizer = _run(chain, params)
    adam = j_state.opt_state[0]
    assert isinstance(adam, optax.ScaleByAdamState) and adam.mu is not None
    j_params, mu, nu = _sd(j_state.params), _sd(adam.mu), _sd(adam.nu)
    lr = F32_ADAM["learning_rate"]
    for name, p in model.named_parameters():
        assert optimizer.mu[name].dtype == optimizer.nu[name].dtype == torch.float32
        err = (p.detach() - j_params[name]).abs() - PARAM_ULPS * j_params[name].abs()
        assert err.max().item() <= 1e-6 * lr, (chain, name, err.max().item())
        for got, want, what in ((optimizer.mu[name], mu[name], "mu"),
                                (optimizer.nu[name], nu[name], "nu")):
            bad = (got - want).abs() > MOMENT_RTOL * want.abs()
            assert not bad.any(), (chain, what, name, (got - want).abs().max().item())
    assert optimizer.count == int(adam.count) == UPDATES
    # the moves are Adam's: at least lr / 10 somewhere in every large tensor
    moved = max((p.detach() - state_dict_from_flax(params)[n]).abs().max().item()
                for n, p in model.named_parameters())
    assert moved > lr / 10


def test_f32_adam_needs_bias_correction():
    _, tcfg = _configs(dict(F32_ADAM, do_bias_correction=False))
    with pytest.raises(ValueError, match="bias"):
        topt.PretrainOptimizer([("w", torch.zeros(2))], [], tcfg.optimizer)


def _f16(x):
    return torch.from_numpy(np.array(x, np.float32)).half().float()


def _assert_same(model, optimizer, j_state):
    """The port's state against JAX's after the file's f16 round trip of
    every f32 leaf: params, mu, nu, counts, bit for bit."""
    adam = j_state.opt_state[0]
    j_params = state_dict_from_flax(jax.tree.map(_f16, j_state.params), dtype=None)
    mu = state_dict_from_flax(jax.tree.map(_f16, adam.mu), dtype=None)
    nu = state_dict_from_flax(jax.tree.map(_f16, adam.nu), dtype=None)
    for name, p in model.named_parameters():
        for got, want in ((p.detach(), j_params[name]), (optimizer.mu[name], mu[name]),
                          (optimizer.nu[name], nu[name])):
            assert got.dtype == torch.float32
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
    assert optimizer.count == int(adam.count) == int(j_state.opt_state[2].count)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_f32_moment_checkpoint_reads_both_ways(params, tmp_path, direction):
    tcfg, j_state, model, optimizer = _run("pretrain", params)
    if direction == "jax_to_port":
        with flax_msgpack_writer():
            jck.save_checkpoint(j_state, str(tmp_path))
        fresh = create_train_state(tcfg, _port_model(tcfg, params))
        tck.load_checkpoint(str(tmp_path), state=fresh)
        assert fresh.step == UPDATES
        _assert_same(fresh.model, fresh.optimizer, j_state)
    else:
        tck.save_checkpoint(TrainState(model, optimizer, UPDATES), str(tmp_path))
        raw = tck.load_checkpoint(str(tmp_path))
        assert next(iter(tck._leaves(raw["opt_state"]["0"]["mu"]))).dtype == torch.float32
        jcfg, _ = _configs(F32_ADAM)
        j_read = jck.load_checkpoint(str(tmp_path), state=jopt.construct_train_state(
            jcfg.optimizer, JaxPretrainer.from_config(jcfg), params))
        assert isinstance(j_read.opt_state[0], optax.ScaleByAdamState)
        tck.load_checkpoint(str(tmp_path), state=TrainState(model, optimizer))
        _assert_same(model, optimizer, j_read)


def test_a_bf16_adam_checkpoint_is_refused_by_an_f32_state(params, tmp_path):
    jcfg, tcfg = _configs()
    tck.save_checkpoint(create_train_state(tcfg, _port_model(tcfg, params)), str(tmp_path))
    _, f32cfg = _configs(F32_ADAM)
    with pytest.raises(ValueError, match="f32 Adam"):
        tck.load_checkpoint(str(tmp_path),
                            state=create_train_state(f32cfg, _port_model(f32cfg, params)))
