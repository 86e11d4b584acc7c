"""Port parity with ``scan_layers: false`` (the soak_fused_r5 recipe's
layout): the port's pretrainer built unrolled against the JAX package's
unrolled ``MerlotReservePretrainer`` at tiny widths (hidden 64, 2 layers per
tower), f32, on the same weights, batch and draws.

Checked: the loss terms and every gradient (test_torch_pretrainer.py's
tolerances: losses within 2e-6, each gradient within 1e-3 of its max |grad|
plus 5e-7); the weight-decay set (JAX's ``ndim > 1`` mask on the
``layer_NN`` leaves, so per-layer biases and LayerNorm scales do not decay);
one train step's parameters (within 1e-5, test_torch_training.py's f32
step); the checkpoint tree (every key, shape and dtype of JAX's unrolled
``TrainState``), read both ways; and the sharding specs (equal to JAX's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.models.pretrainer import loss_fn_given_preds as jax_loss_fn
from merlot_reserve_tpu.parallel import make_mesh as jax_make_mesh
from merlot_reserve_tpu.parallel import sharding as jax_sharding
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.utils import checkpoint as jck
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.parallel import sharding
from merlot_reserve_tpu_torch.parallel.mesh import make_mesh
from merlot_reserve_tpu_torch.training.trainer import (
    create_train_state,
    loss_and_grads,
    train_step,
    weight_decay_names,
)
from merlot_reserve_tpu_torch.utils import checkpoint as tck
from merlot_reserve_tpu_torch.utils import msgpack
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax
from test_torch_checkpoint import flax_msgpack_writer
from test_torch_pretrainer import jax_draws

TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False,
            scan_layers=False)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)
OPTIMIZER = dict(num_warmup_steps=0)  # the f32 step of test_torch_training.py
BATCH, SPANS = 2, 16


def _configs():
    cfgs = [mr.load_config("base", **TINY).replace_data(**DATA),
            load_config("base", **TINY).replace_data(**DATA)]
    return [dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer, **OPTIMIZER))
            for c in cfgs]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's unrolled model: parameters, batch, loss terms, gradients (one
    compile), and the state after one update from those gradients."""
    jcfg, tcfg = _configs()
    batch = jax_make_dummy_batch(jcfg, batch_size=BATCH, seed=0, num_text_spans=SPANS)
    model = JaxPretrainer.from_config(jcfg)
    params = model.init_params(batch)
    bd = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, info), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model.apply({"params": p}, bd)), has_aux=True))(params)
    state = jopt.construct_train_state(jcfg.optimizer, model, params)
    stepped = state.apply_gradients(grads=jax.tree.map(jnp.nan_to_num, grads))
    stepped = stepped.replace(step=jnp.asarray(stepped.step, jnp.int32))  # as a jitted step's
    return {"jcfg": jcfg, "tcfg": tcfg, "batch": batch, "model": model,
            "params": jax.tree.map(np.asarray, params), "state": state, "stepped": stepped,
            "info": {k: float(v) for k, v in info.items()},
            "grads": state_dict_from_flax(jax.tree.map(np.asarray, grads))}


def _port(side):
    model = MerlotReservePretrainer(side["tcfg"], device="cpu")
    load_flax_params(model, side["params"])
    return model


def test_unrolled_params_are_per_layer_leaves(jax_side):
    params = jax_side["params"]
    assert "layers" not in params["joint_transformer"]
    assert {"layer_00", "layer_01"} <= set(params["joint_transformer"])
    model = _port(jax_side)
    assert not model.config.scan_layers
    tree = tck.state_to_flax(create_train_state(jax_side["tcfg"], model))["params"]
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, params)


def test_unrolled_losses_and_every_gradient_match_jax(jax_side):
    split_at, gumbel = jax_draws(jax_side["batch"], jax_side["jcfg"])
    info, grads = loss_and_grads(_port(jax_side), batch_to_tensors(jax_side["batch"], "cpu"),
                                 use_bfloat16_grads=False, split_at=split_at, gumbel=gumbel)
    for k, v in jax_side["info"].items():
        assert abs(float(info[k]) - v) <= 2e-6, (k, float(info[k]), v)
    ref_grads = jax_side["grads"]
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        ref = ref_grads[name]
        err = (g - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 5e-7, (name, err)


def test_unrolled_weight_decay_is_the_per_layer_ndim_mask(jax_side):
    """JAX's mask, ``ndim > 1`` on the ``layer_NN`` leaves: per-layer
    biases and LayerNorm scales are 1-D there and do not decay (they do in
    the scan layout, where every per-layer leaf carries the layer axis)."""
    params = jax_side["params"]
    names = set(weight_decay_names(_port(jax_side)))
    mask = jax.tree.map(lambda x: np.full(x.shape, float(x.ndim > 1), np.float32), params)
    expected = {k for k, v in state_dict_from_flax(mask).items() if v.any()}
    assert names == expected
    assert "joint_transformer.layers.0.pre_attn_ln.weight" not in names
    assert "joint_transformer.layers.0.mlp_layer.intermediate.bias" not in names
    assert "joint_transformer.layers.0.mlp_layer.intermediate.weight" in names
    assert "vision_encoder.seq_attnpool.query.bias" in names  # [heads, d]
    # the scan layout's set is larger by exactly those per-layer 1-D leaves
    scan_cfg = dataclasses.replace(jax_side["tcfg"], model=dataclasses.replace(
        jax_side["tcfg"].model, scan_layers=True))
    scan = set(weight_decay_names(MerlotReservePretrainer(scan_cfg, device="meta")))
    assert names < scan
    assert all(".layers." in n for n in scan - names)


def _stepped_port(jax_side):
    split_at, gumbel = jax_draws(jax_side["batch"], jax_side["jcfg"])
    state = create_train_state(jax_side["tcfg"], _port(jax_side))
    state, _ = train_step(state, batch_to_tensors(jax_side["batch"], "cpu"),
                          use_bfloat16_grads=False, split_at=split_at, gumbel=gumbel)
    return state


def _layout(tree, prefix=""):
    """Every node of a raw checkpoint tree: leaves by shape and dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{prefix}/{k}"))
            out[f"{prefix}/{k}"] = "{}" if not v else "dict"
        else:
            out[f"{prefix}/{k}"] = (tuple(v.shape), v.dtype) if hasattr(v, "shape") else v
    return out


def test_unrolled_step_and_checkpoint_tree_match_jax(jax_side, tmp_path):
    state = _stepped_port(jax_side)
    j_sd = state_dict_from_flax(jax.tree.map(np.asarray, jax_side["stepped"].params))
    for name, p in state.model.named_parameters():
        assert (p.detach() - j_sd[name]).abs().max().item() <= 1e-5, name
    # both ways through the file: JAX reads the port's into its unrolled state
    tck.save_checkpoint(state, str(tmp_path / "port"))
    j_read = jck.load_checkpoint(str(tmp_path / "port"), state=jax_side["state"])
    assert int(j_read.step) == 1
    read_sd = state_dict_from_flax(jax.tree.map(np.asarray, j_read.params))
    for name, p in state.model.named_parameters():
        assert torch.equal(read_sd[name], p.detach().half().float()), name
    with flax_msgpack_writer():
        jck.save_checkpoint(jax_side["stepped"], str(tmp_path / "jax"))
    # the two files' trees: key for key, shape and dtype (layer_NN leaves)
    ours, theirs = (_layout(msgpack.load(tmp_path / d / "ckpt_1")) for d in ("port", "jax"))
    assert ours == theirs
    assert "/params/joint_transformer/layer_01/pre_attn_ln/scale" in theirs
    assert "/opt_state/0/nu/joint_transformer/layer_01/pre_attn_ln/scale" in theirs
    # and the port reads JAX's
    with flax_msgpack_writer():
        jck.save_checkpoint(jax_side["stepped"], str(tmp_path / "jax"))
    fresh = create_train_state(jax_side["tcfg"], _port(jax_side))
    tck.load_checkpoint(str(tmp_path / "jax"), state=fresh)
    assert fresh.step == 1 and fresh.optimizer.count == 1
    for name, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), torch.from_numpy(
            np.array(j_sd[name], np.float32)).half().float()), name


@pytest.mark.parametrize("layout", [dict(dp=4), dict(dp=2, tp=2)])
def test_unrolled_specs_match_jax(jax_side, cpu_devices, layout):
    n = int(np.prod(list(layout.values())))
    jmesh = jax_make_mesh(devices=cpu_devices[:n], **layout)
    mesh = make_mesh(devices=["cpu"] * n, **layout)
    model = MerlotReservePretrainer(jax_side["tcfg"], device="meta")
    for zero1 in (True, False):
        j = jax_sharding.param_shardings(jmesh, jax_side["state"].params, zero1_dp=zero1)
        paths, leaves, _ = jax_sharding._tree_paths(j)
        assert sharding.param_shardings(mesh, model, zero1_dp=zero1) == {
            p: tuple(s.spec) for p, s in zip(paths, leaves)}
