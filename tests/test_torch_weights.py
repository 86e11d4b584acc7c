"""The flax <-> torch weight bridge (merlot_reserve_tpu_torch/utils/weights.py
and utils/checkpoint.py) against the JAX package's parameter tree: a round
trip is bit-exact in both layer layouts, and a tree that does not fit the
model is refused."""

import numpy as np
import pytest
import torch

import jax

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.utils import checkpoint as jckpt
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.models import MerlotReserve
from merlot_reserve_tpu_torch.utils import checkpoint as tckpt
from merlot_reserve_tpu_torch.utils.weights import (
    flax_from_state_dict,
    load_flax_params,
    state_dict_from_flax,
)

TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)


@pytest.fixture(scope="module")
def params():
    tree = JaxMerlotReserve.from_config(mr.load_config("base", **TINY)).init_params_full()
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_round_trip_is_bit_exact_through_the_model(params):
    model = MerlotReserve(load_config("base", **TINY), device="cpu")
    load_flax_params(model, params)
    _assert_trees_equal(flax_from_state_dict(model.state_dict()), params)


def test_both_layer_layouts_give_one_state_dict(params):
    stacked = state_dict_from_flax(params)
    per_layer = state_dict_from_flax(jckpt.unstack_layer_params(params))
    assert stacked.keys() == per_layer.keys()
    for k in stacked:
        assert torch.equal(stacked[k], per_layer[k]), k
    _assert_trees_equal(tckpt.unstack_layer_params(flax_from_state_dict(per_layer)),
                        jckpt.unstack_layer_params(params))


def test_numpy_layer_converters_match_jax(params):
    unstacked = tckpt.unstack_layer_params(params)
    _assert_trees_equal(unstacked, jckpt.unstack_layer_params(params))
    _assert_trees_equal(tckpt.stack_layer_params(unstacked), params)


def test_state_dict_covers_the_model_exactly(params):
    model = MerlotReserve(load_config("base", **TINY), device="cpu")
    sd = state_dict_from_flax(params)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def _without(tree, path):
    tree = jax.tree.map(lambda x: x, tree)
    node = tree
    for p in path[:-1]:
        node = node[p]
    del node[path[-1]]
    return tree


@pytest.mark.parametrize("fault", ["missing", "unused", "unknown_leaf", "wrong_shape",
                                   "mixed_layouts"])
def test_load_refuses_a_tree_that_does_not_fit(params, fault):
    model = MerlotReserve(load_config("base", **TINY), device="cpu")
    tree = jax.tree.map(lambda x: x, params)
    error = ValueError
    if fault == "missing":
        tree = _without(tree, ("head", "bias"))
    elif fault == "unused":
        tree["extra_head"] = {"kernel": np.zeros((128, 4), np.float32)}
    elif fault == "unknown_leaf":
        tree["head"]["gamma"] = np.zeros(128, np.float32)
        error = KeyError
    elif fault == "wrong_shape":
        tree["head"]["bias"] = np.zeros(64, np.float32)
    else:
        tree["joint_transformer"]["layer_00"] = jckpt.unstack_layer_params(
            {"layers": params["joint_transformer"]["layers"]})["layer_00"]
        error = KeyError
    with pytest.raises(error):
        load_flax_params(model, tree)
