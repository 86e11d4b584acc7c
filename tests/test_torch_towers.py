"""Port parity: merlot_reserve_tpu_torch/models/towers.py against the JAX
package's towers, on the same weights and inputs, in f32 with atol 1e-5."""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.models import towers as jtowers
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.models import towers as ttowers
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

ATOL = 1e-5
TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)


def _configs(**overrides):
    kw = dict(TINY, **overrides)
    return mr.load_config("base", **kw).model, load_config("base", **kw).model


def _jax_tower(kind, jcfg):
    common = dict(hidden_size=jcfg.hidden_size, dtype=jnp.float32, do_rotary=jcfg.do_rotary,
                  scan_layers=True)
    if kind == "vision":
        return jtowers.VisionTransformer(num_layers=jcfg.vit_num_layers,
                                         patch_size=jcfg.vit_patch_size,
                                         pooling_ratio=jcfg.vit_pooling_ratio,
                                         output_grid_h=jcfg.output_grid[0],
                                         output_grid_w=jcfg.output_grid[1], **common)
    if kind == "audio":
        return jtowers.AudioTransformer(num_layers=jcfg.audio_num_layers,
                                        patch_size=jcfg.audio_patch_size,
                                        pooling_ratio=jcfg.audio_pooling_ratio, **common)
    return jtowers.SpanTransformer(num_layers=jcfg.span_num_layers,
                                   max_len=jcfg.text_span_length + 1, **common)


def _compare(kind, do_rotary=True):
    jcfg, tcfg = _configs(do_rotary=do_rotary)
    rng = np.random.RandomState(0)
    if kind == "vision":
        args = (rng.randn(3, 16, 768).astype(np.float32),)
    elif kind == "audio":
        args = (rng.randn(2, 3, 60, 65).astype(np.float32),)  # two batch dims
    else:
        x = rng.randn(4, 15, 128).astype(np.float32)
        valid = rng.rand(4, 15) > 0.3
        valid[:, 0] = True
        args = (x, valid)
    jm = _jax_tower(kind, jcfg)
    params = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    j_out = jm.apply({"params": params}, *map(jnp.asarray, args))
    tm = {"vision": ttowers.VisionTransformer, "audio": ttowers.AudioTransformer,
          "span": ttowers.SpanTransformer}[kind](tcfg, torch.float32,
                                                  torch.Generator().manual_seed(0))
    load_flax_params(tm, params)
    with torch.no_grad():
        t_out = tm(*map(torch.from_numpy, args))
    if kind == "span":
        j_out, t_out = {"cls": j_out}, {"cls": t_out}
    for key in j_out:
        assert t_out[key].shape == j_out[key].shape, key
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["vision", "audio", "span"])
def test_tower_matches_jax(kind):
    _compare(kind)


@pytest.mark.parametrize("kind", ["vision", "span"])
def test_tower_with_learned_positions_matches_jax(kind):
    _compare(kind, do_rotary=False)


def test_token_embedder_matches_jax():
    rng = np.random.RandomState(0)
    toks = {"a": rng.randint(0, 32768, (2, 7)), "b": rng.randint(0, 32768, (3,))}
    jm = jtowers.TokenEmbedder(hidden_size=128, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in toks.items()})["params"]
    j_out = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in toks.items()})
    tm = ttowers.TokenEmbedder(128, 32768, torch.float32, torch.Generator().manual_seed(0))
    load_flax_params(tm, params)
    t_out = tm({k: torch.from_numpy(v) for k, v in toks.items()})
    for k in toks:
        np.testing.assert_array_equal(t_out[k].detach().numpy(), np.asarray(j_out[k]))


def test_attention_pool_matches_flax_mha():
    rng = np.random.RandomState(0)
    q = rng.randn(5, 1, 128).astype(np.float32)
    kv = rng.randn(5, 4, 128).astype(np.float32)
    jm = nn.MultiHeadDotProductAttention(num_heads=2, dtype=jnp.float32, deterministic=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv))["params"]
    j_out = jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(kv))
    tm = ttowers.MultiHeadDotProductAttention(128, 2, torch.float32,
                                              torch.Generator().manual_seed(0))
    load_flax_params(tm, params)
    with torch.no_grad():
        t_out = tm(torch.from_numpy(q), torch.from_numpy(kv))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
