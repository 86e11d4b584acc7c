"""Port parity: merlot_reserve_tpu_torch/ops/rotary.py and ops/pooling.py
against the JAX package, in f32 with atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from merlot_reserve_tpu.ops import pooling as jpool
from merlot_reserve_tpu.ops import rotary as jrot
from merlot_reserve_tpu_torch.ops import pooling as tpool
from merlot_reserve_tpu_torch.ops import rotary as trot

ATOL = 1e-5


@pytest.mark.parametrize("seq_len", [7, 30])
@pytest.mark.parametrize("center_origin", [True, False])
def test_rotary_coordinates_1d(seq_len, center_origin):
    j = jrot.get_rotary_coordinates(seq_len, center_origin=center_origin)
    t = trot.get_rotary_coordinates(seq_len, center_origin=center_origin)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("h,w", [(4, 4), (6, 10), (3, 5)])
def test_rotary_coordinates_2d(h, w):
    j = jrot.get_rotary_coordinates_2d(h, w)
    t = trot.get_rotary_coordinates_2d(h, w)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7, rtol=0)


def test_multimodal_coords_zero_fill_and_normalize():
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 8, (2, 9)).astype(np.float32)
    tok = (1 + np.arange(9, dtype=np.float32))[None].repeat(2, 0)
    h = rng.rand(2, 9).astype(np.float32)
    for kw in ({"segment_idx": seg, "token_idx": tok}, {"h": h, "w": h, "segment_idx": seg}):
        j = jrot.multimodal_rotary_coords(**{k: jnp.asarray(v) for k, v in kw.items()})
        t = trot.multimodal_rotary_coords(**{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7, rtol=0)
    with pytest.raises(ValueError):
        trot.multimodal_rotary_coords()


@pytest.mark.parametrize("num_dims", [1, 2, 4])
def test_construct_rotary_sinusoids(num_dims):
    rng = np.random.RandomState(num_dims)
    coords = rng.uniform(-1, 1, (3, 11, num_dims)).astype(np.float32)
    j = jrot.construct_rotary_sinusoids(jnp.asarray(coords), rotary_hsize=32)
    t = trot.construct_rotary_sinusoids(torch.from_numpy(coords), rotary_hsize=32)
    assert t.shape == (3, 2, 11, 32)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("sign_quirk", [True, False])
@pytest.mark.parametrize("sin_batched", [True, False])
def test_apply_rotary(sign_quirk, sin_batched):
    rng = np.random.RandomState(0)
    qk = rng.randn(2, 11, 4, 64).astype(np.float32)
    coords = rng.uniform(-1, 1, (2, 11, 4) if sin_batched else (11, 4)).astype(np.float32)
    j_sin = jrot.construct_rotary_sinusoids(jnp.asarray(coords), rotary_hsize=32)
    t_sin = trot.construct_rotary_sinusoids(torch.from_numpy(coords), rotary_hsize=32)
    j = jrot.apply_rotary(jnp.asarray(qk), j_sin, sign_quirk=sign_quirk)
    t = trot.apply_rotary(torch.from_numpy(qk), t_sin, sign_quirk=sign_quirk)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(t.numpy()[..., 32:], qk[..., 32:])  # only rotary dims move


def test_coordinates_keep_the_requested_dtype():
    assert trot.get_rotary_coordinates_2d(6, 10, dtype=torch.bfloat16).dtype == torch.bfloat16
    coords = trot.get_rotary_coordinates(30, dtype=torch.bfloat16)[:, None] / 30
    assert trot.construct_rotary_sinusoids(coords).dtype == torch.bfloat16


def test_unit_normalize():
    x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32)
    np.testing.assert_allclose(tpool.unit_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jpool.unit_normalize(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tpool.unit_normalize(xb).dtype == torch.bfloat16


@pytest.mark.parametrize("real_bsize", [None, 1])
def test_one_hot_pool(real_bsize):
    rng = np.random.RandomState(0)
    do_pool = rng.rand(2, 12) > 0.4
    idx = rng.randint(0, 5, (2, 12)).astype(np.int32)
    v = rng.randn(2, 12, 8).astype(np.float32)
    j = jpool.one_hot_pool(jnp.asarray(do_pool), jnp.asarray(idx), jnp.asarray(v), 5,
                           real_bsize=real_bsize)
    t = tpool.one_hot_pool(torch.from_numpy(do_pool), torch.from_numpy(idx),
                           torch.from_numpy(v), 5, real_bsize=real_bsize)
    for key in ("x", "idx_oh"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=ATOL, rtol=0)
