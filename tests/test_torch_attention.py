"""Port parity: merlot_reserve_tpu_torch/ops/attention.py against the JAX
package's attention (flash kernel in Pallas interpret mode, dense path).

Tolerance: f32 throughout, atol 1e-5 (the same math in another summation
order). The flash paths are compared on valid rows: for a padding row the
JAX kernel averages V over its padded length, the port over exactly L keys
(the dense path's contract, checked separately on all rows)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from merlot_reserve_tpu.ops import attention as jattn
from merlot_reserve_tpu_torch import kernels
from merlot_reserve_tpu_torch.ops import attention as tattn

ATOL = 1e-5
H, D = 2, 64


def _case(name, seed=0):
    """q, k, v [B, L, H, D] f32 and (is_valid, segment_ids) [B, L] int32."""
    rng = np.random.RandomState(seed)
    B, L = 2, {"padding": 48, "packed": 64, "ragged": 200}[name]
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    if name == "padding":
        valid[0, 40:] = 0
        valid[1, 10:14] = 0
    elif name == "packed":  # two videos per row, each with padded text
        seg[:, 30:] = 1
        valid[:, 26:30] = 0
        valid[:, 60:] = 0
    else:  # L not a multiple of 128, random padding, two segments
        valid = (rng.rand(B, L) > 0.15).astype(np.int32)
        seg[:, 120:] = 1
    return q, k, v, valid, seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", ["padding", "packed", "ragged"])
def test_flash_reference_matches_jax_flash_on_valid_rows(name):
    q, k, v, valid, seg = _case(name)
    block = 128 if name == "ragged" else 16
    args = [jnp.asarray(x) for x in (q, k, v, valid, seg)]
    j_out = jattn.flash_attention(*args, block, block, True)
    _, j_lse = jattn._flash_forward(*args, block, block, True)
    t_out, t_lse = tattn.flash_attention_reference(*_t(q, k, v, valid, seg))
    rows = valid > 0
    L = q.shape[1]
    np.testing.assert_allclose(t_out.numpy()[rows], np.asarray(j_out)[rows], atol=ATOL, rtol=0)
    j_lse = np.asarray(j_lse)[:, :, 0, :L].transpose(0, 2, 1)  # [B, L, H]
    np.testing.assert_allclose(t_lse.numpy().transpose(0, 2, 1)[rows], j_lse[rows],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["padding", "packed", "ragged"])
def test_flash_reference_matches_jax_dense_on_all_rows(name):
    q, k, v, valid, seg = _case(name)
    bias = jattn.make_attention_bias(is_valid=jnp.asarray(valid > 0),
                                     segment_ids=jnp.asarray(seg))
    j_out = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias)
    t_out, _ = tattn.flash_attention_reference(*_t(q, k, v, valid, seg))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)


def test_padding_row_is_mean_of_v_over_exactly_L_keys():
    q, k, v, valid, seg = _case("padding")
    out, lse = tattn.flash_attention_reference(*_t(q, k, v, valid, seg))
    L = q.shape[1]
    np.testing.assert_allclose(out[0, 45].numpy(), v[0].mean(0), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[1, 11].numpy(), v[1].mean(0), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse[0, :, 45].numpy(), np.float32(-1e10) + np.log(L), rtol=1e-7)


@pytest.mark.parametrize("mask_kind", ["labels", "dense_mask"])
def test_dense_path_matches_jax(mask_kind):
    q, k, v, valid, seg = _case("packed", seed=1)
    if mask_kind == "labels":
        j_bias = jattn.make_attention_bias(is_valid=jnp.asarray(valid > 0),
                                           segment_ids=jnp.asarray(seg))
        t_bias = tattn.make_attention_bias(is_valid=torch.from_numpy(valid > 0),
                                           segment_ids=torch.from_numpy(seg))
    else:
        rng = np.random.RandomState(2)
        mask = rng.rand(q.shape[0], q.shape[1], q.shape[1]) > 0.3
        j_bias = jattn.make_attention_bias(attention_mask=jnp.asarray(mask))
        t_bias = tattn.make_attention_bias(attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(t_bias.numpy(), np.asarray(j_bias))
    j_out = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=j_bias)
    t_out = tattn.xla_attention(*_t(q, k, v), bias=t_bias)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)


def test_attention_entry_point_dispatch_on_cpu():
    q, k, v, valid, seg = _t(*_case("padding"))
    dense = tattn.xla_attention(q, k, v, bias=tattn.make_attention_bias(valid, seg))
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        auto = tattn.attention(q, k, v, is_valid=valid, segment_ids=seg)
        flash = tattn.attention(q, k, v, is_valid=valid, segment_ids=seg, impl="flash")
        unlabeled = tattn.attention(q, k, v, impl="flash")
    torch.testing.assert_close(auto, dense, atol=0, rtol=0)  # 'auto' on the CPU is dense
    torch.testing.assert_close(flash, dense, atol=ATOL, rtol=0)
    torch.testing.assert_close(unlabeled, tattn.xla_attention(q, k, v), atol=ATOL, rtol=0)
    assert dict(kernels.LAUNCHES) == before  # the CPU path launches no kernel


def test_resolve_impl_policy():
    assert tattn.resolve_impl("auto", has_labels=True, on_cuda=True) == "flash"
    assert tattn.resolve_impl("auto", has_labels=True, on_cuda=False) == "xla"
    assert tattn.resolve_impl("auto", has_labels=False, on_cuda=True) == "xla"
    assert tattn.resolve_impl("auto", has_bias=True, has_labels=True, on_cuda=True) == "xla"
    assert tattn.resolve_impl("flash") == "flash"
    assert tattn.resolve_impl("xla", has_labels=True, on_cuda=True) == "xla"


@pytest.mark.parametrize("impl,kwargs,error", [
    ("ring", {"bias": "dense"}, ValueError),
    ("ulysses:bogus:sp", {}, ValueError),
    ("flash:128", {}, ValueError),
    ("flash:128:bq", {}, ValueError),
    ("bogus", {}, ValueError),
    ("flash", {"bias": "dense"}, ValueError),
])
def test_attention_rejects(impl, kwargs, error):
    q, k, v, valid, seg = _t(*_case("padding"))
    if kwargs.get("bias") == "dense":
        kwargs = {"bias": tattn.make_attention_bias(valid, seg)}
    with pytest.raises(error):
        tattn.attention(q, k, v, impl=impl, **kwargs)


@pytest.mark.parametrize("impl", ["flash:128:128", "flash:640:640"])
def test_attention_accepts_jax_flash_tiles(impl):
    """The JAX package's 'flash:BQ:BK' names its Pallas tiles; the CUDA
    kernels fix their own, so the port runs it as 'flash'."""
    q, k, v, valid, seg = _t(*_case("padding"))
    assert tattn.resolve_impl(impl) == "flash"
    with torch.no_grad():
        out = tattn.attention(q, k, v, is_valid=valid, segment_ids=seg, impl=impl)
        flash = tattn.attention(q, k, v, is_valid=valid, segment_ids=seg, impl="flash")
    torch.testing.assert_close(out, flash, atol=0, rtol=0)


def test_flash_rejects_cross_attention_lengths():
    q, k, v, _, _ = _t(*_case("padding"))
    with pytest.raises(ValueError, match="Lq == Lk"):
        tattn.attention(q, k[:, :20], v[:, :20], impl="flash")


def test_flash_refuses_gradients():
    """The raw launcher records no gradient: a grad-enabled call raises there
    (flash_attention is the differentiable entry, test_torch_attention_bwd.py)."""
    q, k, v, valid, seg = _t(*_case("padding"))
    with pytest.raises(RuntimeError, match="grad-free launcher"):
        tattn.flash_forward(q.requires_grad_(), k, v, valid, seg)
