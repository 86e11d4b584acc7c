"""Port parity: merlot_reserve_tpu_torch/models/layers.py against the JAX
package's flax layers, on the same weights (converted by utils/weights.py)
and inputs, in f32 with atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from merlot_reserve_tpu.models import layers as jlayers
from merlot_reserve_tpu_torch.models import layers as tlayers
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

ATOL = 1e-5
HID = 128


def _pair(scan_layers=True, rotary_hsize=32, **kw):
    """(flax encoder, port encoder) with the same f32 config."""
    jenc = jlayers.TransformerEncoder(hidden_size=HID, num_layers=2, dtype=jnp.float32,
                                      scan_layers=scan_layers, rotary_hsize=rotary_hsize, **kw)
    tkw = {k: v for k, v in kw.items() if k in ("add_cls_token", "attention_impl")}
    return jenc, tkw


def _run(jenc, tkw, x, pe_len=None, impl=None, **inputs):
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       **{k: jnp.asarray(v) for k, v in inputs.items()})["params"]
    j_out = jenc.apply({"params": params}, jnp.asarray(x),
                       **{k: jnp.asarray(v) for k, v in inputs.items()})
    if impl is not None:
        tkw = dict(tkw, attention_impl=impl)
    tenc = tlayers.TransformerEncoder(HID, 2, generator=torch.Generator().manual_seed(0),
                                      pe_len=pe_len, **tkw)
    load_flax_params(tenc, params)
    with torch.no_grad():
        t_out = tenc(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in inputs.items()})
    return j_out, t_out


def _inputs(B=2, L=9, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, HID).astype(np.float32)
    coords = rng.uniform(-1, 1, (L, 2)).astype(np.float32)
    valid = rng.rand(B, L) > 0.2
    return x, coords, valid


@pytest.mark.parametrize("scan_layers", [True, False])
def test_encoder_with_cls_and_rotary(scan_layers):
    x, coords, valid = _inputs()
    jenc, tkw = _pair(scan_layers=scan_layers, add_cls_token=True)
    j, t = _run(jenc, tkw, x, rotary_coords=coords, is_valid=valid)
    for key in ("cls", "seq"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("port_impl", ["auto", "xla", "flash"])
def test_encoder_with_labels(port_impl):
    """Padding + packed segment labels; the port's flash path (its plain
    version on the CPU) against JAX's dense path, on all rows."""
    x, _, valid = _inputs(L=12)
    rng = np.random.RandomState(3)
    coords = rng.uniform(-1, 1, (2, 12, 4)).astype(np.float32)
    seg = np.repeat(np.array([[0] * 5 + [1] * 7]), 2, 0).astype(np.int32)
    jenc, tkw = _pair(attention_impl="xla")
    j, t = _run(jenc, tkw, x, impl=port_impl, rotary_coords=coords, is_valid=valid,
                segment_ids=seg)
    np.testing.assert_allclose(t["seq"].numpy(), np.asarray(j["seq"]), atol=ATOL, rtol=0)


def test_encoder_learned_positions_fallback():
    x, _, valid = _inputs()
    jenc, tkw = _pair(add_cls_token=True)
    j, t = _run(jenc, tkw, x, pe_len=x.shape[1] + 1, is_valid=valid)
    np.testing.assert_allclose(t["cls"].numpy(), np.asarray(j["cls"]), atol=ATOL, rtol=0)


def test_encoder_dense_attention_mask():
    x, coords, _ = _inputs()
    mask = np.random.RandomState(1).rand(2, 9, 9) > 0.3
    mask |= np.eye(9, dtype=bool)[None]
    jenc, tkw = _pair()
    j, t = _run(jenc, tkw, x, rotary_coords=coords, attention_mask=mask)
    np.testing.assert_allclose(t["seq"].numpy(), np.asarray(j["seq"]), atol=ATOL, rtol=0)


def test_encoder_rejects_cls_with_segments_and_missing_positions():
    enc = tlayers.TransformerEncoder(HID, 1, generator=torch.Generator().manual_seed(0),
                                     add_cls_token=True)
    x = torch.zeros(1, 4, HID)
    with pytest.raises(ValueError, match="segment_ids"):
        enc(x, segment_ids=torch.zeros(1, 4, dtype=torch.int32),
            rotary_coords=torch.zeros(4, 2))
    with pytest.raises(ValueError, match="learned positions"):
        enc(x)


def test_my_gelu_and_init_scale():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(tlayers.my_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.my_gelu(jnp.asarray(x))), atol=1e-6, rtol=0)
    for shape in [(768, 12, 64), (12, 64, 768), (768, 3072), (2, 65, 768)]:
        j = np.asarray(jlayers.kernel_init(jax.random.PRNGKey(0), shape))
        w = tlayers.kernel_init_(torch.empty(int(np.prod(shape))), shape,
                                 torch.Generator().manual_seed(0))
        std = tlayers.kernel_stddev(shape)
        assert abs(float(w.std()) - float(j.std())) < 0.05 * float(j.std())
        assert float(w.abs().max()) <= 2 * std + 1e-9
