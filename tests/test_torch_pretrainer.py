"""Port parity: merlot_reserve_tpu_torch's pretraining objective
(models/pretrainer.py, data/dummy.py) against the JAX package's
MerlotReservePretrainer and loss_fn_given_preds at tiny widths (hidden 128,
2 layers per tower, 4x4 grid, 4 segments, seq_len 80, lang_seq_len 40,
8 spans drawn, batch 2), f32, on the same weights and batch.

Both draws of the objective (the packed-video split and the Gumbel noise of
the span-target draw) are computed with jax.random from the JAX package's
content keys and injected into the port, so both sides see the same numbers.
The port's joint attention runs as 'xla' (dense) and as 'flash' (its plain
forward and backward on the CPU); the JAX side runs its dense path.

Tolerances (f32, the same math in another summation order):
  * stage outputs: atol 1e-5;
  * losses: atol 2e-6;
  * gradients: for every parameter tensor, max |err| <= 1e-3 * max |grad|
    + 5e-7. The absolute part is the f32 floor of the loss itself (a loss
    near ln N = 2.08 resolves about 2.4e-7): at this init the vision and
    span CLS embeddings are nearly equal across rows, so their gradients
    (about 1e-6) are differences of nearly equal logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.models.pretrainer import loss_fn_given_preds as jax_loss_fn
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.models.pretrainer import (
    MerlotReservePretrainer,
    batch_to_tensors,
    loss_fn_given_preds,
)
from merlot_reserve_tpu_torch.training.trainer import loss_and_grads
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax

TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)
BATCH, SPANS = 2, 16


def jax_config(**model):
    return mr.load_config("base", **dict(TINY, **model)).replace_data(**DATA)


def port_config(**model):
    return load_config("base", **dict(TINY, **model)).replace_data(**DATA)


def jax_draws(batch, cfg):
    """The numbers JAX's pretrainer draws for ``batch``: (split_at for the
    audio2text and text2audio streams, gumbel), from its content keys."""
    data = cfg.data
    towers = {"flat": {"audio2text/text_ptr": jnp.asarray(batch["audio2text/text_ptr"])}}
    keys = JaxPretrainer.content_keys(None, towers)
    spg = data.num_segments_per_group
    rows = BATCH * data.num_segment_groups
    probs = np.array([0.1 / (spg - 1)] * (spg - 1) + [0.9])
    split_at = [np.asarray(1 + jax.random.choice(keys[i], a=spg, shape=[rows], p=probs))
                for i in (0, 1)]
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key=keys[2], shape=[BATCH, SPANS],
                                                  dtype=jnp.float32, minval=0.0, maxval=1.0)))
    return [torch.tensor(s) for s in split_at], torch.tensor(np.asarray(gumbel))


@pytest.fixture(scope="module")
def setup():
    cfg = jax_config()
    batch = jax_make_dummy_batch(cfg, batch_size=BATCH, seed=0, num_text_spans=SPANS)
    model = JaxPretrainer.from_config(cfg)
    params = jax.tree.map(np.asarray, model.init_params(batch))
    return cfg, model, params, batch


@pytest.fixture(scope="module")
def jax_reference(setup):
    """JAX's stage outputs, loss terms and gradients, computed once."""
    cfg, model, params, batch = setup
    bd = {k: jnp.asarray(v) for k, v in batch.items()}

    def stages(m):
        t = m.encode_towers(bd)
        keys = m.content_keys(t)
        out = m.fuse_streams(t, keys)
        t2a = m.pool_audio_span_targets(t, out)
        span = m.pool_text_span_targets(t, out, keys[2])
        return {"vision_cls": t["vision_cls"], "frames_by_group": t["frames_by_group"],
                "audio_span_tokens": t["audio_span_tokens"],
                "audio_span_cls": t["audio_span_cls"], "streams": out,
                "matching": m.pool_matching_targets(t, out), "audio_span": t2a,
                "text_span": span}

    def loss(p):
        return jax_loss_fn(model.apply({"params": p}, bd))

    staged = jax.jit(lambda p: model.apply({"params": p}, method=stages))(params)
    (_, info), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return (jax.tree.map(np.asarray, staged), {k: float(v) for k, v in info.items()},
            state_dict_from_flax(jax.tree.map(np.asarray, grads)))


def _port(params, impl):
    model = MerlotReservePretrainer(port_config(joint_attention_impl=impl), device="cpu")
    load_flax_params(model, params)
    return model


def test_make_dummy_batch_is_byte_identical_to_jax():
    for cfg_kw, bs, seed, spans in ((DATA, 2, 0, 16),
                                   (dict(DATA, num_segments=8, seq_len=168), 3, 5, 64)):
        jcfg = mr.load_config("base", **TINY).replace_data(**cfg_kw)
        tcfg = load_config("base", **TINY).replace_data(**cfg_kw)
        j = jax_make_dummy_batch(jcfg, batch_size=bs, seed=seed, num_text_spans=spans)
        t = make_dummy_batch(tcfg, batch_size=bs, seed=seed, num_text_spans=spans)
        assert list(t) == list(j)
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            assert t[k].tobytes() == j[k].tobytes(), k


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_stage_outputs_match_jax(setup, jax_reference, impl):
    cfg, _, params, batch = setup
    ref = jax_reference[0]
    model = _port(params, impl)
    split_at, gumbel = jax_draws(batch, cfg)
    with torch.no_grad():
        t = model.encode_towers(batch_to_tensors(batch, "cpu"))
        out = model.fuse_streams(t, split_at=split_at)
        got = {"vision_cls": t["vision_cls"], "frames_by_group": t["frames_by_group"],
               "audio_span_tokens": t["audio_span_tokens"], "audio_span_cls": t["audio_span_cls"],
               "streams": out, "matching": model.pool_matching_targets(t, out),
               "audio_span": model.pool_audio_span_targets(t, out),
               "text_span": model.pool_text_span_targets(t, out, gumbel=gumbel)}
    for key in ("vision_cls", "frames_by_group", "audio_span_tokens", "audio_span_cls",
                "matching"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-5, rtol=0, err_msg=key)
    for stream, value in ref["streams"].items():
        np.testing.assert_allclose(got["streams"][stream].numpy(), value, atol=1e-5, rtol=0,
                                   err_msg=stream)
    for key in ("audio_span", "text_span"):
        for i, (a, b) in enumerate(zip(got[key], ref[key])):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0, err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_losses_and_every_gradient_match_jax(setup, jax_reference, impl):
    cfg, _, params, batch = setup
    _, ref_info, ref_grads = jax_reference
    model = _port(params, impl)
    split_at, gumbel = jax_draws(batch, cfg)
    info, grads = loss_and_grads(model, batch_to_tensors(batch, "cpu"), use_bfloat16_grads=False,
                                 split_at=split_at, gumbel=gumbel)
    assert set(info) == set(ref_info) | {"total"}
    for k, v in ref_info.items():
        assert abs(float(info[k]) - v) <= 2e-6, (k, float(info[k]), v)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        ref = ref_grads[name]
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        err = (g - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 5e-7, (name, err)


def test_losses_sit_near_ln_n_at_init(setup):
    """An untrained model scores every candidate about equally: each head's
    loss is near the log of its number of candidates (batch 2, 4 segments,
    12 audio spans, 3 of them targets, 16 drawn spans)."""
    _, _, params, batch = setup
    model = _port(params, "xla")
    with torch.no_grad():
        _, info = loss_fn_given_preds(model(batch_to_tensors(batch, "cpu")))
    expected = {"imgs_to_audio": np.log(8), "text_to_audio": (np.log(24) + np.log(6)) / 2,
                "stuff_to_span": np.log(16)}
    for head, value in expected.items():
        assert abs(float(info[head]) - value) < 0.5, (head, float(info[head]), value)


def test_content_generator_draws_the_same_for_one_batch(setup):
    """Without injected draws the port seeds its generator from the batch's
    content: one batch gives one loss, every time."""
    _, _, params, batch = setup
    model = _port(params, "xla")
    bd = batch_to_tensors(batch, "cpu")
    with torch.no_grad():
        a = loss_fn_given_preds(model(bd))[0]
        b = loss_fn_given_preds(model(bd))[0]
        c = loss_fn_given_preds(model(bd, generator=torch.Generator().manual_seed(1)))[0]
    assert float(a) == float(b)
    assert np.isfinite(float(c))


def test_split_packed_videos_offsets_the_tail():
    model = MerlotReservePretrainer(port_config(), device="cpu")
    ids = torch.tensor([[1, 1, 1, 1], [0, 0, 1, 1]])
    out = model._split_packed_videos(ids, split_at=torch.tensor([2, 4]))
    assert out.tolist() == [[1, 1, 17, 17], [0, 0, 1, 1]]
    draws = model.draw_split_at(4000, 4, torch.Generator().manual_seed(0))
    assert draws.min() >= 1 and draws.max() <= 4
    assert abs((draws == 4).float().mean().item() - 0.9) < 0.03
