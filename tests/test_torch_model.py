"""Port parity: merlot_reserve_tpu_torch MerlotReserve (embed_video, the
batch serving path and the other zero-shot methods) against the JAX
package's MerlotReserve at tiny widths (hidden 128, 2 layers per tower,
4x4 grid, 2 segments), on the same weights and inputs.

Tolerance: f32, atol 1e-4 on the unit-normalized outputs. Against JAX's
dense joint attention every row is compared; against JAX's flash kernel
(Pallas interpret mode) only the valid rows, since for a padding row the
JAX kernel averages over its padded length and the port over exactly L."""

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

import merlot_reserve_tpu as mr
import merlot_reserve_tpu.ops.attention as jattn
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.utils.checkpoint import unstack_layer_params
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.config import CONFIG_DIR
from merlot_reserve_tpu_torch.models import MerlotReserve, PretrainedMerlotReserve
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

ATOL = 1e-4
TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
L_TOKENS, N_VALID = 20, 16


def _video(seed):
    """2 segments: 12 AUDIOSPAN tokens (subsegments 0-1), 4 text tokens
    (subsegments 2-5), then 4 PADDING."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros(L_TOKENS, np.int32)
    tokens[:12] = 5
    tokens[12:N_VALID] = rng.randint(10, 1000, N_VALID - 12)
    subseg = np.zeros(L_TOKENS, np.int32)
    subseg[:12] = np.arange(12) // 6
    subseg[12:N_VALID] = [2, 3, 4, 5]
    return (rng.randn(2, 16, 768).astype(np.float32), rng.randn(6, 60, 65).astype(np.float32),
            tokens, subseg)


@pytest.fixture(scope="module")
def jax_params():
    return JaxMerlotReserve.from_config(mr.load_config("base", **TINY)).init_params_full()


def _jax_apply(params, method, *args, impl="xla", **kwargs):
    model = JaxMerlotReserve.from_config(
        mr.load_config("base", joint_attention_impl=impl, **TINY))
    return np.asarray(model.apply({"params": params}, *map(jnp.asarray, args),
                                  method=getattr(model, method), **kwargs))


def _port(params, impl="xla", layout="stacked"):
    model = MerlotReserve(load_config("base", joint_attention_impl=impl, **TINY), device="cpu")
    load_flax_params(model, params if layout == "stacked" else unstack_layer_params(params))
    return model


def _port_apply(model, method, *args):
    with torch.no_grad():
        return getattr(model, method)(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()


@pytest.fixture(scope="module")
def jax_dense_video(jax_params):
    return _jax_apply(jax_params, "embed_video", *_video(0))


@pytest.mark.parametrize("layout", ["stacked", "layer_NN"])
@pytest.mark.parametrize("port_impl", ["xla", "flash"])
def test_embed_video_matches_jax_dense_on_all_rows(jax_params, jax_dense_video, port_impl,
                                                   layout):
    out = _port_apply(_port(jax_params, port_impl, layout), "embed_video", *_video(0))
    assert out.shape == (L_TOKENS, 128)
    np.testing.assert_allclose(out, jax_dense_video, atol=ATOL, rtol=0)


def test_embed_video_matches_jax_flash_on_valid_rows(jax_params, monkeypatch):
    monkeypatch.setattr(jattn, "_FORCE_INTERPRET", True)
    j = _jax_apply(jax_params, "embed_video", *_video(0), impl="flash")
    out = _port_apply(_port(jax_params, "flash", "layer_NN"), "embed_video", *_video(0))
    np.testing.assert_allclose(out[:N_VALID], j[:N_VALID], atol=ATOL, rtol=0)


def test_jax_flash_tile_string_builds_the_flash_model(jax_params):
    """A config written for the JAX package (joint_attention_impl
    'flash:640:640', as docs/TRAINING.md recommends) builds a port model
    that gives the 'flash' model's output exactly."""
    tiles = _port_apply(_port(jax_params, "flash:640:640"), "embed_video", *_video(0))
    flash = _port_apply(_port(jax_params, "flash"), "embed_video", *_video(0))
    np.testing.assert_array_equal(tiles, flash)


def _one_minus_cosine(a, b):
    return 1 - (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("port_impl", ["xla", "flash"])
def test_embed_video_bf16_follows_jax_bf16_policy(jax_params, jax_dense_video, port_impl):
    """Under use_bfloat16 the port rounds where JAX's bf16 path rounds (bf16
    rotary coordinates and sinusoids, bf16 pooling softmax, weights cast at
    use). Measured at these widths: per-row 1 - cosine to JAX bf16 is at
    most 3.7e-5, with a mean of 1.4e-5. The mean to JAX f32 is 2.9e-5, and
    an f32 policy would sit that far from JAX bf16 and ~1e-7 from JAX f32."""
    bf16 = dict(TINY, use_bfloat16=True)
    jax_model = JaxMerlotReserve.from_config(
        mr.load_config("base", joint_attention_impl="xla", **bf16))
    j16 = jax_model.apply({"params": jax_params}, *map(jnp.asarray, _video(0)),
                          method=jax_model.embed_video)
    model = MerlotReserve(load_config("base", joint_attention_impl=port_impl, **bf16),
                          device="cpu")
    load_flax_params(model, jax_params)
    with torch.no_grad():
        out = model.embed_video(*[torch.from_numpy(a) for a in _video(0)])
    assert out.dtype == torch.bfloat16 and j16.dtype == jnp.bfloat16
    out, j16 = out.float().numpy(), np.asarray(j16, np.float32)
    assert out.shape == (L_TOKENS, 128)
    to_bf16, to_f32 = _one_minus_cosine(out, j16), _one_minus_cosine(out, jax_dense_video)
    assert to_bf16.max() <= 1e-4
    assert to_bf16.mean() <= 0.7 * to_f32.mean()


def test_batch_embed_video_matches_jax(jax_params):
    videos = [_video(1), _video(2)]
    batch = [np.stack(x) for x in zip(*videos)]
    j = _jax_apply(jax_params, "batch_embed_video", *batch)
    out = _port_apply(_port(jax_params, "flash"), "batch_embed_video", *batch)
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=0)
    single = _port_apply(_port(jax_params, "flash"), "embed_video", *videos[1])
    np.testing.assert_allclose(out[1], single, atol=1e-6, rtol=0)


def _zero_shot_args(method, rng):
    images = rng.randn(2, 16, 768).astype(np.float32)
    _, _, tokens, subseg = _video(3)
    enc = rng.randn(2, 4, 128).astype(np.float32)
    return {
        "embed_text_spans_only": (np.where(rng.rand(3, 15) > 0.3,
                                           rng.randint(10, 1000, (3, 15)), 0),),
        "embed_audio_only": (rng.randn(2, 3, 60, 65).astype(np.float32),),
        "get_imgseq_only": (images,),
        "get_audioseq_only": (rng.randn(3, 60, 65).astype(np.float32),),
        "embed_singleimg_with_multiimg_prompt": (enc[:1], images[:1], tokens, subseg),
        "embed_preencoded_noaudio": (enc, tokens, subseg),
        "embed_preencoded_audio": (enc, rng.randn(6, 6, 128).astype(np.float32), tokens,
                                   subseg, subseg),
    }[method]


@pytest.mark.parametrize("method", [
    "embed_text_spans_only", "embed_audio_only", "get_imgseq_only", "get_audioseq_only",
    "embed_singleimg_with_multiimg_prompt", "embed_preencoded_noaudio",
    "embed_preencoded_audio"])
def test_zero_shot_methods_match_jax(jax_params, method):
    args = _zero_shot_args(method, np.random.RandomState(4))
    j = _jax_apply(jax_params, method, *args)
    out = _port_apply(_port(jax_params, "flash"), method, *args)
    assert out.shape == j.shape
    np.testing.assert_allclose(out, j, atol=ATOL, rtol=0)


def test_prepare_multimodal_inputs_packing_matches_jax(jax_params):
    rng = np.random.RandomState(5)
    tokens = np.where(rng.rand(2, 12) > 0.2, rng.randint(6, 1000, (2, 12)), 0)
    tokens[:, :6] = 5
    seg_idx = np.repeat(np.arange(4)[None], 2, 0).repeat(3, 1)
    ptr = np.repeat(np.arange(6)[None], 2, 0).repeat(2, 1)
    kwargs = dict(tokens=tokens, token_segment_idx=seg_idx,
                  token_embs=rng.randn(2, 12, 128).astype(np.float32),
                  vision_input=rng.randn(2, 8, 128).astype(np.float32),
                  audio_spans=rng.randn(2, 6, 6, 128).astype(np.float32),
                  audio_pointers=ptr, video_src_idx=np.array([[0, 0, 1, 1], [0, 1, 1, 1]]))
    model = JaxMerlotReserve.from_config(mr.load_config("base", **TINY))
    j = model.apply({"params": jax_params}, method=model.prepare_multimodal_inputs,
                    padding_len=24, **{k: jnp.asarray(v) for k, v in kwargs.items()})
    port = _port(jax_params)
    with torch.no_grad():
        t = port.prepare_multimodal_inputs(
            padding_len=24, **{k: torch.from_numpy(np.asarray(v)) for k, v in kwargs.items()})
    for key in ("x", "rotary_coords", "is_valid", "segment_ids"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=1e-6, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("knob,value", [("pipeline_axis", "pp")])
def test_unported_config_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        MerlotReserve(load_config("base", **dict(TINY, **{knob: value})), device="cpu")


@pytest.mark.parametrize("knob,value", [
    ("gradient_checkpoint", True), ("tower_gradient_checkpoint", True),
    ("segment_shard_axis", "sp")])
def test_remat_and_segment_knobs_build_the_model(jax_params, jax_dense_video, knob, value):
    """The remat knobs reach the encoders they name (the joint tower, or the
    vision, audio and span towers) and the segment-shard hint is taken;
    none changes the forward."""
    model = MerlotReserve(load_config("base", **dict(TINY, **{knob: value})), device="cpu")
    load_flax_params(model, jax_params)
    towers = [model.vision_encoder.transformer, model.audio_encoder.transformer,
              model.span_encoder.transformer]
    remat = {enc: enc.remat_saves is not None for enc in towers + [model.joint_transformer]}
    assert remat[model.joint_transformer] == (knob == "gradient_checkpoint")
    assert all(remat[enc] == (knob == "tower_gradient_checkpoint") for enc in towers)
    assert getattr(model.config, knob) == value
    np.testing.assert_allclose(_port_apply(model, "embed_video", *_video(0)), jax_dense_video,
                               atol=ATOL, rtol=0)


def test_seq_shard_axis_reaches_the_joint_transformer(jax_params, jax_dense_video):
    """seq_shard_axis is a sharding hint in the JAX package: the port takes
    it, checks it against the active mesh, and computes the same numbers."""
    model = MerlotReserve(load_config("base", seq_shard_axis="sp", **TINY), device="cpu")
    load_flax_params(model, jax_params)
    assert model.joint_transformer.seq_shard_axis == "sp"
    np.testing.assert_allclose(_port_apply(model, "embed_video", *_video(0)), jax_dense_video,
                               atol=ATOL, rtol=0)


def test_pretrained_from_params_runs_under_inference_mode(jax_params, jax_dense_video, tmp_path):
    with open(f"{CONFIG_DIR}/base.yaml") as f:
        raw = yaml.safe_load(f)
    raw["model"].update({k: v for k, v in TINY.items() if k != "output_grid"})
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    pre = PretrainedMerlotReserve.from_params(str(path), unstack_layer_params(jax_params),
                                              image_grid_size=(4, 4), device="cpu")
    out = pre.embed_video(*_video(0))  # numpy in, moved to the model's device
    assert out.dtype == torch.float32 and out.is_inference()
    np.testing.assert_allclose(out.numpy(), jax_dense_video, atol=ATOL, rtol=0)
