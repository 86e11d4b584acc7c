"""Port parity at the large configuration's widths: ``configs/large.yaml``
(hidden 1024, 16 heads of 64) with its depth cut to one layer per tower, a
4x4 grid and f32 compute, against the JAX package's ``large`` config cut
the same way, on one JAX init shared by every case (``init_params_full``;
the pretrainer, the embedder and the finetuning heads read the same tree).
The base-width tests hold the same functions at hidden 128 and 4 heads; here
the head split (16 heads in the attention's reshape, the flax kernels'
[1024, 48, 64] qkv and [16, 64, 1024] output layouts) and the wider
reductions are what is new.

Tolerances (f32 on both sides, the same math in another summation order;
each about ten times the largest difference measured here, on the CPU):
  * the weight bridge: bit for bit, both layer layouts;
  * ``embed_video``: atol 1e-6 on every row of unit-norm output (measured
    1.1e-7);
  * the pretrainer: each loss term within 5e-6 (measured 4.8e-7), every
    gradient tensor within 1e-3 of its largest |value| plus 5e-7, as
    tests/test_torch_pretrainer.py holds it (gradients that are
    cancellations lose digits; the largest measured is 2.3% of its limit);
  * the VCR and TVQA heads' logits: atol 2e-6 (measured 1.9e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.finetune import models as jm
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.models.pretrainer import loss_fn_given_preds as jax_loss_fn
from merlot_reserve_tpu.utils import checkpoint as jckpt
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_tvqa_batch, make_dummy_vcr_batch
from merlot_reserve_tpu_torch.finetune import models as tm
from merlot_reserve_tpu_torch.models import MerlotReserve
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.training.trainer import loss_and_grads
from merlot_reserve_tpu_torch.utils.weights import (
    flax_from_state_dict,
    load_flax_params,
    state_dict_from_flax,
)
from test_torch_pretrainer import jax_draws
from test_torch_weights import _assert_trees_equal

CUT = dict(joint_num_layers=1, vit_num_layers=1, audio_num_layers=1, span_num_layers=1,
           output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)
FINETUNE_DATA = dict(lang_seq_len=48, num_segments=7)
BATCH, SPANS = 2, 16  # as tests/test_torch_pretrainer.py, whose jax_draws this file shares
EMBED_ATOL = 1e-6
LOSS_ATOL = 5e-6
LOGIT_ATOL = 2e-6


def _configs(**data):
    """(JAX config, port config) of the cut large model."""
    return (mr.load_config("large", **CUT).replace_data(**data),
            load_config("large", **CUT).replace_data(**data))


def _port(cls, cfg, tree):
    """``cls`` on the CPU with ``tree``'s weights, built without drawing its
    own (every parameter is then loaded from the tree)."""
    model = cls(cfg, device="meta").to_empty(device="cpu")
    load_flax_params(model, tree)
    return model


@pytest.fixture(scope="module")
def params():
    """One JAX init of every tower of the cut large model, as numpy."""
    jcfg, tcfg = _configs(**DATA)
    assert (tcfg.model.hidden_size, tcfg.model.num_heads, tcfg.model.size_per_head) == (
        1024, 16, 64)
    assert (jcfg.model.hidden_size, jcfg.model.num_heads) == (1024, 16)
    return jax.tree.map(np.asarray, JaxMerlotReserve.from_config(jcfg).init_params_full())


def test_weight_bridge_is_bit_exact_at_large_widths(params):
    """The flax tree into the port's model and back, bit for bit; the
    per-layer layout gives the same state dict; the attention kernels keep
    the 16-head split in flax's layout."""
    model = _port(MerlotReserve, _configs(**DATA)[1], params)
    _assert_trees_equal(flax_from_state_dict(model.state_dict()), params)
    stacked = state_dict_from_flax(params)
    per_layer = state_dict_from_flax(jckpt.unstack_layer_params(params))
    assert stacked.keys() == per_layer.keys() == model.state_dict().keys()
    for k in stacked:
        assert torch.equal(stacked[k], per_layer[k]), k
    attention = params["joint_transformer"]["layers"]["attention_layer"]
    assert attention["qkv"]["kernel"].shape == (1, 1024, 3 * 16, 64)
    assert attention["attn_proj"]["kernel"].shape == (1, 16, 64, 1024)


def test_embed_video_matches_jax_at_large_widths(params):
    rng = np.random.RandomState(0)
    tokens = np.zeros(24, np.int32)
    tokens[:12] = 5  # AUDIOSPAN
    tokens[12:20] = rng.randint(10, 1000, 8)
    subseg = np.zeros(24, np.int32)
    subseg[:12] = np.arange(12) // 6
    subseg[12:20] = np.arange(8) // 2 + 2
    video = (rng.randn(2, 16, 768).astype(np.float32), rng.randn(6, 60, 65).astype(np.float32),
             tokens, subseg)
    jcfg, tcfg = _configs(**DATA)
    jmodel = JaxMerlotReserve.from_config(jcfg)
    j = np.asarray(jax.jit(lambda p, *v: jmodel.apply({"params": p}, *v,
                                                      method=jmodel.embed_video))(
        params, *map(jnp.asarray, video)))
    # the joint tower as the card runs it: flash, here its plain version
    model = _port(MerlotReserve, load_config("large", joint_attention_impl="flash", **CUT),
                  params)
    with torch.no_grad():
        out = model.embed_video(*map(torch.from_numpy, video)).numpy()
    assert out.shape == (24, 1024)
    np.testing.assert_allclose(out, j, atol=EMBED_ATOL, rtol=0)


def test_pretrainer_losses_and_gradients_match_jax_at_large_widths(params):
    """The three heads' losses and every parameter's gradient, the draws
    injected from JAX's content keys."""
    jcfg, tcfg = _configs(**DATA)
    batch = jax_make_dummy_batch(jcfg, batch_size=BATCH, seed=0, num_text_spans=SPANS)
    jmodel = JaxPretrainer.from_config(jcfg)
    bd = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, ref_info), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jmodel.apply({"params": p}, bd)), has_aux=True))(params)
    ref_grads = state_dict_from_flax(jax.tree.map(np.asarray, ref_grads))
    model = _port(MerlotReservePretrainer, load_config(
        "large", joint_attention_impl="flash", **CUT).replace_data(**DATA), params)
    split_at, gumbel = jax_draws(batch, jcfg)
    info, grads = loss_and_grads(model, batch_to_tensors(batch, "cpu"), use_bfloat16_grads=False,
                                 split_at=split_at, gumbel=gumbel)
    for k, v in ref_info.items():
        assert abs(float(info[k]) - float(v)) <= LOSS_ATOL, (k, float(info[k]), float(v))
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        ref = ref_grads[name]
        assert g.shape == ref.shape, name
        assert (g - ref).abs().max().item() <= 1e-3 * ref.abs().max().item() + 5e-7, name


@pytest.mark.parametrize("task", ["vcr", "tvqa"])
def test_finetuning_heads_match_jax_at_large_widths(params, task):
    jcfg, tcfg = _configs(**FINETUNE_DATA)
    j_cls, t_cls, make_batch = {
        "vcr": (jm.MerlotReserveVCR, tm.MerlotReserveVCR, make_dummy_vcr_batch),
        "tvqa": (jm.MerlotReserveTVQA, tm.MerlotReserveTVQA, make_dummy_tvqa_batch)}[task]
    head = jm.adapt_pretrained_params(params, 1024, drop_audio=task == "vcr")
    batch = make_batch(tcfg, 2, seed=1)
    j_model = j_cls.from_config(jcfg)
    j_out = jax.jit(lambda p, b: j_model.apply({"params": p}, b))(
        head, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(t_cls, tcfg, head)
    with torch.no_grad():
        out = model(batch_to_tensors(batch, "cpu"))
    j_out, out = (j_out, out) if task == "tvqa" else ((j_out,), (out,))
    for j, t in zip(j_out, out):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL, rtol=0)
