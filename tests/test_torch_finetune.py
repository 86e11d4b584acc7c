"""Port parity: merlot_reserve_tpu_torch's finetuning (finetune/models.py,
finetune/train.py, the finetuning chain of training/optimization.py)
against the JAX package's finetune/models.py, finetune/train.py and
construct_finetuning_train_state, at tiny widths (hidden 128, 2 layers per
tower, f32 compute), on batches with the shapes ``finetune_batches``
yields (``data.dummy.make_dummy_vcr_batch`` / ``make_dummy_tvqa_batch``).

Tolerances:
  * logits within 1e-6 (f32, the same operations; measured about 4e-8);
  * the loss within 1e-6, each gradient tensor within 1e-3 of its largest
    |value| plus 5e-7, as tests/test_torch_pretrainer.py holds gradients:
    f32 sums in another order, and gradients that are cancellations lose
    digits (the vision tower's, about 1e-6 at this init, differences of
    nearly equal logits; a MASK token's embedding row, whose uses in the
    options of a task cancel under the softmax; the joint pre-LN bias, a
    sum over every position): measured up to 3.9e-7 absolute;
  * one finetune_train_step (the finetuning chain with bias correction,
    lr 1e-3, eps 1e-6), with f32 gradients and no microbatching, and with
    bf16 gradients and scan_minibatch (the scripts' setting): the metrics
    within 1e-6; 1 - cosine of the whole update against JAX's at most 1e-5
    (measured 3e-10 to 5e-7); every parameter within STEP_TOL = 5e-5 of
    JAX's (measured at most 3.6e-5, with either kind of gradient alone). The first
    step moves an element by lr * g / (|g| + eps), whose slope in g is
    lr / (4 eps) where |g| is near eps: a gradient that differs by 1e-7
    (1e-3 of a tensor's largest, above) moves it by 2.5e-5. Under bf16
    gradients with scan_minibatch each example's gradient is rounded to
    bf16 before the bf16 sum, so where the examples' gradients cancel, the
    packages' different last f32 bits round apart by 2^-8 of each term and
    the sum can change sign: there at most STEP_FAR_SHARE = 1e-5 of the
    elements (measured 1.2e-6 and 2.1e-6) may differ by more, up to a
    flipped first step, 2 lr;
  * the states read across: bit for bit (parameters after the f16 round
    trip both packages apply).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.finetune import models as jm
from merlot_reserve_tpu.finetune import train as jt
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.utils import checkpoint as jck
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_tvqa_batch, make_dummy_vcr_batch
from merlot_reserve_tpu_torch.finetune import models as tm
from merlot_reserve_tpu_torch.finetune import train as tt
from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
from merlot_reserve_tpu_torch.training.trainer import weight_decay_names
from merlot_reserve_tpu_torch.utils import checkpoint as tck
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax
from test_torch_checkpoint import flax_msgpack_writer

TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(lang_seq_len=48, num_segments=7)
OPT = dict(learning_rate=1e-3, num_warmup_steps=0, num_train_steps=20, do_bias_correction=True)
STEP_TOL = 5e-5
STEP_FAR_SHARE = 1e-5
TASKS = {"vcr": (jm.MerlotReserveVCR, tm.MerlotReserveVCR, make_dummy_vcr_batch,
                 jt.vcr_loss_fn, tt.vcr_loss_fn, True),
         "tvqa": (jm.MerlotReserveTVQA, tm.MerlotReserveTVQA, make_dummy_tvqa_batch,
                  jt.tvqa_loss_fn, tt.tvqa_loss_fn, False)}


def _configs():
    cfgs = [mr.load_config("base", **TINY).replace_data(**DATA),
            load_config("base", **TINY).replace_data(**DATA)]
    return [dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer, **OPT))
            for c in cfgs]


@pytest.fixture(scope="module", params=sorted(TASKS))
def task(request):
    """(name, JAX model, adapted JAX params, port model with them, batch, configs)."""
    name = request.param
    j_cls, t_cls, make_batch, _, _, drop_audio = TASKS[name]
    jcfg, tcfg = _configs()
    batch = make_batch(tcfg, 2, seed=1)
    j_model = j_cls.from_config(jcfg)
    params = jax.tree.map(np.asarray, j_model.init_params(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    params = jm.adapt_pretrained_params(params, TINY["hidden_size"], drop_audio=drop_audio)
    model = t_cls(tcfg, device="cpu")
    load_flax_params(model, params)
    return name, j_model, params, model, batch, (jcfg, tcfg)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_heads_match_jax(task):
    name, j_model, params, model, batch, _ = task
    j_out = j_model.apply({"params": params}, _jbatch(batch))
    with torch.no_grad():
        out = model(batch_to_tensors(batch, "cpu"))
    j_out, out = (j_out, out) if name == "tvqa" else ((j_out,), (out,))
    for j, t in zip(j_out, out):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_losses_and_gradients_match_jax(task):
    name, j_model, params, model, batch, (jcfg, _) = task
    _, _, _, j_loss_fn, t_loss_fn, _ = TASKS[name]
    j_state = jopt.construct_finetuning_train_state(jcfg.optimizer, j_model, params)
    (j_loss, j_info), j_grads = jax.value_and_grad(
        lambda p: j_loss_fn(j_state, p, _jbatch(batch)), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    named = {n: p.detach().requires_grad_() for n, p in model.named_parameters()}
    loss, info = t_loss_fn(model, named, batch_to_tensors(batch, "cpu"))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    assert abs(float(loss) - float(j_loss)) <= 1e-6
    for k, v in j_info.items():
        assert abs(float(info[k]) - float(v)) <= 1e-6, k
    j_grads = state_dict_from_flax(jax.tree.map(np.asarray, j_grads))
    assert set(j_grads) == set(grads)
    for n, g in grads.items():
        g = torch.zeros_like(named[n]) if g is None else g
        scale = j_grads[n].abs().max().item()
        assert (g - j_grads[n]).abs().max().item() <= 1e-3 * scale + 5e-7, n
    assert j_grads["proj.weight"].abs().max() > 0


def test_adapt_pretrained_params_matches_jax():
    tree = {"audio_encoder": {"x": np.ones(2, np.float32)}, "head": {}, "span_encoder": {},
            "joint_transformer": {"y": np.ones(3, np.float32)}}
    for drop_audio in (False, True):
        j = jm.adapt_pretrained_params(tree, 16, drop_audio=drop_audio)
        t = tm.adapt_pretrained_params(tree, 16, drop_audio=drop_audio)
        assert sorted(t) == sorted(j)
        assert torch.equal(t["proj"]["kernel"], torch.from_numpy(j["proj"]["kernel"]))
    assert "audio_encoder" not in t and "head" not in t and "span_encoder" not in t


def test_finetune_mask_follows_the_flax_leaf(task):
    """ndim > 1 and size > 4096 on the scan-stacked flax leaves: the
    per-layer [2, 128] LayerNorm scales and biases (256) stay out at these
    widths, the stacked [2, 128, 6, 64] qkv kernel is in."""
    _, _, params, model, _, _ = task
    names = set(weight_decay_names(model, tt.FINETUNE_DECAY_MIN_SIZE))
    expected = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        if leaf.ndim > 1 and leaf.size > 4096:
            one = jax.tree_util.tree_map_with_path(
                lambda p, x: np.ones_like(x) if p == path else np.zeros_like(x), params)
            expected |= {k for k, v in state_dict_from_flax(one).items() if v.any()}
    assert names == expected
    assert "joint_transformer.layers.0.attention_layer.qkv.weight" in names
    assert "proj.weight" not in names and "contrastive_scales" not in names


def _moved(params, seed=5):
    """The params moved off the anchor, so the decay toward it shows."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32), params)


@pytest.mark.parametrize("scan_minibatch,bf16_grads", [(False, False), (True, True)],
                         ids=["f32-grads", "bf16-grads-scan-minibatch"])
def test_finetune_train_step_matches_jax(task, scan_minibatch, bf16_grads):
    name, j_model, params, model, batch, (jcfg, tcfg) = task
    _, t_cls, _, j_loss_fn, t_loss_fn, _ = TASKS[name]
    j_state = jopt.construct_finetuning_train_state(jcfg.optimizer, j_model, params)
    moved = _moved(params)
    j_state = j_state.replace(params=jax.tree.map(jnp.asarray, moved))
    j_step = jax.jit(jt.finetune_train_step, static_argnums=(2, 3, 4))
    j_state, j_info = j_step(j_state, _jbatch(batch), j_loss_fn, scan_minibatch, bf16_grads)

    port = t_cls(tcfg, device="cpu")
    load_flax_params(port, params)
    state = tt.create_finetune_state(tcfg, port)  # the anchor: bf16 of params
    load_flax_params(port, moved)
    state, info = tt.finetune_train_step(state, batch_to_tensors(batch, "cpu"), t_loss_fn,
                                         scan_minibatch=scan_minibatch,
                                         use_bfloat16_grads=bf16_grads)
    assert state.step == 1 and state.optimizer.count == 1
    for k, v in j_info.items():
        assert abs(float(info[k]) - float(v)) <= 1e-6, k
    j_sd = state_dict_from_flax(jax.tree.map(np.asarray, j_state.params))
    start = state_dict_from_flax(moved)
    diff = torch.cat([(p.detach() - j_sd[n]).flatten() for n, p in port.named_parameters()])
    upd, j_upd = (torch.cat([(x[n] - start[n]).flatten() for n in start]).double()
                  for x in ({n: p.detach() for n, p in port.named_parameters()}, j_sd))
    assert 1 - float(upd @ j_upd / (upd.norm() * j_upd.norm())) <= 1e-5
    far = diff.abs() > STEP_TOL
    assert diff.abs().max().item() <= 2 * OPT["learning_rate"]
    assert float(far.float().mean()) <= (STEP_FAR_SHARE if bf16_grads and scan_minibatch else 0)
    assert not torch.equal(port.proj.weight.detach(), start["proj.weight"])


def test_finetune_states_cross_both_ways(task, tmp_path):
    """A JAX finetuning state one step in, through its msgpack file into the
    port, and the port's file back into JAX: params (f16), mu, nu, counts
    and the anchor (orig_params) bit for bit."""
    name, j_model, params, _, batch, (jcfg, tcfg) = task
    _, t_cls, _, j_loss_fn, _, _ = TASKS[name]
    j_state = jopt.construct_finetuning_train_state(jcfg.optimizer, j_model, params)
    j_state, _ = jax.jit(jt.finetune_train_step, static_argnums=(2,))(
        j_state.replace(params=jax.tree.map(jnp.asarray, _moved(params))), _jbatch(batch),
        j_loss_fn)
    with flax_msgpack_writer():
        jck.save_checkpoint(j_state, str(tmp_path / "jax"))
    port = t_cls(tcfg, device="cpu")
    state = tt.create_finetune_state(tcfg, port)
    tck.load_checkpoint(str(tmp_path / "jax"), state=state)

    def expect(tree, f16=False):
        tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
        if f16:
            tree = jax.tree.map(lambda x: x.astype(np.float16).astype(np.float32), tree)
        return state_dict_from_flax(tree)

    def same_bits(ours, theirs):
        for n, t in ours.items():
            bits = torch.int32 if t.dtype == torch.float32 else torch.int16
            assert torch.equal(t.detach().view(bits), theirs[n].to(t.dtype).view(bits)), n

    def compare(j_state, f16):
        same_bits(dict(port.named_parameters()), expect(j_state.params, f16))
        same_bits(state.optimizer.mu, expect(j_state.opt_state[0].mu))
        same_bits(state.optimizer.nu, expect(j_state.opt_state[0].nu))
        same_bits(state.optimizer.anchor, expect(j_state.opt_state[1].orig_params))
        assert state.optimizer.count == int(j_state.opt_state[0].count) == 1

    compare(j_state, f16=True)
    tck.save_checkpoint(state, str(tmp_path / "port"))
    back = jck.load_checkpoint(str(tmp_path / "port"), state=jopt.construct_finetuning_train_state(
        jcfg.optimizer, j_model, params))
    compare(back, f16=False)
    with pytest.raises(ValueError, match="chain"):  # a finetuning file into a pretraining chain
        from merlot_reserve_tpu_torch.training.trainer import create_train_state
        tck.load_checkpoint(str(tmp_path / "port"), state=create_train_state(tcfg, port))


def test_pred_steps_match_jax(task):
    name, j_model, params, model, batch, (jcfg, tcfg) = task
    j_state = jopt.construct_finetuning_train_state(jcfg.optimizer, j_model, params)
    state = tt.create_finetune_state(tcfg, model)
    j_pred = (jt.vcr_pred_step if name == "vcr" else jt.tvqa_pred_step)(j_state, _jbatch(batch))
    pred = (tt.vcr_pred_step if name == "vcr" else tt.tvqa_pred_step)(
        state, batch_to_tensors(batch, "cpu"))
    assert sorted(pred) == sorted(j_pred)
    for k, v in j_pred.items():
        if k.startswith("preds"):
            np.testing.assert_array_equal(pred[k].numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(pred[k].numpy(), np.asarray(v), rtol=0, atol=1e-6)
