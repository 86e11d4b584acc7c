"""Port parity: remat (gradient checkpointing) in merlot_reserve_tpu_torch's
TransformerEncoder and training step against the port without remat and
against the JAX package's nn.remat encoder (tests/test_remat.py's shapes:
hidden 64, 2 layers, heads of 32, 9 positions, batch 2).

Tolerances:
  * remat against no remat in the port: bit for bit, outputs and every
    gradient, in f32 and in a bf16 training step on the CPU. The recompute
    runs the same ops on the same tensors, and the CPU's plain versions are
    deterministic;
  * the port's remat encoder against JAX's: atol 1e-5 on the gradients, as
    tests/test_remat.py holds JAX's remat against its own no-remat grads
    (the same math in another summation order).
"""

import dataclasses
import threading
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from merlot_reserve_tpu.models import layers as jlayers
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.models import layers as tlayers
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.ops import ring_attention as tring
from merlot_reserve_tpu_torch.parallel import mesh as tmesh
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

HID, LAYERS, HEAD = 64, 2, 32
POLICIES = (None, "nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable")


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, HID).astype(np.float32)
    coords = rng.uniform(-1, 1, (2, 9, 1)).astype(np.float32)
    valid = np.ones((2, 9), bool)
    valid[1, 6:] = False
    return x, coords, valid


@pytest.fixture(scope="module")
def jax_params():
    x, coords, _ = _inputs()
    enc = jlayers.TransformerEncoder(hidden_size=HID, num_layers=LAYERS, size_per_head=HEAD)
    return enc.init(jax.random.PRNGKey(0), jnp.asarray(x), rotary_coords=jnp.asarray(coords))


def _port_encoder(params, impl="xla", **kw):
    enc = tlayers.TransformerEncoder(HID, LAYERS, generator=torch.Generator().manual_seed(0),
                                     size_per_head=HEAD, attention_impl=impl, **kw)
    load_flax_params(enc, params["params"])
    return enc


def _port_grads(enc, with_labels=False):
    """(output, grad of the input, grads of every parameter) of mean(out^2)."""
    x, coords, valid = _inputs()
    tx = torch.from_numpy(x).requires_grad_()
    labels = {"is_valid": torch.from_numpy(valid)} if with_labels else {}
    out = enc(tx, rotary_coords=torch.from_numpy(coords), **labels)["seq"]
    params = dict(enc.named_parameters())
    grads = torch.autograd.grad((out ** 2).mean(), [tx, *params.values()])
    return out.detach(), grads[0], dict(zip(params, grads[1:]))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_encoder_is_bit_exact(jax_params, impl, policy):
    """Every policy against the same encoder without remat: the output and
    every gradient equal. 'flash' runs the FlashAttention autograd Function
    (its plain versions on the CPU) inside the recompute."""
    plain = _port_grads(_port_encoder(jax_params, impl), with_labels=True)
    ckpt_enc = _port_encoder(jax_params, impl, remat=True, remat_policy=policy)
    assert (ckpt_enc.remat_saves is None) == (policy == "everything_saveable")
    ckpt = _port_grads(ckpt_enc, with_labels=True)
    assert torch.equal(plain[0], ckpt[0]) and torch.equal(plain[1], ckpt[1])
    for name, g in plain[2].items():
        assert torch.equal(g, ckpt[2][name]), name


@pytest.mark.parametrize("policy", [None, "dots_saveable", "everything_saveable"])
def test_remat_encoder_matches_jax_remat(jax_params, policy):
    x, coords, _ = _inputs()
    jenc = jlayers.TransformerEncoder(hidden_size=HID, num_layers=LAYERS, size_per_head=HEAD,
                                      remat=True, remat_policy=policy)

    def loss(p, x_):
        return (jenc.apply(p, x_, rotary_coords=jnp.asarray(coords))["seq"] ** 2).mean()

    j_params, j_x = jax.grad(loss, argnums=(0, 1))(jax_params, jnp.asarray(x))
    _, t_x, t_params = _port_grads(_port_encoder(jax_params, remat=True, remat_policy=policy))
    np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), atol=1e-5, rtol=0)
    check = _port_encoder(jax_params)  # the port's names for JAX's gradient tree
    load_flax_params(check, jax.tree.map(np.asarray, j_params)["params"])
    for name, j in check.named_parameters():
        np.testing.assert_allclose(t_params[name].numpy(), j.detach().numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_remat_policy_unknown_name_raises():
    with pytest.raises(ValueError, match="remat policy"):
        jlayers.resolve_remat_policy("not_a_policy")
    with pytest.raises(ValueError, match="remat policy"):
        tlayers.resolve_remat_policy("not_a_policy")
    with pytest.raises(ValueError, match="remat policy"):
        tlayers.TransformerEncoder(HID, 1, generator=torch.Generator(), remat=True,
                                   remat_policy="checkpoint_dots")
    # as in JAX, the policy is read only under remat
    tlayers.TransformerEncoder(HID, 1, generator=torch.Generator(), remat_policy="bogus")
    assert tlayers.resolve_remat_policy(None) == ()
    assert tlayers.resolve_remat_policy("everything_saveable") is None


class _CountProducts(TorchDispatchMode):
    """Counts the aten products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.counts["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [
    (None, {"mm", "bmm"}), ("dots_saveable", set()),
    ("dots_with_no_batch_dims_saveable", {"bmm"}), ("everything_saveable", set())])
def test_remat_policy_decides_what_the_backward_recomputes(jax_params, policy, recomputed):
    """The products the backward runs, counted against the backward without
    remat: a policy that saves a kind of product (mm/addmm: the linear
    layers; bmm: dense attention's einsums) does not run it again."""

    def backward_products(enc):
        x, coords, _ = _inputs()
        tx = torch.from_numpy(x).requires_grad_()
        out = enc(tx, rotary_coords=torch.from_numpy(coords))["seq"]
        with _CountProducts() as mode:
            (out ** 2).sum().backward()
        return mode.counts

    plain = backward_products(_port_encoder(jax_params))
    ckpt = backward_products(_port_encoder(jax_params, remat=True, remat_policy=policy))
    assert {k for k in plain if ckpt[k] > plain[k]} == recomputed, (plain, ckpt)
    assert all(ckpt[k] >= plain[k] for k in plain)


def test_recompute_runs_under_the_forward_mesh_on_another_thread(jax_params):
    """The backward of a remat'd ring:flash encoder started from a thread that
    has no active mesh (as autograd's device thread on the card): the
    recompute still walks the 4-rank ring, and the gradients equal those of
    a backward on the forward's own thread."""
    x, coords, valid = _inputs()
    x = np.concatenate([x, x[:, :3]], 1)  # 12 positions over 4 ranks
    coords = np.concatenate([coords, coords[:, :3]], 1)
    valid = np.concatenate([valid, valid[:, :3]], 1)
    enc = _port_encoder(jax_params, "ring:flash", remat=True, seq_shard_axis="sp")
    calls = []
    real = tring._ring_flash_forward

    def counted(*args):
        calls.append(len(args[0]))
        return real(*args)

    def grads(on_thread):
        tx = torch.from_numpy(x).requires_grad_()
        with tmesh.activate_mesh(tmesh.make_mesh(sp=4, devices=["cpu"] * 4)):
            out = enc(tx, rotary_coords=torch.from_numpy(coords),
                      is_valid=torch.from_numpy(valid))["seq"]
        loss = (out * torch.from_numpy(valid)[..., None]).pow(2).sum()
        calls.clear()
        if on_thread:
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(timeout=120)
            assert not worker.is_alive()
        else:
            loss.backward()
        return tx.grad, list(calls)

    with unittest.mock.patch.object(tring, "_ring_flash_forward", counted):
        home, home_calls = grads(False)
        away, away_calls = grads(True)
    assert home_calls == away_calls == [4] * LAYERS  # each layer's recompute: the ring
    assert torch.equal(home, away)


def test_train_step_bf16_with_both_remat_knobs_is_bit_exact():
    """One bf16 train_step (use_bfloat16_grads, bf16 compute) with
    gradient_checkpoint and tower_gradient_checkpoint against the same step
    without them, from the same weights, batch and draws: the losses and
    every updated parameter equal. The weights are moved off the bf16 grid
    first (LayerNorm scales start at exactly 1), so a recompute that read
    the f32 masters in place of the step's bf16 copies would show."""
    tiny = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
                span_num_layers=2, output_grid=(4, 4), use_bfloat16=True)
    data = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)
    cfgs = [load_config("base", gradient_checkpoint=on, tower_gradient_checkpoint=on,
                        **tiny).replace_data(**data) for on in (False, True)]
    # warmup 0: the first update moves every weight
    cfgs = [dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer,
                                                                 num_warmup_steps=0))
            for c in cfgs]
    batch = batch_to_tensors(make_dummy_batch(cfgs[0], 2, seed=0, num_text_spans=16), "cpu")
    g = torch.Generator().manual_seed(3)
    start = None
    results = []
    for cfg in cfgs:
        model = MerlotReservePretrainer(cfg, device="cpu", seed=0)
        if start is None:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(torch.randn(p.shape, generator=g) * 1e-3)
            start = {n: p.detach().clone() for n, p in model.named_parameters()}
        model.load_state_dict(start)
        state = create_train_state(cfg, model)
        split_at = [torch.tensor([2, 1, 2, 2]), torch.tensor([1, 2, 2, 2])]
        gumbel = torch.from_numpy(np.random.RandomState(1).gumbel(size=(2, 16)).astype(np.float32))
        state, info = train_step(state, batch, use_bfloat16_grads=True, split_at=split_at,
                                 gumbel=gumbel)
        results.append((info, dict(model.named_parameters())))
    (info0, params0), (info1, params1) = results
    assert cfgs[1].model.gradient_checkpoint and cfgs[1].model.tower_gradient_checkpoint
    for k, v in info0.items():
        assert torch.equal(v, info1[k]), k
    moved = 0
    for name, p in params0.items():
        assert torch.equal(p, params1[name]), name
        moved += not torch.equal(p, start[name])
    assert moved > len(params0) // 2  # the step moved the weights
