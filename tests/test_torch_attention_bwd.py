"""Port parity: the flash backward of merlot_reserve_tpu_torch/ops/attention.py
(``flash_attention_backward_reference``, the plain version of the two CUDA
kernels, and the ``FlashAttention`` autograd Function) against the JAX
package's ``_flash_backward`` (its two Pallas kernels in interpret mode),
against ``jax.grad`` of its flash custom_vjp, and against torch autograd of
the port's dense path.

Tolerance: f32 throughout, atol 2e-5 on gradients of magnitude up to about
10 (the same math in another summation order, over up to 130 keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_reserve_tpu.ops import attention as jattn
from merlot_reserve_tpu_torch import kernels
from merlot_reserve_tpu_torch.ops import attention as tattn

ATOL = 2e-5
H, D = 2, 64
BLOCK = {"padding": (16, 32), "packed": (32, 32), "ragged": (64, 32), "span": (16, 16)}


def _case(name, seed=0):
    """q, k, v, dO [B, L, H, D] f32 (dO random on every row) and
    (is_valid, segment_ids) [B, L] int32."""
    rng = np.random.RandomState(seed)
    B, L = 2, {"padding": 40, "packed": 130, "ragged": 130, "span": 16}[name]
    q, k, v, do = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(4))
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    if name == "padding":
        valid[0, 30:] = 0
        valid[1, 5:9] = 0
    elif name == "packed":  # two videos per row, each with padded text
        seg[:, 70:] = 1
        valid[:, 60:70] = 0
        valid[:, 125:] = 0
    elif name == "ragged":  # L not a block multiple, random padding, two segments
        valid = (rng.rand(B, L) > 0.15).astype(np.int32)
        seg[:, 50:] = 1
    else:  # the span tower: CLS + a span padded after its length
        valid[0, 9:] = 0
        valid[1, 3:] = 0
    return q, k, v, do, valid, seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", ["padding", "packed", "ragged", "span"])
def test_backward_reference_matches_jax_pallas_backward(name):
    """The same (q, k, v, dO, out, lse) into both: JAX's padded kernels skip
    nothing that the port skips, so every row agrees."""
    q, k, v, do, valid, seg = _case(name)
    out, lse = tattn.flash_attention_reference(*_t(q, k, v, valid, seg))
    got = tattn.flash_attention_backward_reference(*_t(q, k, v, do), out, lse,
                                                   *_t(valid, seg))
    bq, bk = BLOCK[name]
    ref = jattn._flash_backward(*(jnp.asarray(x) for x in (q, k, v, do)), jnp.asarray(out.numpy()),
                                jnp.asarray(lse.numpy())[:, :, None, :], jnp.asarray(valid),
                                jnp.asarray(seg), block_q=bq, block_k=bk, interpret=True)
    for n, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=n)


def _key_labels(valid, seg, seed=1):
    """Key labels of their own (a ring hop's shard): a quarter of the keys
    invalid at random and a fifth moved to the other segment, so that some
    queries see few keys or none."""
    rng = np.random.RandomState(seed)
    k_valid = (rng.rand(*valid.shape) > 0.25).astype(np.int32)
    k_seg = np.where(rng.rand(*seg.shape) > 0.8, 1 - seg, seg).astype(np.int32)
    return k_valid, k_seg


@pytest.mark.parametrize("name", ["padding", "packed", "ragged"])
def test_backward_reference_with_key_labels_matches_jax_pallas_backward(name):
    """The keys' own labels, as a ring hop gives them: the same (q, k, v,
    dO, out, lse) into both, out and lse from the forward with those labels."""
    q, k, v, do, valid, seg = _case(name)
    k_valid, k_seg = _key_labels(valid, seg)
    out, lse = tattn.flash_attention_reference(*_t(q, k, v, valid, seg, k_valid, k_seg))
    got = tattn.flash_attention_backward_reference(*_t(q, k, v, do), out, lse,
                                                   *_t(valid, seg, k_valid, k_seg))
    bq, bk = BLOCK[name]
    ref = jattn._flash_backward(*(jnp.asarray(x) for x in (q, k, v, do)), jnp.asarray(out.numpy()),
                                jnp.asarray(lse.numpy())[:, :, None, :], jnp.asarray(valid),
                                jnp.asarray(seg), block_q=bq, block_k=bk, interpret=True,
                                k_is_valid=jnp.asarray(k_valid), k_segment_ids=jnp.asarray(k_seg))
    for n, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["padding", "packed", "ragged", "span"])
def test_backward_reference_self_path_is_unchanged(name):
    """Without key labels, and with the queries' labels given as the keys',
    the plain backward gives bit for bit what it gave before it took key
    labels (the formula below)."""
    q, k, v, do, valid, seg = _t(*_case(name))
    out, lse = tattn.flash_attention_reference(q, k, v, valid, seg)
    scale = 1.0 / np.sqrt(D)
    delta = torch.einsum("blhd,blhd->bhl", do, out)
    p = torch.exp(tattn._masked_scores(q, k, valid, seg) - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    before = (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
              torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
              torch.einsum("bhqk,bqhd->bkhd", p, do))
    for k_labels in ((), (valid, seg)):
        got = tattn.flash_attention_backward_reference(q, k, v, do, out, lse, valid, seg,
                                                       *k_labels)
        for n, a, b in zip(("dq", "dk", "dv"), got, before):
            assert torch.equal(a, b), n


def test_blind_rows_recompute_p_from_lse_as_jax_does():
    """A row that sees no key has lse = -1e10 in f32, so the backward's p is
    1 for every key (not 1/L): with dO on that row only, dv is dO there for
    every key."""
    q, k, v, do, valid, seg = _case("padding")
    do = np.zeros_like(do)
    do[0, 35] = 1.0  # a padding row of example 0
    out, lse = tattn.flash_attention_reference(*_t(q, k, v, valid, seg))
    assert lse[0, 0, 35].item() == np.float32(-1e10)
    _, _, dv = tattn.flash_attention_backward_reference(*_t(q, k, v, do), out, lse,
                                                        *_t(valid, seg))
    np.testing.assert_allclose(dv[0].numpy(), np.broadcast_to(do[0, 35], dv[0].shape),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["padding", "packed", "ragged", "span"])
def test_flash_autograd_matches_dense_autograd_and_jax_grad(name):
    """dO zeroed on padding rows, as in the model: FlashAttention's grads
    equal torch autograd of the dense path and jax.grad of JAX's flash."""
    q, k, v, do, valid, seg = _case(name)
    do = do * (valid > 0)[..., None, None]
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    before = dict(kernels.LAUNCHES)
    out = tattn.flash_attention(*leaves, *_t(valid, seg))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert dict(kernels.LAUNCHES) == before  # the CPU path launches no kernel

    dense_leaves = [x.detach().clone().requires_grad_() for x in leaves]
    bias = tattn.make_attention_bias(*_t(valid, seg))
    dense = torch.autograd.grad(tattn.xla_attention(*dense_leaves, bias=bias), dense_leaves,
                                torch.from_numpy(do))

    bq, bk = BLOCK[name]

    def jax_loss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, jnp.asarray(valid), jnp.asarray(seg), bq, bk, True)
        return (o * jnp.asarray(do)).sum()

    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for n, a, b, c in zip(("dq", "dk", "dv"), grads, dense, j_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0, err_msg=n)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL, rtol=0, err_msg=n)


def test_grad_free_calls_save_nothing_and_flash_forward_refuses_grads():
    q, k, v, _, valid, seg = _t(*_case("padding"))
    with torch.no_grad():
        out = tattn.flash_attention(q.requires_grad_(), k, v, valid, seg)
    assert out.grad_fn is None
    with pytest.raises(RuntimeError, match="grad-free launcher"):
        tattn.flash_forward(q, k, v, valid, seg)
    out = tattn.flash_attention(q, k, v, valid, seg)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
