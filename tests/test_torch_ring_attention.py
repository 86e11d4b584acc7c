"""Port parity: merlot_reserve_tpu_torch's sequence-parallel attention
(ops/ring_attention.py over parallel/mesh.py's virtual ranks) against the
JAX package's ring and Ulysses attention on a CPU mesh of 4 virtual devices
(and 2 x 4 for dp x sp), with JAX's flash and rdma kernels in Pallas
interpret mode, as the JAX package's own tests run them.

The cases are those of tests/test_ring_attention.py (matches full, no mask,
packed video across shards, rdma, dp x sp), with 4 heads instead of 2 so
that Ulysses' head split over 4 ranks applies to every case. Tolerance: f32,
atol 2e-5 on valid rows, as the JAX package's ring tests (the ring merges
partial softmaxes in another order than one dense softmax); gradients of the
lax and flash rings atol 3e-4, as there. Rows that see no key are compared only where
both sides define them the same way (the port averages V over exactly L
keys; JAX's flash and rdma kernels over their padded length)."""

import unittest.mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.models import layers as jlayers
from merlot_reserve_tpu.ops import attention as jattn
from merlot_reserve_tpu.ops import ring_attention as jring
from merlot_reserve_tpu.parallel import mesh as jmesh
from merlot_reserve_tpu.parallel.mesh import Mesh as JaxMesh
from merlot_reserve_tpu_torch import kernels, load_config
from merlot_reserve_tpu_torch.models import MerlotReserve
from merlot_reserve_tpu_torch.models import layers as tlayers
from merlot_reserve_tpu_torch.ops import attention as tattn
from merlot_reserve_tpu_torch.ops import ring_attention as tring
from merlot_reserve_tpu_torch.parallel import mesh as tmesh
from merlot_reserve_tpu_torch.serving import DynamicBatcher, VideoEmbedService
from merlot_reserve_tpu_torch.tokenizer import PADDING
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

ATOL = 2e-5
GRAD_ATOL = 3e-4
IMPLS = ("lax", "flash", "rdma", "ulysses", "ulysses-flash")


def _case(name):
    """(q, k, v [B, L, H, D] f32, is_valid [B, L] bool or None, segment_ids
    [B, L] int32 or None, (dp, sp)) of one case of tests/test_ring_attention.py."""
    if name == "full":  # test_ring_matches_full
        rng, (B, L, D), mesh = np.random.RandomState(0), (2, 64, 16), (1, 4)
    elif name == "no_mask":  # test_ring_no_mask
        rng, (B, L, D), mesh = np.random.RandomState(1), (1, 32, 8), (1, 4)
    elif name == "packed":  # test_ring_flash_packed_video_blocks
        rng, (B, L, D), mesh = np.random.RandomState(4), (1, 128, 8), (1, 4)
    elif name == "rdma":  # test_ring_rdma_matches_full
        rng, (B, L, D), mesh = np.random.RandomState(5), (2, 128, 16), (1, 4)
    else:  # "dp_sp", test_ring_dp_sp_combined_mesh
        rng, (B, L, D), mesh = np.random.RandomState(8), (4, 64, 8), (2, 4)
    q, k, v = (rng.randn(B, L, 4, D).astype(np.float32) for _ in range(3))
    if name == "no_mask":
        return q, k, v, None, None, mesh
    if name == "packed":  # three videos whose boundaries do not align with the shards
        valid = np.ones((B, L), bool)
        valid[0, 110:] = False
        segs = np.zeros((B, L), np.int32)
        segs[0, 37:91] = 1
        segs[0, 91:] = 2
    elif name == "full":
        valid = rng.rand(B, L) > 0.2
        segs = rng.randint(0, 2, (B, L)).astype(np.int32)
    else:
        valid = rng.rand(B, L) > 0.2
        segs = np.sort(rng.randint(0, 3 if name == "rdma" else 2, (B, L)), -1).astype(np.int32)
    return q, k, v, valid, segs, mesh


def _jax_mesh(cpu_devices, dp, sp):
    if dp == 1:
        return JaxMesh(np.asarray(cpu_devices[:sp]), axis_names=("sp",))
    return JaxMesh(np.asarray(cpu_devices[:dp * sp]).reshape(dp, sp), axis_names=("dp", "sp"))


def _port_mesh(dp, sp):
    if dp == 1:
        return tmesh.Mesh(np.full(sp, "cpu", dtype=object), ("sp",))
    return tmesh.Mesh(np.full((dp, sp), "cpu", dtype=object), ("dp", "sp"))


def _jax_out(cpu_devices, name, impl):
    q, k, v, valid, segs, (dp, sp) = _case(name)
    labels = [None if x is None else jnp.asarray(x) for x in (valid, segs)]
    out = jring.sequence_parallel_attention(
        _jax_mesh(cpu_devices, dp, sp), *map(jnp.asarray, (q, k, v)), *labels, impl=impl,
        interpret=impl in ("flash", "rdma", "ulysses-flash"))
    return np.asarray(out)


def _port_out(name, impl):
    q, k, v, valid, segs, (dp, sp) = _case(name)
    labels = [None if x is None else torch.from_numpy(x) for x in (valid, segs)]
    with torch.no_grad():
        out = tring.sequence_parallel_attention(
            _port_mesh(dp, sp), *map(torch.from_numpy, (q, k, v)), *labels, impl=impl)
    return out.numpy()


def _rows(name):
    valid = _case(name)[3]
    return np.ones(_case(name)[0].shape[:2], bool) if valid is None else valid


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ["full", "no_mask", "packed", "rdma", "dp_sp"])
def test_sequence_parallel_attention_matches_jax(cpu_devices, name, impl):
    """Each port impl against the same JAX impl. One exception: JAX's rdma
    kernel names its neighbours by logical device id over the whole mesh,
    and on the 2 x 4 dp x sp mesh it does not finish in interpret mode, so
    the port's rdma there is held against JAX's lax ring."""
    rows = _rows(name)
    got = _port_out(name, impl)
    jax_impl = "lax" if (name, impl) == ("dp_sp", "rdma") else impl
    np.testing.assert_allclose(got[rows], _jax_out(cpu_devices, name, jax_impl)[rows],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_sequence_parallel_attention_matches_dense_on_all_rows(impl):
    """The port's impls against its own dense path: a row that sees no key
    is the mean of V over all L keys in both, except under 'flash'. There,
    as in the JAX package, such a row's per-hop lse is -1e10 in f32, where
    adding log 2 is lost, so the log-sum-exp merge sums the hops' means
    instead of averaging them; 'flash' is held on valid rows."""
    q, k, v, valid, segs, (dp, sp) = _case("full")
    t = [torch.from_numpy(x) for x in (q, k, v, valid, segs)]
    dense = tattn.xla_attention(*t[:3], bias=tattn.make_attention_bias(t[3], t[4]))
    with torch.no_grad():
        got = tring.sequence_parallel_attention(_port_mesh(dp, sp), *t, impl=impl)
    rows = valid if impl == "flash" else np.ones_like(valid)
    np.testing.assert_allclose(got.numpy()[rows], dense.numpy()[rows], atol=ATOL, rtol=0)


def test_ring_lax_gradients_match_jax(cpu_devices):
    """The lax ring is differentiable through autograd: dq, dk, dv of a loss
    on the valid rows against jax.grad through JAX's lax ring (the case of
    test_ring_flash_is_differentiable: packed segments and an invalid tail)."""
    rng = np.random.RandomState(7)
    B, L, H, D = 1, 64, 2, 8
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    valid = np.ones((B, L), bool)
    valid[0, 56:] = False
    segs = np.sort(rng.randint(0, 2, (B, L)), -1).astype(np.int32)
    w = valid.astype(np.float32)[..., None, None]
    mesh = _jax_mesh(cpu_devices, 1, 4)

    def j_loss(q_, k_, v_):
        out = jring.sequence_parallel_attention(mesh, q_, k_, v_, jnp.asarray(valid),
                                                jnp.asarray(segs))
        return ((out * w) ** 2).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tring.sequence_parallel_attention(_port_mesh(1, 4), tq, tk, tv,
                                            torch.from_numpy(valid), torch.from_numpy(segs))
    ((out * torch.from_numpy(w)) ** 2).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("name", ["vjp", "full", "packed", "dp_sp"])
def test_ring_flash_gradients_match_jax(cpu_devices, name):
    """ring:flash is differentiable (RingFlashAttention: the backward ring
    with the dk/dv accumulators travelling with their shard): dq, dk, dv of
    a loss on the valid rows against jax.grad through JAX's ring_flash
    custom VJP, its Pallas kernels in interpret mode. "vjp" is the case of
    test_ring_flash_is_differentiable (packed segments and an invalid
    tail); "packed" has three videos whose boundaries cross the shards.
    Valid positions only, as the rows that see no key are undefined."""
    if name == "vjp":
        rng = np.random.RandomState(7)
        B, L, H, D = 1, 64, 2, 8
        q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
        valid = np.ones((B, L), bool)
        valid[0, 56:] = False
        segs = np.sort(rng.randint(0, 2, (B, L)), -1).astype(np.int32)
        dp, sp = 1, 4
    else:
        q, k, v, valid, segs, (dp, sp) = _case(name)
    w = valid.astype(np.float32)[..., None, None]
    mesh = _jax_mesh(cpu_devices, dp, sp)

    def j_loss(q_, k_, v_):
        out = jring.sequence_parallel_attention(mesh, q_, k_, v_, jnp.asarray(valid),
                                                jnp.asarray(segs), impl="flash", interpret=True)
        return ((out * w) ** 2).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(kernels.LAUNCHES)
    out = tring.sequence_parallel_attention(_port_mesh(dp, sp), tq, tk, tv,
                                            torch.from_numpy(valid), torch.from_numpy(segs),
                                            impl="flash")
    ((out * torch.from_numpy(w)) ** 2).sum().backward()
    assert dict(kernels.LAUNCHES) == before  # CPU tensors: the plain versions
    for dname, t, j in zip("qkv", (tq, tk, tv), j_grads):
        np.testing.assert_allclose(t.grad.numpy()[valid], np.asarray(j)[valid], atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{dname}")


def test_ring_flash_backward_walks_the_ring():
    """The backward calls flash_backward once per (rank, hop) with the
    visiting shard's own key labels and the merged (out, lse) of the rank:
    the same lse at every hop of a rank, in the kernels' [B, H, Lloc]
    layout, and each rank meeting every shard once."""
    q, k, v, valid, segs, _ = _case("packed")
    n, L = 4, q.shape[1]
    lloc = L // n
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for x in t:
        x.requires_grad_()
    calls = []
    real = tattn.flash_backward

    def spy(q_, k_, v_, do, out, lse, is_valid, segment_ids, k_is_valid, k_segment_ids):
        calls.append((q_.data_ptr(), k_.data_ptr(), lse.clone(), k_is_valid.clone()))
        return real(q_, k_, v_, do, out, lse, is_valid, segment_ids, k_is_valid=k_is_valid,
                    k_segment_ids=k_segment_ids)

    out = tring.sequence_parallel_attention(_port_mesh(1, n), *t, torch.from_numpy(valid),
                                            torch.from_numpy(segs), impl="flash")
    with unittest.mock.patch.object(tattn, "flash_backward", spy):
        out.sum().backward()
    assert len(calls) == n * n
    q_ptr = [t[0][:, r * lloc:].data_ptr() for r in range(n)]
    k_ptr = [t[1][:, r * lloc:].data_ptr() for r in range(n)]
    for r in range(n):
        mine = [c for c in calls if c[0] == q_ptr[r]]
        assert sorted(k_ptr.index(c[1]) for c in mine) == list(range(n))
        assert all(torch.equal(c[2], mine[0][2]) for c in mine)
        assert mine[0][2].shape == (1, 4, lloc)
        for c in mine:
            s = k_ptr.index(c[1])
            assert torch.equal(c[3], torch.from_numpy(valid[:, s * lloc:(s + 1) * lloc]).int())


@pytest.mark.parametrize("impl", ["rdma"])
def test_forward_only_rings_refuse_gradients(impl):
    q, k, v, valid, segs, _ = _case("full")
    t = [torch.from_numpy(x) for x in (q, k, v, valid, segs)]
    t[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        tring.sequence_parallel_attention(_port_mesh(1, 4), *t, impl=impl)


def test_ring_impl_without_mesh_is_the_dense_path():
    """No active mesh: attention(impl='ring') is the dense path, exactly, as in
    the JAX package (test_ring_impl_falls_back_without_mesh), and matches it."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(1, 32, 2, 8).astype(np.float32) for _ in range(3))
    valid = rng.rand(1, 32) > 0.2
    t = [torch.from_numpy(x) for x in (q, k, v, valid)]
    before = dict(kernels.LAUNCHES)
    for impl in ("ring", "ring:rdma", "ulysses:flash", "ring:flash:sp"):
        out = tattn.attention(*t[:3], is_valid=t[3], impl=impl)
        torch.testing.assert_close(out, tattn.attention(*t[:3], is_valid=t[3], impl="xla"),
                                   atol=0, rtol=0)
    assert dict(kernels.LAUNCHES) == before
    j = jattn.attention(*map(jnp.asarray, (q, k, v)), is_valid=jnp.asarray(valid), impl="ring")
    np.testing.assert_allclose(out.numpy(), np.asarray(j), atol=1e-6, rtol=0)


def test_attention_dispatches_to_the_active_mesh():
    """Under activate_mesh the ring strings reach sequence_parallel_attention
    over the named axis; an axis of size 1 is the dense path. Valid rows
    (see the test above for 'flash' on the others)."""
    q, k, v, valid, segs, _ = _case("full")
    t = [torch.from_numpy(x) for x in (q, k, v, valid, segs)]
    dense = tattn.attention(*t[:3], is_valid=t[3], segment_ids=t[4], impl="xla")
    mesh = tmesh.make_mesh(sp=4, devices=["cpu"] * 4)
    with tmesh.activate_mesh(mesh), torch.no_grad():
        assert tmesh.current_mesh() is mesh
        for impl in ("ring", "ring:rdma", "ring:flash:sp", "ring:lax:sp", "ulysses:sp",
                     "ulysses:flash", "ring:pp"):
            out = tattn.attention(*t[:3], is_valid=t[3], segment_ids=t[4], impl=impl)
            np.testing.assert_allclose(out.numpy()[valid], dense.numpy()[valid], atol=ATOL,
                                       rtol=0, err_msg=impl)
    assert tmesh.current_mesh() is None


@pytest.mark.parametrize("impl,error,match", [
    ("ring:bogus:sp", ValueError, "unknown ring inner"),
    ("ringx", ValueError, "unknown sequence-parallel impl"),
    ("ring:lax:sp:extra", ValueError, "bad sequence-parallel impl"),
    ("ring:", ValueError, "empty axis"),
    ("ring:cp", ValueError, "not in mesh axes"),
])
def test_sequence_parallel_impl_strings_that_raise(impl, error, match):
    q, k, v, valid, segs, _ = _case("full")
    t = [torch.from_numpy(x) for x in (q, k, v, valid)]
    with tmesh.activate_mesh(tmesh.make_mesh(sp=4, devices=["cpu"] * 4)):
        with pytest.raises(error, match=match):
            tattn.attention(*t[:3], is_valid=t[3], impl=impl)


def test_parse_sequence_parallel_impl_follows_the_jax_grammar():
    parse = tring.parse_sequence_parallel_impl
    assert parse("ring") == ("lax", "sp")
    assert parse("ring:rdma") == ("rdma", "sp")
    assert parse("ring:cp") == ("lax", "cp")
    assert parse("ring:flash:cp") == ("flash", "cp")
    assert parse("ulysses") == ("ulysses", "sp")
    assert parse("ulysses:flash") == ("ulysses-flash", "sp")
    assert parse("ulysses:xla:cp") == ("ulysses", "cp")


def test_sequence_parallel_attention_checks_like_jax(cpu_devices):
    q, k, v, valid, segs, _ = _case("full")
    t = [torch.from_numpy(x) for x in (q, k, v, valid, segs)]
    with pytest.raises(ValueError, match="not divisible"):  # L % n
        tring.sequence_parallel_attention(_port_mesh(1, 3), *t)
    with pytest.raises(ValueError, match="local heads"):  # 4 heads over 8 ranks
        tring.sequence_parallel_attention(_port_mesh(1, 8), *t, impl="ulysses")
    with pytest.raises(ValueError, match="tp_heads"):
        tring.sequence_parallel_attention(_port_mesh(1, 4), *t, tp_heads=True)
    with pytest.raises(NotImplementedError, match="several cards"):
        tring.sequence_parallel_attention(tmesh.Mesh(["cpu", "meta"], ("sp",)), *t)
    # ulysses over 2 tp shards of 4 heads: 2 local heads per tp shard, 4 ranks
    mesh = tmesh.make_mesh(sp=4, tp=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="2 local heads"):
        tring.sequence_parallel_attention(mesh, *t, impl="ulysses")
    with pytest.raises(AssertionError):  # the JAX package refuses it too
        jring.sequence_parallel_attention(
            JaxMesh(np.asarray(cpu_devices[:8]).reshape(4, 2), ("sp", "tp")),
            *map(jnp.asarray, (q, k, v, valid, segs)), impl="ulysses")


def test_rdma_on_one_rank_is_the_flash_forward(cpu_devices):
    """n = 1: the rdma path is the flash forward (the JAX package's
    ring_flash_attention_rdma does the same), and matches JAX's on a
    one-device mesh on valid rows."""
    q, k, v, valid, segs, _ = _case("rdma")
    t = [torch.from_numpy(x) for x in (q, k, v, valid, segs)]
    with torch.no_grad():
        got = tring.sequence_parallel_attention(_port_mesh(1, 1), *t, impl="rdma")
    flash, _ = tattn.flash_forward(*t[:3], t[3].int(), t[4])
    torch.testing.assert_close(got, flash, atol=0, rtol=0)
    j = jring.sequence_parallel_attention(_jax_mesh(cpu_devices, 1, 1),
                                          *map(jnp.asarray, (q, k, v, valid, segs)),
                                          impl="rdma", interpret=True)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(j)[valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["cross", "disjoint"])
def test_flash_forward_with_key_labels_matches_jax(name):
    """K carries labels of its own (a ring hop): against JAX's _flash_forward
    with k_is_valid / k_segment_ids, in interpret mode, on valid rows."""
    rng = np.random.RandomState(11)
    B, L, H, D = 2, 48, 2, 64
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    valid = (rng.rand(B, L) > 0.2).astype(np.int32)
    segs = np.sort(rng.randint(0, 3, (B, L)), -1).astype(np.int32)
    k_valid = (rng.rand(B, L) > 0.3).astype(np.int32)
    k_segs = np.sort(rng.randint(0, 3, (B, L)), -1).astype(np.int32)
    if name == "disjoint":  # batch row 1's keys all invalid: its rows see no key
        k_valid[1] = 0
    j_out, j_lse = jattn._flash_forward(*map(jnp.asarray, (q, k, v, valid, segs)), 16, 16,
                                        True, k_is_valid=jnp.asarray(k_valid),
                                        k_segment_ids=jnp.asarray(k_segs))
    t_out, t_lse = tattn.flash_forward(*map(torch.from_numpy, (q, k, v, valid, segs)),
                                       k_is_valid=torch.from_numpy(k_valid),
                                       k_segment_ids=torch.from_numpy(k_segs))
    mask = ((valid[:, :, None] > 0) & (k_valid[:, None, :] > 0)
            & (segs[:, :, None] == k_segs[:, None, :]))
    rows = mask.any(-1)  # rows that see a key: JAX pads the others' average
    assert rows[0].any() and not rows[1].any() if name == "disjoint" else rows.any()
    np.testing.assert_allclose(t_out.numpy()[rows], np.asarray(j_out)[rows], atol=1e-5, rtol=0)
    j_lse = np.asarray(j_lse)[:, :, 0, :L].transpose(0, 2, 1)
    np.testing.assert_allclose(t_lse.numpy().transpose(0, 2, 1)[rows], j_lse[rows], atol=1e-5,
                               rtol=0)
    # the keys' labels default to the queries'
    same, _ = tattn.flash_forward(*map(torch.from_numpy, (q, k, v, valid, segs)),
                                  k_is_valid=torch.from_numpy(valid),
                                  k_segment_ids=torch.from_numpy(segs))
    plain, _ = tattn.flash_forward(*map(torch.from_numpy, (q, k, v, valid, segs)))
    torch.testing.assert_close(same, plain, atol=0, rtol=0)
    with pytest.raises(ValueError, match="both"):
        tattn.flash_forward(*map(torch.from_numpy, (q, k, v, valid, segs)),
                            k_is_valid=torch.from_numpy(valid))


def test_encoder_ring_rdma_matches_jax_dense(cpu_devices):
    """TransformerEncoder(attention_impl='ring:rdma', seq_shard_axis='sp')
    under an active sp=4 mesh against JAX's dense encoder on the same weights
    (the shape of test_encoder_ring_impl_matches_dense), on valid rows."""
    rng = np.random.RandomState(6)
    B, L, HID = 2, 64, 64
    kw = dict(hidden_size=HID, num_layers=2, size_per_head=16, rotary_hsize=8)
    x = rng.randn(B, L, HID).astype(np.float32)
    coords = np.broadcast_to(np.arange(L, dtype=np.float32)[None, :, None], (B, L, 1)).copy()
    valid = np.ones((B, L), bool)
    valid[0, 50:] = False
    segs = np.sort(rng.randint(0, 2, (B, L)), -1).astype(np.int32)
    jenc = jlayers.TransformerEncoder(**kw)
    inputs = dict(rotary_coords=coords, is_valid=valid, segment_ids=segs)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       **{k_: jnp.asarray(v_) for k_, v_ in inputs.items()})
    j = np.asarray(jenc.apply(params, jnp.asarray(x), **{k_: jnp.asarray(v_)
                                                         for k_, v_ in inputs.items()})["seq"])
    tenc = tlayers.TransformerEncoder(HID, 2, generator=torch.Generator().manual_seed(0),
                                      size_per_head=16, rotary_hsize=8,
                                      attention_impl="ring:rdma", seq_shard_axis="sp")
    load_flax_params(tenc, params["params"])
    with tmesh.activate_mesh(tmesh.make_mesh(sp=4, devices=["cpu"] * 4)), torch.no_grad():
        t = tenc(torch.from_numpy(x), **{k_: torch.from_numpy(v_)
                                         for k_, v_ in inputs.items()})["seq"].numpy()
    np.testing.assert_allclose(t[valid], j[valid], atol=3e-5, rtol=1e-5)
    with tmesh.activate_mesh(tmesh.Mesh(["cpu"] * 4, ("dp",))):
        with pytest.raises(ValueError, match="seq_shard_axis"):
            tenc(torch.from_numpy(x), **{k_: torch.from_numpy(v_) for k_, v_ in inputs.items()})


def test_make_mesh_shapes_like_jax(cpu_devices):
    for kwargs in (dict(sp=4), dict(dp=2, sp=2, tp=2), dict(dp=4, sp=2, dcn_dp=2),
                   dict(dp=-1, pp=2)):
        j = jmesh.make_mesh(devices=cpu_devices[:8], **kwargs)
        t = tmesh.make_mesh(devices=["cpu"] * 8, **kwargs)
        assert t.shape == dict(j.shape) and t.axis_names == tuple(j.axis_names)
        assert tmesh.dp_size(t) == jmesh.dp_size(j)
        assert tmesh.batch_axes(t) == jmesh.batch_axes(j)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(sp=3, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def ring_video(cpu_devices):
    """One video, JAX's embed_video on it (dense attention) and a tiny-config
    port model on the same weights with joint_attention_impl='ring:rdma' and
    seq_shard_axis='sp' (joint L 28, 7 rows per rank at sp 4)."""
    tiny = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
                span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
    rng = np.random.RandomState(0)
    tokens = np.zeros(20, np.int32)
    tokens[:12] = 5  # AUDIOSPAN
    tokens[12:16] = rng.randint(10, 1000, 4)
    subseg = np.zeros(20, np.int32)
    subseg[:12] = np.arange(12) // 6
    subseg[12:16] = [2, 3, 4, 5]
    video = (rng.randn(2, 16, 768).astype(np.float32), rng.randn(6, 60, 65).astype(np.float32),
             tokens, subseg)
    jmodel = JaxMerlotReserve.from_config(mr.load_config("base", **tiny))
    params = jmodel.init_params_full()
    j = np.asarray(jmodel.apply({"params": params}, *map(jnp.asarray, video),
                                method=jmodel.embed_video))
    model = MerlotReserve(load_config("base", joint_attention_impl="ring:rdma",
                                      seq_shard_axis="sp", **tiny), device="cpu")
    load_flax_params(model, params)
    return video, j, model


def _counted_rdma(calls):
    """``ring_flash_attention_rdma`` patched to note each call's rank count."""
    real = tring.ring_flash_attention_rdma

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    return unittest.mock.patch.object(tring, "ring_flash_attention_rdma", counted)


def test_embed_video_ring_rdma_matches_jax(ring_video):
    """The ring model under an sp=4 mesh of CPU ranks against JAX's
    embed_video on the same weights, every row."""
    video, j, model = ring_video
    calls = []
    with tmesh.activate_mesh(tmesh.make_mesh(sp=4, devices=["cpu"] * 4)), torch.no_grad():
        with _counted_rdma(calls):
            out = model.embed_video(*map(torch.from_numpy, video)).numpy()
    assert calls == [4, 4]  # every joint layer went through the 4-rank ring
    np.testing.assert_allclose(out, j, atol=1e-4, rtol=0)


def test_dynamic_batcher_serves_ring_rdma_under_the_callers_mesh(ring_video):
    """``DynamicBatcher`` runs each batch in its submitter's context: under
    the caller's ``activate_mesh`` the dispatcher thread's joint tower goes
    through the 4-rank ring (before the batcher carried the context, it found
    no mesh there and ran dense attention), and every answer matches JAX's
    dense embed_video on its valid rows, as the direct call does."""
    video, j, model = ring_video
    service = VideoEmbedService(model, batch_size=2, device="cpu")
    request = dict(zip(("images", "audio_clips", "tokens", "subseg_idxs"), video))
    calls = []
    with tmesh.activate_mesh(tmesh.make_mesh(sp=4, devices=["cpu"] * 4)), _counted_rdma(calls):
        with DynamicBatcher(service, max_wait_ms=2000.0) as batcher:
            futures = [batcher.submit(request) for _ in range(3)]
            outs = [f.result(timeout=120) for f in futures]
    assert batcher.batch_fills == [2, 1]
    assert calls == [4] * 2 * len(batcher.batch_fills)  # 2 joint layers a batch, all on the ring
    rows = video[2] != PADDING
    for out in outs:
        np.testing.assert_allclose(out[rows], j[rows], atol=1e-4, rtol=0)
