"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers and build around them. No JAX here: the card-only tests (marked
``cuda``) run on the machine with the card, which has no JAX, with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a card they skip. Tolerances on the card:
  * forward: out within 8e-3 in bf16 (probabilities enter the second
    product as bf16, out is rounded to bf16) and 1e-5 in f32; lse within
    1e-3 on valid rows;
  * backward: max |err| of dq, dk, dv within 1e-2 of the reference's max
    |value| in bf16 (p and ds enter their products as bf16 and the outputs
    are rounded to bf16: about 4e-3 when those roundings are emulated on
    the CPU) and within 1e-4 of it in f32 (another summation order).
    dO is random on valid rows and 0 on rows that see no key, as in the
    model: such a row has p = 1 for every key, and a random dO there would
    feed gradients far larger than the valid rows' and set the scale;
  * the ring kernel: out within 1e-2 of the plain ring's max |value| on
    valid rows in bf16 (as flash_fwd: bf16 probabilities and output) and
    within 1e-5 of it in f32 (the online softmax merges the n shards in
    another order than the plain ring's per-shard merge)."""

import ctypes
import dataclasses
import shutil
import unittest.mock

import numpy as np
import pytest
import torch

from merlot_reserve_tpu_torch import kernels, load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.kernels import build
from merlot_reserve_tpu_torch.models import MerlotReserve, MerlotReservePretrainer
from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
from merlot_reserve_tpu_torch.ops import attention as tattn
from merlot_reserve_tpu_torch.ops import ring_attention as tring
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step

TOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
RING_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _case(name, device, seed=0):
    rng = np.random.RandomState(seed)
    B, H, L = 2, 3, {"padding": 48, "packed": 130, "ragged": 200, "short": 5, "span": 16,
                     "seg64": 320, "ragged600": 600}[name]
    qkv = rng.randn(3, B, L, H, 64).astype(np.float32)
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    if name == "padding":
        valid[0, 40:] = 0
        valid[1, 10:14] = 0
    elif name == "packed":
        seg[:, 70:] = 1
        valid[:, 64:70] = 0
    elif name in ("ragged", "ragged600"):
        valid = (rng.rand(B, L) > 0.15).astype(np.int32)
        seg[:, 120:] = 1
    elif name == "seg64":  # segments meeting at multiples of 64: whole tiles masked
        seg[:, 128:] = 1
        seg[:, 256:] = 2
        valid[1, 300:] = 0
    elif name == "span":  # CLS + a 15-token span padded after its length
        valid[0, 9:] = 0
        valid[1, 2:] = 0
    t = [torch.from_numpy(x).to(device) for x in (*qkv, valid, seg)]
    return t


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernels.py")
    return torch.device("cuda", 0)


def test_params_struct_matches_the_c_layout():
    # FlashParams in csrc/flash_fwd.cu: 9 pointers, 3 x int64[3], 3 x int32, float
    P = tattn._FlashParams
    assert ctypes.sizeof(P) == 9 * 8 + 9 * 8 + 3 * 4 + 4
    assert P.k_is_valid.offset == 40 and P.k_segment_ids.offset == 48
    assert P.q_strides.offset == 72 and P.batch.offset == 144 and P.scale.offset == 156


def test_ring_params_struct_matches_the_c_layout():
    # RingParams in csrc/ring_fwd.cu: 10 pointers, 3 x int64[3], 5 x int32, float, int64
    P = tring._RingParams
    assert ctypes.sizeof(P) == 10 * 8 + 9 * 8 + 5 * 4 + 4 + 8
    assert P.flags.offset == 72 and P.q_strides.offset == 80 and P.batch.offset == 152
    assert P.grid.offset == 168 and P.scale.offset == 172 and P.timeout_ns.offset == 176


@pytest.mark.parametrize("max_blocks,n,lloc,members,grid", [
    (528, 4, 64, 384, 384),     # every member's one q-group resident at once
    (528, 4, 160, 2304, 528),   # the persistent walk: 66 rings of 4 x 2 q-groups at a time
    (530, 4, 128, 2304, 528),   # whole rings only
    (132, 4, 640, 384, 120),    # the long-video shape: 6 rings of 4 x 5 q-groups
    (132, 8, 80, 768, 128),
    (3, 4, 64, 8, 0),           # not one ring fits: the wrapper raises
    (16, 4, 640, 384, 0),
])
def test_ring_grid_holds_whole_rings(max_blocks, n, lloc, members, grid):
    assert tring.ring_grid(max_blocks, n, lloc, members) == grid


@pytest.mark.parametrize("max_blocks,n,lloc,members,group_rows", [
    (132, 4, 640, 384, 128),    # B 8, H 12, L 2560 at sp 4
    (132, 2, 320, 192, 128),    # B 8, H 12, L 640 at sp 2
    (132, 3, 200, 72, 128),     # L 600 at n 3: a q-group of 128 rows and one of 72
    (132, 8, 80, 768, 128),
    (132, 4, 160, 2304, 128),   # B 48: more rings than fit at once
    (1000, 4, 160, 384, 64),    # the f32 kernel's 64-row q-groups
    (5000, 2, 320, 24, 64),     # all of it fits at once
])
def test_ring_grid_launches_whole_rings_of_q_groups(max_blocks, n, lloc, members, group_rows):
    """The unit is a q-group of one member, for its whole walk: a ring is
    n * ceil(lloc / group_rows) blocks, which must be resident together."""
    groups = -(-lloc // group_rows)
    grid = tring.ring_grid(max_blocks, n, lloc, members, group_rows)
    assert 0 < grid <= max_blocks and grid % (n * groups) == 0
    units = members * groups
    assert grid == units or grid + n * groups > max_blocks


def test_bwd_params_struct_matches_the_c_layout():
    # FlashBwdParams in csrc/flash_bwd.cu: 16 pointers, 4 x int64[3], 4 x int32,
    # float, padded to a multiple of 8
    P = tattn._FlashBwdParams
    assert ctypes.sizeof(P) == 16 * 8 + 12 * 8 + 4 * 4 + 4 + 4
    assert P.k_is_valid.offset == 72 and P.stats.offset == 88 and P.dq_acc.offset == 96
    assert P.q_strides.offset == 128 and P.do_strides.offset == 200
    assert P.batch.offset == 224 and P.padded_len.offset == 236 and P.scale.offset == 240


def test_bwd_prep_reference_writes_the_row_stats():
    """flash_bwd_prep's plain version: per query row lse * log2(e), delta =
    rowsum(dO * out) and the labels' int32 bits; rows past L padded with
    +inf, 0, 0, 0 up to a multiple of 64; the accumulator zero."""
    q, k, v, valid, seg = _case("ragged", "cpu")
    B, L, H, D = q.shape
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    out, lse = tattn.flash_attention_reference(q, k, v, valid, seg)
    stats, acc = tattn.flash_bwd_prep_reference(do, out, lse, valid, seg)
    Lp = -(-L // 64) * 64
    assert stats.shape == (B, H, Lp, 4) and acc.shape == (B, H, Lp, D) and not acc.any()
    torch.testing.assert_close(stats[:, :, :L, 0], lse * tattn.LOG2E, atol=0, rtol=0)
    torch.testing.assert_close(stats[:, :, :L, 1], torch.einsum("blhd,blhd->bhl", do, out))
    bits = stats.view(torch.int32)[:, :, :L, 2:]
    assert torch.equal(bits[..., 0], (valid > 0).int()[:, None].expand(B, H, L))
    assert torch.equal(bits[..., 1], seg[:, None].expand(B, H, L))
    assert torch.isinf(stats[:, :, L:, 0]).all() and not stats[:, :, L:, 1:].any()


def test_bwd_convert_reference_reads_the_fragment_order():
    """flash_bwd_convert's plain version undoes the fused pass's fragment
    order: float4 (4j + w) 32 + lane of a 64-row tile holds rows 16w + g and
    16w + g + 8 (g = lane // 4), columns 8j + 2 (lane % 4) + {0, 1}."""
    B, H, L, D = 2, 3, 100, 64
    dq = torch.randn(B, L, H, D).to(torch.bfloat16).float()
    Lp = 128
    acc = torch.zeros(B, H, Lp // 64, 8, 4, 32, 4)  # tile, j, w, lane, register
    for w in range(4):
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            for j in range(8):
                for r in range(4):
                    row, col = 16 * w + g + 8 * (r // 2), 8 * j + 2 * t4 + r % 2
                    rows = torch.arange(Lp // 64) * 64 + row
                    ok = rows < L
                    acc[:, :, ok, j, w, lane, r] = dq[:, rows[ok], :, col].permute(0, 2, 1) * 8
    got = tattn.flash_bwd_convert_reference(torch.zeros(B, L, H, D, dtype=torch.bfloat16),
                                            acc.reshape(B, H, Lp, D))
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, H, D)
    torch.testing.assert_close(got.float(), dq, atol=0, rtol=0)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["flash_fwd"])


def test_build_target_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    a = build._target("flash_fwd")
    assert a.parent == build.BUILD_DIR and a.name.startswith("libflash_fwd-") and a.suffix == ".so"
    assert build._target("flash_fwd") == a
    # a copy of the sources: the same name; a changed shared header, source
    # or flag gives another library
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    assert build._target("flash_fwd") == a
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    b = build._target("flash_fwd")
    assert b != a and b.name.startswith("libflash_fwd-")
    (csrc / "extra.cuh").write_text("// a new header\n")
    c = build._target("flash_fwd")
    assert c not in (a, b)
    (csrc / "flash_fwd.cu").write_text((csrc / "flash_fwd.cu").read_text() + "\n")
    assert build._target("flash_fwd") not in (a, b, c)
    before = build._target("ring_fwd")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._target("ring_fwd") != before


def test_each_source_has_its_own_build_target():
    fwd, bwd, ring = build._target("flash_fwd"), build._target("flash_bwd"), \
        build._target("ring_fwd")
    assert bwd.name.startswith("libflash_bwd-") and bwd.parent == fwd.parent and bwd != fwd
    assert ring.name.startswith("libring_fwd-") and ring.parent == fwd.parent


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["padding", "packed", "ragged", "short"])
def test_flash_kernel_matches_reference_on_card(cuda_device, name, dtype):
    q, k, v, valid, seg = _case(name, cuda_device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = kernels.LAUNCHES["flash_fwd"]
    with torch.inference_mode():
        out, lse = tattn.flash_forward(q, k, v, valid, seg)
        ref_out, ref_lse = tattn.flash_attention_reference(q.float(), k.float(), v.float(),
                                                           valid, seg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out, atol=TOL[dtype], rtol=0)
    rows = (valid > 0)[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[rows], ref_lse[rows], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q, k, v as the model hands them over: views into one QKV projection."""
    q, k, v, valid, seg = _case("packed", cuda_device)
    qkv = torch.cat([q, k, v], dim=2).to(torch.bfloat16)  # [B, L, 3H, 64]
    H = q.shape[2]
    views = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    with torch.inference_mode():
        out, _ = tattn.flash_forward(*views, valid, seg)
        ref, _ = tattn.flash_forward(*(x.contiguous() for x in views), valid, seg)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_wrapper_rejects_bad_inputs(cuda_device):
    q, k, v, valid, seg = _case("padding", cuda_device)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="head dim"):
            tattn.flash_forward(q[..., :32], k[..., :32], v[..., :32], valid, seg)
        with pytest.raises(ValueError, match="bf16 or all f32"):
            tattn.flash_forward(q.half(), k.half(), v.half(), valid, seg)
        with pytest.raises(ValueError, match="unit last stride"):
            tattn.flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, valid, seg)
        with pytest.raises(ValueError, match="labels"):
            tattn.flash_forward(q, k, v, valid[:, :10], seg)
    with pytest.raises(RuntimeError, match="grad-free launcher"):
        tattn.flash_forward(q.requires_grad_(), k, v, valid, seg)


BWD_LAUNCHES = {torch.bfloat16: ("flash_bwd_prep", "flash_bwd", "flash_bwd_convert"),
                torch.float32: ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")}


def _key_labels(valid, seed=3):
    """Key labels of their own: random validity and two segments, and batch
    row 1 with no valid key (every query of it sees no key)."""
    g = torch.Generator().manual_seed(seed)
    k_valid = (torch.rand(valid.shape, generator=g) > 0.3).int().to(valid.device)
    k_seg = torch.randint(0, 2, valid.shape, generator=g).int().to(valid.device)
    k_valid[1] = 0
    return k_valid, k_seg


def _bwd_inputs(name, device, dtype, blind_do=False, key_labels=False):
    """q, k, v, dO, the kernel forward's out and lse, the labels and the
    keys' labels (None: the queries'), for one case. dO is random on valid
    rows and 0 on rows that see no key, as in the model; with ``blind_do``
    random on every row."""
    q, k, v, valid, seg = _case(name, device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    k_labels = _key_labels(valid) if key_labels else (None, None)
    do = torch.from_numpy(np.random.RandomState(7).randn(*q.shape).astype(np.float32))
    do = do.to(device)
    if not blind_do:
        do = do * (valid > 0)[..., None, None]
    do = do.to(dtype)
    with torch.no_grad():
        out, lse = tattn.flash_forward(q, k, v, valid, seg, *k_labels)
    return q, k, v, do, out, lse, valid, seg, k_labels


def _assert_grads_close(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_REL_TOL[dtype] * b.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,blind_do,key_labels", [
    ("padding", False, False), ("packed", False, False), ("ragged", False, False),
    ("short", False, False), ("span", False, False),
    ("padding", True, False),   # blind rows with dO: p = 1 on every key of every tile
    ("span", True, False),
    ("seg64", False, False),    # whole tiles masked out (skipped) and whole tiles full
    ("seg64", True, False),
    ("ragged600", False, False),  # L not a multiple of the 128 keys of a block
    ("ragged", False, True),    # keys with labels of their own, a row seeing no key
    ("span", False, True),
])
def test_flash_bwd_kernels_match_reference_on_card(cuda_device, name, blind_do, key_labels,
                                                   dtype):
    q, k, v, do, out, lse, valid, seg, k_labels = _bwd_inputs(name, cuda_device, dtype,
                                                              blind_do, key_labels)
    before = dict(kernels.LAUNCHES)
    got = tattn.flash_backward(q, k, v, do, out, lse, valid, seg, *k_labels)
    torch.cuda.synchronize()
    for launch in BWD_LAUNCHES[dtype]:
        assert kernels.LAUNCHES[launch] == before.get(launch, 0) + 1, launch
    ref = tattn.flash_attention_backward_reference(q.float(), k.float(), v.float(), do.float(),
                                                   out.float(), lse, valid, seg, *k_labels)
    _assert_grads_close(got, ref, dtype)


@pytest.mark.cuda
def test_flash_bwd_kernels_read_strided_views(cuda_device):
    """q, k, v as the model hands them over (views into one QKV projection),
    and a dO view: the same gradients as from contiguous copies. dk and dv
    are bit for bit the same; dq is summed over the key blocks by bulk
    reductions in device memory, whose order changes from run to run, so it
    is held to BWD_REL_TOL."""
    q, k, v, do, out, lse, valid, seg, _ = _bwd_inputs("packed", cuda_device, torch.bfloat16)
    H = q.shape[2]
    qkv = torch.cat([q, k, v], dim=2)
    views = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    do_view = torch.cat([do, do], dim=2)[:, :, H:]
    got = tattn.flash_backward(*views, do_view, out, lse, valid, seg)
    ref = tattn.flash_backward(*(x.contiguous() for x in views), do, out, lse, valid, seg)
    _assert_grads_close(got[:1], ref[:1], torch.bfloat16)
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
def test_flash_bwd_wrappers_reject_bad_inputs(cuda_device):
    q, k, v, do, out, lse, valid, seg, _ = _bwd_inputs("padding", cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="both k_is_valid and k_segment_ids"):
        tattn.flash_backward(q, k, v, do, out, lse, valid, seg, valid, None)
    with pytest.raises(ValueError, match="bf16 only"):
        tattn.flash_bwd_prep(q.float(), k.float(), v.float(), do.float(), out.float(), lse,
                             valid, seg)
    stats, dq_acc = tattn.flash_bwd_prep(q, k, v, do, out, lse, valid, seg)
    with pytest.raises(ValueError, match="dq_acc"):
        tattn.flash_bwd_fused(q, k, v, do, stats, dq_acc[:, :, :32], valid, seg)


@pytest.mark.cuda
def test_flash_attention_grad_launches_the_backward_kernels(cuda_device):
    """A grad-enabled call goes through FlashAttention: one forward launch,
    then one launch of each backward pass, with the plain version's grads."""
    q, k, v, valid, seg = _case("ragged", cuda_device)
    q, k, v = (x.to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    before = dict(kernels.LAUNCHES)
    out = tattn.flash_attention(q, k, v, valid, seg)
    do = torch.randn_like(out) * (valid > 0)[..., None, None]
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    for name in ("flash_fwd", *BWD_LAUNCHES[torch.bfloat16]):
        assert kernels.LAUNCHES[name] == before.get(name, 0) + 1, name
    assert kernels.LAUNCHES["flash_bwd_dq_f32"] == before.get("flash_bwd_dq_f32", 0)
    _, ref_lse = tattn.flash_attention_reference(q.detach().float(), k.detach().float(),
                                                       v.detach().float(), valid, seg)
    ref = tattn.flash_attention_backward_reference(
        q.detach().float(), k.detach().float(), v.detach().float(), do.float(),
        out.detach().float(), ref_lse, valid, seg)
    _assert_grads_close(grads, ref, torch.bfloat16)


@pytest.mark.cuda
def test_tiny_model_on_card_matches_cpu(cuda_device):
    """The same f32 weights: kernel path on the card vs plain path on the CPU."""
    cfg = load_config("base", hidden_size=128, joint_num_layers=2, vit_num_layers=2,
                      audio_num_layers=2, span_num_layers=2, output_grid=(4, 4),
                      use_bfloat16=False, joint_attention_impl="flash")
    on_card = MerlotReserve(cfg, device=cuda_device)
    on_cpu = MerlotReserve(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    rng = np.random.RandomState(0)
    tokens = np.zeros(20, np.int64)
    tokens[:12] = 5
    tokens[12:16] = rng.randint(10, 1000, 4)
    subseg = np.zeros(20, np.int64)
    subseg[:12] = np.arange(12) // 6
    subseg[12:16] = [2, 3, 4, 5]
    args = [rng.randn(2, 16, 768).astype(np.float32), rng.randn(6, 60, 65).astype(np.float32),
            tokens, subseg]
    before = kernels.LAUNCHES["flash_fwd"]
    with torch.inference_mode():
        card = on_card.embed_video(*[torch.from_numpy(a).to(cuda_device) for a in args])
        cpu = on_cpu.embed_video(*[torch.from_numpy(a) for a in args])
    assert kernels.LAUNCHES["flash_fwd"] == before + cfg.model.joint_num_layers
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_tiny_pretrainer_step_on_card_matches_cpu(cuda_device):
    """One f32 train_step from the same weights, batch and draws: the kernel
    path on the card (joint and span attention through flash_fwd and the f32
    dq and dk/dv kernels) against the plain path on the CPU. Tolerances as for the JAX
    parity of the step (tests/test_torch_training.py): losses within 2e-6
    plus f32 summation order, 1e-5, and every parameter within 1e-5."""
    cfg = load_config("base", hidden_size=128, joint_num_layers=2, vit_num_layers=2,
                      audio_num_layers=2, span_num_layers=2, output_grid=(4, 4),
                      use_bfloat16=False, joint_attention_impl="flash")
    cfg = cfg.replace_data(num_segments=4, seq_len=80, lang_seq_len=40,
                           num_text_spans_to_include=8)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                 num_warmup_steps=0))
    batch = make_dummy_batch(cfg, 2, seed=0, num_text_spans=16)
    card_batch, cpu_batch = (batch_to_tensors(batch, d) for d in (cuda_device, "cpu"))
    card = create_train_state(cfg, MerlotReservePretrainer(cfg, device=cuda_device))
    cpu_model = MerlotReservePretrainer(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    cpu = create_train_state(cfg, cpu_model)
    g = torch.Generator().manual_seed(3)
    split_at = [1 + torch.randint(0, 2, (4,), generator=g) for _ in range(2)]
    gumbel = -torch.log(-torch.log(torch.rand((2, 16), generator=g)))
    before = dict(kernels.LAUNCHES)
    card, card_info = train_step(card, card_batch, use_bfloat16_grads=False, split_at=split_at,
                                 gumbel=gumbel)
    torch.cuda.synchronize()
    for name in ("flash_fwd", *BWD_LAUNCHES[torch.float32]):  # 2 joint + 2 span layers
        assert kernels.LAUNCHES[name] == before.get(name, 0) + 4, name
    cpu, cpu_info = train_step(cpu, cpu_batch, use_bfloat16_grads=False, split_at=split_at,
                               gumbel=gumbel)
    for k, v in cpu_info.items():
        assert abs(float(card_info[k]) - float(v)) <= 1e-5, k
    card_params = dict(card.model.named_parameters())
    for name, p in cpu.model.named_parameters():
        assert (card_params[name].detach().cpu() - p.detach()).abs().max().item() <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_with_key_labels_on_card(cuda_device, dtype):
    """A ring hop's call: the keys carry labels of their own."""
    q, k, v, valid, seg = _case("ragged", cuda_device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    g = torch.Generator().manual_seed(3)
    k_valid = (torch.rand(valid.shape, generator=g) > 0.3).int().to(cuda_device)
    k_seg = torch.randint(0, 2, valid.shape, generator=g).int().to(cuda_device)
    k_valid[1] = 0  # batch row 1 sees no key
    with torch.inference_mode():
        out, lse = tattn.flash_forward(q, k, v, valid, seg, k_is_valid=k_valid,
                                       k_segment_ids=k_seg)
        ref_out, ref_lse = tattn.flash_attention_reference(q.float(), k.float(), v.float(),
                                                           valid, seg, k_valid, k_seg)
    torch.testing.assert_close(out.float(), ref_out, atol=TOL[dtype], rtol=0)
    rows = (valid > 0)[:, None, :].expand_as(lse).clone()
    rows[1] = False
    torch.testing.assert_close(lse[rows], ref_lse[rows], atol=1e-3, rtol=0)


def _ring_case(name, device, dtype):
    """(q, k, v [B, L, H, 64], is_valid, segment_ids [B, L] int32, n ranks).
    "heads" has 96 rings of 4 members whose heads share their labels."""
    n, B, L, H = {"tail": (2, 2, 96, 3), "packed": (4, 2, 200, 3), "blind_shard": (3, 2, 192, 3),
                  "segment_pads": (4, 1, 256, 3), "ragged": (8, 2, 640, 3),
                  "heads": (4, 8, 640, 12)}[name]
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(3, B, L, H, 64).astype(np.float32)).to(device, dtype)
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    if name in ("tail", "heads"):
        valid[:, L - L // 6:] = 0
    elif name == "packed":  # boundaries inside shards 0, 1 and 3 of 50 rows
        seg[:, 30:120] = 1
        seg[:, 120:] = 2
        valid[:, 110:120] = 0
    elif name == "blind_shard":  # the keys of rank 1's shard are all invalid
        valid[:, 64:128] = 0
    elif name == "segment_pads":  # as prepare_multimodal_inputs pads: valid 0, segment -1
        seg[:, 100:] = 1
        valid[:, 230:] = 0
        seg[:, 230:] = -1
    else:
        valid = (rng.rand(B, L) > 0.15).astype(np.int32)
        seg[:, 300:] = 1
    labels = [torch.from_numpy(x).to(device) for x in (valid, seg)]
    return (*qkv.unbind(0), *labels, n)


def _assert_ring_close(out, ref, valid, dtype):
    rows = valid > 0
    err = (out.float() - ref.float())[rows].abs().max().item()
    assert err <= RING_REL_TOL[dtype] * ref.float()[rows].abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["tail", "packed", "blind_shard", "segment_pads", "ragged",
                                  "heads"])
def test_ring_kernel_matches_plain_ring_on_card(cuda_device, name, dtype):
    q, k, v, valid, seg, n = _ring_case(name, cuda_device, dtype)
    before = kernels.LAUNCHES["ring_fwd"]
    with torch.inference_mode():
        out = tring.ring_flash_attention_rdma(q, k, v, valid, seg, n)
        ref = tring.ring_attention_reference(q.float(), k.float(), v.float(), valid, seg, n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _assert_ring_close(out, ref, valid, dtype)
    blind = valid == 0  # rows that see no key: the mean of V over all L
    if blind.any():
        mean_v = v.float().mean(1, keepdim=True).expand_as(ref)
        torch.testing.assert_close(out.float()[blind], mean_v[blind],
                                   atol=2e-2 if dtype == torch.bfloat16 else 1e-5, rtol=0)


@pytest.mark.cuda
def test_ring_kernel_persistent_walk_on_card(cuda_device, monkeypatch):
    """A grid of two rings' blocks (n ranks x q-groups each) walks all B * H
    rings of the case."""
    q, k, v, valid, seg, n = _ring_case("packed", cuda_device, torch.bfloat16)
    max_blocks, rows = tring._launch_info(q.device, False)
    per_ring = n * -(-q.shape[1] // n // rows)
    monkeypatch.setattr(tring, "_launch_info", lambda device, f32: (2 * per_ring, rows))
    with torch.inference_mode():
        out = tring.ring_fwd(q, k, v, valid, seg, n)
        ref = tring.ring_attention_reference(q.float(), k.float(), v.float(), valid, seg, n)
    torch.cuda.synchronize()
    assert max_blocks >= 2 * per_ring
    _assert_ring_close(out, ref, valid, torch.bfloat16)


@pytest.mark.cuda
def test_ring_kernel_reads_strided_views(cuda_device):
    q, k, v, valid, seg, n = _ring_case("packed", cuda_device, torch.bfloat16)
    H = q.shape[2]
    qkv = torch.cat([q, k, v], dim=2)
    views = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    with torch.inference_mode():
        got = tring.ring_fwd(*views, valid, seg, n)
        ref = tring.ring_fwd(*(x.contiguous() for x in views), valid, seg, n)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.cuda
def test_ring_kernel_wrapper_rejects_bad_inputs(cuda_device):
    q, k, v, valid, seg, n = _ring_case("tail", cuda_device, torch.bfloat16)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="not divisible"):
            tring.ring_fwd(q, k, v, valid, seg, 5)
        with pytest.raises(ValueError, match="head dim"):
            tring.ring_fwd(q[..., :32], k[..., :32], v[..., :32], valid, seg, n)
        with pytest.raises(ValueError, match="bf16 or all f32"):
            tring.ring_fwd(q.half(), k.half(), v.half(), valid, seg, n)
        with pytest.raises(ValueError, match="n >= 2"):
            tring.ring_fwd(q, k, v, valid, seg, 1)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tring.ring_flash_attention_rdma(q.requires_grad_(), k, v, valid, seg, n)


def _ragged_case(L, device, seed=5):
    """q, k, v [2, L, 3, 64] bf16 as strided views of one QKV projection
    ([2, L, 9, 64]), labels with padding, two segments and rows that see no
    key, and keys' labels of their own (batch row 1: no valid key)."""
    rng = np.random.RandomState(seed)
    B, H = 2, 3
    qkv = torch.from_numpy(rng.randn(B, L, 3 * H, 64).astype(np.float32)).to(device,
                                                                            torch.bfloat16)
    valid = (rng.rand(B, L) > 0.2).astype(np.int32)
    valid[0, L - L // 4:] = 0  # a padded tail
    seg = (np.arange(L) >= L // 2).astype(np.int32)[None].repeat(B, 0)
    k_valid = (rng.rand(B, L) > 0.3).astype(np.int32)
    k_valid[1] = 0
    k_seg = rng.randint(0, 3, (B, L)).astype(np.int32)  # segment 2: no query of it
    labels = [torch.from_numpy(x).to(device) for x in (valid, seg, k_valid, k_seg)]
    return (qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:], *labels)


@pytest.mark.cuda
@pytest.mark.parametrize("key_labels", [False, True])
@pytest.mark.parametrize("L", [16, 100, 600])
def test_flash_kernel_ragged_lengths_on_card(cuda_device, L, key_labels):
    """The wgmma forward at lengths that are not a multiple of its 128-row
    query tiles or key tiles, on strided views, with rows that see no key:
    those rows average V over exactly L keys, and their lse is -1e10 bit for
    bit (-1e10 + log L in f32), as the backward's preprocess expects."""
    q, k, v, valid, seg, k_valid, k_seg = _ragged_case(L, cuda_device)
    k_labels = (k_valid, k_seg) if key_labels else (None, None)
    before = kernels.LAUNCHES["flash_fwd"]
    with torch.inference_mode():
        out, lse = tattn.flash_forward(q, k, v, valid, seg, *k_labels)
        ref_out, ref_lse = tattn.flash_attention_reference(q.float(), k.float(), v.float(),
                                                           valid, seg, *k_labels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    torch.testing.assert_close(out.float(), ref_out, atol=TOL[torch.bfloat16], rtol=0)
    blind = ref_lse < -1e9
    assert blind.any() and (~blind).any()
    assert (lse[blind] == tattn.NEG_INF).all()
    torch.testing.assert_close(lse[~blind], ref_lse[~blind], atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(3, 600), (8, 640)])
def test_ring_kernel_ragged_shards_on_card(cuda_device, n, L):
    """The ring at shard lengths that are not a multiple of its 128-row
    q-groups or key tiles (Lloc 200: a q-group of 128 rows and one of 72;
    Lloc 80: one partial q-group, a key tile cut at Lloc), on strided views,
    with padded rows and segments that cross the shards, in bf16 against the
    plain ring."""
    q, k, v, valid, seg, _, _ = _ragged_case(L, cuda_device, seed=n)
    before = kernels.LAUNCHES["ring_fwd"]
    with torch.inference_mode():
        out = tring.ring_fwd(q, k, v, valid, seg, n)
        ref = tring.ring_attention_reference(q.float(), k.float(), v.float(), valid, seg, n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ring_fwd"] == before + 1
    _assert_ring_close(out, ref, valid, torch.bfloat16)
    blind = valid == 0  # rows that see no key: the mean of V over all L
    mean_v = v.float().mean(1, keepdim=True).expand_as(ref)
    torch.testing.assert_close(out.float()[blind], mean_v[blind], atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("raw", [(180, 320), (360, 640), (100, 150)])
@pytest.mark.parametrize("tf32", [False, True])
def test_front_end_on_card_matches_cpu(cuda_device, raw, tf32):
    """Patches (1e-5: the resize's f32 sums in another order) and log-mel
    (1e-3, as against JAX) on the card against the CPU, whatever the
    caller's global TF32 flag, which the front end leaves as it was."""
    from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram
    from merlot_reserve_tpu_torch.ops.vision import batch_preprocess_images

    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (3, *raw, 3), dtype=np.uint8)
    pcm = (0.1 * rng.randn(3, 110250)).astype(np.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        patches = batch_preprocess_images(frames, (12, 20), device=cuda_device)
        log_mel = batch_make_spectrogram(pcm, device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.testing.assert_close(patches.cpu(), batch_preprocess_images(frames, (12, 20),
                                                                      device="cpu"),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(log_mel.cpu(), batch_make_spectrogram(pcm, device="cpu"),
                               atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_label_space_launches_the_span_towers_flash_kernel(cuda_device):
    """One get_label_space call runs the span tower's layers through
    flash_fwd, one launch each, and agrees with the CPU on the same f32
    weights."""
    from merlot_reserve_tpu_torch.models import PretrainedMerlotReserve

    cfg = load_config("base", hidden_size=128, joint_num_layers=2, vit_num_layers=2,
                      audio_num_layers=2, span_num_layers=3, output_grid=(4, 4),
                      use_bfloat16=False)
    on_card = MerlotReserve(cfg, device=cuda_device)
    on_cpu = MerlotReserve(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    options = ["a dog", "the next action is cooking pasta in the kitchen", "", "x² ½ café"]
    before = kernels.LAUNCHES["flash_fwd"]
    card = PretrainedMerlotReserve(on_card).get_label_space(options)
    assert kernels.LAUNCHES["flash_fwd"] == before + cfg.model.span_num_layers
    cpu = PretrainedMerlotReserve(on_cpu).get_label_space(options)
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-4, rtol=0)


def _long_ring_case(device, dtype, B=2, L=2560, H=12):
    """A long-video joint row pair at n = 4 (640 rows per rank): two packed
    videos whose boundary falls inside rank 1's shard, padded text at the
    end of rank 0's and at the end of the sequence, and dO random on the
    valid rows and 0 on the rest, as in the model."""
    rng = np.random.RandomState(2)
    qkvo = torch.from_numpy(rng.randn(4, B, L, H, 64).astype(np.float32)).to(device, dtype)
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    valid[:, 600:640] = 0
    seg[:, 1000:] = 1
    valid[1, L - 200:] = 0
    valid, seg = (torch.from_numpy(x).to(device) for x in (valid, seg))
    q, k, v, do = qkvo.unbind(0)
    return q, k, v, do * (valid > 0)[..., None, None], valid, seg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_flash_backward_on_card_matches_plain_ring(cuda_device, dtype):
    """ring:flash under grad at B2 L2560 n4 (RingFlashAttention): one
    flash_fwd per (rank, hop) in the forward and one backward per (rank,
    hop) against the merged out/lse, against the same ring with the plain
    flash forward and backward on the card; dq, dk, dv within the backward's
    tolerance of the plain ring's max |value|, on valid positions."""
    q, k, v, do, valid, seg = _long_ring_case(cuda_device, dtype)
    n = 4

    def grads():
        tq, tk, tv = (x.detach().requires_grad_() for x in (q, k, v))
        out = tring.ring_flash_attention(tq, tk, tv, valid, seg, n)
        return torch.autograd.grad(out, (tq, tk, tv), do)

    before = dict(kernels.LAUNCHES)
    got = grads()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before.get("flash_fwd", 0) + n * n
    for name in BWD_LAUNCHES[dtype]:
        assert kernels.LAUNCHES[name] == before.get(name, 0) + n * n, name
    with unittest.mock.patch.object(tattn, "flash_forward", tattn.flash_attention_reference), \
            unittest.mock.patch.object(tattn, "flash_backward",
                                       tattn.flash_attention_backward_reference):
        ref = grads()
    rows = valid > 0
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        err = (a.float() - b.float())[rows].abs().max().item()
        assert err <= BWD_REL_TOL[dtype] * b.float()[rows].abs().max().item(), (name, err)


@pytest.mark.cuda
def test_checkpointed_ring_encoder_recomputes_through_the_ring_on_card(cuda_device):
    """A remat'd bf16 encoder with ring:flash under activate_mesh(make_mesh(sp=4)):
    autograd runs the backward, and with it the recompute, on its own device
    thread, which does not see the context variable of the mesh. The
    recompute must still walk the ring: n^2 flash_fwd per layer in the
    forward and as many again in the recompute, n^2 of each backward launch,
    and the gradient of the input equal to that of the same encoder
    without remat (bit for bit but for dq's atomics: within the backward's
    tolerance)."""
    from merlot_reserve_tpu_torch.models.layers import TransformerEncoder
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh

    layers, n = 2, 4
    encoders = [TransformerEncoder(128, layers, generator=torch.Generator().manual_seed(0),
                                   dtype=torch.bfloat16,
                                   attention_impl="ring:flash", seq_shard_axis="sp",
                                   remat=remat).to(cuda_device) for remat in (False, True)]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 256, 128).astype(np.float32)).to(cuda_device)
    # rotary coordinates in the compute dtype, as the model builds them
    coords = torch.arange(256, device=cuda_device)[None, :, None].expand(2, 256, 1) / 256
    coords = coords.to(torch.bfloat16)
    valid = torch.ones((2, 256), dtype=torch.int32, device=cuda_device)
    valid[1, 200:] = 0
    results = []
    for enc in encoders:
        tx = x.detach().requires_grad_()
        before = dict(kernels.LAUNCHES)
        with activate_mesh(make_mesh(sp=n)):
            out = enc(tx, rotary_coords=coords, is_valid=valid)["seq"]
        (out.float() * valid[..., None]).pow(2).mean().backward()
        torch.cuda.synchronize()
        results.append(({k: kernels.LAUNCHES[k] - before.get(k, 0)
                          for k in ("flash_fwd", *BWD_LAUNCHES[torch.bfloat16])}, tx.grad))
    (plain, g_plain), (remat, g_remat) = results
    assert plain == {"flash_fwd": layers * n * n,
                     **{k: layers * n * n for k in BWD_LAUNCHES[torch.bfloat16]}}
    assert remat == dict(plain, flash_fwd=2 * layers * n * n)
    rows = valid > 0
    err = (g_remat - g_plain).float()[rows].abs().max().item()
    assert err <= BWD_REL_TOL[torch.bfloat16] * g_plain.float()[rows].abs().max().item()
