"""The port's CUDA kernel against its plain PyTorch version, and the wrapper
and build around it. No JAX here: the card-only tests (marked ``cuda``) run
on the machine with the card, which has no JAX, with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a card they skip. Tolerances on the card: out within 8e-3 in bf16
(probabilities enter the second product as bf16, out is rounded to bf16)
and 1e-5 in f32; lse within 1e-3 on valid rows."""

import ctypes

import numpy as np
import pytest
import torch

from merlot_reserve_tpu_torch import kernels, load_config
from merlot_reserve_tpu_torch.kernels import build
from merlot_reserve_tpu_torch.models import MerlotReserve
from merlot_reserve_tpu_torch.ops import attention as tattn

TOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}


def _case(name, device, seed=0):
    rng = np.random.RandomState(seed)
    B, H, L = 2, 3, {"padding": 48, "packed": 130, "ragged": 200, "short": 5}[name]
    qkv = rng.randn(3, B, L, H, 64).astype(np.float32)
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    if name == "padding":
        valid[0, 40:] = 0
        valid[1, 10:14] = 0
    elif name == "packed":
        seg[:, 70:] = 1
        valid[:, 64:70] = 0
    elif name == "ragged":
        valid = (rng.rand(B, L) > 0.15).astype(np.int32)
        seg[:, 120:] = 1
    t = [torch.from_numpy(x).to(device) for x in (*qkv, valid, seg)]
    return t


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernels.py")
    return torch.device("cuda", 0)


def test_params_struct_matches_the_c_layout():
    # FlashParams in csrc/flash_fwd.cu: 7 pointers, 3 x int64[3], 3 x int32, float
    P = tattn._FlashParams
    assert ctypes.sizeof(P) == 7 * 8 + 9 * 8 + 3 * 4 + 4
    assert P.q_strides.offset == 56 and P.batch.offset == 128 and P.scale.offset == 140


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["flash_fwd"])


def test_build_target_is_keyed_by_source_and_flags():
    a = build._target("flash_fwd")
    assert a.parent == build.BUILD_DIR and a.name.startswith("libflash_fwd-") and a.suffix == ".so"
    assert build._target("flash_fwd") == a


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
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.flash_forward(q.requires_grad_(), k, v, valid, seg)


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
