"""The frozen FLOP counts and bounds against shapes worked by hand."""

import pytest
import torch

from frozen import bounds, flops
from conftest import ROOT


def test_transformer_layer_flops_by_hand():
    s, h = 641, 768
    assert flops.transformer_layer_flops(s, h) == 8 * s * h * h + 4 * s * s * h + 16 * s * h * h


def _cfg(name, **traffic):
    from harness.config import load

    return load(ROOT / f"benchmark/configs/{name}.json", traffic)


def test_pretrain_step_flops_base_batch_8():
    """Base, batch 8: 128 frames of 241 tokens through 12 layers, 384
    audio subsegments of 31, 384 spans of 16, 48 joint rows of 640 (x3)."""
    c = _cfg("mreserve-base")
    L = flops.transformer_layer_flops
    h = 768
    f = 128 * (12 * L(241, h) + 2 * 240 * 768 * h + 4 * 240 * h * h + 4 * 240 * 60 * h)
    f += 384 * (12 * L(31, h) + 2 * 30 * 130 * h + 4 * 30 * h * h + 4 * 30 * 6 * h)
    f += 384 * 4 * L(16, h)
    f += 48 * (12 * L(640, h) + 2 * 640 * h * h)
    assert flops.pretrain_step_flops(c, 8) == pytest.approx(3 * f, rel=1e-12)
    assert flops.pretrain_step_flops(c, 8) == pytest.approx(42.1e12, rel=0.01)


def test_encode_flops_large_8_videos_of_8_segments():
    c = _cfg("mreserve-large")
    assert flops.encode_flops(c, 8, 8) == pytest.approx(15.0e12, rel=0.01)


def test_pretrain_flops_long_video_shapes():
    c = _cfg("mreserve-base", data={"num_segments": 80, "seq_len": 2560})
    assert flops.pretrain_step_flops(c, 4) == pytest.approx(107e12, rel=0.02)


def test_fwd_and_bwd_bounds_by_hand():
    """One row of 4 positions, the last two padding: 4 attended pairs and
    2 rows that see no key."""
    valid = torch.tensor([[1, 1, 0, 0]])
    seg = torch.zeros((1, 4), dtype=torch.int32)
    H, D = 2, 64
    assert bounds.pair_counts(valid, seg) == (4, 2)
    fwd = bounds.fwd_bound(valid, seg, H, D, "bf16", 2)
    assert fwd["ops"] == 2 * D * H * (2 * 4 + 4 * 2)
    assert fwd["bytes"] == 4 * 4 * H * D * 2 + 2 * 4 * 4 + H * 4 * 4
    assert fwd["bound_ms"] == pytest.approx(fwd["bytes"] / 3.35e12 * 1e3)
    bwd = bounds.bwd_bounds(valid, seg, H, D, "bf16", 2)["both"]
    assert bwd["ops"] == 2 * D * H * (4 + 4 * (4 + 4 * 2))
    assert bwd["bytes"] == 7 * 4 * H * D * 2 + 2 * H * 4 * 4 + 2 * 4 * 4


def test_bound_by_operations_at_the_serving_shape():
    """The large serving joint call: 8 rows of 640, 144 tokens and 480
    frames valid, 16 heads: bound by operations."""
    valid = torch.cat([torch.ones(8, 144), torch.zeros(8, 16), torch.ones(8, 480)], 1).int()
    seg = torch.zeros_like(valid)
    b = bounds.fwd_bound(valid, seg, 16, 64, "bf16", 2)
    pairs = 8 * 624 * 624
    assert b["ops"] == 2 * 64 * 16 * (2 * pairs + 640 * 8 * 16)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(b["ops"] / 989e12 * 1e3)


def test_adam_bytes_per_parameter():
    assert bounds.ADAM_BYTES_PER_PARAM == {"bf16": 4 + 4 + 2 + 2 + 4 + 2 + 2, "f32": 28}
