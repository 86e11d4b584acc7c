"""The step breakdown of ``scripts/profile_torch_training.py`` on the CPU at
tiny widths: one ``torch.profiler`` trace of a ``train_step``, split into
parts (``train_step``'s ranges, and each tower's forward and backward) that
add up to the step. No JAX here."""

import sys
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity

from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.models import MerlotReservePretrainer
from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import profile_torch_training as prof_script  # noqa: E402


@pytest.fixture(scope="module")
def split():
    cfg = load_config("base", hidden_size=128, joint_num_layers=2, vit_num_layers=2,
                      audio_num_layers=2, span_num_layers=2, output_grid=(4, 4),
                      joint_attention_impl="flash")
    cfg = cfg.replace_data(num_segments=4, seq_len=80, lang_seq_len=40,
                           num_text_spans_to_include=8)
    state = create_train_state(cfg, MerlotReservePretrainer(cfg, device="cpu"))
    batch = batch_to_tensors(make_dummy_batch(cfg, 2, seed=0, num_text_spans=16), "cpu")
    train_step(state, batch)
    prof, wall_ms = prof_script.trace_steps(state, batch, 1, [ProfilerActivity.CPU])
    parts, device_ms = prof_script.split_step(prof.events(), 1)
    return parts, device_ms, wall_ms


def test_every_tower_has_a_forward_and_a_backward_part(split):
    parts, _, _ = split
    for tower in prof_script.TOWERS.values():
        for side in ("forward", "backward"):
            assert parts[f"{side}/{tower}"]["host_ms"] > 0, (side, tower)
    for part in ("cast", "forward/other", "backward/other", "grads", "optimizer"):
        assert parts[part]["host_ms"] > 0, part


def test_parts_add_up_to_the_step(split):
    """The parts are disjoint ranges inside the step: their host ms sum to
    no more than the traced step and to most of it (what is left is the
    Python between the ranges). No card: no device time."""
    parts, device_ms, wall_ms = split
    host = sum(p["host_ms"] for p in parts.values())
    assert 0.8 * wall_ms <= host <= wall_ms, (host, wall_ms)
    assert device_ms == 0 and all(p["device_ms"] == 0 for p in parts.values())
