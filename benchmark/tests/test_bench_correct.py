"""``correct`` on the CPU at tiny widths: the harness's run without its look
for a card, the program run in float32 (where it must agree with the
reference to float32 rounding), and the same run with the timed path
broken underneath, which must come out not correct under the committed
limits. One fault of each kind a cell can have: a step that leaves the
state unchanged, half the batch left out (the mean over the rest), an
answer altered where it is produced. (The cells run on one chip, so no
exchange between chips can be left out.)"""

import pytest
import torch

from conftest import tiny_cell
from harness import faults
from harness.runner import run

SEED = 2 ** 31 + 11
TRAIN, SERVE = "base.pretrain.b8", "large.serve.offline"


@pytest.fixture
def f32_program(monkeypatch):
    """The program's step with its parameters kept in float32."""
    from merlot_reserve_tpu_torch.training import trainer

    orig = trainer.train_step
    monkeypatch.setattr(trainer, "train_step",
                        lambda state, batch, *a, **k: orig(state, batch, False))
    torch.set_num_threads(4)


def f32_cell(name):
    cell = tiny_cell(name)
    cell.config.model.use_bfloat16 = False
    cell.config.optimizer.use_bfloat16_adam = False
    cell.config.optimizer.do_bias_correction = True
    return cell


def test_training_reference_agrees_with_the_program_in_f32(f32_program):
    result, _ = run(f32_cell(TRAIN), SEED, 0.2, False, "cpu")
    r = result["readings"]
    assert r["loss_gap"] < 1e-6 and r["grad_gap_worst"] < 1e-2 and r["change_gap_worst"] < 1e-2
    assert result["correct"] is True


def test_serving_reference_agrees_with_the_program_in_f32(f32_program):
    result, _ = run(f32_cell(SERVE), SEED, 0.2, False, "cpu")
    assert result["readings"]["row_err"] < 1e-4
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_a_broken_training_step_is_not_correct(f32_program, fault):
    with faults.FAULTS[fault]():
        result, lines = run(f32_cell(TRAIN), SEED, 0.2, False, "cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])


def test_an_altered_answer_is_not_correct(f32_program):
    with faults.altered():
        result, _ = run(f32_cell(SERVE), SEED, 0.2, False, "cpu")
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0
