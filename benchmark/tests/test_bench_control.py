"""The control: the reference put in the program's place and computed one
precision below what the configurations state (bf16 compute: every
product's operands rounded to float8 e4m3). Under the committed limits it
has to come out not correct: here at a test's size on the CPU, and on the
card at each cell's own size (marked ``cuda``; the limits in
``benchmark/limits/`` were set from those readings)."""

import pytest
import torch

from conftest import tiny_cell
from harness import checks

WORKLOADS = ["base.pretrain.b8", "large.serve.offline", "large.pretrain.b4",
             "base.pretrain.long"]


@pytest.mark.parametrize("workload", ["base.pretrain.b8", "large.serve.offline"])
def test_the_control_fails_at_a_tiny_size(workload):
    torch.set_num_threads(4)
    cell = tiny_cell(workload)
    driver = cell.driver(2 ** 31 + 17, "cpu")
    driver.make_inputs()
    judged = checks.judge(driver.control_numbers(), cell.limits)
    assert not checks.passes(judged), judged


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_at_the_cells_size(cuda_card, workload):
    from harness.cell import load_cell

    cell = load_cell(workload)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        driver = cell.driver(seed, cuda_card)
        driver.make_inputs()
        judged = checks.judge(driver.control_numbers(), cell.limits)
        assert not checks.passes(judged), (seed, judged)
        del driver
        torch.cuda.empty_cache()


def test_the_bf16_witness_rounds_each_products_operands():
    """``Numerics("bf16")``, the witness of what the configurations'
    precision alone does to a reading, rounds an operand to bfloat16 and
    passes its gradient straight through."""
    from reference.model import Numerics

    x = torch.tensor([1.0 + 2 ** -10, 3.0], requires_grad=True)
    y = Numerics("bf16").q(x)
    assert y.tolist() == [1.0, 3.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0]
