"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``):
the harness on the CPU at tiny widths, where the program runs its plain
attention path and its plain optimizer loop."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
                  span_num_layers=2)


def tiny_cell(name):
    """The cell ``name`` with its widths and shapes cut to a CPU test's size
    (two heads of 64, two layers a tower, 4 segments, batches of 2); its
    limits are the committed ones."""
    from harness.cell import load_cell
    from harness.config import with_overrides

    cell = load_cell(name)
    cell.config = with_overrides(cell.config, **TINY_MODEL)
    d = cell.config.data
    if cell.traffic["driver"] == "pretrain":
        d.num_segments, d.seq_len, d.lang_seq_len, d.num_text_spans_to_include = 4, 160, 40, 8
        cell.traffic = dict(cell.traffic, batch_size=2, num_text_spans=16, trace_iterations=2)
    else:
        cell.traffic = dict(cell.traffic, batch_size=2, pool_videos=4, segments=2, tokens=40,
                            audio_tokens=36, text_subsegments=2, warmup_requests=1,
                            trace_iterations=2, kept_round=1)
    return cell


@pytest.fixture
def cuda_card():
    """Skips the test where there is no CUDA card (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
