"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference computes from the same inputs."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a key bias under softmax): Adam moves it by
# round-off alone, so it takes no part in the leaf comparisons
NEGLIGIBLE_LEAF = 1e-3


def loss_gaps(program: Sequence[float], reference: Sequence[float]) -> list:
    """Each step's relative gap of the loss."""
    return [abs(p - r) / abs(r) for p, r in zip(program, reference)]


def leaf_gaps(program: torch.Tensor, reference: torch.Tensor, keep: torch.Tensor
              ) -> torch.Tensor:
    """Each kept leaf's gap between the two norms, against the larger of
    that leaf's reference norm and the median leaf's."""
    program, reference = program.double(), reference.double()
    scale = torch.clamp(reference, min=float(reference.median()))
    return ((program - reference).abs() / scale)[keep]


def kept_leaves(reference_grad_norms: torch.Tensor) -> torch.Tensor:
    g = reference_grad_norms.double()
    return g >= NEGLIGIBLE_LEAF * float(g.median())


def training_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """The steps' widest loss gap, the mean gap of the steps' head losses
    (three InfoNCE heads a step: nine draws, where the total loss gives
    three), and of the first gradient and of the change after the checked
    steps the worst leaf's gap and the median leaf's."""
    keep = kept_leaves(reference["grad_norms"])
    steps = loss_gaps(program["losses"], reference["losses"])
    heads = [g for p, r in zip(program["head_losses"], reference["head_losses"])
             for g in loss_gaps([p[k] for k in sorted(r)], [r[k] for k in sorted(r)])]
    out = {"loss_gap": max(steps), "head_loss_gap_mean": sum(heads) / len(heads)}
    for key in ("grad", "change"):
        gaps = leaf_gaps(program[key + "_norms"], reference[key + "_norms"], keep)
        out[key + "_gap_worst"] = float(gaps.max())
        out[key + "_gap_median"] = float(gaps.median())
    return out


def row_error(out: np.ndarray, ref: np.ndarray, valid: np.ndarray) -> float:
    """The largest L2 distance between an output row and the reference's
    row over the valid positions (rows are unit vectors)."""
    d = np.linalg.norm(out.astype(np.float64) - ref.astype(np.float64), axis=-1)
    return float(d[valid].max()) if valid.any() else 0.0


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number that is not finite fails."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
