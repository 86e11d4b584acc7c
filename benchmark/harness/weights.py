"""Seeded weights, made by the benchmark on the device: one float32 buffer
drawn in one call from a generator on the device, each parameter a view of
it, scaled to its kind. The program and the reference get the same values.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from reference.model import param_shapes


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, batch i, ...)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _scale(name: str, shape, hidden: int) -> Tuple[float, float]:
    """(mean, std) of a parameter: LayerNorm scales about 1, the learned
    temperatures 1, the attention pools' projections 1/sqrt(H) (their
    LeCun init), every other weight 0.02 and every bias and CLS token small."""
    if name == "contrastive_scales":
        return 1.0, 0.0
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("_ln.weight"):
        return 1.0, 0.02
    if leaf == "weight" and len(shape) == 2:
        return 0.0, (1.0 / math.sqrt(hidden) if ".seq_attnpool." in name else 0.02)
    return 0.0, 0.02


class Weights:
    """``flat`` [N] f32 and ``views``: name -> a view of it, in
    ``param_shapes`` order."""

    def __init__(self, flat: torch.Tensor, layout: List[Tuple[str, Tuple[int, ...]]]):
        self.flat = flat
        self.views: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape in layout:
            n = math.prod(shape)
            self.views[name] = flat[off:off + n].view(shape)
            off += n


def make(cfg, seed: int, device) -> Weights:
    layout = param_shapes(cfg)
    total = sum(math.prod(s) for _, s in layout)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    w = Weights(flat, layout)
    with torch.no_grad():
        for name, shape in layout:
            mean, std = _scale(name, shape, cfg.model.hidden_size)
            w.views[name].mul_(std).add_(mean)
    return w


def load_into(model: torch.nn.Module, w: Weights) -> None:
    """Copy the weights into the program's model, which must hold exactly
    these parameters."""
    params = dict(model.named_parameters())
    theirs = {n: tuple(p.shape) for n, p in params.items()}
    ours = {n: tuple(v.shape) for n, v in w.views.items()}
    if theirs != ours:
        raise ValueError(f"the program's parameters differ from the benchmark's layout: "
                         f"{sorted(set(theirs.items()) ^ set(ours.items()))[:6]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w.views[n])


def leaf_norms(tensors: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """[len(names)] f32 on the host: each tensor's L2 norm."""
    return torch.stack([tensors[n].detach().float().norm() for n in names]).cpu()
