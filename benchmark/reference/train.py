"""The reference's pretraining steps: the loss and its gradient by autograd
through ``model.pretraining_loss`` over one flat float32 parameter buffer,
and the pretraining chain's update (Adam, decoupled weight decay on the
decayed leaves, linear warmup then cosine decay, the step -lr) in float32,
moments kept in float32. The program keeps its moments in bf16; that is a
rounding of the same chain."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from reference.model import Numerics, decayed, pretraining_loss


def schedule(count: int, opt) -> float:
    """The learning-rate scale read before update ``count + 1``."""
    warm, total = opt.num_warmup_steps, opt.num_train_steps
    if count < warm:
        return count / warm
    post = min((count - warm) / (total - warm + 1.0), 1.0)
    post = 1.0 - (1.0 - math.cos(math.pi * post)) / 2.0
    return opt.final_lr_scale + (1.0 - opt.final_lr_scale) * post


def views(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def leaf_norms(flat: torch.Tensor, layout) -> torch.Tensor:
    v = views(flat, layout)
    return torch.stack([v[n].norm() for n, _ in layout]).cpu()


def run_steps(cfg, w0: torch.Tensor, layout, batches: Sequence[Dict[str, torch.Tensor]],
              nm: Numerics = Numerics()) -> Dict[str, object]:
    """``len(batches)`` steps from the parameters ``w0`` (left unchanged).

    :return: {'losses': [per step], 'head_losses': [per step, {head:
        loss}], 'grad_norms': the first gradient's per-leaf norms,
        'change_norms': per-leaf norms of the parameters' change after the
        last step}"""
    opt = cfg.optimizer
    b1, b2 = opt.beta_1, opt.beta_2
    mask = torch.cat([torch.full((math.prod(s),), decayed(n, s, cfg.model.scan_layers),
                                 device=w0.device) for n, s in layout]).float()
    p = w0.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses: List[float] = []
    head_losses: List[Dict[str, float]] = []
    grad_norms = None
    for t, batch in enumerate(batches):
        leaf = p.detach().requires_grad_()
        loss, heads = pretraining_loss(views(leaf, layout), cfg, batch, nm)
        (g,) = torch.autograd.grad(loss, [leaf])
        g = torch.nan_to_num(g)
        losses.append(float(loss.detach()))
        head_losses.append({k: float(v.detach()) for k, v in heads.items()})
        if t == 0:
            grad_norms = leaf_norms(g, layout)
        with torch.no_grad():
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            mh, vh = m, v
            if opt.do_bias_correction:
                mh, vh = m / (1 - b1 ** (t + 1)), v / (1 - b2 ** (t + 1))
            update = mh / (torch.sqrt(vh) + opt.eps) + opt.weight_decay_rate * p * mask
            p.add_(update * (schedule(t, opt) * -opt.learning_rate))
        del leaf, g, loss, heads
    change = leaf_norms(p - w0, layout)
    return {"losses": losses, "head_losses": head_losses, "grad_norms": grad_norms,
            "change_norms": change}
