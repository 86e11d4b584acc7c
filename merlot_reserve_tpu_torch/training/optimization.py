"""The pretraining optimizer, without optax.

The port of ``merlot_reserve_tpu/training/optimization.py``'s pretraining
chain: memory-lean Adam with the first moment stored in bf16 and the second
in a cube-root bf16 encoding that spends the (always non-negative) sign bit
as an extra mantissa bit, then decoupled weight decay on the parameters
whose flax leaf has more than one axis, then the linear-warmup / cosine
schedule, then the step -lr. The update math is f32 and follows the optax
chain operation for operation, so that the two packages agree to rounding.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

# one extra half-step of mantissa, signaled by the sign bit
_MISSING_PRECISION = 1 + (1 / 2 ** 9)
_F32_TINY = torch.finfo(torch.float32).tiny  # the smallest normal f32


def unsigned_bfloat16_decode(v: torch.Tensor) -> torch.Tensor:
    """Decode the cube-root bf16 encoding back to f32. torch has no cbrt:
    the cube root is pow(x, 1/3), which can differ from a correctly rounded
    cbrt in the last ulp or two."""
    v_abs = v.abs().float()
    v_abs = torch.where(v >= 0, v_abs, v_abs * _MISSING_PRECISION)
    return torch.pow(v_abs, 1.0 / 3.0)


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _F32_TINY, 0.0, x)


def unsigned_bfloat16_encode(v: torch.Tensor) -> torch.Tensor:
    """Encode a non-negative f32 as bf16 of v^3, choosing the sign that
    minimizes the decode error. Subnormal intermediates are flushed to zero
    as XLA does on the CPU and the TPU: the error terms of a nu below about
    1e-12 are subnormal, and the flush decides its half-step bit."""
    v_pow = _flush_subnormal(v * v * v)
    v_bf = v_pow.to(torch.bfloat16)
    v_bf32 = v_bf.float()
    err0 = _flush_subnormal((v_bf32 - v_pow).abs())
    err1 = _flush_subnormal((v_bf32 * _MISSING_PRECISION - v_pow).abs())
    return torch.where(err0 < err1, v_bf, -v_bf)


def lr_scale_linearwarmup_cosinedecay(num_warmup_steps: int, num_train_steps: int,
                                      final_lr_scale: float = 0.1):
    """step -> f32 scale: step / warmup, then a cosine from 1 down to
    ``final_lr_scale`` over the remaining steps."""
    if num_warmup_steps > num_train_steps:
        raise ValueError("num_warmup_steps > num_train_steps")

    def schedule(step: int) -> torch.Tensor:
        step_f = torch.tensor(step, dtype=torch.float32)
        if step < num_warmup_steps:
            return step_f / num_warmup_steps
        post = torch.clamp((step_f - num_warmup_steps) / (num_train_steps - num_warmup_steps + 1.0),
                           max=1.0)
        post = 1.0 - (1.0 - torch.cos(math.pi * post)) / 2.0
        return final_lr_scale + (1.0 - final_lr_scale) * post

    return schedule


def lr_scale_linearwarmup_lineardecay(num_warmup_steps: int, num_train_steps: int):
    """step -> f32 scale: step / warmup, then linear down to 0."""
    if num_warmup_steps > num_train_steps:
        raise ValueError("num_warmup_steps > num_train_steps")

    def schedule(step: int) -> torch.Tensor:
        step_f = torch.tensor(step, dtype=torch.float32)
        if step < num_warmup_steps:
            return step_f / num_warmup_steps
        post = (step_f - num_warmup_steps) / (num_train_steps - num_warmup_steps + 1.0)
        return 1.0 - torch.clamp(post, max=1.0)

    return schedule


class PretrainOptimizer:
    """bf16 Adam -> decoupled weight decay -> schedule -> -lr, over named
    f32 parameters, updated in place.

    :param named_params: (name, parameter) pairs, e.g. ``model.named_parameters()``
    :param decay: names of the parameters that take weight decay
    :param opt_config: an ``OptimizerConfig``

    ``count`` is the number of updates made. Like optax's
    ``scale_by_schedule``, the schedule is read at the count before the
    update, so the first update has scale schedule(0) = 0 under warmup.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], decay: Iterable[str],
                 opt_config):
        if not opt_config.use_bfloat16_adam:
            raise NotImplementedError("only the bf16 Adam of the pretraining chain is ported")
        self.config = opt_config
        self.params: Dict[str, torch.Tensor] = dict(named_params)
        self.decay = frozenset(decay)
        unknown = self.decay - set(self.params)
        if unknown:
            raise KeyError(f"weight decay names no parameter: {sorted(unknown)}")
        self.schedule = lr_scale_linearwarmup_cosinedecay(
            opt_config.num_warmup_steps, opt_config.num_train_steps, opt_config.final_lr_scale)
        self.mu = {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update of every parameter from its f32 gradient."""
        cfg = self.config
        b1, b2 = cfg.beta_1, cfg.beta_2
        count_inc = self.count + 1
        # an f32 value as a Python float: multiplying by it is exact in f32,
        # and it needs no copy to the device
        step_size = float(self.schedule(self.count))
        for name, p in self.params.items():
            g = grads[name]
            next_m = (1 - b1) * g + b1 * self.mu[name].float()
            next_v = (1 - b2) * torch.square(g) + b2 * unsigned_bfloat16_decode(self.nu[name])
            self.mu[name] = next_m.to(torch.bfloat16)
            self.nu[name] = unsigned_bfloat16_encode(next_v)
            if cfg.do_bias_correction:
                next_m = next_m / (1 - b1 ** count_inc)
                next_v = next_v / (1 - b2 ** count_inc)
            update = next_m / (torch.sqrt(next_v) + cfg.eps)
            if name in self.decay:
                update = update + cfg.weight_decay_rate * p
            update = update * step_size
            p.add_(update * (-cfg.learning_rate))
        self.count = count_inc
