"""Faults planted in the program under test, for the checks' own tests and
for reading the numbers a broken timed path gives on the card. Each is a
context manager that patches the program and restores it."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def half_batch():
    """The step's loss and gradient over the first half of the batch's rows
    only (the mean taken over the rest)."""
    from merlot_reserve_tpu_torch.training import trainer

    orig = trainer.loss_and_grads

    def half(model, batch, *args, **kwargs):
        b = batch["images"].shape[0] // 2
        return orig(model, {k: v[:b] for k, v in batch.items()}, *args, **kwargs)

    trainer.loss_and_grads = half
    try:
        yield
    finally:
        trainer.loss_and_grads = orig


@contextlib.contextmanager
def unchanged():
    """A step that leaves the parameters and the optimizer's state as they were."""
    from merlot_reserve_tpu_torch.training.optimization import PretrainOptimizer

    orig = PretrainOptimizer.step
    PretrainOptimizer.step = lambda self, grads: None
    try:
        yield
    finally:
        PretrainOptimizer.step = orig


@contextlib.contextmanager
def altered():
    """Every served batch comes back with its first video's first row
    negated: one answer altered where it is produced."""
    from merlot_reserve_tpu_torch.models.model import MerlotReserve

    orig = MerlotReserve.batch_embed_video

    def wrong(self, *args):
        out = orig(self, *args).clone()
        out[0, 0] = -out[0, 0]
        return out

    MerlotReserve.batch_embed_video = wrong
    try:
        yield
    finally:
        MerlotReserve.batch_embed_video = orig


FAULTS = {"half_batch": half_batch, "unchanged": unchanged, "altered": altered}


def none():
    return contextlib.nullcontext()
