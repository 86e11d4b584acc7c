"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with a concrete CUDA index.

    Raises when a CUDA device is asked for and none is available: the port's
    entry points run on the card unless the caller passes ``device="cpu"``,
    and never fall back to the CPU on their own.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def ieee_f32_matmul():
    """f32 matrix products inside the block run in true f32 on the card and
    the CPU, whatever the caller's global TF32 setting, which is restored on
    exit.

    The setting is global, not per call, so this sets it and restores it
    (not thread-safe against another thread changing it meanwhile). It goes
    through the backends' ``fp32_precision``: torch refuses to read the
    legacy ``allow_tf32`` once the two APIs disagree, and restoring the
    value read keeps them agreeing.
    """
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [b.fp32_precision for b in backends]
    try:
        for b in backends:
            b.fp32_precision = "ieee"
        yield
    finally:
        for b, value in zip(backends, saved):
            b.fp32_precision = value
