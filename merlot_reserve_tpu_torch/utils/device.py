"""Device selection for the port's entry points."""

from __future__ import annotations

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
