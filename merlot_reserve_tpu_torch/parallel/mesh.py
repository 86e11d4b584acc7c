"""Device meshes: named axes over an array of devices.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
(dcn, dp, sp, pp, tp): ``dp`` data parallel, ``sp`` sequence parallel (the
joint transformer's ring and Ulysses attention, ``ops/ring_attention.py``),
``pp`` pipeline, ``tp`` tensor parallel, ``dcn`` the slices of a multi-slice
job. Size-1 axes stay in the mesh, so one rule set serves every layout.

The port keeps the same names and shapes. A device may appear more than
once: ``make_mesh(sp=4)`` with the default devices puts four *virtual
ranks* of the sp axis on one card, which is how the sequence-parallel
attention runs on one H100 (each rank's K/V shard in its own slots of the
card's memory). Meshes that span several cards are not run yet.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch.utils.device import resolve_device


class Mesh:
    """An n-d array of ``torch.device``s with one name per axis.

    :param devices: array-like of devices, one dimension per axis name
    :param axis_names: the axes' names, outermost first
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for {len(axis_names)} axis names "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self):
        """The mesh's devices, each once."""
        return sorted(set(self.devices.flat), key=str)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct_devices()]})"


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1,
              devices: Optional[Sequence] = None, dcn_dp: Optional[int] = None) -> Mesh:
    """Build a (dcn, dp, sp, pp, tp) mesh, as the JAX package's ``make_mesh``.

    dp = -1 means all remaining devices; ``dp`` counts the total
    data-parallel ways, of which ``dcn_dp`` are slices (their own ``dcn``
    axis, size 1 without it). ``devices`` defaults to the card, repeated
    once per rank (dp = -1 then means 1): the mesh's ranks are virtual
    ranks on one card, and raises when there is no card.
    """
    if devices is None:
        n = (1 if dp == -1 else dp) * sp * pp * tp
        devices = [resolve_device("cuda")] * n
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    rest = sp * pp * tp
    if dp == -1:
        if n % rest:
            raise ValueError(f"{n} devices not divisible by sp*pp*tp={rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(f"dp({dp})*sp({sp})*pp({pp})*tp({tp}) != {n} devices")
    dcn = 1
    if dcn_dp is not None and dcn_dp > 1:
        if dp % dcn_dp:
            raise ValueError(f"dp={dp} not divisible by {dcn_dp} slices")
        dcn = dcn_dp
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dcn, dp // dcn, sp, pp, tp),
                axis_names=("dcn", "dp", "sp", "pp", "tp"))


def dp_size(mesh: Mesh) -> int:
    """Total data-parallel ways: dcn (slices) x dp (intra-slice)."""
    return mesh.shape.get("dcn", 1) * mesh.shape.get("dp", 1)


def batch_axes(mesh: Mesh):
    """The axis names batch dim 0 shards over: ("dcn", "dp") when both
    exist, else "dp" (or None)."""
    names = [a for a in ("dcn", "dp") if a in mesh.axis_names]
    return tuple(names) if len(names) > 1 else (names[0] if names else None)


_ACTIVE_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "merlot_torch_active_mesh", default=None)


def current_mesh() -> Optional[Mesh]:
    """The mesh most recently activated with :func:`activate_mesh` in this
    context (a context variable: it does not follow a call into another
    thread)."""
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def activate_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh that ``attention(impl='ring...')`` and
    ``TransformerEncoder(seq_shard_axis=...)`` resolve their axes against."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)
