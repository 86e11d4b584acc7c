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


def row_shard_axes(mesh: Optional[Mesh], dim0: int,
                   extra_axis: Optional[str] = None) -> Optional[Tuple[str, ...]]:
    """The mesh axes that the JAX package's ``rows_anchor`` shards a row-major
    tensor's dim 0 (of size ``dim0``) over: the batch axes, plus
    ``extra_axis`` when it is in the mesh, larger than 1, not ``dp``, and
    divides dim 0 together with them. Without ``extra_axis`` (or when it
    falls back) ``dp_anchor``'s rule: the batch axes when they divide dim 0.
    None when nothing shards: no mesh, no dp axis, or no division."""
    if mesh is None:
        return None
    bax = batch_axes(mesh)
    batch = list(bax) if isinstance(bax, tuple) else ([bax] if bax else [])
    n = mesh.shape.get(extra_axis, 1) if extra_axis else 1
    if n > 1 and extra_axis != "dp" and dim0 % (dp_size(mesh) * n) == 0:
        return tuple(batch) + (extra_axis,)
    if "dp" not in mesh.axis_names or dim0 % dp_size(mesh):
        return None
    return tuple(batch)


def rows_anchor(*arrays, extra_axis: Optional[str] = None):
    """The JAX package's ``rows_anchor`` (and, without ``extra_axis``, its
    ``dp_anchor``): a sharding hint for row-major tensors whose dim 0 is
    batch x independent rows (the modality towers' inputs, the drawn text
    spans), so that it may split over the batch axes and
    ``segment_shard_axis`` too (``row_shard_axes``, fallbacks included).
    In the JAX package it is a GSPMD constraint and changes no number.
    Here every rank of the mesh runs in this process on the tensors'
    device, so it returns its inputs; a split over ranks on other devices
    raises, as a mesh across several cards is not ported yet."""
    mesh = current_mesh()
    for a in arrays:
        axes = row_shard_axes(mesh, a.shape[0], extra_axis)
        if axes and any(mesh.shape[x] > 1 for x in axes) and any(
                d != a.device for d in mesh.distinct_devices()):
            raise NotImplementedError(
                f"rows_anchor: dim 0 splits over {axes} of a mesh on "
                f"{[str(d) for d in mesh.distinct_devices()]} for a tensor on {a.device}; "
                "a mesh across several cards is not ported yet")
    return arrays if len(arrays) > 1 else arrays[0]


def dp_anchor(*arrays):
    """The JAX package's ``dp_anchor``: ``rows_anchor`` without an extra
    axis, dim 0 over the batch axes only."""
    return rows_anchor(*arrays)


@contextlib.contextmanager
def activate_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the ambient mesh that ``attention(impl='ring...')`` and
    ``TransformerEncoder(seq_shard_axis=...)`` resolve their axes against.
    ``None`` makes no mesh ambient (a recompute restores the forward's
    state with it)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)
