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
card's memory).

Across cards the port runs one process per card (``parallel.distributed``).
After ``initialize``, ``make_mesh`` without ``devices`` lays the job's
processes out as the JAX package lays out its devices, tp innermost: a
*process mesh*, whose every rank is a process and whose axes each hold one
process group (``Mesh.group``). Each process's own position is its card; a
tensor's dim 0 there already is the rank's share. A mesh whose ranks sit on
several devices of one process still raises: the way across cards is one
process per card.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from merlot_reserve_tpu_torch.parallel import distributed
from merlot_reserve_tpu_torch.utils.device import resolve_device

Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """An n-d array of ``torch.device``s with one name per axis.

    :param devices: array-like of devices, one dimension per axis name
    :param axis_names: the axes' names, outermost first
    :param ranks: for a process mesh, the job's ranks in the same layout;
        every process of the job builds the mesh (the groups are made
        collectively), and one outside ``ranks`` holds no position in it
    """

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
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
        self.ranks = None if ranks is None else np.asarray(ranks, dtype=np.int64).reshape(arr.shape)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], List[int]] = {}
        self.coords: Optional[Tuple[int, ...]] = None
        if self.ranks is not None:
            me = np.argwhere(self.ranks == distributed.process_index())
            self.coords = tuple(int(c) for c in me[0]) if len(me) else None
            batch = tuple(a for a in ("dcn", "dp") if a in axis_names)
            for axes in [(a,) for a in axis_names] + ([batch] if len(batch) > 1 else []):
                self._make_groups(axes)
            self._make_groups(axis_names)

    def _make_groups(self, axes: Tuple[str, ...]) -> None:
        """One process group per line of ``axes`` through the mesh (every
        process takes part in making each of them)."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        lines = self.ranks.transpose(rest + idx).reshape(-1, int(np.prod(
            [self.ranks.shape[i] for i in idx], dtype=np.int64)))
        lines = [[int(r) for r in line] for line in lines]
        import torch.distributed as dist

        groups = [dist.new_group(line) for line in lines]
        for line, group in zip(lines, groups):
            if distributed.process_index() in line:
                self._groups[axes] = group
                self._members[axes] = line

    @property
    def is_process_mesh(self) -> bool:
        """Whether the ranks are processes (else virtual ranks of this one)."""
        return self.ranks is not None

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of names)."""
        return int(np.prod([self.shape.get(a, 1) for a in _axes(axes)], dtype=np.int64))

    def axis_index(self, axes: Axes) -> int:
        """This process's index along ``axes`` (row-major over a tuple)."""
        if self.coords is None:
            raise RuntimeError("axis_index: this process holds no position in the mesh")
        index = 0
        for a in _axes(axes):
            i = self.axis_names.index(a)
            index = index * self.devices.shape[i] + self.coords[i]
        return index

    def group(self, axes: Axes):
        """The process group of this process's line along ``axes``."""
        key = _axes(axes)
        if key not in self._groups:
            raise KeyError(f"no process group for axes {key} (a process mesh makes one per "
                           "axis, one for the batch axes and one for the whole mesh)")
        return self._groups[key]

    def group_ranks(self, axes: Axes) -> List[int]:
        """The job ranks of ``group(axes)``, in order along the axes."""
        self.group(axes)
        return self._members[_axes(axes)]

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
              devices: Optional[Sequence] = None, dcn_dp: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (dcn, dp, sp, pp, tp) mesh, as the JAX package's ``make_mesh``.

    dp = -1 means all remaining devices; ``dp`` counts the total
    data-parallel ways, of which ``dcn_dp`` are slices (their own ``dcn``
    axis, size 1 without it).

    Without ``devices``, after ``parallel.distributed.initialize``: a
    process mesh over the job's ranks (``ranks``, default all), when the
    axes multiply to their number. In a job of one process a mesh of more
    ranks puts virtual ranks on its card, as without a job: ``devices``
    then defaults to the card, repeated once per rank (dp = -1 means 1),
    and raises when there is no card.
    """
    if devices is None and distributed.is_initialized():
        members = list(range(distributed.process_count())) if ranks is None else list(ranks)
        rest = sp * pp * tp
        n_dp = len(members) // rest if dp == -1 else dp
        if n_dp * rest == len(members):
            return _process_mesh(n_dp, tp, sp, pp, dcn_dp, members)
        if distributed.process_count() > 1 or ranks is not None:
            raise ValueError(f"dp({dp})*sp({sp})*pp({pp})*tp({tp}) does not lay out the "
                             f"{len(members)} ranks {members}")
        devices = [distributed.device()] * ((1 if dp == -1 else dp) * rest)
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
    dcn = _dcn(dp, dcn_dp)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dcn, dp // dcn, sp, pp, tp),
                axis_names=("dcn", "dp", "sp", "pp", "tp"))


def _dcn(dp: int, dcn_dp: Optional[int]) -> int:
    if dcn_dp is not None and dcn_dp > 1:
        if dp % dcn_dp:
            raise ValueError(f"dp={dp} not divisible by {dcn_dp} slices")
        return dcn_dp
    return 1


def _process_mesh(dp, tp, sp, pp, dcn_dp, members) -> Mesh:
    """The (dcn, dp, sp, pp, tp) process mesh over the job ranks
    ``members``, tp innermost; rank r's device is its card
    ``cuda:r % LOCAL_WORLD_SIZE`` (torchrun's layout), the one card that
    every rank shares (``distributed.shared_card``), or the CPU. A
    stand-in's other ranks exist only as ranks: every position gets its
    device."""
    dcn = _dcn(dp, dcn_dp)
    own = distributed.device()
    local = distributed.local_world_size()
    own_card = own.type != "cuda" or distributed.shared_card() or distributed.is_standin()
    devices = np.empty(len(members), dtype=object)
    devices[:] = [own if own_card else torch.device("cuda", r % local) for r in members]
    shape = (dcn, dp // dcn, sp, pp, tp)
    return Mesh(devices.reshape(shape), axis_names=("dcn", "dp", "sp", "pp", "tp"),
                ranks=np.asarray(members).reshape(shape))


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


def process_mesh() -> Optional[Mesh]:
    """The active mesh when it is a process mesh, else None."""
    mesh = _ACTIVE_MESH.get()
    return mesh if mesh is not None and mesh.is_process_mesh else None


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
    On virtual ranks every rank runs in this process on the tensors'
    device, so it returns its inputs, and a split over ranks on other
    devices of this process raises (across cards the port runs one process
    per card). Under a process mesh dim 0 already is the rank's share: it
    returns its inputs."""
    mesh = current_mesh()
    if mesh is not None and mesh.is_process_mesh:
        return arrays if len(arrays) > 1 else arrays[0]
    for a in arrays:
        axes = row_shard_axes(mesh, a.shape[0], extra_axis)
        if axes and any(mesh.shape[x] > 1 for x in axes) and any(
                d != a.device for d in mesh.distinct_devices()):
            raise NotImplementedError(
                f"rows_anchor: dim 0 splits over {axes} of a mesh on "
                f"{[str(d) for d in mesh.distinct_devices()]} for a tensor on {a.device}; "
                "a mesh over several cards runs one process per card (a process mesh)")
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
