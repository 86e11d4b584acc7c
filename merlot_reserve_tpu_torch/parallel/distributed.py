"""The processes of a training job: the counterpart of the JAX package's
``jax.distributed.initialize``, ``jax.process_index()`` and
``jax.process_count()``.

One process drives one card. ``torchrun`` (``utils/launch.py`` builds its
command lines) starts them and sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``initialize`` reads them, takes the card ``cuda:LOCAL_RANK`` and starts the
default process group: NCCL on the card, gloo when the caller asks for the
CPU. A caller that names a card (``device="cuda:0"``) puts every rank of
the node on that card; NCCL refuses two ranks on one card, so such a job
takes gloo (its collectives on CUDA tensors go through the host). Nothing
falls back from one to the other, and a card that does not exist raises.

Without an initialized group ``process_count()`` is 1 and every path of the
port is its one-process path.

A *stand-in* (``initialize_standin``) is one process that joins a job of N
ranks as rank r on torch's fake backend, with no other process and no
network: every collective is issued, recorded and sized by
``parallel.comm`` and returns at once, while everything that is the rank's
own (its share of the parameters, its ZeRO-1 masters and moments, its
activations, its kernels) is real and on its device. So the rank's peak
memory, its collectives and its kernel launches are a real rank's; the
values are not (a fake all-gather's result is whatever its buffer held).
A stand-in is never passed off as a real job: the training loop,
checkpoint saves and the ring kernel's peer buffers refuse it
(``refuse_standin``).
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class _Job:
    device: Optional[torch.device] = None
    local_world_size: int = 1
    shared_card: bool = False
    standin: bool = False
    at_shutdown: List[Callable[[], None]] = []


def is_initialized() -> bool:
    """Whether this process belongs to a started process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(device="cuda", timeout_s: float = 600.0) -> torch.device:
    """Join the job described by torchrun's environment and return this
    process's device: ``cuda:LOCAL_RANK`` for "cuda", the named card for
    "cuda:<i>" (every local rank on it), or the CPU. The backend is NCCL on
    the cards, gloo on the CPU and for ranks that share a card. Raises when
    a variable is missing, when the card is asked for and there is none or
    not that one, or when a group is already up."""
    if is_initialized():
        raise RuntimeError("a process group is already initialized")
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize: {missing} not set; start the job with torchrun "
                           "(utils.launch) or set the variables by hand")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    shared = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: device 'cuda' requested but torch.cuda.is_available() "
                               "is False; pass device='cpu' for gloo on the CPU")
        shared = dev.index is not None and local_world > 1
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"initialize: card {dev} does not exist "
                               f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(dev)
        backend = "gloo" if shared else "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: no process group backend for device {dev}")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _Job.device = dev
    _Job.local_world_size = local_world
    _Job.shared_card = shared
    return dev


def _fake_backend():
    """torch's fake process group (``torch.testing._internal``): importing
    it registers the "fake" backend. The only import of it in the port."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("initialize_standin: this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg); a stand-in rank "
                           "needs it") from e
    return FakeStore


def initialize_standin(world_size: int, rank: int, device="cuda",
                       local_world_size: int = 8) -> torch.device:
    """Join a job of ``world_size`` ranks as rank ``rank``, alone: the
    default group runs on torch's fake backend, so every collective returns
    at once and no other process or network is needed. Ranks ``r`` and
    ``s`` share a node when ``r // local_world_size == s // local_world_size``
    (8 cards an H100 node), which is how ``comm.split_intra_inter`` splits
    the records. Returns the rank's device: the card (the current one for
    "cuda", or the one named) unless the caller passes "cpu". Raises when a
    group is already up, when the card is asked for and there is none, or
    when this torch has no fake backend."""
    if is_initialized():
        raise RuntimeError("a process group is already initialized")
    if not 0 <= rank < world_size:
        raise ValueError(f"initialize_standin: rank {rank} outside a world of {world_size}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_standin: device 'cuda' requested but "
                               "torch.cuda.is_available() is False; pass device='cpu'")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"initialize_standin: no stand-in on device {dev}")
    store = _fake_backend()()
    dist.init_process_group("fake", store=store, rank=rank, world_size=world_size)
    _Job.device = dev
    _Job.local_world_size = local_world_size
    _Job.shared_card = False
    _Job.standin = True
    return dev


def is_standin() -> bool:
    """Whether this process is a stand-in rank (``initialize_standin``)."""
    return _Job.standin and is_initialized()


def refuse_standin(what: str) -> None:
    """Raise when this process is a stand-in: ``what`` expects a real job's
    result, and a stand-in's values are not one."""
    if is_standin():
        raise RuntimeError(
            f"{what}: this process is a stand-in rank (parallel.distributed."
            "initialize_standin) on the fake backend, whose collectives move no data; its "
            "values are meaningless, so it trains no loop, saves no checkpoint and opens no "
            "peer buffers")


def process_index() -> int:
    """This process's rank in the job (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The job's number of processes (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def local_world_size() -> int:
    """Processes per node (``LOCAL_WORLD_SIZE``; 1 without a group): ranks
    ``r`` and ``s`` share a node when ``r // n == s // n``."""
    return _Job.local_world_size if is_initialized() else 1


def device() -> Optional[torch.device]:
    """The device ``initialize`` took (None without a group)."""
    return _Job.device if is_initialized() else None


def shared_card() -> bool:
    """Whether every local rank of the job sits on the card ``initialize``
    was given by name."""
    return _Job.shared_card if is_initialized() else False


def backend() -> Optional[str]:
    """The default group's backend ("nccl", "gloo", or "fake" for a stand-in;
    None without a group)."""
    return dist.get_backend() if is_initialized() else None


def at_shutdown(fn: Callable[[], None]) -> None:
    """Have ``shutdown`` call ``fn()`` first, while the process groups are
    still up (buffers that other processes mapped, closed collectively)."""
    _Job.at_shutdown.append(fn)


def shutdown() -> None:
    """Leave the job: run the ``at_shutdown`` calls in order, then destroy
    every process group (a no-op without one)."""
    if is_initialized():
        while _Job.at_shutdown:
            _Job.at_shutdown.pop(0)()
        dist.destroy_process_group()
    _Job.at_shutdown.clear()
    _Job.device = None
    _Job.local_world_size = 1
    _Job.shared_card = False
    _Job.standin = False
