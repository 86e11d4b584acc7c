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
    """The default group's backend ("nccl" or "gloo"; None without a group)."""
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
