"""Multi-process runtime glue on ``torch.distributed``.

Counterpart of ``kaldi_ctc_tpu/parallel/distributed.py`` (the reference's
run.pl/queue.pl job spawning, ``utils/run.pl:7-29``,
``steps/ctc/train.sh:386-446``): one process per device, launched N
times (``cli/launch.py`` on one machine), with data sharded per process
and gradients summed across processes by the step (``training/train.py``).

``init_distributed`` reads the variables the launcher sets
(``COORDINATOR_ADDRESS``, ``PROCESS_ID``, ``NUM_PROCESSES``; torchrun's
``MASTER_ADDR``/``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` spell the
same) and joins the process group over ``tcp://``: NCCL when the rank's
device is a card, gloo when it is the CPU.  Each rank takes
``cuda:(rank % device_count)``; a run that would put two ranks on one
card raises, naming both counts (NCCL cannot run two ranks on one
device), and nothing falls back to gloo or to the CPU.  With no such
variable it is a no-op, as in the JAX package.  ``shutdown`` leaves the
group, so that a caller in the same process can start again.
"""

from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from kaldi_ctc_tpu_torch.utils.profiling import profiler

__all__ = ["init_distributed", "host_shard", "is_primary", "process_count",
           "process_index", "rank_device", "initialised_device", "shutdown",
           "resolve_environment", "DistEnv", "process_allgather"]

T = TypeVar("T")

# the rank's device, set by init_distributed (None: not initialised)
_RANK_DEVICE: Optional[torch.device] = None
# how long a rank waits for the others at the rendezvous and in a
# collective before it raises
_TIMEOUT = datetime.timedelta(seconds=600)


class DistEnv(NamedTuple):
    """What a process needs to join the group."""
    address: str           # host:port of rank 0's store
    world_size: int
    rank: int


def _env(*names: str) -> Optional[str]:
    for name in names:
        value = os.environ.get(name, "").strip()
        if value:
            return value
    return None


def resolve_environment(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None
                        ) -> Optional[DistEnv]:
    """The group this process is asked to join, from the arguments or the
    environment; None in a one-process run that names no coordinator
    (the no-op case, ``kaldi_ctc_tpu/parallel/distributed.py:34-37``)."""
    address = coordinator_address or _env("COORDINATOR_ADDRESS",
                                          "JAX_COORDINATOR_ADDRESS")
    if address is None and _env("MASTER_ADDR"):
        address = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or 29500}"
    if num_processes is None:
        value = _env("NUM_PROCESSES", "WORLD_SIZE")
        num_processes = int(value) if value is not None else None
    if process_id is None:
        value = _env("PROCESS_ID", "RANK")
        process_id = int(value) if value is not None else None
    if address is None:
        if num_processes is not None and num_processes > 1:
            raise ValueError(f"{num_processes} processes asked for but no "
                             "coordinator address (set COORDINATOR_ADDRESS "
                             "or MASTER_ADDR)")
        return None
    world = 1 if num_processes is None else num_processes
    rank = 0 if process_id is None else process_id
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world}: out of range")
    return DistEnv(address, world, rank)


def rank_device(kind: str, rank: int, world_size: int) -> torch.device:
    """The device of ``rank``: the CPU, or ``cuda:(local rank % cards)``.
    Raises where NCCL would put two ranks of this machine on one card."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"no process-group backend for device {kind!r}")
    cards = torch.cuda.device_count()
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if cards < 1 or local_ranks > cards:
        raise RuntimeError(
            f"{local_ranks} processes on this machine but {cards} CUDA "
            f"device(s): NCCL cannot put two ranks on one device (run at "
            f"most {cards} processes, or pass --device cpu for gloo)")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local_rank % cards)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join the process group (no-op in a one-process run) and return
    this rank's device: ``device`` itself when there is no group, else
    the rank's card or the CPU."""
    global _RANK_DEVICE
    device = torch.device(device)
    env = resolve_environment(coordinator_address, num_processes,
                              process_id)
    if env is None:
        return device
    rank_dev = rank_device(device.type, env.rank, env.world_size)
    if dist.is_initialized():
        # joined already (a caller in this process): as the JAX package
        # does once its backends are up, keep the group
        _RANK_DEVICE = rank_dev
        return rank_dev
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    dist.init_process_group(
        backend="nccl" if rank_dev.type == "cuda" else "gloo",
        init_method=f"tcp://{env.address}", world_size=env.world_size,
        rank=env.rank, timeout=_TIMEOUT)
    _RANK_DEVICE = rank_dev
    return rank_dev


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None


def initialised_device() -> Optional[torch.device]:
    """The rank's device while a group is joined, else None."""
    return _RANK_DEVICE if dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def host_shard(items: Sequence[T]) -> List[T]:
    """This process's shard of a global list (per-process data loading;
    the analogue of per-job egs archives in train.sh:408-419)."""
    n, i = process_count(), process_index()
    return list(items[i::n])


def process_allgather(x) -> np.ndarray:
    """``x`` (an array) of every process, stacked along a new leading axis
    in rank order (``multihost_utils.process_allgather``); ``x[None]`` in
    a one-process run."""
    a = np.asarray(x)
    if not dist.is_initialized():
        return a[None]
    with profiler.span("parallel.allgather"):
        t = torch.as_tensor(a, device=_RANK_DEVICE)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy()
