"""One-process, one-device stand-in for the multi-process runtime.

Counterpart of ``kaldi_ctc_tpu/parallel/distributed.py`` and of the
``make_mesh`` / ``shard_batch`` pair of ``parallel/mesh.py``, the names
the training driver uses.  It is temporary: ROADMAP.md item 14 replaces
it with ``torch.distributed`` (NCCL on the card, gloo on the CPU).
Until then one process trains on one device, and an environment that
asks for more processes raises rather than training one process's shard
as if it were the whole set.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, TypeVar

import numpy as np
import torch

__all__ = ["init_distributed", "host_shard", "is_primary", "process_count",
           "process_index", "make_mesh", "shard_batch"]

T = TypeVar("T")

_NOT_PORTED = ("multi-process training is not ported yet: ROADMAP.md "
               "item 14 (torch.distributed); this process found {}")


def _multi_process_request() -> str:
    """The environment variable that asks for several processes, or ''."""
    for name in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        if os.environ.get(name):
            return f"{name}={os.environ[name]}"
    for name in ("NUM_PROCESSES", "WORLD_SIZE"):
        value = os.environ.get(name, "")
        if value.strip() and int(value) > 1:
            return f"{name}={value}"
    return ""


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None) -> None:
    """No-op in a one-process run; raises ``NotImplementedError`` when the
    arguments or the environment ask for several processes."""
    request = _multi_process_request()
    if coordinator_address:
        request = f"coordinator_address={coordinator_address}"
    elif num_processes is not None and num_processes > 1:
        request = f"num_processes={num_processes}"
    if request:
        raise NotImplementedError(_NOT_PORTED.format(request))


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def is_primary() -> bool:
    return True


def host_shard(items: Sequence[T]) -> List[T]:
    """This process's shard of a global list: all of it."""
    return list(items)


def make_mesh(device="cuda") -> torch.device:
    """The device the step runs on (a mesh of one)."""
    return torch.device(device)


def shard_batch(batch: Dict[str, np.ndarray],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Move a numpy batch onto the device (host → card copies)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
