"""The process mesh and its sharding rules.

Counterpart of ``kaldi_ctc_tpu/parallel/mesh.py``.  The JAX package lays
its devices out as a ('data', 'model') ``Mesh`` and lets XLA insert the
collectives; here each process drives one device, the processes form
the mesh, and the train step (``training/train.py``) calls the
collectives itself:

- ``data`` axis: the utterance minibatch is split over the processes;
  the gradient is summed over the data group;
- ``model`` axis: the last axis of the recurrent weights and of the
  output affine is split over the model group (tensor parallelism).
  Each rank stores its slice; the step all-gathers the whole leaves
  before the forward (the hand-written kernels need the whole ``W_h``).

Rank r sits at (data index, model index) = (r // model, r % model), as
``np.asarray(devices).reshape(data, model)`` places device r.  In a
process with no process group the mesh is one device, and the step runs
no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kaldi_ctc_tpu_torch.parallel.distributed import (initialised_device,
                                                      process_count,
                                                      process_index)
from kaldi_ctc_tpu_torch.utils.profiling import profiler

__all__ = ["Mesh", "make_mesh", "data_sharding", "param_sharding",
           "shard_batch", "replicated", "split_dims", "local_slices",
           "gather_model", "sum_over_data", "gather_over_data"]

# the leaves whose last axis goes over 'model' under tensor parallelism
# (kaldi_ctc_tpu/parallel/mesh.py:67-78)
_MODEL_SPLIT = ("w_x", "w_h", "b", "out_w", "out_b")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ('data', 'model') mesh."""
    device: torch.device
    data: int
    model: int
    data_index: int
    model_index: int
    # the processes that share this rank's model index (its gradient is
    # summed over them) and those that share its data index (they hold
    # the same rows and the other slices of the split leaves); None
    # without a process group
    data_group: Any = None
    model_group: Any = None

    @property
    def distributed(self) -> bool:
        """True when the step runs collectives (a process group exists,
        of one process or more)."""
        return self.data_group is not None


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """This process's mesh.  ``devices``: one per process, in rank order
    (this rank takes ``devices[rank]``); by default the device
    ``init_distributed`` chose for each rank, or ``cuda`` in a process
    with no group.  data=-1 → all remaining processes."""
    n_proc = process_count()
    if devices is None:
        devices = [initialised_device() or torch.device("cuda")] * n_proc
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n != n_proc:
        raise ValueError(f"{n} devices for {n_proc} processes: a process "
                         "drives one device")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices but "
            f"{n} are available — the device count must be divisible "
            f"by the mesh shape; pass an explicitly trimmed `devices` "
            f"list (devices[:k*model]) to use a subset")
    rank = process_index()
    data_group = model_group = None
    if dist.is_initialized():
        # every rank creates every group, in the same order
        for j in range(model):
            group = dist.new_group([i * model + j for i in range(data)])
            if j == rank % model:
                data_group = group
        for i in range(data):
            group = dist.new_group([i * model + j for j in range(model)])
            if i == rank // model:
                model_group = group
    return Mesh(device=devices[rank], data=data, model=model,
                data_index=rank // model, model_index=rank % model,
                data_group=data_group, model_group=model_group)


def data_sharding(mesh: Mesh) -> int:
    """Batch arrays: the leading (batch) dim over the data axis."""
    return 0


def replicated(mesh: Mesh) -> None:
    """Every rank holds the whole leaf."""
    return None


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, torch.Size) else tuple(leaf.shape)


def _split_dim(path: Tuple, leaf, tensor_parallel: bool) -> Optional[int]:
    ndim = len(_shape(leaf))
    if not tensor_parallel or ndim == 0:
        return None
    if any(name in _MODEL_SPLIT for name in path):
        return ndim - 1
    return None


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        return type(tree)(_map_with_path(fn, v, path + (None,))
                          for v in tree)
    return fn(path, tree)


def _leaf_paths(tree, path=()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) in ``params.tree_flatten`` order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        return [pl for v in tree for pl in _leaf_paths(v, path + (None,))]
    return [(path, tree)]


def param_sharding(mesh: Mesh, params: Any,
                   tensor_parallel: bool = False) -> Any:
    """The tree of ``params`` with, for each leaf, the dim split over
    'model' or None (replicated).  Default: all replicated (pure data
    parallelism).  With tensor_parallel: the last axis of every leaf under
    w_x, w_h, b, out_w or out_b (the gate dim of the recurrent weights and
    the output affine's target axis)."""
    return _map_with_path(
        lambda path, leaf: _split_dim(path, leaf, tensor_parallel), params)


def split_dims(mesh: Mesh, params: Any) -> List[Optional[int]]:
    """``param_sharding``'s dims in flatten order, as the step applies
    them: split over 'model' whenever the mesh has a model axis."""
    return [_split_dim(path, leaf, mesh.model > 1)
            for path, leaf in _leaf_paths(params)]


def _slice(mesh: Mesh, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    if dim is None or mesh.model == 1:
        return x
    if x.shape[dim] % mesh.model:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not "
                         f"split over model={mesh.model}")
    return x.chunk(mesh.model, dim)[mesh.model_index].contiguous()


def local_slices(mesh: Mesh, leaves: Sequence[torch.Tensor],
                 dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """This rank's slice of each whole leaf."""
    return [_slice(mesh, x, d) for x, d in zip(leaves, dims)]


def gather_model(mesh: Mesh, leaves: Sequence[torch.Tensor],
                 dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """The whole leaves from each rank's slices (all-gather over the
    model group)."""
    if mesh.model == 1:
        return list(leaves)
    out = []
    for x, d in zip(leaves, dims):
        if d is None:
            out.append(x)
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.model)]
        dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
        out.append(torch.cat(parts, dim=d))
    return out


def sum_over_data(mesh: Mesh, tensors: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Each tensor summed over the data group, in f32 on one flat buffer
    (one all-reduce a call); the inputs are unchanged.  The span
    ``parallel.all_reduce`` times the host's part (the flattening and
    the collective's launch; NCCL's runs on the device)."""
    if not mesh.distributed:
        return list(tensors)
    with profiler.span("parallel.all_reduce"):
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    profiler.count("parallel.all_reduce_bytes", flat.numel() * 4)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def gather_over_data(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` of every rank of the data group, concatenated along ``dim``
    in data-index order (the rows of the global batch)."""
    if not mesh.distributed or mesh.data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=dim)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's rows of the batch, on its device.  Each process
    already holds its own shard (``distributed.host_shard``), as
    ``jax.make_array_from_process_local_data`` assumes."""
    return {k: torch.as_tensor(v, device=mesh.device)
            for k, v in batch.items()}
