"""Checkpointing: params + optimizer state + step, with retention policy.

Counterpart of ``kaldi_ctc_tpu/training/checkpoint.py`` in the same
on-disk layout, so each package restores the other's checkpoints leaf for
leaf.  A checkpoint is ``<dir>/step_<N>/{arrays.npz, meta.json}``: the
state's leaves as ``leaf_<i>`` in ``jax.tree_util`` order (reproduced by
:func:`params.tree_flatten`, hazard F3), and a meta with ``step``,
``num_leaves``, ``num_param_leaves`` and ``extra``.  The training state is
flattened with ``params`` first, so leaves ``[0, num_param_leaves)`` are
the params whatever optimizer state follows.  A model with batch norms
keeps its running statistics last (``TrainState.stats``), counted in the
meta's ``num_stat_leaves``.  Retention keeps every ``keep_every``-th
checkpoint and the last few (``steps/ctc/train.sh:450-452,527-535``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, am_param_shapes
from kaldi_ctc_tpu_torch.params import tree_flatten, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_train_state",
           "latest_step", "read_meta", "restore_params",
           "restore_norm_stats", "cfg_for_checkpoint", "apply_retention"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a state tree (a ``TrainState`` or any tree of tensors and
    arrays) under ckpt_dir/step_<N>/: written to step_<N>.tmp, then
    renamed."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [_numpy(leaf) for leaf in tree_flatten(state)]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    meta = {"step": step, "num_leaves": len(leaves), "extra": extra or {}}
    # the params-prefix contract of restore_params
    if hasattr(state, "params"):
        meta["num_param_leaves"] = len(tree_flatten(state.params))
    if getattr(state, "stats", None):
        meta["num_stat_leaves"] = len(tree_flatten(state.stats))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_checkpoint(ckpt_dir: str, like: Any,
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (step None → latest): each
    leaf a tensor of its saved dtype on the device of ``like``'s first
    leaf → (state, meta)."""
    step = _resolve(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{step}")
    meta = read_meta(ckpt_dir, step)
    device = tree_flatten(like)[0].device
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
                  for i in range(meta["num_leaves"])]
    return tree_unflatten(like, leaves), meta


def restore_train_state(ckpt_dir: str, state: Any,
                        step: Optional[int] = None) -> Tuple[Any, Dict]:
    """:func:`restore_checkpoint` into a ``TrainState`` like ``state``.
    A model with batch norms restores their running statistics too; a
    step-0 checkpoint that holds none (initial weights written by a tool
    that knows no batch norm) starts them as ``state`` holds them, fresh
    as ``init_model`` writes them.  Any later checkpoint without them
    raises: it would train on with the wrong normalisation."""
    meta = read_meta(ckpt_dir, step)
    if state.stats and not meta.get("num_stat_leaves"):
        _check_fresh_ok(ckpt_dir, meta)
        restored, meta = restore_checkpoint(
            ckpt_dir, state._replace(stats=None), step)
        return restored._replace(stats=state.stats), meta
    return restore_checkpoint(ckpt_dir, state, step)


def _check_fresh_ok(ckpt_dir: str, meta: Dict) -> None:
    """Fresh running statistics stand in only for a step-0 checkpoint."""
    if meta["step"]:
        raise ValueError(f"checkpoint step {meta['step']} in {ckpt_dir} "
                         f"holds no running statistics, which its model's "
                         f"batch norms need")


def apply_retention(ckpt_dir: str, keep_every: int = 100,
                    keep_last: int = 8) -> List[int]:
    """Delete checkpoints except every `keep_every`-th and the last
    `keep_last` (steps/ctc/train.sh:450-452). Returns removed steps."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = sorted(int(m.group(1)) for n in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(n)))
    if not steps:
        return []
    keep = set(s for s in steps if keep_every > 0 and s % keep_every == 0)
    keep.update(steps[-keep_last:] if keep_last > 0 else [])
    removed = []
    for s in steps:
        if s not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"))
            removed.append(s)
    return removed


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(n))]
    return max(steps) if steps else None


def _resolve(ckpt_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return step


def read_meta(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """A checkpoint's meta.json, without loading arrays."""
    step = _resolve(ckpt_dir, step)
    with open(os.path.join(ckpt_dir, f"step_{step}", "meta.json")) as f:
        return json.load(f)


def restore_params(ckpt_dir: str, cfg: AmConfig, step: Optional[int] = None,
                   device="cpu") -> Tuple[Any, Dict]:
    """Restore ONLY the model params of ``cfg`` from a checkpoint (step
    None → latest), whatever training state was saved beside them.
    → (params on ``device``, meta)."""
    from kaldi_ctc_tpu_torch.models.artifact import leaves_to_params

    step = _resolve(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{step}")
    meta = read_meta(ckpt_dir, step)
    n = len(tree_flatten(am_param_shapes(cfg)))
    recorded = meta.get("num_param_leaves")
    if recorded is not None and recorded != n:
        raise ValueError(
            f"checkpoint {path} has {recorded} param leaves, the model "
            f"expects {n} — config/checkpoint mismatch")
    if meta["num_leaves"] < n:
        raise ValueError(f"checkpoint {path} holds only "
                         f"{meta['num_leaves']} leaves, params need {n}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        params = leaves_to_params(cfg, [data[f"leaf_{i}"] for i in range(n)],
                                  path, device)
    return params, meta


def restore_norm_stats(ckpt_dir: str, cfg: AmConfig,
                       step: Optional[int] = None, device="cpu") -> list:
    """The running statistics of ``cfg``'s batch norms from a checkpoint
    (its last ``num_stat_leaves`` leaves; fresh for a step-0 checkpoint
    that holds none, as :func:`restore_train_state`); empty for a model
    with none."""
    from kaldi_ctc_tpu_torch.models.acoustic import init_norm_stats

    fresh = init_norm_stats(cfg, device)
    if not fresh:
        return fresh
    step = _resolve(ckpt_dir, step)
    meta = read_meta(ckpt_dir, step)
    k, n = meta.get("num_stat_leaves", 0), meta["num_leaves"]
    if not k:
        _check_fresh_ok(ckpt_dir, meta)
        return fresh
    if k != len(tree_flatten(fresh)):
        raise ValueError(f"checkpoint step {step} in {ckpt_dir} has {k} "
                         f"statistics leaves, the model expects "
                         f"{len(tree_flatten(fresh))}")
    path = os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")
    with np.load(path) as data:
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
                  for i in range(n - k, n)]
    return tree_unflatten(fresh, leaves)


def cfg_for_checkpoint(ckpt_dir: str, cfg: AmConfig,
                       step: Optional[int] = None) -> AmConfig:
    """Reconcile an AmConfig with a checkpoint's saved layer count
    (layer-wise growth rewrites model_config.json before a checkpoint at
    the new size exists).  Returns cfg unchanged when the meta has no
    layer record or already matches."""
    try:
        layers = read_meta(ckpt_dir, step=step)["extra"].get("num_layers")
    except (OSError, KeyError, ValueError):
        return cfg
    if layers and layers != cfg.num_layers:
        return dataclasses.replace(cfg, num_layers=layers)
    return cfg
