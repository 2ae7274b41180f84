"""Checkpointing: params + optimizer state + step, with retention policy.

Counterpart of ``kaldi_ctc_tpu/training/checkpoint.py`` in the same
on-disk layout, so each package restores the other's checkpoints leaf for
leaf.  A checkpoint is ``<dir>/step_<N>/{arrays.npz, meta.json}``: the
state's leaves as ``leaf_<i>`` in ``jax.tree_util`` order (reproduced by
:func:`params.tree_flatten`, hazard F3), and a meta with ``step``,
``num_leaves``, ``num_param_leaves`` and ``extra``.  The training state is
flattened with ``params`` first, so leaves ``[0, num_param_leaves)`` are
the params whatever optimizer state follows.  Retention keeps every
``keep_every``-th checkpoint and the last few
(``steps/ctc/train.sh:450-452,527-535``).
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

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_meta", "restore_params", "cfg_for_checkpoint",
           "apply_retention"]

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
