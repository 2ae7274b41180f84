"""Checkpoint reading: the params of a JAX training directory.

Counterpart of the read half of ``kaldi_ctc_tpu/training/checkpoint.py``
(``latest_step``, ``read_meta``, ``restore_params``,
``cfg_for_checkpoint``), so ``serve --dir exp`` loads what JAX's
``init_model`` / ``train_ctc`` wrote.  A checkpoint is
``<dir>/step_<N>/{arrays.npz, meta.json}``; the training state is
flattened with ``params`` first, so leaves ``[0, num_param_leaves)`` are
the params in ``jax.tree_util`` order whatever optimizer state follows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, am_param_shapes
from kaldi_ctc_tpu_torch.params import tree_flatten

__all__ = ["latest_step", "read_meta", "restore_params", "cfg_for_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d+)$")


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
