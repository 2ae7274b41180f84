"""Deployable inference artifact: params + config + priors in one file.

Counterpart of ``kaldi_ctc_tpu/models/artifact.py``, same ``.npz``
format: ``leaf_<i>`` arrays numbered in ``jax.tree_util`` flatten order
(reproduced by :func:`params.tree_flatten`, hazard F3), the AmConfig
JSON under ``__config__`` and the prior vector under ``__priors__``.
Artifacts written by either package load in the other.  A model with
batch norms (the port's alone) adds its running statistics as
``stat_<i>`` (:func:`load_norm_stats`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig, am_param_shapes,
                                                 init_norm_stats)
from kaldi_ctc_tpu_torch.params import tree_flatten, tree_unflatten

__all__ = ["save_inference_artifact", "load_inference_artifact",
           "load_acoustic_model", "leaves_to_params", "load_norm_stats"]


def save_inference_artifact(path: str, params: Any, cfg: AmConfig,
                            priors: Optional[np.ndarray] = None,
                            stats: Optional[list] = None) -> None:
    """``stats``: the running statistics of a model with batch norms."""
    arrays = {f"leaf_{i}": l.detach().to("cpu", torch.float32).numpy()
              for i, l in enumerate(tree_flatten(params))}
    for i, leaf in enumerate(tree_flatten(stats)):
        arrays[f"stat_{i}"] = leaf.detach().to("cpu", torch.float32).numpy()
    arrays["__config__"] = np.frombuffer(
        json.dumps(cfg.to_dict()).encode(), dtype=np.uint8)
    if priors is not None:
        arrays["__priors__"] = np.asarray(priors, np.float32)
    # write through a handle so numpy cannot append '.npz'
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def leaves_to_params(cfg: AmConfig, leaves, source: str, device="cpu"):
    """Numbered leaves → the parameter tree of ``cfg`` on ``device``,
    each leaf checked against the shape its position must have."""
    shapes = tree_flatten(am_param_shapes(cfg))
    if len(leaves) < len(shapes):
        raise ValueError(f"{source}: {len(leaves)} leaves, the model "
                         f"needs {len(shapes)}")
    out = []
    for i, (leaf, shape) in enumerate(zip(leaves, shapes)):
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"{source}: leaf_{i} has shape "
                             f"{tuple(leaf.shape)}, expected {tuple(shape)}")
        out.append(torch.as_tensor(np.asarray(leaf, np.float32),
                                   device=device))
    return tree_unflatten(am_param_shapes(cfg), out)


def load_inference_artifact(path: str, device="cpu"
                            ) -> Tuple[Any, AmConfig, Optional[np.ndarray]]:
    """→ (params on ``device``, cfg, priors-or-None)."""
    with np.load(path) as data:
        cfg = AmConfig.from_dict(
            json.loads(bytes(data["__config__"]).decode()))
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(tree_flatten(am_param_shapes(cfg))):
            raise ValueError(f"{path}: {n} leaves do not match its config")
        params = leaves_to_params(
            cfg, [data[f"leaf_{i}"] for i in range(n)], path, device)
        priors = (np.asarray(data["__priors__"])
                  if "__priors__" in data.files else None)
    return params, cfg, priors


def load_norm_stats(cfg: AmConfig, model: Optional[str] = None,
                    dir: Optional[str] = None, step: Optional[int] = None,
                    device="cpu") -> list:
    """The running statistics of ``cfg``'s batch norms, from the model
    file or the training directory :func:`load_acoustic_model` read;
    empty for a model with none.  A model file without them raises (every
    writer of the port writes them); a training directory's step-0
    checkpoint may start them fresh (``restore_norm_stats``)."""
    fresh = init_norm_stats(cfg, device)
    if not fresh:
        return fresh
    if not model:
        from kaldi_ctc_tpu_torch.training.checkpoint import restore_norm_stats
        return restore_norm_stats(os.path.join(dir, "checkpoints"), cfg,
                                  step, device)
    keys = [f"stat_{i}" for i in range(len(tree_flatten(fresh)))]
    with np.load(model) as data:
        if keys[0] not in data.files:
            raise ValueError(f"{model} holds no running statistics, which "
                             f"its model's batch norms need")
        return tree_unflatten(fresh, [torch.as_tensor(data[k], device=device)
                                      for k in keys])


def load_acoustic_model(model: Optional[str] = None,
                        dir: Optional[str] = None,
                        step: Optional[int] = None, device="cpu"):
    """One loader for every CLI → (params, cfg, priors, meta).

    `model`: single-file inference artifact (priors embedded, meta None).
    `dir`: training directory — model_config.json reconciled with the
    checkpoint's layer count, then the checkpoint's params restored;
    `priors.npy` is picked up when present.

    Raises ValueError when neither source is given.
    """
    if model:
        params, cfg, priors = load_inference_artifact(model, device)
        return params, cfg, priors, None
    if not dir:
        raise ValueError("need a model artifact (--model) or a "
                         "training dir (--dir)")
    from kaldi_ctc_tpu_torch.training.checkpoint import (
        cfg_for_checkpoint, restore_params)
    with open(os.path.join(dir, "model_config.json")) as f:
        cfg = AmConfig.from_dict(json.load(f))
    ckpt = os.path.join(dir, "checkpoints")
    cfg = cfg_for_checkpoint(ckpt, cfg, step=step)
    params, meta = restore_params(ckpt, cfg, step=step, device=device)
    ppath = os.path.join(dir, "priors.npy")
    priors = np.load(ppath) if os.path.exists(ppath) else None
    return params, cfg, priors, meta
