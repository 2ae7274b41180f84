"""Operations and bytes from the shapes alone, and the card's peaks.

The work a configuration needs, whatever kernel does it: the matrix
products of the forward (input projections, recurrent products, the
output affine) at 2 operations a multiply-add, the backward at twice the
forward, and, for the recurrent stack's roofline, the recurrent products
alone with each input byte read once and each output byte written once
(``PERF.md``'s rule).  Elementwise gate arithmetic is not counted.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

__all__ = ["forward_flops_per_frame", "train_flops_per_frame",
           "recurrent_work", "least_seconds", "peaks_for"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def _gates(cfg: dict) -> int:
    return {2: 4, 3: 3}[int(cfg["rnn_mode"])]


def forward_flops_per_frame(cfg: dict) -> float:
    """Forward operations for one (output) frame of one utterance."""
    h, g = int(cfg["hidden_dim"]), _gates(cfg)
    dirs = 2 if int(cfg["bidirectional"]) else 1
    total = 0.0
    for layer in range(int(cfg["num_layers"])):
        d_in = int(cfg["input_dim"]) if layer == 0 else h * dirs
        total += dirs * (2.0 * d_in * g * h + 2.0 * h * g * h)
    return total + 2.0 * h * dirs * int(cfg["num_targets"])


def train_flops_per_frame(cfg: dict) -> float:
    """Forward plus backward (twice the forward: the gradients of the
    inputs and of the weights)."""
    return 3.0 * forward_flops_per_frame(cfg)


def recurrent_work(cfg: dict, frames: Sequence[int], backward: bool
                   ) -> Dict[str, float]:
    """The recurrent stack's work over utterances of ``frames`` valid
    frames: the recurrent products ``h W_h`` (and, with ``backward``,
    ``dgates W_h^T``) of every layer and direction, and the bytes each
    direction must move at least (f32): its input projection read, its
    outputs written, W_h read; the backward also reads the outputs'
    gradients and writes the gates' gradients."""
    h, g = int(cfg["hidden_dim"]), _gates(cfg)
    dirs = 2 if int(cfg["bidirectional"]) else 1
    layers = int(cfg["num_layers"])
    n = float(sum(frames))
    passes = 2.0 if backward else 1.0
    flops = passes * layers * dirs * n * 2.0 * h * g * h
    per_dir = n * (g * h + h) * 4.0 + h * g * h * 4.0
    if backward:
        per_dir += n * (h + g * h) * 4.0 + h * g * h * 4.0
    return {"flops": flops, "bytes": layers * dirs * per_dir}


def least_seconds(work: Dict[str, float], peak_flops: float,
                  peak_bytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(work["flops"] / peak_flops, work["bytes"] / peak_bytes)


def peaks_for(device_name: str, dtype: str) -> Dict[str, float]:
    """{"flops": peak FLOP/s of ``dtype``, "bytes": HBM bytes/s} of the
    card whose name holds a key of ``peaks.json``; KeyError otherwise."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        cards = json.load(f)["cards"]
    for key, p in cards.items():
        if key in device_name:
            return {"flops": float(p[dtype]),
                    "bytes": float(p["hbm_bytes_per_s"])}
    raise KeyError(f"no published peaks for {device_name!r}")
