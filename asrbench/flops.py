"""Operations and bytes from the shapes alone, and the card's peaks.

The work a configuration needs, whatever kernel does it, as its family
(``families``) counts it: the forward's matrix products at 2 operations
a multiply-add, the backward at twice the forward, and, for a layer's
roofline, the least operations and bytes of the layers that
``kernels/*.json`` names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

from asrbench import families

__all__ = ["forward_flops_per_frame", "train_flops_per_frame",
           "recurrent_work", "least_seconds", "peaks_for"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def forward_flops_per_frame(cfg: dict) -> float:
    """Forward operations for one (input) frame of one utterance."""
    return families.of(cfg).forward_flops_per_frame(cfg)


def train_flops_per_frame(cfg: dict) -> float:
    """Forward plus backward (twice the forward: the gradients of the
    inputs and of the weights)."""
    return 3.0 * forward_flops_per_frame(cfg)


def recurrent_work(cfg: dict, frames: Sequence[int], backward: bool
                   ) -> Dict[str, float]:
    """{"flops", "bytes"} of the recurrent stack over utterances of
    ``frames`` input frames (with ``backward``, the backward's too): the
    family's ``layer_work``."""
    return families.of(cfg).layer_work(cfg, "recurrent stack", frames,
                                       backward)


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
