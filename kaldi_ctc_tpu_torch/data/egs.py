"""CTC training examples and the rules that govern them.

A copy of ``kaldi_ctc_tpu/data/egs.py`` (host-only numpy).

Replaces NnetCtcExample (``ctc/ctc-nnet-example.h:37-79``), the example
filter in the background reader (``ctc/ctc-nnet-train.cc:84-94``), the
label collapse done by ``ali-to-pdf --shift=1 --unique=true``
(``bin/ali-to-pdf.cc:68-74``) and frame subsampling/shift augmentation
(``ctc/ctc-nnet-example.cc:78-106``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional

import numpy as np

__all__ = ["CtcExample", "MAX_LABEL_LENGTH", "collapse_alignment",
           "frame_subsample", "example_ok"]

# warp-ctc's CUDA label-length limit, kept as the framework default
# (ctc/ctc-nnet-train.cc:25-26).
MAX_LABEL_LENGTH = 639


@dataclasses.dataclass
class CtcExample:
    """One utterance: features + collapsed CTC label sequence."""

    key: str
    feats: np.ndarray    # [T, D] float32
    labels: np.ndarray   # [L] int32, values >= 1 (0 is blank)

    @property
    def num_frames(self) -> int:
        return self.feats.shape[0]

    @property
    def num_labels(self) -> int:
        return self.labels.shape[0]


def collapse_alignment(ali: np.ndarray, shift: int = 1) -> np.ndarray:
    """pdf-id alignment → CTC label sequence.

    Collapse consecutive duplicates and shift ids by +1 so pdf 0 becomes
    label 1 and index 0 is free for the blank (ali-to-pdf --shift=1
    --unique=true, bin/ali-to-pdf.cc:68-74; note the reference shifts first
    then uniques — order is equivalent for a constant shift).
    """
    ali = np.asarray(ali)
    if ali.size == 0:
        return ali.astype(np.int32)
    keep = np.concatenate([[True], ali[1:] != ali[:-1]])
    return (ali[keep] + shift).astype(np.int32)


def frame_subsample(feats: np.ndarray, factor: int, shift: int = 0) -> np.ndarray:
    """Take frames shift, shift+factor, ... (ctc-nnet-example.cc:78-92).

    The per-iteration `shift` cycling is the reference's cheap data
    augmentation (steps/ctc/train.sh:412).
    """
    if factor <= 1:
        return feats
    if not 0 <= shift < factor:
        raise ValueError(f"shift {shift} must be in [0, {factor})")
    idx = np.arange(0, feats.shape[0] - shift, factor) + shift
    if idx.size == 0:
        return feats
    return np.ascontiguousarray(feats[idx])


def perturb_examples(
    examples,
    noise_scale: float = 0.1,
    seed: int = 0,
):
    """Add covariance-shaped Gaussian noise to features.

    The nnet-ctc-perturb-egs equivalent (ctcbin/nnet-ctc-perturb-egs.cc:
    30-45): estimate the feature covariance over the dataset, take its
    Cholesky factor, and add ``noise_scale * L @ N(0, I)`` to every frame,
    so the perturbation follows the data's own correlation structure.
    """
    examples = list(examples)
    if not examples:
        return []
    frames = np.concatenate([e.feats for e in examples], axis=0)
    mean = frames.mean(axis=0)
    centered = frames - mean
    cov = (centered.T @ centered) / max(frames.shape[0] - 1, 1)
    d = cov.shape[0]
    chol = np.linalg.cholesky(cov + 1e-5 * np.eye(d))
    rng = np.random.default_rng(seed)
    out = []
    for e in examples:
        noise = rng.standard_normal(e.feats.shape).astype(np.float32)
        out.append(CtcExample(
            e.key,
            e.feats + noise_scale * (noise @ chol.T.astype(np.float32)),
            e.labels))
    return out


def example_ok(
    eg: CtcExample,
    max_allow_frames: int = 2000,
    max_label_length: int = MAX_LABEL_LENGTH,
    time_stride: int = 1,
) -> bool:
    """The background reader's skip rules (ctc/ctc-nnet-train.cc:84-94):
    drop if too many frames, too many labels, or frames < 2*labels+1.
    `time_stride` > 1 (DS2 conv front end) checks the CTC constraint
    against the model's output length ceil(t/stride)."""
    t, l = eg.num_frames, eg.num_labels
    if max_allow_frames > 0 and t > max_allow_frames:
        return False
    if l > max_label_length or l == 0:
        return False
    if -(-t // max(time_stride, 1)) < 2 * l + 1:
        return False
    return True
