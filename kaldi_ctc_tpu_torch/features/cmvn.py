"""Cepstral mean/variance normalization (reference: src/transform/cmvn.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/cmvn.py``.  Stats use the
Kaldi on-disk convention: a [2, dim+1] matrix with row0 = (sum_x.., count)
and row1 = (sum_x2.., 0).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["acc_cmvn_stats", "apply_cmvn"]


def acc_cmvn_stats(feats) -> np.ndarray:
    """Accumulate CMVN stats for one utterance [T, D] → [2, D+1] (f64)."""
    if isinstance(feats, torch.Tensor):
        feats = feats.detach().cpu().numpy()
    feats = np.asarray(feats, dtype=np.float64)
    t, d = feats.shape
    stats = np.zeros((2, d + 1), dtype=np.float64)
    stats[0, :d] = feats.sum(axis=0)
    stats[0, d] = t
    stats[1, :d] = (feats * feats).sum(axis=0)
    return stats


def apply_cmvn(
    feats: torch.Tensor,
    stats: np.ndarray,
    norm_means: bool = True,
    norm_vars: bool = False,
) -> torch.Tensor:
    """Apply CMVN to [T, D] features given [2, D+1] stats; the scale and
    offset are computed in f64 on the host, applied on feats' device."""
    stats = np.asarray(stats, dtype=np.float64)
    d = stats.shape[1] - 1
    count = stats[0, d]
    if count <= 0:
        raise ValueError("CMVN stats have zero count")
    if norm_vars and not norm_means:
        # dividing by sqrt(E[x^2]) is not a variance normalization;
        # Kaldi rejects the combination too (apply-cmvn)
        raise ValueError("cannot normalize variance but not mean")
    mean = stats[0, :d] / count
    if not norm_means:
        mean = np.zeros_like(mean)
    if norm_vars:
        var = stats[1, :d] / count - mean * mean
        scale = 1.0 / np.sqrt(np.maximum(var, 1e-20))
    else:
        scale = np.ones_like(mean)
    offset = -mean * scale
    return (feats * torch.as_tensor(scale, dtype=feats.dtype,
                                    device=feats.device)
            + torch.as_tensor(offset, dtype=feats.dtype, device=feats.device))
