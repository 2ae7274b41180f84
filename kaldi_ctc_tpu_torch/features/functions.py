"""Delta features and frame splicing (reference: src/feat/feature-functions.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/functions.py``: both are
one index gather with edge replication and a weighted sum over the
context, on the device of a torch tensor.  A numpy array goes in and
comes out as numpy (computed on the CPU), as the JAX functions accept
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["delta_coeffs", "add_deltas", "splice_frames"]


def delta_coeffs(order: int = 2, window: int = 2) -> list:
    """Delta filter coefficients (DeltaFeatures ctor, feature-functions.cc).

    Returns a list of 1-D arrays; entry k is the filter for the k-th order
    delta, of length 1 + 2*k*window.
    """
    scales = [np.array([1.0])]
    for _ in range(order):
        prev = scales[-1]
        cur = np.zeros(prev.shape[0] + 2 * window)
        norm = sum(j * j for j in range(-window, window + 1))
        for j in range(-window, window + 1):
            cur[window + j: window + j + prev.shape[0]] += (j / norm) * prev
        scales.append(cur)
    return [s.astype(np.float32) for s in scales]


def _context(feats: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """[T, D] → [T, left+1+right, D], frames clamped to [0, T)."""
    t = feats.shape[0]
    offs = torch.arange(-left, right + 1, device=feats.device)
    idx = torch.clamp(torch.arange(t, device=feats.device)[:, None]
                      + offs[None, :], 0, t - 1)
    return feats[idx]


def add_deltas(feats, order: int = 2, window: int = 2):
    """[T, D] → [T, D*(order+1)] with edge-replicated context."""
    as_numpy = not isinstance(feats, torch.Tensor)
    x = torch.as_tensor(np.asarray(feats)) if as_numpy else feats
    outs = []
    for k, c in enumerate(delta_coeffs(order, window)):
        half = k * window
        ctx = _context(x, half, half)                 # [T, len(c), D]
        outs.append(torch.einsum(
            "tcd,c->td", ctx, torch.as_tensor(c, dtype=x.dtype,
                                              device=x.device)))
    out = torch.cat(outs, dim=1)
    return out.numpy() if as_numpy else out


def splice_frames(feats, left: int, right: int):
    """[T, D] → [T, D*(left+1+right)] with edge replication (SpliceFrames)."""
    as_numpy = not isinstance(feats, torch.Tensor)
    x = torch.as_tensor(np.asarray(feats)) if as_numpy else feats
    out = _context(x, left, right).reshape(x.shape[0], -1)
    return out.numpy() if as_numpy else out
