"""Feature-space linear transforms (transform-feats): a numpy copy of
``kaldi_ctc_tpu/features/transform.py``.

Applies LDA/MLLT/fMLLR matrices estimated by the GMM bootstrap stage —
consumed as fixtures, exactly like the reference recipe applies them in
the egs feature pipeline (``steps/ctc/get_egs2.sh:162-199``:
``apply-cmvn | splice-feats | transform-feats $lda | transform-feats
--utt2spk ark:utt2spk ark:trans.ark``).

Kaldi's transform-feats convention (transform-feats.cc): a transform
with as many columns as the feature dim is linear (y = F x); one extra
column makes it affine (y = F [x; 1]).
"""

from __future__ import annotations

import numpy as np

__all__ = ["apply_transform"]


def apply_transform(feats: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """[T, D] features × [R, D] (linear) or [R, D+1] (affine) → [T, R]."""
    feats = np.asarray(feats, np.float32)
    mat = np.asarray(mat, np.float32)
    d = feats.shape[1]
    if mat.shape[1] == d:
        return feats @ mat.T
    if mat.shape[1] == d + 1:
        return feats @ mat[:, :d].T + mat[:, d]
    raise ValueError(
        f"transform has {mat.shape[1]} cols; features have dim {d} "
        f"(need D or D+1)")
