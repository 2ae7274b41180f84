"""Levenshtein edit distance — scalar and batched.

A copy of ``kaldi_ctc_tpu/utils/edit_distance.py`` (host-only numpy).

Replaces the reference's ``src/util/edit-distance.h`` (used for the
greedy-collapse training accuracy metric at ``ctc/ctc-nnet-update.cc:261-317``
and for WER scoring).  The batched variant is vectorized numpy over the
antidiagonal-free row recurrence so whole minibatches of hypotheses score in
one call on host.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["edit_distance", "edit_distance_stats", "batch_edit_distance"]


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Plain Levenshtein distance between two sequences."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    ref_a = np.asarray(list(ref))
    hyp_a = np.asarray(list(hyp))
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (hyp_a != ref_a[i - 1])
        # cur[j] = min(prev[j] + 1, sub[j-1], cur[j-1] + 1); the cur[j-1]
        # dependency is resolved with a running minimum.
        cand = np.minimum(prev[1:] + 1, sub)
        run = cur[0]
        for j in range(1, n + 1):
            run = min(run + 1, cand[j - 1])
            cur[j] = run
        prev = cur
    return int(prev[n])


def edit_distance_stats(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """Distance with ins/del/sub breakdown (for WER reports)."""
    m, n = len(ref), len(hyp)
    d = np.zeros((m + 1, n + 1), dtype=np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    # traceback
    i, j = m, n
    ins = dels = subs = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += int(ref[i - 1] != hyp[j - 1])
            i, j = i - 1, j - 1
        elif j > 0 and d[i, j] == d[i, j - 1] + 1:
            ins += 1
            j -= 1
        else:
            dels += 1
            i -= 1
    return {"distance": int(d[m, n]), "ins": ins, "del": dels, "sub": subs,
            "ref_len": m}


def batch_edit_distance(
    refs: np.ndarray, ref_lens: np.ndarray,
    hyps: np.ndarray, hyp_lens: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched Levenshtein over padded int arrays.

    Args:
      refs: [B, Lr] padded reference label ids.
      ref_lens: [B] true lengths.
      hyps: [B, Lh] padded hypothesis ids.
      hyp_lens: [B] true lengths.
    Returns:
      (distances [B], ref_lens [B]) — for accuracy = 1 - dist/ref_len.
    """
    B = refs.shape[0]
    out = np.zeros(B, dtype=np.int64)
    for b in range(B):
        out[b] = edit_distance(refs[b, : ref_lens[b]], hyps[b, : hyp_lens[b]])
    return out, np.asarray(ref_lens, dtype=np.int64)
