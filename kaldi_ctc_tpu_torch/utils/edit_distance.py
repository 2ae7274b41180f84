"""Levenshtein edit distance — scalar and batched.

The distances of ``kaldi_ctc_tpu/utils/edit_distance.py`` (host-only
numpy), computed row by row with no loop over a row's columns.

Replaces the reference's ``src/util/edit-distance.h`` (used for the
greedy-collapse training accuracy metric at ``ctc/ctc-nnet-update.cc:261-317``
and for WER scoring).  Row i of the table from row i-1: the
substitution and deletion candidates ``cand`` for every column at once,
then the insertion chain ``cur[j] = min(cand[j], cur[j-1] + 1)``, which
is ``j + min_{k <= j}(cand[k] - k)``, a running minimum.  The batched
variant steps every pair of a minibatch through its rows together, the
rows of whichever side is shorter (the distance is symmetric), so a
training step scores in as many numpy calls as the shorter side's
longest sequence has labels: none where every hypothesis is empty.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["edit_distance", "edit_distance_stats", "batch_edit_distance"]


def _next_row(prev: np.ndarray, i: int, cost: np.ndarray) -> np.ndarray:
    """Row i of the distance table ([..., n + 1]) from row i-1 ``prev``
    and the substitution costs ``cost`` [..., n] of ref[i-1] against each
    hypothesis symbol."""
    cols = np.arange(prev.shape[-1], dtype=prev.dtype)
    cand = np.empty_like(prev)
    cand[..., 0] = i
    cand[..., 1:] = np.minimum(prev[..., 1:] + 1, prev[..., :-1] + cost)
    return cols + np.minimum.accumulate(cand - cols, axis=-1)


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
        prev = _next_row(prev, i, hyp_a != ref_a[i - 1])
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
    refs, hyps = np.asarray(refs), np.asarray(hyps)
    ref_lens = np.asarray(ref_lens, dtype=np.int64)
    hyp_lens = np.asarray(hyp_lens, dtype=np.int64)
    # the table's rows run over the side whose longest sequence is shorter
    a, a_lens, b, b_lens = refs, ref_lens, hyps, hyp_lens
    if hyp_lens.max(initial=0) < ref_lens.max(initial=0):
        a, a_lens, b, b_lens = hyps, hyp_lens, refs, ref_lens
    rows = np.arange(a.shape[0])
    n = int(b_lens.max(initial=0))
    # row 0 of every table; a pair's distance is read at its own (m, n)
    prev = np.broadcast_to(np.arange(n + 1, dtype=np.int32),
                           (rows.size, n + 1))
    out = b_lens.copy()
    for i in range(1, int(a_lens.max(initial=0)) + 1):
        prev = _next_row(prev, i, b[:, :n] != a[:, i - 1:i])
        done = a_lens == i
        out[done] = prev[rows[done], b_lens[done]]
    return out, ref_lens
