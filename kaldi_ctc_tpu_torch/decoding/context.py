"""Context-dependency expansion of phone-labeled graphs (triphone route).

Counterpart of ``kaldi_ctc_tpu/decoding/context.py``: the same host code over
the port's modules.

The fstcomposecontext + make-h-transducer step of mkgraph.sh
(``mkgraph.sh:101-117``; context FST ``fstext/context-fst.h``) collapsed
into one pass for 1-state-per-phone CTC topologies: a phone:word
transducer (LG) becomes a pdf:word transducer by rewriting each phone
arc with the pdf its N-phone window maps to under the ContextDependency
tree.

For N=3 (triphone) the right context is supplied by a one-phone delay —
state = (LG state, left phone, pending phone); a phone arc emits the
*pending* phone's pdf (whose right context it just revealed) and the
utterance-final pending phone is flushed with right context 0 into a
sink state, exactly the context-FST trick of emitting symbols one phone
late.  Output ilabels are pdf+1 (blank reserves 0 after the CTC
transform), matching the monophone route where phone id == pdf+1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
from kaldi_ctc_tpu_torch.utils.tree import ContextDependency

__all__ = ["context_expand", "labels_to_pdfs"]

_INF = float("inf")


def labels_to_pdfs(phones: np.ndarray, tree: ContextDependency,
                   shift: int = 1) -> np.ndarray:
    """Phone-id sequence → (pdf + shift) CTC label sequence under the
    tree, with 0-padding at the utterance edges (flat-start triphone
    labels; the ali-free analogue of ali-to-pdf)."""
    phones = np.asarray(phones, np.int64)
    n, p_pos = tree.N, tree.P
    padded = np.concatenate([np.zeros(p_pos, np.int64), phones,
                             np.zeros(n - 1 - p_pos, np.int64)])
    out = []
    for i in range(len(phones)):
        pdf = tree.pdf(padded[i:i + n])
        if pdf is None:
            raise ValueError(
                f"tree has no pdf for window {padded[i:i + n]}")
        out.append(pdf + shift)
    return np.asarray(out, np.int32)


def context_expand(fst: NativeFst, tree: ContextDependency) -> NativeFst:
    """Phone:word transducer → pdf:word transducer (ilabels pdf+1).

    Supports N=1 (mono relabeling) and N=3 with P=1 (cross-word
    triphones, one-phone delayed emission).  Unseen contexts raise."""
    start, arcs, weights, finals = fst.to_arrays()
    n_in = len(finals)
    by_state: List[List[int]] = [[] for _ in range(n_in)]
    for i in range(arcs.shape[0]):
        by_state[arcs[i, 0]].append(i)

    def pdf1(window) -> int:
        p = tree.pdf(window)
        if p is None:
            raise ValueError(f"tree has no pdf for phone window {window}")
        return p + 1

    out_arcs: List[Tuple[int, int, int, int]] = []
    out_w: List[float] = []
    out_final: List[float] = []

    if tree.N == 1:
        # mono: relabel in place
        for i in range(arcs.shape[0]):
            il = int(arcs[i, 1])
            out_arcs.append((int(arcs[i, 0]),
                             pdf1([il]) if il != 0 else 0,
                             int(arcs[i, 2]), int(arcs[i, 3])))
            out_w.append(float(weights[i]))
        return NativeFst.from_arrays(
            int(start), n_in, np.asarray(out_arcs, np.int32),
            np.asarray(out_w, np.float32), finals)

    if not (tree.N == 3 and tree.P == 1):
        raise ValueError(f"unsupported context width N={tree.N} P={tree.P}"
                         " (mono and triphone are implemented)")

    state_of: Dict[Tuple[int, int, int], int] = {}
    stack: List[Tuple[int, int, int]] = []
    sink = -1  # lazily created final sink for pending-phone flushes

    def get_state(key: Tuple[int, int, int]) -> int:
        sid = state_of.get(key)
        if sid is None:
            sid = len(out_final)
            state_of[key] = sid
            out_final.append(_INF)
            stack.append(key)
        return sid

    new_start = get_state((int(start), 0, 0))
    while stack:
        key = stack.pop()
        s, left, pending = key
        sid = state_of[key]
        if not np.isinf(finals[s]):
            if pending == 0:
                out_final[sid] = min(out_final[sid], float(finals[s]))
            else:
                # flush the pending phone with end-of-utterance right
                # context, then terminate in the sink
                if sink < 0:
                    sink = len(out_final)
                    out_final.append(0.0)
                out_arcs.append((sid, pdf1([left, pending, 0]), 0, sink))
                out_w.append(float(finals[s]))
        for i in by_state[s]:
            il, ol, ns = int(arcs[i, 1]), int(arcs[i, 2]), int(arcs[i, 3])
            w = float(weights[i])
            if il == 0:
                tid = get_state((ns, left, pending))
                out_arcs.append((sid, 0, ol, tid))
                out_w.append(w)
            elif pending == 0:
                tid = get_state((ns, left, il))
                out_arcs.append((sid, 0, ol, tid))
                out_w.append(w)
            else:
                tid = get_state((ns, pending, il))
                out_arcs.append((sid, pdf1([left, pending, il]), ol, tid))
                out_w.append(w)
    return NativeFst.from_arrays(
        new_start, len(out_final),
        np.asarray(out_arcs, np.int32).reshape(-1, 4),
        np.asarray(out_w, np.float32),
        np.asarray(out_final, np.float32)).connect()
