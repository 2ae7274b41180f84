"""Lattice LM rescoring with an ARPA backoff model.

Counterpart of ``kaldi_ctc_tpu/decoding/rescore.py``: the same host code over the
port's modules.

The ``lattice-lmrescore`` / ``lattice-lmrescore-const-arpa`` semantics:
compose the word-level lattice with a deterministic-on-demand LM
automaton and add ``lm_scale`` × the LM cost of each word (and of the
end-of-sentence at finals) to the graph cost.  With ``lm_scale=-1`` and
the old LM this subtracts the graph scores the decoding G contributed;
with ``+1`` and a bigger LM it adds the new scores — the standard
two-call rescoring pipeline.

Works on :class:`CompactLattice` (word-level, determinized); LM states
are truncated n-gram histories, expanded lazily, so only histories the
lattice can reach are instantiated.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from kaldi_ctc_tpu_torch.decoding.det_lattice import CompactLattice
from kaldi_ctc_tpu_torch.lm.arpa import ArpaLm

__all__ = ["lmrescore_compact"]

_LN10 = math.log(10.0)
_INF = float("inf")


def lmrescore_compact(
    clat: CompactLattice,
    lm: ArpaLm,
    id_to_word: Dict[int, str],
    lm_scale: float = 1.0,
    bos: str = "<s>",
    eos: str = "</s>",
) -> CompactLattice:
    """→ new CompactLattice with LM costs folded into the graph costs.

    Epsilon word arcs keep the LM history; unknown word ids score through
    the LM's OOV handling (``ArpaLm.logprob``)."""

    def advance(hist: Tuple[str, ...], word: str) -> Tuple[str, ...]:
        nh = (hist + (word,))[-(lm.order - 1):] if lm.order > 1 else ()
        # shorten to a history the LM actually has (arpa_to_fst_arrays'
        # next-history rule) so the state space stays bounded
        while nh and not lm.has_ngram(nh):
            nh = nh[1:]
        return nh

    by_state: List[List[int]] = [[] for _ in range(clat.num_states)]
    for i in range(clat.num_arcs):
        by_state[clat.arc_from[i]].append(i)

    state_of: Dict[Tuple[int, Tuple[str, ...]], int] = {}
    out = CompactLattice(
        start=0, num_states=0, arc_from=[], arc_to=[], arc_word=[],
        arc_graph_cost=[], arc_acoustic_cost=[], arc_ilabels=[],
        final_graph_cost=[], final_acoustic_cost=[], final_ilabels=[])
    stack: List[Tuple[int, Tuple[str, ...]]] = []

    def get_state(s: int, hist: Tuple[str, ...]) -> int:
        key = (s, hist)
        sid = state_of.get(key)
        if sid is not None:
            return sid
        sid = out.num_states
        state_of[key] = sid
        out.num_states += 1
        if math.isinf(clat.final_graph_cost[s]):
            out.final_graph_cost.append(_INF)
            out.final_acoustic_cost.append(_INF)
            out.final_ilabels.append(())
        else:
            eos_cost = -_LN10 * lm.logprob(eos, hist)
            out.final_graph_cost.append(
                clat.final_graph_cost[s] + lm_scale * eos_cost)
            out.final_acoustic_cost.append(clat.final_acoustic_cost[s])
            out.final_ilabels.append(clat.final_ilabels[s])
        stack.append(key)
        return sid

    start_hist = (bos,) if lm.order > 1 and lm.has_ngram((bos,)) else ()
    out.start = get_state(clat.start, start_hist)
    while stack:
        s, hist = stack.pop()
        sid = state_of[(s, hist)]
        for i in by_state[s]:
            w = int(clat.arc_word[i])
            g = float(clat.arc_graph_cost[i])
            if w == 0:
                nh = hist
            else:
                word = id_to_word.get(w, "<unk>")
                g += lm_scale * (-_LN10 * lm.logprob(word, hist))
                nh = advance(hist, word)
            tid = get_state(int(clat.arc_to[i]), nh)
            out.arc_from.append(sid)
            out.arc_to.append(tid)
            out.arc_word.append(w)
            out.arc_graph_cost.append(g)
            out.arc_acoustic_cost.append(float(clat.arc_acoustic_cost[i]))
            out.arc_ilabels.append(clat.arc_ilabels[i])
    return out
