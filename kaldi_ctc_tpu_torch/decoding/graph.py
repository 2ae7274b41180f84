"""TLG decoding-graph construction as a library.

Counterpart of ``kaldi_ctc_tpu/decoding/graph.py``: the same host code over
the port's modules.

The mkgraph.sh pipeline (``egs/librispeech/ctc/run.sh`` →
``utils/mkgraph.sh:92-124``) as one function: L (lexicon, with
disambiguation symbols) ∘ G (ARPA-compiled grammar) → determinize-star →
minimize-encoded → push-special → strip disambig → add CTC self-loops →
blank-twin CTC transform.  ``cli/graph_tool.py make-tlg`` is the CLI
wrapper; ``bench.py --decode`` and ``recipes/medium`` call this directly.

Every FST stage runs in native C++ (native/fst.cc, native/determinize.cc)
— the Python here is only array plumbing.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

__all__ = ["build_tlg"]


def build_tlg(
    lexicon: List[Tuple[str, List[str]]],
    arpa_lm,                           # ArpaLm
    phone_to_id: Optional[Dict[str, int]] = None,
    sil_phone: Optional[str] = None,
    sil_prob: float = 0.5,
    determinize: bool = True,
    push: bool = True,
    tree=None,
    timings: Optional[Dict[str, float]] = None,
):
    """→ (tlg: NativeFst, word_to_id, phone_to_id).

    `timings`, if given, is filled with per-stage wall seconds."""
    from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
    from kaldi_ctc_tpu_torch.lm import arpa_to_fst_arrays
    from kaldi_ctc_tpu_torch.lm.lexicon import (
        add_lex_disambig, lexicon_to_fst_arrays)

    def tic():
        return time.perf_counter()

    def rec(name, t0):
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0

    t0 = tic()
    num_disambig = 0
    if determinize:
        # homophone/prefix disambiguation so L∘G is determinizable
        # (utils/add_lex_disambig.pl + L_disambig.fst, mkgraph.sh:92)
        lexicon, num_disambig = add_lex_disambig(lexicon)
    l_start, l_n, l_arcs, l_w, l_fin, phone_to_id, word_to_id = \
        lexicon_to_fst_arrays(lexicon, phone_to_id=phone_to_id,
                              sil_phone=sil_phone, sil_prob=sil_prob)
    L = NativeFst.from_arrays(l_start, l_n, l_arcs, l_w, l_fin)
    rec("L", t0)

    t0 = tic()
    g_start, g_n, g_arcs, g_w, g_fin, word_to_id = \
        arpa_to_fst_arrays(arpa_lm, dict(word_to_id))
    G = NativeFst.from_arrays(g_start, g_n, g_arcs, g_w, g_fin)
    rec("G", t0)

    t0 = tic()
    LG = L.compose(G)
    rec("compose", t0)

    if determinize:
        # mkgraph.sh:92-98 chain on LG: determinize-star |
        # minimize-encoded | push-special, then strip disambig ids
        t0 = tic()
        LG = LG.determinize_star().minimize()
        rec("determinize+minimize", t0)
        t0 = tic()
        if push:
            LG = LG.push_special()
        if num_disambig:
            first = min(i for p, i in phone_to_id.items()
                        if p.startswith("#") and p[1:].isdigit())
            LG = LG.remove_disambig(first).connect()
        rec("push+strip", t0)

    if tree is not None:
        # context-dependency expansion (triphone route): phone ilabels
        # -> tree pdf+1 before the H/CTC steps
        from kaldi_ctc_tpu_torch.decoding.context import context_expand
        t0 = tic()
        LG = context_expand(LG, tree)
        rec("context", t0)

    # H step: self-loops (sustained frames), then the CTC transform
    t0 = tic()
    tlg = LG.add_self_loops().make_ctc_graph()
    rec("ctc", t0)
    # BFS renumbering: isomorphic, but decode-critical for cache
    # locality on big graphs (each blank twin lands next to its
    # original instead of num_states away; active-set arc walks become
    # near-sequential)
    t0 = tic()
    tlg = tlg.renumber_bfs()
    rec("renumber", t0)
    return tlg, word_to_id, phone_to_id
