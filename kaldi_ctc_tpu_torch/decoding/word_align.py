"""Word alignment of CTC CompactLattices (lattice-align-words-lexicon).

Counterpart of ``kaldi_ctc_tpu/decoding/word_align.py``: the same host code over the
port's modules.

Re-partitions each CompactLattice arc's frame-alignment string so every
output arc corresponds to exactly one word and carries exactly that
word's frames (reference contract: ``lat/word-align-lattice-lexicon.h``,
``latbin/lattice-align-words.cc:33-45``).  Because CTC phones carry no
word-position markers, the lexicon variant is the right one: a word's
span is located by matching its pronunciation(s) against the phone
instances decoded from the graph-label string.

CTC specifics (ctc-transition-model.h:56-75): graph label 1 = blank,
label g >= 2 = transition-id g-1.  A phone *instance* starts at a
non-self-loop transition-id and continues through self-loop repeats;
blanks between a word's phones belong to the word, blanks between words
come out as separate silence arcs (word = ``silence_label``, default 0).

The traversal is a closure over computation states
(lattice state, pending labels, pending words): consuming lattice arcs
accumulates labels/words/weight; emissions cut word or blank-stretch
arcs off the front of the pending string.  Deterministic input keeps the
pending window bounded by one pronunciation span.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.decoding.det_lattice import CompactLattice

__all__ = ["word_align_lattice_lexicon", "AlignError"]

_INF = float("inf")
_FINAL = -1                       # pseudo lattice state after final weight


class AlignError(ValueError):
    """Lattice could not be word-aligned (mismatched lexicon/model)."""


def _runs(labels: Tuple[int, ...], tid_phone: Optional[np.ndarray],
          tid_selfloop: Optional[np.ndarray], blank_label: int):
    """Split a graph-label string into runs: ('B', i, j, 0) blank
    stretches and ('P', i, j, phone) phone instances (labels[i:j]).

    With a transition model, an instance starts at a non-self-loop
    transition-id and continues through self-loop repeats of the same
    phone.  Without one (tid_phone None — native unit graphs where
    label = unit+1), an instance is a maximal run of identical labels,
    matching CTC collapse semantics.
    """
    runs = []
    n = len(labels)
    i = 0
    while i < n:
        g = labels[i]
        if g == blank_label:
            j = i
            while j < n and labels[j] == blank_label:
                j += 1
            runs.append(("B", i, j, 0))
            i = j
        elif tid_phone is None:
            j = i + 1
            while j < n and labels[j] == g:
                j += 1
            runs.append(("P", i, j, g - 1))
            i = j
        else:
            tid = g - 1
            if tid <= 0 or tid >= len(tid_phone):
                raise AlignError(f"graph label {g} out of range")
            if tid_selfloop[tid]:
                raise AlignError(
                    f"label string starts a phone instance with a "
                    f"self-loop transition-id {tid}")
            j = i + 1
            while j < n and labels[j] != blank_label and labels[j] - 1 > 0 \
                    and labels[j] - 1 < len(tid_phone) \
                    and tid_selfloop[labels[j] - 1] \
                    and tid_phone[labels[j] - 1] == tid_phone[tid]:
                j += 1
            runs.append(("P", i, j, int(tid_phone[tid])))
            i = j
    return runs


def word_align_lattice_lexicon(
        clat: CompactLattice,
        prons: Dict[int, List[Tuple[int, ...]]],
        tid_phone: Optional[np.ndarray] = None,
        tid_selfloop: Optional[np.ndarray] = None,
        blank_label: int = 1,
        silence_label: int = 0,
        partial_word_label: int = 0,
        max_states: int = 200000) -> CompactLattice:
    """→ word-aligned CompactLattice.

    prons: word id → pronunciations (tuples of phone ids, as trained —
    the ids ``tid_phone`` maps transition-ids onto).
    Raises AlignError if some path cannot be segmented (wrong lexicon,
    malformed strings) or the expansion exceeds ``max_states``.
    """
    if (tid_phone is None) != (tid_selfloop is None):
        raise ValueError("tid_phone and tid_selfloop must be given "
                         "together (both from the same TransitionModel)")
    n_in = clat.num_states
    in_adj: List[List[int]] = [[] for _ in range(n_in)]
    for i in range(clat.num_arcs):
        in_adj[clat.arc_from[i]].append(i)

    # output lattice under construction
    state_ids: Dict[Tuple, int] = {}
    out_arcs: List[Tuple[int, int, int, float, float, Tuple[int, ...]]] = []
    out_final: Dict[int, Tuple[float, float]] = {}
    expand_stack: List[Tuple] = []

    def out_state(key: Tuple) -> int:
        if key not in state_ids:
            if len(state_ids) >= max_states:
                raise AlignError("alignment expansion exceeded max_states "
                                 "(mismatched lexicon/model?)")
            state_ids[key] = len(state_ids)
            expand_stack.append(key)
        return state_ids[key]

    def step(lat_s: int, labels: Tuple[int, ...], words: Tuple[int, ...]):
        """→ (emissions, consume): emissions are
        (word, consumed_labels, labels', words') cuts off the front of
        the pending string; consume says whether pulling in more lattice
        arcs could still enable a (different) emission.  lat_s == _FINAL
        means no more labels can arrive."""
        at_end = lat_s == _FINAL
        emits = []
        if not labels:
            return emits, not at_end
        runs = _runs(labels, tid_phone, tid_selfloop, blank_label)
        first = runs[0]
        if first[0] == "B":
            # blank stretch: emit once its extent is known (a phone
            # follows in pending, or the path has ended); its extent is
            # unknown only while it is the sole run
            if len(runs) > 1 or at_end:
                emits.append((silence_label, labels[:first[2]],
                              labels[first[2]:], words))
                return emits, False
            return emits, True
        inst = [r for r in runs if r[0] == "P"]
        iphones = tuple(r[3] for r in inst)
        if not words:
            # phones with no word pending: only legal as a forced-out
            # partial at the very end of the lattice
            if at_end:
                emits.append((partial_word_label, labels, (), ()))
            return emits, not at_end
        word = words[0]
        consume = False
        for pron in prons.get(word, ()):
            k = len(pron)
            m = min(k, len(iphones))
            if k == 0 or tuple(pron[:m]) != iphones[:m]:
                continue
            if k > len(inst):
                consume = True         # compatible prefix; needs more
                continue
            last = inst[k - 1]
            if last is runs[-1] and not at_end:
                # the k-th instance may still extend by self-loops on
                # the next lattice arc — wait for more labels
                consume = True
                continue
            emits.append((word, labels[:last[2]], labels[last[2]:],
                          words[1:]))
        if at_end:
            consume = False
            if not emits:
                # force-out: no pron completed but the path ended
                emits.append((partial_word_label, labels, (), words[1:]))
        return emits, consume

    def expand(key: Tuple) -> None:
        src = state_ids[key]
        # closure: consume lattice arcs (accumulating weight) until
        # emissions become possible; every emission adds an output arc
        stack = [(key[0], key[1], key[2], 0.0, 0.0)]
        seen = set()
        while stack:
            lat_s, labels, words, g, a = stack.pop()
            item_key = (lat_s, labels, words, round(g, 6), round(a, 6))
            if item_key in seen:
                continue
            if len(seen) > max_states:
                # cap the closure too: a pron that stays a compatible
                # prefix forever enumerates weighted paths, not states
                raise AlignError("alignment closure exceeded max_states "
                                 "(mismatched lexicon/model?)")
            seen.add(item_key)
            emits, consume = step(lat_s, labels, words)
            for (w, consumed, labels2, words2) in emits:
                tgt = out_state((lat_s, labels2, words2))
                out_arcs.append((src, tgt, w, g, a, consumed))
            if lat_s == _FINAL:
                if not labels and not words:
                    prev = out_final.get(src)
                    if prev is None or g + a < prev[0] + prev[1]:
                        out_final[src] = (g, a)
                continue
            if not consume:
                continue
            # consume: final weight folds in as a step to _FINAL
            if not math.isinf(clat.final_graph_cost[lat_s]):
                stack.append((_FINAL,
                              labels + clat.final_ilabels[lat_s], words,
                              g + clat.final_graph_cost[lat_s],
                              a + clat.final_acoustic_cost[lat_s]))
            for i in in_adj[lat_s]:
                w = clat.arc_word[i]
                stack.append((clat.arc_to[i],
                              labels + clat.arc_ilabels[i],
                              words + ((w,) if w != 0 else ()),
                              g + clat.arc_graph_cost[i],
                              a + clat.arc_acoustic_cost[i]))

    start_key = (clat.start, (), ())
    out_state(start_key)
    while expand_stack:
        expand(expand_stack.pop())

    n_out = len(state_ids)
    fg = [_INF] * n_out
    fa = [0.0] * n_out
    fi: List[Tuple[int, ...]] = [()] * n_out
    for s, (g, a) in out_final.items():
        fg[s], fa[s] = g, a
    out = CompactLattice(
        start=state_ids[start_key], num_states=n_out,
        arc_from=[x[0] for x in out_arcs],
        arc_to=[x[1] for x in out_arcs],
        arc_word=[x[2] for x in out_arcs],
        arc_graph_cost=[x[3] for x in out_arcs],
        arc_acoustic_cost=[x[4] for x in out_arcs],
        arc_ilabels=[x[5] for x in out_arcs],
        final_graph_cost=fg, final_acoustic_cost=fa, final_ilabels=fi)
    out = _connect(out)
    if out.num_states == 0:
        raise AlignError("no path could be word-aligned")
    return out


def _connect(clat: CompactLattice) -> CompactLattice:
    """Drop states not on a start→final path."""
    n = clat.num_states
    fwd = [[] for _ in range(n)]
    bwd = [[] for _ in range(n)]
    for i in range(clat.num_arcs):
        fwd[clat.arc_from[i]].append(clat.arc_to[i])
        bwd[clat.arc_to[i]].append(clat.arc_from[i])

    def reach(starts, adj):
        seen = set(starts)
        stack = list(starts)
        while stack:
            s = stack.pop()
            for t in adj[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return seen

    acc = reach([clat.start], fwd)
    coacc = reach([s for s in range(n)
                   if not math.isinf(clat.final_graph_cost[s])], bwd)
    keep = sorted(acc & coacc)
    if not keep:
        return CompactLattice(0, 0, [], [], [], [], [], [], [], [], [])
    new_id = {s: i for i, s in enumerate(keep)}
    idx = [i for i in range(clat.num_arcs)
           if clat.arc_from[i] in new_id and clat.arc_to[i] in new_id]
    return CompactLattice(
        start=new_id[clat.start], num_states=len(keep),
        arc_from=[new_id[clat.arc_from[i]] for i in idx],
        arc_to=[new_id[clat.arc_to[i]] for i in idx],
        arc_word=[clat.arc_word[i] for i in idx],
        arc_graph_cost=[clat.arc_graph_cost[i] for i in idx],
        arc_acoustic_cost=[clat.arc_acoustic_cost[i] for i in idx],
        arc_ilabels=[clat.arc_ilabels[i] for i in idx],
        final_graph_cost=[clat.final_graph_cost[s] for s in keep],
        final_acoustic_cost=[clat.final_acoustic_cost[s] for s in keep],
        final_ilabels=[clat.final_ilabels[s] for s in keep])
