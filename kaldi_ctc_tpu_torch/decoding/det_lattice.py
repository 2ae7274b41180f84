"""Lattice determinization → CompactLattice.

Counterpart of ``kaldi_ctc_tpu/decoding/det_lattice.py``: the same host code over the
port's modules.

The src/lat/determinize-lattice-pruned slice the CTC decode path uses
(``DeterminizeLatticePhonePrunedWrapperCtc``, ``ctc/ctc-graph.cc:245-269``,
driven from ``ctc/ctc-decoder-wrappers.cc:27-126``): the raw lattice is
determinized on word sequences so each word sequence keeps exactly one
path — the lowest-cost one — with its frame alignment (ilabel string)
attached to the word arcs, CompactLattice-style.

Implementation: weighted subset determinization over the word-projected
acceptor.  Raw lattices are acyclic (tokens ordered by frame), so
epsilon (word-0) arcs are removed by closure first, then classic subset
construction with weight/string residuals and common-prefix extraction.
Weights are (graph, acoustic) pairs ordered by total cost, matching
LatticeWeight's ordering (``fstext/lattice-weight.h``).  Pruning happens
before determinization (Lattice.prune), mirroring the reference's
--prune-on-the-fly behaviour closely enough for decode-time use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, TextIO, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.decoding.lattice import Lattice

__all__ = ["CompactLattice", "determinize_lattice",
           "determinize_lattice_native", "determinize_lattice_pruned",
           "write_compact_lattice_text", "read_compact_lattice_text_ark"]

_INF = float("inf")


@dataclasses.dataclass
class CompactLattice:
    """Deterministic word lattice; arcs carry (word, weight pair, ilabels)."""

    start: int
    num_states: int
    arc_from: List[int]
    arc_to: List[int]
    arc_word: List[int]
    arc_graph_cost: List[float]
    arc_acoustic_cost: List[float]
    arc_ilabels: List[Tuple[int, ...]]   # frame alignment per word arc
    final_graph_cost: List[float]        # +inf = non-final
    final_acoustic_cost: List[float]
    final_ilabels: List[Tuple[int, ...]]

    @property
    def num_arcs(self) -> int:
        return len(self.arc_from)

    def best_path(self, acoustic_scale: float = 1.0, lm_scale: float = 1.0):
        """→ (words, alignment, total_cost) under scaled weights."""
        dist = [_INF] * self.num_states
        back = [-1] * self.num_states
        dist[self.start] = 0.0
        w = [lm_scale * g + acoustic_scale * a
             for g, a in zip(self.arc_graph_cost, self.arc_acoustic_cost)]
        for _ in range(self.num_states + 2):
            changed = False
            for i in range(self.num_arcs):
                v = dist[self.arc_from[i]] + w[i]
                if v < dist[self.arc_to[i]]:
                    dist[self.arc_to[i]] = v
                    back[self.arc_to[i]] = i
                    changed = True
            if not changed:
                break
        best_end, best_total = -1, _INF
        for s in range(self.num_states):
            if math.isinf(self.final_graph_cost[s]):
                continue
            v = dist[s] + lm_scale * self.final_graph_cost[s] + \
                acoustic_scale * self.final_acoustic_cost[s]
            if v < best_total:
                best_total, best_end = v, s
        if best_end < 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32), _INF
        words: List[int] = []
        align: List[int] = list(self.final_ilabels[best_end])
        s = best_end
        while back[s] != -1:
            i = back[s]
            if self.arc_word[i] != 0:
                words.append(self.arc_word[i])
            align[:0] = self.arc_ilabels[i]
            s = self.arc_from[i]
        words.reverse()
        return (np.asarray(words, np.int32), np.asarray(align, np.int32),
                float(best_total))


def _word_eps_closure(lat: Lattice):
    """Remove word-epsilon arcs: for each state, the set of states
    reachable via olabel-0 arcs with the best (cost pair, ilabel string)
    residual.  Acyclic, so iterate in reverse-relaxation style."""
    n = lat.num_states
    # adjacency of eps arcs
    eps_out: List[List[int]] = [[] for _ in range(n)]
    emit_out: List[List[int]] = [[] for _ in range(n)]
    for i in range(lat.num_arcs):
        (eps_out if lat.arc_olabel[i] == 0 else emit_out)[
            int(lat.arc_from[i])].append(i)

    cache: Dict[int, Dict[int, Tuple[float, float, Tuple[int, ...]]]] = {}

    def closure(s: int) -> Dict[int, Tuple[float, float, Tuple[int, ...]]]:
        """state -> {reach_state: (graph, acoustic, ilabels)} including s
        itself with zero residual."""
        if s in cache:
            return cache[s]
        out = {s: (0.0, 0.0, ())}
        stack = [(s, 0.0, 0.0, ())]
        while stack:
            u, g, a, il = stack.pop()
            for i in eps_out[u]:
                v = int(lat.arc_to[i])
                ng = g + float(lat.arc_graph_cost[i])
                na = a + float(lat.arc_acoustic_cost[i])
                nil = il + ((int(lat.arc_ilabel[i]),)
                            if lat.arc_ilabel[i] != 0 else ())
                cur = out.get(v)
                if cur is None or ng + na < cur[0] + cur[1]:
                    out[v] = (ng, na, nil)
                    stack.append((v, ng, na, nil))
        cache[s] = out
        return out

    return closure, emit_out


def determinize_lattice(lat: Lattice, det_beam: float = 10.0,
                        max_states: int = 200000) -> CompactLattice:
    """Weighted subset determinization on word labels.

    det_beam is the pruned-determinization bound
    (DeterminizeLatticePruned's beam): a subset element is dropped when
    its residual plus the lattice's backward (best-completion) cost is
    more than det_beam worse than the subset's best element's — such an
    element cannot contribute a path within det_beam of the subset's
    best, and unbounded residual diversity is what makes exact
    determinization blow up."""
    closure, emit_out = _word_eps_closure(lat)
    _, beta = lat._alpha_beta()
    best_total = float(beta[lat.start])  # global best path cost

    # a det-state is a frozenset of (lat_state, res_graph, res_acoustic,
    # res_ilabels); arc construction normalizes residuals so the best
    # element is (0,0) and the common ilabel prefix rides on the arc.
    # The initial subset keeps raw closure residuals (relative to the
    # zero start weight) — no normalization, so nothing is dropped even
    # when epsilon closure costs are negative.
    def _beam_prune(elems):
        totals = [g + a + beta[v] for v, g, a, _ in elems]
        best = min(totals)
        if math.isinf(best):   # no completion info: fall back to residuals
            best = min(g + a for _, g, a, _ in elems)
            return [e for e in elems if e[1] + e[2] <= best + det_beam]
        return [e for e, t in zip(elems, totals) if t <= best + det_beam]

    init_set = frozenset(_beam_prune([
        (v, round(g, 4), round(a, 4), il)
        for v, (g, a, il) in closure(lat.start).items()]))

    out = CompactLattice(start=0, num_states=0, arc_from=[], arc_to=[],
                         arc_word=[], arc_graph_cost=[],
                         arc_acoustic_cost=[], arc_ilabels=[],
                         final_graph_cost=[], final_acoustic_cost=[],
                         final_ilabels=[])

    ids: Dict[frozenset, int] = {}

    def state_id(subset) -> int:
        if subset not in ids:
            ids[subset] = out.num_states
            out.num_states += 1
            out.final_graph_cost.append(_INF)
            out.final_acoustic_cost.append(_INF)
            out.final_ilabels.append(())
        return ids[subset]

    start_id = state_id(init_set)
    out.start = start_id
    # forward cost of the det path that created each subset (first-visit;
    # approximate when acoustic costs are negative, conservative slack
    # below absorbs that).  Global prune: fw + best completion over the
    # subset must stay within det_beam of the global best path.
    fw: Dict[frozenset, float] = {init_set: 0.0}
    slack = 1e-3
    # leading weight/prefix of the initial subset folds into finals/arcs
    # naturally since residuals are relative; attach to nothing (start
    # weight is zero in our lattices: alpha[start]=0)
    queue = [init_set]
    seen = {init_set}
    guard = 0
    while queue:
        guard += 1
        if guard > max_states:
            raise RuntimeError(
                "determinization did not converge (try a smaller "
                "det_beam or prune the lattice first)")
        subset = queue.pop()
        sid = ids[subset]
        # finality: min over elements of residual + final cost
        bestf = None
        for s, g, a, il in subset:
            fg = float(lat.final_cost[s])
            if math.isinf(fg):
                continue
            tot = g + a + fg
            if bestf is None or tot < bestf[0]:
                bestf = (tot, g + fg, a, il)
        if bestf is not None:
            out.final_graph_cost[sid] = bestf[1]
            out.final_acoustic_cost[sid] = bestf[2]
            out.final_ilabels[sid] = bestf[3]
        # group outgoing emitting (word) transitions by word
        by_word: Dict[int, List[Tuple[int, float, float, Tuple[int, ...]]]] = {}
        for s, g, a, il in subset:
            for i in emit_out[s]:
                w = int(lat.arc_olabel[i])
                ng = g + float(lat.arc_graph_cost[i])
                na = a + float(lat.arc_acoustic_cost[i])
                nil = il + ((int(lat.arc_ilabel[i]),)
                            if lat.arc_ilabel[i] != 0 else ())
                # then closure from the arc target
                for v, (cg, ca, cil) in closure(int(lat.arc_to[i])).items():
                    by_word.setdefault(w, []).append(
                        (v, ng + cg, na + ca, nil + cil))
        for w, elems in by_word.items():
            # keep best residual per target state (tropical semiring)
            best_per: Dict[int, Tuple[int, float, float, Tuple[int, ...]]] = {}
            for v, g, a, il in elems:
                cur = best_per.get(v)
                if cur is None or g + a < cur[1] + cur[2]:
                    best_per[v] = (v, g, a, il)
            elems = list(best_per.values())
            strings = [il for _, _, _, il in elems]
            prefix = strings[0]
            for s_ in strings[1:]:
                k = 0
                while (k < len(prefix) and k < len(s_)
                       and prefix[k] == s_[k]):
                    k += 1
                prefix = prefix[:k]
            plen = len(prefix)
            # arc weight: put the min total on the arc, split as
            # (graph=min_tot, acoustic=0) is wrong — keep the pair of the
            # best element instead (reference keeps pairs exactly)
            best_elem = min(elems, key=lambda e: e[1] + e[2])
            arc_g, arc_a = best_elem[1], best_elem[2]
            norm_elems = _beam_prune([
                (v, round(g - arc_g, 4), round(a - arc_a, 4), il[plen:])
                for v, g, a, il in elems])
            fw_t = fw[subset] + arc_g + arc_a
            completion = min(g + a + beta[v] for v, g, a, _ in norm_elems)
            if fw_t + completion > best_total + det_beam + slack:
                continue  # no path through this arc is within det_beam
            norm = frozenset(norm_elems)
            tid = state_id(norm)
            fw[norm] = min(fw.get(norm, _INF), fw_t)
            out.arc_from.append(sid)
            out.arc_to.append(tid)
            out.arc_word.append(w)
            out.arc_graph_cost.append(arc_g)
            out.arc_acoustic_cost.append(arc_a)
            out.arc_ilabels.append(prefix)
            if norm not in seen:
                seen.add(norm)
                queue.append(norm)
    return out


def determinize_lattice_native(lat: Lattice, det_beam: float = 10.0,
                               max_states: int = 200000) -> CompactLattice:
    """C++ subset determinization (native/det_lattice.cc) — the same
    algorithm as determinize_lattice (which remains the tested reference
    implementation), built for decode-pipeline throughput.  Raises
    RuntimeError on blowup like the Python version."""
    import ctypes

    from kaldi_ctc_tpu_torch.decoding.wfst import _load
    lib = _load()
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    f32 = ctypes.POINTER(ctypes.c_float)

    def arr(x, dt):
        return np.ascontiguousarray(x, dt)

    fr = arr(lat.arc_from, np.int32)
    to = arr(lat.arc_to, np.int32)
    il = arr(lat.arc_ilabel, np.int32)
    ol = arr(lat.arc_olabel, np.int32)
    gc = arr(lat.arc_graph_cost, np.float32)
    ac = arr(lat.arc_acoustic_cost, np.float32)
    fc = arr(lat.final_cost, np.float32)
    h = lib.ctcn_det_lattice(
        lat.num_states, lat.start, lat.num_arcs,
        fr.ctypes.data_as(i32), to.ctypes.data_as(i32),
        il.ctypes.data_as(i32), ol.ctypes.data_as(i32),
        gc.ctypes.data_as(f32), ac.ctypes.data_as(f32),
        fc.ctypes.data_as(f32), det_beam, max_states)
    if not h:
        raise RuntimeError(
            "determinization did not converge (try a smaller "
            "det_beam or prune the lattice first)")
    try:
        n_states = lib.ctcn_clat_num_states(h)
        n_arcs = lib.ctcn_clat_num_arcs(h)
        a_fr = np.zeros(n_arcs, np.int32)
        a_to = np.zeros(n_arcs, np.int32)
        a_w = np.zeros(n_arcs, np.int32)
        a_g = np.zeros(n_arcs, np.float32)
        a_a = np.zeros(n_arcs, np.float32)
        a_off = np.zeros(n_arcs + 1, np.int64)
        a_il = np.zeros(max(lib.ctcn_clat_arc_ilabels_size(h), 1), np.int32)
        lib.ctcn_clat_get_arcs(
            h, a_fr.ctypes.data_as(i32), a_to.ctypes.data_as(i32),
            a_w.ctypes.data_as(i32), a_g.ctypes.data_as(f32),
            a_a.ctypes.data_as(f32), a_off.ctypes.data_as(i64),
            a_il.ctypes.data_as(i32))
        f_g = np.zeros(n_states, np.float32)
        f_a = np.zeros(n_states, np.float32)
        f_off = np.zeros(n_states + 1, np.int64)
        f_il = np.zeros(max(lib.ctcn_clat_final_ilabels_size(h), 1),
                        np.int32)
        lib.ctcn_clat_get_finals(
            h, f_g.ctypes.data_as(f32), f_a.ctypes.data_as(f32),
            f_off.ctypes.data_as(i64), f_il.ctypes.data_as(i32))
        start = int(lib.ctcn_clat_start(h))
    finally:
        lib.ctcn_clat_free(h)
    return CompactLattice(
        start=start, num_states=int(n_states),
        arc_from=a_fr.tolist(), arc_to=a_to.tolist(),
        arc_word=a_w.tolist(),
        arc_graph_cost=a_g.astype(float).tolist(),
        arc_acoustic_cost=a_a.astype(float).tolist(),
        arc_ilabels=[tuple(a_il[a_off[i]:a_off[i + 1]].tolist())
                     for i in range(n_arcs)],
        final_graph_cost=[float(x) if np.isfinite(x) else _INF
                          for x in f_g],
        final_acoustic_cost=[float(x) if np.isfinite(x) else _INF
                             for x in f_a],
        final_ilabels=[tuple(f_il[f_off[i]:f_off[i + 1]].tolist())
                       for i in range(n_states)])


def determinize_lattice_pruned(lat: Lattice, det_beam: float = 10.0,
                               max_states: int = 200000,
                               implementation: str = "native",
                               ) -> CompactLattice:
    """Determinize with beam backoff on blowup: halve the beam (pruning
    the input lattice to match) and retry, like the reference wrapper's
    retry loop (DeterminizeLatticePhonePrunedWrapper / ...WrapperCtc,
    ctc/ctc-graph.cc:245-269).  Always succeeds: at a small enough beam
    the lattice collapses toward its best path.

    implementation: "native" (C++, default) or "python" (the reference
    implementation the native one is parity-tested against)."""
    det = (determinize_lattice_native if implementation == "native"
           else determinize_lattice)
    beam = det_beam
    cur = lat
    while True:
        try:
            return det(cur, det_beam=beam, max_states=max_states)
        except RuntimeError:
            if beam <= 0.26:
                raise
            beam = beam / 2.0
            cur = cur.prune(beam)


# ---------------------------------------------------------------------------
# CompactLattice text I/O (Kaldi CompactLatticeWeight: g,a,il_il_il)
# ---------------------------------------------------------------------------

def write_compact_lattice_text(f: TextIO, key: str,
                               clat: CompactLattice) -> None:
    f.write(key + "\n")
    order = sorted(range(clat.num_arcs),
                   key=lambda i: (clat.arc_from[i] != clat.start,
                                  clat.arc_from[i]))
    for i in order:
        ils = "_".join(str(x) for x in clat.arc_ilabels[i])
        f.write(f"{clat.arc_from[i]}\t{clat.arc_to[i]}\t{clat.arc_word[i]}"
                f"\t{clat.arc_graph_cost[i]:.6g},"
                f"{clat.arc_acoustic_cost[i]:.6g},{ils}\n")
    for s in range(clat.num_states):
        if not math.isinf(clat.final_graph_cost[s]):
            ils = "_".join(str(x) for x in clat.final_ilabels[s])
            f.write(f"{s}\t{clat.final_graph_cost[s]:.6g},"
                    f"{clat.final_acoustic_cost[s]:.6g},{ils}\n")
    f.write("\n")


def read_compact_lattice_text_ark(
        path: str) -> Iterator[Tuple[str, CompactLattice]]:
    with open(path) as f:
        key = None
        arcs: List[tuple] = []
        finals: Dict[int, tuple] = {}
        for raw in f:
            line = raw.rstrip("\n")
            if key is None:
                if line.strip():
                    key = line.strip().split()[0]
                    arcs, finals = [], {}
                continue
            if not line.strip():
                yield key, _assemble_compact(arcs, finals)
                key = None
                continue
            parts = line.split()
            if len(parts) >= 4:
                frm, to, w = int(parts[0]), int(parts[1]), int(parts[2])
                g, a, ils = _parse_clat_weight(parts[3])
                arcs.append((frm, to, w, g, a, ils))
            elif len(parts) == 3:
                # weightless arc line (OpenFst text: implicit One weight)
                arcs.append((int(parts[0]), int(parts[1]), int(parts[2]),
                             0.0, 0.0, ()))
            elif len(parts) >= 2:
                s = int(parts[0])
                g, a, ils = _parse_clat_weight(parts[1])
                finals[s] = (g, a, ils)
            elif len(parts) == 1:
                finals[int(parts[0])] = (0.0, 0.0, ())
        if key is not None:
            yield key, _assemble_compact(arcs, finals)


def _parse_clat_weight(s: str):
    comps = s.split(",")
    g = float(comps[0]) if comps and comps[0] else 0.0
    a = float(comps[1]) if len(comps) > 1 and comps[1] else 0.0
    ils: Tuple[int, ...] = ()
    if len(comps) > 2 and comps[2]:
        ils = tuple(int(x) for x in comps[2].split("_") if x)
    return g, a, ils


def _assemble_compact(arcs, finals) -> CompactLattice:
    n = 1
    for a in arcs:
        n = max(n, a[0] + 1, a[1] + 1)
    for s in finals:
        n = max(n, s + 1)
    clat = CompactLattice(
        start=arcs[0][0] if arcs else 0, num_states=n,
        arc_from=[a[0] for a in arcs], arc_to=[a[1] for a in arcs],
        arc_word=[a[2] for a in arcs],
        arc_graph_cost=[a[3] for a in arcs],
        arc_acoustic_cost=[a[4] for a in arcs],
        arc_ilabels=[a[5] for a in arcs],
        final_graph_cost=[_INF] * n, final_acoustic_cost=[_INF] * n,
        final_ilabels=[()] * n)
    for s, (g, a, ils) in finals.items():
        clat.final_graph_cost[s] = g
        clat.final_acoustic_cost[s] = a
        clat.final_ilabels[s] = ils
    return clat
