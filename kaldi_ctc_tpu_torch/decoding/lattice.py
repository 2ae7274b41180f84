"""Lattices: generation binding, weight ops, best path, Kaldi text I/O.

Counterpart of ``kaldi_ctc_tpu/decoding/lattice.py``: the same host code over the
port's modules.

The src/lat/ slice the CTC decode path needs
(``lat/kaldi-lattice.h`` Lattice type + ``lat/lattice-functions.{h,cc}``
scale/prune/best-path as driven by ``ctc/ctc-decoder-wrappers.cc:27-126``
and scored by ``steps/ctc/decode.sh:169-176`` / local/score.sh's LM-weight
sweep).  Weights are (graph_cost, acoustic_cost) pairs — the LatticeWeight
semiring (``fstext/lattice-weight.h``); scaling multiplies the two
components independently (lattice-scale semantics).

Text I/O uses Kaldi's lattice text-archive format (one utterance: key
line, arc/final lines ``from [to ilabel olabel] graph,acoustic``, blank
line) so lattices interoperate with Kaldi's lattice-* tools.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, TextIO, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst, _load

__all__ = ["Lattice", "decode_lattice", "write_lattice_text",
           "read_lattice_text_ark", "LatticeWriter"]

_INF = float("inf")


@dataclasses.dataclass
class Lattice:
    """Raw lattice DAG with LatticeWeight-style (graph, acoustic) costs."""

    start: int
    num_states: int
    arc_from: np.ndarray       # [A] int32
    arc_to: np.ndarray         # [A] int32
    arc_ilabel: np.ndarray     # [A] int32 (graph labels, CTC-shifted)
    arc_olabel: np.ndarray     # [A] int32 (word ids)
    arc_graph_cost: np.ndarray     # [A] f32
    arc_acoustic_cost: np.ndarray  # [A] f32
    final_cost: np.ndarray     # [S] f32, +inf = non-final
    state_frame: Optional[np.ndarray] = None  # [S] int32

    @property
    def num_arcs(self) -> int:
        return int(self.arc_from.shape[0])

    def scale(self, acoustic_scale: float = 1.0,
              lm_scale: float = 1.0) -> "Lattice":
        """lattice-scale: scale the two weight components independently.
        (ScaleLattice with a diagonal scale matrix; graph component is
        scaled by lm_scale, acoustic by acoustic_scale.)"""
        return dataclasses.replace(
            self,
            arc_graph_cost=self.arc_graph_cost * np.float32(lm_scale),
            arc_acoustic_cost=(self.arc_acoustic_cost
                               * np.float32(acoustic_scale)),
            final_cost=np.where(np.isinf(self.final_cost), self.final_cost,
                                self.final_cost * np.float32(lm_scale)),
        )

    def _alpha_beta(self) -> Tuple[np.ndarray, np.ndarray]:
        """Shortest-distance forward/backward over total cost."""
        w = self.arc_graph_cost.astype(np.float64) + \
            self.arc_acoustic_cost.astype(np.float64)
        alpha = np.full(self.num_states, _INF)
        alpha[self.start] = 0.0
        # relaxation to fixpoint (states are near-topological; few passes)
        for _ in range(self.num_states + 2):
            changed = False
            for i in range(self.num_arcs):
                v = alpha[self.arc_from[i]] + w[i]
                if v < alpha[self.arc_to[i]]:
                    alpha[self.arc_to[i]] = v
                    changed = True
            if not changed:
                break
        beta = np.where(np.isinf(self.final_cost), _INF,
                        self.final_cost.astype(np.float64))
        for _ in range(self.num_states + 2):
            changed = False
            for i in range(self.num_arcs - 1, -1, -1):
                f = self.arc_from[i]
                v = beta[self.arc_to[i]] + w[i]
                if v < beta[f]:
                    beta[f] = v
                    changed = True
            if not changed:
                break
        return alpha, beta

    def prune(self, beam: float) -> "Lattice":
        """Keep states/arcs within `beam` of the best path
        (lat/lattice-functions PruneLattice)."""
        alpha, beta = self._alpha_beta()
        bound = beta[self.start] + beam
        keep_state = (alpha + beta) <= bound
        remap = np.cumsum(keep_state) - 1
        w = self.arc_graph_cost.astype(np.float64) + \
            self.arc_acoustic_cost.astype(np.float64)
        through = alpha[self.arc_from] + w + beta[self.arc_to]
        keep_arc = (through <= bound) & keep_state[self.arc_from] & \
            keep_state[self.arc_to]
        return Lattice(
            start=int(remap[self.start]),
            num_states=int(keep_state.sum()),
            arc_from=remap[self.arc_from[keep_arc]].astype(np.int32),
            arc_to=remap[self.arc_to[keep_arc]].astype(np.int32),
            arc_ilabel=self.arc_ilabel[keep_arc],
            arc_olabel=self.arc_olabel[keep_arc],
            arc_graph_cost=self.arc_graph_cost[keep_arc],
            arc_acoustic_cost=self.arc_acoustic_cost[keep_arc],
            final_cost=self.final_cost[keep_state],
            state_frame=(self.state_frame[keep_state]
                         if self.state_frame is not None else None),
        )

    def arc_posteriors(self, acoustic_scale: float = 1.0,
                       lm_scale: float = 1.0) -> np.ndarray:
        """Per-arc posterior probabilities by log-domain forward-backward
        (lat/lattice-functions ComputeLatticeAlphasAndBetas +
        LatticeForwardBackward as used by lattice-arc-post)."""
        ll = -(lm_scale * self.arc_graph_cost.astype(np.float64)
               + acoustic_scale * self.arc_acoustic_cost.astype(np.float64))
        order = self._topo_order()
        rank = np.full(self.num_states, -1, np.int64)
        for i, s in enumerate(order):
            rank[s] = i
        alpha = np.full(self.num_states, -np.inf)
        alpha[self.start] = 0.0
        arc_order = np.argsort(rank[self.arc_from], kind="stable")
        for i in arc_order:
            f, t = self.arc_from[i], self.arc_to[i]
            if rank[f] < 0:
                continue
            alpha[t] = np.logaddexp(alpha[t], alpha[f] + ll[i])
        final_ll = np.where(np.isinf(self.final_cost), -np.inf,
                            -lm_scale * self.final_cost.astype(np.float64))
        beta = final_ll.copy()
        for i in arc_order[::-1]:
            f, t = self.arc_from[i], self.arc_to[i]
            beta[f] = np.logaddexp(beta[f], beta[t] + ll[i])
        with np.errstate(invalid="ignore"):
            tot = np.logaddexp.reduce(alpha + final_ll)
        if not np.isfinite(tot):
            return np.zeros(self.num_arcs)
        post = np.exp(alpha[self.arc_from] + ll + beta[self.arc_to] - tot)
        return np.where(np.isfinite(post), post, 0.0)

    def _topo_order(self) -> List[int]:
        """Kahn topological order over states reachable from start."""
        n = self.num_states
        adj: List[List[int]] = [[] for _ in range(n)]
        for i in range(self.num_arcs):
            adj[self.arc_from[i]].append(self.arc_to[i])
        reach = np.zeros(n, bool)
        stack = [int(self.start)]
        reach[self.start] = True
        while stack:
            s = stack.pop()
            for t in adj[s]:
                if not reach[t]:
                    reach[t] = True
                    stack.append(t)
        indeg = np.zeros(n, np.int64)
        for i in range(self.num_arcs):
            if reach[self.arc_from[i]] and reach[self.arc_to[i]]:
                indeg[self.arc_to[i]] += 1
        out: List[int] = []
        stack = [int(self.start)]
        while stack:
            s = stack.pop()
            out.append(s)
            for t in adj[s]:
                if not reach[t]:
                    continue
                indeg[t] -= 1
                if indeg[t] == 0:
                    stack.append(t)
        if len(out) != int(reach.sum()):
            raise ValueError("cycle detected in lattice")
        return out

    def nbest(self, n: int, acoustic_scale: float = 1.0,
              lm_scale: float = 1.0, max_pops: int = 200000):
        """N best distinct paths (lattice-nbest): A* over partial paths
        with the exact backward best-cost as (admissible) heuristic.
        → list of (words, alignment, total_cost), best first."""
        import heapq

        w = (lm_scale * self.arc_graph_cost.astype(np.float64)
             + acoustic_scale * self.arc_acoustic_cost.astype(np.float64))
        fc = np.where(np.isinf(self.final_cost), _INF,
                      lm_scale * self.final_cost.astype(np.float64))
        # exact heuristic: best completion cost per state
        beta = fc.copy()
        for _ in range(self.num_states + 2):
            changed = False
            for i in range(self.num_arcs - 1, -1, -1):
                v = beta[self.arc_to[i]] + w[i]
                if v < beta[self.arc_from[i]]:
                    beta[self.arc_from[i]] = v
                    changed = True
            if not changed:
                break
        by_state: List[List[int]] = [[] for _ in range(self.num_states)]
        for i in range(self.num_arcs):
            by_state[self.arc_from[i]].append(i)
        results = []
        seen_words = set()
        if math.isinf(beta[self.start]):
            return results
        # heap entries: (f = g + h, tiebreak, state, g, arc-trace)
        tiebreak = 0
        heap = [(float(beta[self.start]), 0, int(self.start), 0.0, ())]
        pops = 0
        while heap and len(results) < n and pops < max_pops:
            f, _, s, g, trace = heapq.heappop(heap)
            pops += 1
            if not math.isinf(fc[s]):
                words = tuple(int(self.arc_olabel[i]) for i in trace
                              if self.arc_olabel[i] != 0)
                if words not in seen_words:
                    seen_words.add(words)
                    align = np.asarray(
                        [int(self.arc_ilabel[i]) for i in trace
                         if self.arc_ilabel[i] != 0], np.int32)
                    results.append((np.asarray(words, np.int32), align,
                                    float(g + fc[s])))
            for i in by_state[s]:
                g2 = g + float(w[i])
                h = beta[self.arc_to[i]]
                if math.isinf(h):
                    continue
                tiebreak += 1
                heapq.heappush(heap, (g2 + float(h), tiebreak,
                                      int(self.arc_to[i]), g2,
                                      trace + (i,)))
        return results

    def best_path(self, acoustic_scale: float = 1.0,
                  lm_scale: float = 1.0):
        """Shortest path under scaled weights → (words, alignment,
        total_cost).  The CompactLatticeShortestPath + scale analogue used
        by scoring's LM-weight sweep (best WER path at each scale)."""
        w = (lm_scale * self.arc_graph_cost.astype(np.float64)
             + acoustic_scale * self.arc_acoustic_cost.astype(np.float64))
        dist = np.full(self.num_states, _INF)
        back: List[int] = [-1] * self.num_states
        dist[self.start] = 0.0
        for _ in range(self.num_states + 2):
            changed = False
            for i in range(self.num_arcs):
                f, t = self.arc_from[i], self.arc_to[i]
                v = dist[f] + w[i]
                if v < dist[t]:
                    dist[t] = v
                    back[t] = i
                    changed = True
            if not changed:
                break
        fc = np.where(np.isinf(self.final_cost), _INF,
                      lm_scale * self.final_cost.astype(np.float64))
        totals = dist + fc
        end = int(np.argmin(totals))
        if math.isinf(totals[end]):
            return np.zeros(0, np.int32), np.zeros(0, np.int32), _INF
        words: List[int] = []
        align: List[int] = []
        s = end
        while back[s] != -1:
            i = back[s]
            if self.arc_olabel[i] != 0:
                words.append(int(self.arc_olabel[i]))
            if self.arc_ilabel[i] != 0:
                align.append(int(self.arc_ilabel[i]))
            s = int(self.arc_from[i])
        words.reverse()
        align.reverse()
        return (np.asarray(words, np.int32), np.asarray(align, np.int32),
                float(totals[end]))


def decode_lattice(
    fst: NativeFst,
    scores: np.ndarray,                 # [T, A] higher-better log scores
    ilabel_map: Optional[np.ndarray] = None,
    beam: float = 16.0,
    max_active: int = 7000,
    acoustic_scale: float = 1.0,
    lattice_beam: float = 10.0,
) -> Lattice:
    """Run the native lattice decoder (native/lattice.cc DecodeLattice).

    Raises RuntimeError on decode failure (everything pruned)."""
    lib = _load()
    scores = np.ascontiguousarray(scores, np.float32)
    t, a = scores.shape
    if ilabel_map is None:
        ilabel_map = np.concatenate(
            [[-1], np.arange(a, dtype=np.int32)]).astype(np.int32)
    ilabel_map = np.ascontiguousarray(ilabel_map, np.int32)
    h = lib.ctcn_decode_lattice(
        fst._h, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, a, ilabel_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ilabel_map.shape[0], beam, max_active, acoustic_scale, lattice_beam)
    if not h:
        raise RuntimeError("lattice decode failed (all tokens pruned?)")
    try:
        n_states = lib.ctcn_lat_num_states(h)
        n_arcs = lib.ctcn_lat_num_arcs(h)
        i32 = ctypes.POINTER(ctypes.c_int32)
        f32 = ctypes.POINTER(ctypes.c_float)
        fr = np.zeros(n_arcs, np.int32); to = np.zeros(n_arcs, np.int32)
        il = np.zeros(n_arcs, np.int32); ol = np.zeros(n_arcs, np.int32)
        gc = np.zeros(n_arcs, np.float32); ac = np.zeros(n_arcs, np.float32)
        if n_arcs:
            lib.ctcn_lat_get_arcs(
                h, fr.ctypes.data_as(i32), to.ctypes.data_as(i32),
                il.ctypes.data_as(i32), ol.ctypes.data_as(i32),
                gc.ctypes.data_as(f32), ac.ctypes.data_as(f32))
        finals = np.zeros(n_states, np.float32)
        frames = np.zeros(n_states, np.int32)
        if n_states:
            lib.ctcn_lat_get_finals(h, finals.ctypes.data_as(f32))
            lib.ctcn_lat_get_frames(h, frames.ctypes.data_as(i32))
        return Lattice(
            start=int(lib.ctcn_lat_start(h)), num_states=int(n_states),
            arc_from=fr, arc_to=to, arc_ilabel=il, arc_olabel=ol,
            arc_graph_cost=gc, arc_acoustic_cost=ac, final_cost=finals,
            state_frame=frames)
    finally:
        lib.ctcn_lat_free(h)


# ---------------------------------------------------------------------------
# Kaldi lattice text-archive I/O
# ---------------------------------------------------------------------------

def write_lattice_text(f: TextIO, key: str, lat: Lattice) -> None:
    """One text-archive record: Kaldi Lattice format (LatticeWeight
    prints as graph,acoustic; fst text lines; blank line terminator)."""
    f.write(key + "\n")
    # arcs grouped by source state, start state's arcs first (Kaldi
    # requires the first line to involve the start state)
    order = np.argsort(np.where(lat.arc_from == lat.start, -1, lat.arc_from),
                       kind="stable")
    for i in order:
        f.write(f"{lat.arc_from[i]}\t{lat.arc_to[i]}\t{lat.arc_ilabel[i]}"
                f"\t{lat.arc_olabel[i]}\t{lat.arc_graph_cost[i]:.6g},"
                f"{lat.arc_acoustic_cost[i]:.6g}\n")
    for s in range(lat.num_states):
        fc = lat.final_cost[s]
        if not math.isinf(fc):
            f.write(f"{s}\t{fc:.6g},0\n")
    f.write("\n")


class LatticeWriter:
    """Text lattice archive writer (``ark,t:`` style)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, key: str, lat: Lattice) -> None:
        write_lattice_text(self._f, key, lat)

    def __setitem__(self, key, lat):
        self.write(key, lat)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_lattice_text_ark(path: str) -> Iterator[Tuple[str, Lattice]]:
    """Read a text lattice archive written by write_lattice_text (also
    reads Kaldi lattice-copy text output for Lattice-type lattices)."""
    with open(path) as f:
        key = None
        arcs: List[Tuple[int, int, int, int, float, float]] = []
        finals: Dict[int, float] = {}
        for raw in f:
            line = raw.rstrip("\n")
            if key is None:
                if line.strip():
                    key = line.strip().split()[0]
                    arcs, finals = [], {}
                continue
            if not line.strip():
                yield key, _assemble(arcs, finals)
                key = None
                continue
            parts = line.split()
            if len(parts) >= 4:
                frm, to, il, ol = (int(parts[0]), int(parts[1]),
                                   int(parts[2]), int(parts[3]))
                gc, ac = 0.0, 0.0
                if len(parts) >= 5:
                    comps = parts[4].split(",")
                    gc = float(comps[0]) if comps[0] else 0.0
                    ac = float(comps[1]) if len(comps) > 1 and comps[1] \
                        else 0.0
                arcs.append((frm, to, il, ol, gc, ac))
            elif len(parts) >= 1:
                s = int(parts[0])
                gc = 0.0
                if len(parts) >= 2:
                    # LatticeWeight final "g,a": Lattice keeps one final
                    # cost, so fold both components in (same convention
                    # as the binary reader; our own writer emits a=0)
                    comps = parts[1].split(",")
                    gc = float(comps[0]) if comps[0] else 0.0
                    if len(comps) > 1 and comps[1]:
                        gc += float(comps[1])
                finals[s] = gc
        if key is not None:
            yield key, _assemble(arcs, finals)


def _assemble(arcs, finals) -> Lattice:
    n_states = 0
    for a in arcs:
        n_states = max(n_states, a[0] + 1, a[1] + 1)
    for s in finals:
        n_states = max(n_states, s + 1)
    fr = np.asarray([a[0] for a in arcs], np.int32)
    to = np.asarray([a[1] for a in arcs], np.int32)
    il = np.asarray([a[2] for a in arcs], np.int32)
    ol = np.asarray([a[3] for a in arcs], np.int32)
    gc = np.asarray([a[4] for a in arcs], np.float32)
    ac = np.asarray([a[5] for a in arcs], np.float32)
    fc = np.full(max(n_states, 1), _INF, np.float32)
    for s, c in finals.items():
        fc[s] = c
    start = int(arcs[0][0]) if arcs else 0
    return Lattice(start=start, num_states=max(n_states, 1), arc_from=fr,
                   arc_to=to, arc_ilabel=il, arc_olabel=ol,
                   arc_graph_cost=gc, arc_acoustic_cost=ac, final_cost=fc)
