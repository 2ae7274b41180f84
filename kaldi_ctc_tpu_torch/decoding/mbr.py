"""Minimum Bayes Risk decoding and confusion networks ("sausages").

Counterpart of ``kaldi_ctc_tpu/decoding/mbr.py``: the same host code over the
port's modules.

The ``lat/sausages.{h,cc}`` subsystem of the reference: word-level MBR
decoding by the edit-distance recursion of Xu, Povey, Mangu & Zhu,
"Minimum Bayes Risk decoding and system combination based on a recursion
for edit distance" (Computer Speech and Language, 2011) — implemented
here from the paper's Figures 4-6 (forward edit-distance recursion,
statistics accumulation, MBR decode loop).

Outputs match the reference class surface (``lat/sausages.h:60-104``):
the MBR one-best, the expected Bayes risk, sausage bins with word
posteriors (confusion network), bin times, and per-word confidences.

Inputs are word-level :class:`CompactLattice` objects (determinized
lattices); acoustic/LM scaling is applied by the caller, as in
``lattice-mbr-decode``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.decoding.det_lattice import CompactLattice

__all__ = ["MinimumBayesRisk", "compact_lattice_state_times"]

_DELTA = 1.0e-05   # the paper's small insertion penalty (sausages.h:132)


def compact_lattice_state_times(clat: CompactLattice) -> List[int]:
    """Frame index of each state (CompactLatticeStateTimes): length of the
    arc alignment strings along paths from the start.  States reached by
    paths of different lengths take the max (lattices from the pruned
    determinizer are aligned, so paths normally agree)."""
    times = [-1] * clat.num_states
    times[clat.start] = 0
    # relax to fixpoint (lattices are DAGs; a couple of passes suffice)
    for _ in range(clat.num_states + 2):
        changed = False
        for i in range(clat.num_arcs):
            t = times[clat.arc_from[i]]
            if t < 0:
                continue
            v = t + len(clat.arc_ilabels[i])
            if v > times[clat.arc_to[i]]:
                times[clat.arc_to[i]] = v
                changed = True
        if not changed:
            break
    return [max(t, 0) for t in times]


def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


class MinimumBayesRisk:
    """MBR decode + sausage statistics over a CompactLattice.

    Attributes after construction:
      one_best              MBR (or MAP if do_mbr=False) word sequence
      bayes_risk            expected edit distance of one_best vs lattice
      sausage               list of bins; each bin is [(word, posterior)]
                            sorted by descending posterior (word 0 = eps)
      times                 per-bin (start, end) average frame times
      one_best_times        subsequence of times for non-eps one_best bins
      one_best_confidences  posterior of each one_best word in its bin
    """

    def __init__(self, clat: CompactLattice, do_mbr: bool = True,
                 words: Optional[Sequence[int]] = None,
                 acoustic_scale: float = 1.0, lm_scale: float = 1.0):
        self.do_mbr = do_mbr
        self._prepare(clat, acoustic_scale, lm_scale)
        if words is not None:
            self._R = [int(w) for w in words if w != 0]
        else:
            w, _, cost = clat.best_path(acoustic_scale=acoustic_scale,
                                        lm_scale=lm_scale)
            if math.isinf(cost):
                raise ValueError("lattice has no successful path")
            self._R = [int(x) for x in w]
        self._L = 0.0
        self._decode()

    # -- lattice preparation (PrepareLatticeAndInitStats analogue) --------

    def _prepare(self, clat: CompactLattice, acoustic_scale: float,
                 lm_scale: float) -> None:
        state_times = compact_lattice_state_times(clat)
        # super-final state so the algorithm sees exactly one final state
        n = clat.num_states
        superfinal = n
        arcs: List[Tuple[int, int, int, float]] = []  # (from, to, word, ll)
        for i in range(clat.num_arcs):
            ll = -(lm_scale * clat.arc_graph_cost[i] +
                   acoustic_scale * clat.arc_acoustic_cost[i])
            arcs.append((clat.arc_from[i], clat.arc_to[i],
                         int(clat.arc_word[i]), float(ll)))
        max_time = max(state_times) if state_times else 0
        for s in range(n):
            if math.isinf(clat.final_graph_cost[s]):
                continue
            ll = -(lm_scale * clat.final_graph_cost[s] +
                   acoustic_scale * clat.final_acoustic_cost[s])
            arcs.append((s, superfinal, 0, float(ll)))
        state_times = state_times + [max_time]
        n += 1

        # drop non-coaccessible dead-ends first: with them gone every
        # other state has a path to the superfinal, so any topological
        # order necessarily puts the superfinal last (the recursions
        # below index it as node N)
        coacc = [False] * n
        coacc[superfinal] = True
        back: List[List[int]] = [[] for _ in range(n)]
        for (f, t, _w, _ll) in arcs:
            back[t].append(f)
        stack = [superfinal]
        while stack:
            s = stack.pop()
            for f in back[s]:
                if not coacc[f]:
                    coacc[f] = True
                    stack.append(f)
        if not coacc[clat.start]:
            raise ValueError("no path from start to a final state")
        arcs = [a for a in arcs if coacc[a[0]] and coacc[a[1]]]

        # topological order (lattices are DAGs)
        order = self._topo_order(n, clat.start, arcs)
        rank = {s: i + 1 for i, s in enumerate(order)}  # 1-based nodes
        if rank.get(clat.start) != 1:
            raise ValueError("start state must sort first")
        if rank.get(superfinal) != len(order):
            raise ValueError("superfinal state must sort last")
        self._N = len(order)
        self._state_times = [0.0] * (self._N + 1)
        for s, r_ in rank.items():
            self._state_times[r_] = float(state_times[s])
        # arcs in 1-based node numbering; pre_[n] = incoming arc indices
        self._arcs: List[Tuple[int, int, int, float]] = []
        self._pre: List[List[int]] = [[] for _ in range(self._N + 1)]
        for (f, t, w, ll) in arcs:
            if f not in rank or t not in rank:
                continue  # unreachable
            a = (rank[f], rank[t], w, ll)
            self._pre[rank[t]].append(len(self._arcs))
            self._arcs.append(a)

    @staticmethod
    def _topo_order(n: int, start: int,
                    arcs: List[Tuple[int, int, int, float]]) -> List[int]:
        adj: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for (f, t, _, _) in arcs:
            adj[f].append(t)
            indeg[t] += 1
        # only states reachable from start participate
        reach = [False] * n
        stack = [start]
        reach[start] = True
        while stack:
            s = stack.pop()
            for t in adj[s]:
                if not reach[t]:
                    reach[t] = True
                    stack.append(t)
        indeg = [0] * n
        for (f, t, _, _) in arcs:
            if reach[f] and reach[t]:
                indeg[t] += 1
        out = []
        stack = [start]
        while stack:
            s = stack.pop()
            out.append(s)
            for t in adj[s]:
                if not reach[t]:
                    continue
                indeg[t] -= 1
                if indeg[t] == 0:
                    stack.append(t)
        if len(out) != sum(reach):
            raise ValueError("cycle detected in lattice")
        return out

    # -- the paper's recursions ------------------------------------------

    @staticmethod
    def _normalize_eps(r: List[int]) -> List[int]:
        r = [w for w in r if w != 0]
        out = [0]
        for w in r:
            out += [w, 0]
        return out

    def _edit_distance(self, R: List[int], alpha: np.ndarray,
                       alpha_dash: np.ndarray) -> float:
        """Figure 4: forward edit-distance recursion.  Fills alpha (log
        forward probs) and alpha_dash (expected partial edit distance)."""
        N, Q = self._N, len(R)
        alpha[1] = 0.0
        alpha_dash[1, 0] = 0.0
        for q in range(1, Q + 1):
            alpha_dash[1, q] = alpha_dash[1, q - 1] + (R[q - 1] != 0)
        arc_buf = np.zeros(Q + 1)
        for node in range(2, N + 1):
            a = -math.inf
            for i in self._pre[node]:
                sa, _, _, ll = self._arcs[i]
                a = _log_add(a, alpha[sa] + ll)
            alpha[node] = a
            alpha_dash[node, :] = 0.0
            for i in self._pre[node]:
                sa, _, wa, ll = self._arcs[i]
                occ = math.exp(alpha[sa] + ll - alpha[node])
                # q = 0: only deletion of the arc word is possible
                arc_buf[0] = alpha_dash[sa, 0] + (wa != 0) + _DELTA
                row = alpha_dash[sa]
                for q in range(1, Q + 1):
                    rq = R[q - 1]
                    a1 = row[q - 1] + (0.0 if wa == rq else 1.0)
                    a2 = row[q] + (wa != 0) + _DELTA
                    a3 = arc_buf[q - 1] + (rq != 0)
                    arc_buf[q] = min(a1, a2, a3)
                alpha_dash[node, :] += occ * arc_buf
        return float(alpha_dash[N, Q])

    def _acc_stats(self) -> Tuple[float, List[Dict[int, float]],
                                  np.ndarray, np.ndarray]:
        """Figure 5: accumulate per-position word posteriors gamma and the
        bin time statistics, via traceback of the forward recursion."""
        R = self._R_norm
        N, Q = self._N, len(R)
        alpha = np.full(N + 1, -math.inf)
        alpha_dash = np.zeros((N + 1, Q + 1))
        L = self._edit_distance(R, alpha, alpha_dash)

        beta_dash = np.zeros((N + 1, Q + 1))
        beta_dash[N, Q] = 1.0
        gamma: List[Dict[int, float]] = [dict() for _ in range(Q + 1)]
        tau_b = np.zeros(Q + 1)
        tau_e = np.zeros(Q + 1)
        arc_alpha = np.zeros(Q + 1)
        b_arc = np.zeros(Q + 1, np.int8)

        def add(q: int, w: int, d: float) -> None:
            if d != 0.0:
                gamma[q][w] = gamma[q].get(w, 0.0) + d

        for node in range(N, 1, -1):
            for i in self._pre[node]:
                sa, _, wa, ll = self._arcs[i]
                occ = math.exp(alpha[sa] + ll - alpha[node])
                row = alpha_dash[sa]
                arc_alpha[0] = row[0] + (wa != 0) + _DELTA
                for q in range(1, Q + 1):
                    rq = R[q - 1]
                    a1 = row[q - 1] + (0.0 if wa == rq else 1.0)
                    a2 = row[q] + (wa != 0) + _DELTA
                    a3 = arc_alpha[q - 1] + (rq != 0)
                    if a1 <= a2:
                        if a1 <= a3:
                            b_arc[q] = 1
                            arc_alpha[q] = a1
                        else:
                            b_arc[q] = 3
                            arc_alpha[q] = a3
                    else:
                        if a2 <= a3:
                            b_arc[q] = 2
                            arc_alpha[q] = a2
                        else:
                            b_arc[q] = 3
                            arc_alpha[q] = a3
                beta_arc = np.zeros(Q + 1)
                for q in range(Q, 0, -1):
                    beta_arc[q] += occ * beta_dash[node, q]
                    v = beta_arc[q]
                    if b_arc[q] == 1:       # substitution/match
                        beta_dash[sa, q - 1] += v
                        add(q, wa, v)
                        tau_b[q] += self._state_times[sa] * v
                        tau_e[q] += self._state_times[node] * v
                    elif b_arc[q] == 2:     # deletion of arc word
                        beta_dash[sa, q] += v
                    else:                   # insertion: eps aligns to r_q
                        beta_arc[q - 1] += v
                        add(q, 0, v)
                        # both times from the arc's END node (the paper's
                        # Appendix C erratum — see sausages.cc:203-208)
                        tau_b[q] += self._state_times[node] * v
                        tau_e[q] += self._state_times[node] * v
                beta_arc[0] += occ * beta_dash[node, 0]
                beta_dash[sa, 0] += beta_arc[0]
        # initial-state residuals (Figure 5 lines 29-34)
        carry = 0.0
        for q in range(Q, 0, -1):
            carry = beta_dash[1, q] + carry
            add(q, 0, carry)
            tau_b[q] += self._state_times[1] * carry
            tau_e[q] += self._state_times[1] * carry
        return L, gamma, tau_b, tau_e

    def _decode(self) -> None:
        """Figure 6: iterate stats accumulation and per-bin argmax."""
        for counter in range(101):
            self._R_norm = self._normalize_eps(self._R)
            L, gamma, tau_b, tau_e = self._acc_stats()
            Q = len(self._R_norm)
            bins: List[List[Tuple[int, float]]] = []
            times: List[Tuple[float, float]] = []
            for q in range(1, Q + 1):
                items = sorted(gamma[q].items(),
                               key=lambda kv: (-kv[1], kv[0]))
                if not items:
                    items = [(0, 1.0)]
                bins.append([(w, float(p)) for w, p in items])
                times.append((float(tau_b[q]), float(tau_e[q])))
            # repair out-of-order bin boundaries (sausages.cc:318-326)
            for q in range(1, len(times)):
                if times[q - 1][1] > times[q][0]:
                    avg = 0.5 * (times[q - 1][1] + times[q][0])
                    times[q - 1] = (times[q - 1][0], avg)
                    times[q] = (avg, times[q][1])
            delta_q = 0.0
            new_R = list(self._R_norm)
            for q in range(Q):
                rq = new_R[q]
                rhat, new_g = bins[q][0]
                old_g = 0.0
                for w, p in bins[q]:
                    if w == rq:
                        old_g = p
                        break
                if self.do_mbr:
                    delta_q += old_g - new_g
                    new_R[q] = rhat
            self._L = L
            self.sausage = bins
            self.times = times
            self._R = [w for w in new_R if w != 0]
            if not self.do_mbr or delta_q == 0.0:
                break
        # one-best outputs from the final sausage
        self.one_best = list(self._R)
        self.bayes_risk = float(self._L)
        self.one_best_times = []
        self.one_best_confidences = []
        final_R = self._normalize_eps(self._R)
        for q, w in enumerate(final_R):
            if w == 0 or q >= len(self.sausage):
                continue
            conf = 0.0
            for ww, p in self.sausage[q]:
                if ww == w:
                    conf = p
                    break
            self.one_best_times.append(self.times[q])
            self.one_best_confidences.append(conf)
