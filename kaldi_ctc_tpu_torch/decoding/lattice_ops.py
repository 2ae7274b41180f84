"""CompactLattice push and minimize (lattice-push / lattice-minimize).

Counterpart of ``kaldi_ctc_tpu/decoding/lattice_ops.py``: the same host code over the
port's modules.

Mirrors the reference semantics of ``lat/push-lattice.cc`` and
``lat/minimize-lattice.cc``:

* ``push_compact_lattice_strings`` — move the per-arc frame-alignment
  strings (ilabel sequences) as far toward the start state as possible
  without changing any path's string (``push-lattice.cc:30-206``,
  CompactLatticePusher).  For every state, the longest common prefix of
  all outgoing (arc string + onward string) continuations is hoisted
  onto the incoming side.
* ``push_compact_lattice_weights`` — weight pushing in the
  LatticeWeight (graph, acoustic) semiring: every state's
  "weight to the end" becomes One, with the leftover left on the start
  state (``push-lattice.cc:216-270``).
* ``minimize_compact_lattice`` — suffix-sharing state merge for
  deterministic acyclic lattices: reverse-topological hashing of
  (final, sorted arcs into equivalence classes), then exact equivalence
  check with ApproxEqual weights (``minimize-lattice.cc:38-230``).
  As in ``latbin/lattice-minimize.cc:78-90``, the convenience driver
  pushes strings and weights before minimizing.

All functions are pure: they return a new CompactLattice (inputs are
top-sorted first; lattices must be acyclic).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from kaldi_ctc_tpu_torch.decoding.det_lattice import CompactLattice

__all__ = [
    "top_sort_compact_lattice",
    "push_compact_lattice_strings",
    "push_compact_lattice_weights",
    "minimize_compact_lattice",
]

_INF = float("inf")
_KDELTA = 1.0 / 1024.0  # fst::kDelta


def _is_final(clat: CompactLattice, s: int) -> bool:
    return not math.isinf(clat.final_graph_cost[s])


def _out_arcs(clat: CompactLattice) -> List[List[int]]:
    adj: List[List[int]] = [[] for _ in range(clat.num_states)]
    for i in range(clat.num_arcs):
        adj[clat.arc_from[i]].append(i)
    return adj


def top_sort_compact_lattice(clat: CompactLattice) -> CompactLattice:
    """Relabel states so every arc goes from a lower to a higher id
    (raises ValueError on cyclic input).  Start state becomes 0."""
    adj = _out_arcs(clat)
    n = clat.num_states
    # iterative DFS post-order from the start state (unreachable states
    # are dropped, matching OpenFst TopSort+Connect usage on lattices)
    order: List[int] = []
    state = [0] * n                  # 0 unvisited, 1 on stack, 2 done
    stack: List[Tuple[int, int]] = [(clat.start, 0)]
    state[clat.start] = 1
    while stack:
        s, idx = stack.pop()
        if idx < len(adj[s]):
            stack.append((s, idx + 1))
            t = clat.arc_to[adj[s][idx]]
            if state[t] == 1:
                raise ValueError("cyclic CompactLattice cannot be top-sorted")
            if state[t] == 0:
                state[t] = 1
                stack.append((t, 0))
        else:
            state[s] = 2
            order.append(s)
    order.reverse()                  # topological order, start first
    new_id = {s: i for i, s in enumerate(order)}
    keep = [i for i in range(clat.num_arcs)
            if clat.arc_from[i] in new_id and clat.arc_to[i] in new_id]
    return CompactLattice(
        start=0,
        num_states=len(order),
        arc_from=[new_id[clat.arc_from[i]] for i in keep],
        arc_to=[new_id[clat.arc_to[i]] for i in keep],
        arc_word=[clat.arc_word[i] for i in keep],
        arc_graph_cost=[clat.arc_graph_cost[i] for i in keep],
        arc_acoustic_cost=[clat.arc_acoustic_cost[i] for i in keep],
        arc_ilabels=[clat.arc_ilabels[i] for i in keep],
        final_graph_cost=[clat.final_graph_cost[s] for s in order],
        final_acoustic_cost=[clat.final_acoustic_cost[s] for s in order],
        final_ilabels=[clat.final_ilabels[s] for s in order],
    )


def _get_string(clat: CompactLattice, adj: List[List[int]], state: int,
                arc_idx: int, length: int) -> Tuple[int, ...]:
    """First `length` ilabels of a path from `state`; the first step
    takes arc `arc_idx` (an index into adj[state]), or -1 for an
    arbitrary continuation (final string wins if the state is final).
    Paths in a deterministic lattice agree on any common-prefix length
    requested here (push-lattice.cc GetString)."""
    out: List[int] = []
    first = arc_idx
    while len(out) < length:
        if first == -1 and _is_final(clat, state):
            out.extend(clat.final_ilabels[state][:length - len(out)])
            break
        arcs = adj[state]
        if not arcs:
            raise ValueError("inconsistent path lengths in lattice")
        i = arcs[first if first != -1 else 0]
        out.extend(clat.arc_ilabels[i][:length - len(out)])
        state = clat.arc_to[i]
        first = -1
    return tuple(out)


def push_compact_lattice_strings(clat: CompactLattice) -> CompactLattice:
    """Hoist ilabel strings toward the start state."""
    clat = top_sort_compact_lattice(clat)
    adj = _out_arcs(clat)
    n = clat.num_states
    shift = [0] * n
    for s in range(n - 1, clat.start, -1):
        arcs = adj[s]
        if not arcs:
            shift[s] = len(clat.final_ilabels[s]) if _is_final(clat, s) else 0
            continue
        sh = min(shift[clat.arc_to[i]] + len(clat.arc_ilabels[i])
                 for i in arcs)
        if _is_final(clat, s):
            sh = min(sh, len(clat.final_ilabels[s]))
        # conflict check: reduce to the longest common prefix among all
        # outgoing continuations (push-lattice.cc CheckForConflict)
        n_branches = len(arcs) + (1 if _is_final(clat, s) else 0)
        if n_branches > 1 and sh > 0:
            if _is_final(clat, s):
                base = clat.final_ilabels[s][:sh]
                rest = range(len(arcs))
            else:
                base = _get_string(clat, adj, s, 0, sh)
                rest = range(1, len(arcs))
            for a in rest:
                other = _get_string(clat, adj, s, a, sh)
                k = 0
                while k < len(base) and base[k] == other[k]:
                    k += 1
                if k < len(base):
                    sh = k
                    base = base[:k]
        shift[s] = sh

    arc_ilabels: List[Tuple[int, ...]] = []
    for i in range(clat.num_arcs):
        s, t = clat.arc_from[i], clat.arc_to[i]
        string = clat.arc_ilabels[i] + _get_string(clat, adj, t, -1, shift[t])
        arc_ilabels.append(string[shift[s]:])
    final_ilabels = [clat.final_ilabels[s][shift[s]:] if _is_final(clat, s)
                     else clat.final_ilabels[s] for s in range(n)]
    import dataclasses
    return dataclasses.replace(clat, arc_ilabels=arc_ilabels,
                               final_ilabels=final_ilabels)


def _lat_plus(a: Tuple[float, float],
              b: Tuple[float, float]) -> Tuple[float, float]:
    """LatticeWeight Plus: min by total cost, ties broken by graph cost."""
    sa, sb = a[0] + a[1], b[0] + b[1]
    if sa < sb:
        return a
    if sb < sa:
        return b
    return a if a[0] <= b[0] else b


def push_compact_lattice_weights(clat: CompactLattice) -> CompactLattice:
    """Weight pushing toward the start in the (graph, acoustic) semiring."""
    clat = top_sort_compact_lattice(clat)
    adj = _out_arcs(clat)
    n = clat.num_states
    w2e: List[Tuple[float, float]] = [(_INF, _INF)] * n
    for s in range(n - 1, -1, -1):
        acc = ((clat.final_graph_cost[s], clat.final_acoustic_cost[s])
               if _is_final(clat, s) else (_INF, _INF))
        for i in adj[s]:
            t = clat.arc_to[i]
            acc = _lat_plus(acc, (clat.arc_graph_cost[i] + w2e[t][0],
                                  clat.arc_acoustic_cost[i] + w2e[t][1]))
        w2e[s] = acc
    w2e[clat.start] = (0.0, 0.0)     # leftover weight stays on the start

    import dataclasses
    arc_g = list(clat.arc_graph_cost)
    arc_a = list(clat.arc_acoustic_cost)
    fin_g = list(clat.final_graph_cost)
    fin_a = list(clat.final_acoustic_cost)
    for s in range(n):
        if math.isinf(w2e[s][0]) and math.isinf(w2e[s][1]):
            continue                 # non-coaccessible
        for i in adj[s]:
            t = clat.arc_to[i]
            if math.isinf(w2e[t][0]):
                continue
            arc_g[i] = arc_g[i] - w2e[s][0] + w2e[t][0]
            arc_a[i] = arc_a[i] - w2e[s][1] + w2e[t][1]
        if _is_final(clat, s):
            fin_g[s] = fin_g[s] - w2e[s][0]
            fin_a[s] = fin_a[s] - w2e[s][1]
    return dataclasses.replace(clat, arc_graph_cost=arc_g,
                               arc_acoustic_cost=arc_a,
                               final_graph_cost=fin_g,
                               final_acoustic_cost=fin_a)


def _approx_equal(g1: float, a1: float, g2: float, a2: float,
                  delta: float) -> bool:
    """LatticeWeight ApproxEqual: totals within delta (lattice-weight.h)."""
    if g1 == g2 and a1 == a2:
        return True
    if math.isinf(g1) != math.isinf(g2):
        return False
    if math.isinf(g1):
        return True
    return abs((g1 + a1) - (g2 + a2)) <= delta


def minimize_compact_lattice(clat: CompactLattice, delta: float = _KDELTA,
                             push: bool = True) -> CompactLattice:
    """Merge suffix-equivalent states of a deterministic acyclic
    CompactLattice.  With push=True (the lattice-minimize default),
    strings and weights are pushed first so more states coincide."""
    if push:
        clat = push_compact_lattice_strings(clat)
        clat = push_compact_lattice_weights(clat)
    else:
        clat = top_sort_compact_lattice(clat)
    adj = _out_arcs(clat)
    n = clat.num_states

    # reverse-topological hashing: weight-insensitive signature so the
    # delta-tolerant equivalence check below decides real merges
    state_hash: List[int] = [0] * n
    for s in range(n - 1, -1, -1):
        h = (hash(("F", clat.final_ilabels[s])) if _is_final(clat, s)
             else hash("NF"))
        acc = 0
        for i in adj[s]:
            acc += hash((clat.arc_word[i], clat.arc_ilabels[i],
                         state_hash[clat.arc_to[i]]))
        state_hash[s] = hash((h, acc)) & 0x7FFFFFFFFFFFFFFF

    groups: Dict[int, List[int]] = {}
    for s in range(n):
        groups.setdefault(state_hash[s], []).append(s)

    state_map = list(range(n))

    def _arc_sig(s: int):
        sig = []
        for i in adj[s]:
            sig.append((clat.arc_word[i], state_map[clat.arc_to[i]],
                        clat.arc_ilabels[i], clat.arc_graph_cost[i],
                        clat.arc_acoustic_cost[i]))
        sig.sort(key=lambda x: (x[0], x[1]))
        return sig

    def _equivalent(s: int, t: int) -> bool:
        if not _approx_equal(clat.final_graph_cost[s],
                             clat.final_acoustic_cost[s],
                             clat.final_graph_cost[t],
                             clat.final_acoustic_cost[t], delta):
            return False
        if _is_final(clat, s) and \
                clat.final_ilabels[s] != clat.final_ilabels[t]:
            return False
        sa, ta = _arc_sig(s), _arc_sig(t)
        if len(sa) != len(ta):
            return False
        for x, y in zip(sa, ta):
            if x[0] != y[0] or x[1] != y[1] or x[2] != y[2]:
                return False
            if not _approx_equal(x[3], x[4], y[3], y[4], delta):
                return False
        return True

    # reverse-topological merge: map each state to a LATER equivalent
    # representative; later states are already finalized when visited,
    # so mappings are one-hop (minimize-lattice.cc ComputeStateMap)
    for s in range(n - 1, -1, -1):
        for t in groups[state_hash[s]]:
            if t > s and state_map[t] == t and _equivalent(s, t):
                state_map[s] = t
                break

    kept = sorted(s for s in range(n) if state_map[s] == s)
    # arcs out of merged-away states are dropped (their representative
    # carries an equivalent arc set); redirect survivors' targets
    new_id = {s: i for i, s in enumerate(kept)}
    keep_arcs = [i for i in range(clat.num_arcs)
                 if state_map[clat.arc_from[i]] == clat.arc_from[i]]
    out = CompactLattice(
        start=new_id[state_map[clat.start]],
        num_states=len(kept),
        arc_from=[new_id[clat.arc_from[i]] for i in keep_arcs],
        arc_to=[new_id[state_map[clat.arc_to[i]]] for i in keep_arcs],
        arc_word=[clat.arc_word[i] for i in keep_arcs],
        arc_graph_cost=[clat.arc_graph_cost[i] for i in keep_arcs],
        arc_acoustic_cost=[clat.arc_acoustic_cost[i] for i in keep_arcs],
        arc_ilabels=[clat.arc_ilabels[i] for i in keep_arcs],
        final_graph_cost=[clat.final_graph_cost[s] for s in kept],
        final_acoustic_cost=[clat.final_acoustic_cost[s] for s in kept],
        final_ilabels=[clat.final_ilabels[s] for s in kept],
    )
    # drop states no longer reachable after merging
    return top_sort_compact_lattice(out)
