"""Data-driven phonetic decision-tree building (src/tree parity).

Counterpart of ``kaldi_ctc_tpu/utils/tree_build.py``: the same host code over
the port's modules.

The native replacement for the reference's tree-building chain in
``steps/ctc/build_tree.sh:139-193``:

* :func:`acc_tree_stats` / :func:`sum_tree_stats` — per-context-event
  diagonal-Gaussian statistics (acc-tree-stats / sum-tree-stats;
  GaussClusterable: count, sum, sum-of-squares).
* :func:`cluster_phones` — agglomerative clustering of per-phone stats
  into phonetic question sets (cluster-phones; every intermediate
  cluster of the merge tree becomes a question).
* :func:`build_tree` — greedy top-down splitting of root stats by the
  best (position key, question) likelihood gain up to ``max_leaves``,
  then optional bottom-up leaf clustering within each root
  (build-tree's SplitDecisionTree + ClusterEventMapRestrictedByMap with
  ``--cluster-thresh``), producing a :class:`ContextDependency` that
  plugs into ``make-tlg --tree`` and ``prepare_egs --tree``.

Events follow the Kaldi convention (tree/context-dep.h): key -1 is the
pdf-class, keys 0..N-1 are phone-window positions, out-of-utterance
context is phone 0.  Objective is the shared diagonal-Gaussian data
likelihood with floored variances (GaussClusterable::Objf).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.utils.tree import CE, SE, TE, ContextDependency

__all__ = ["GaussStats", "acc_tree_stats", "sum_tree_stats",
           "cluster_phones", "build_tree", "TreeStats",
           "save_tree_stats", "load_tree_stats", "parse_roots"]

# event: ((-1, pdf_class), (0, left), (1, central), (2, right), ...)
Event = Tuple[Tuple[int, int], ...]
_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class GaussStats:
    """Diagonal-Gaussian sufficient statistics."""

    count: float
    sum: np.ndarray     # [D]
    sumsq: np.ndarray   # [D]

    @classmethod
    def zero(cls, dim: int) -> "GaussStats":
        return cls(0.0, np.zeros(dim, np.float64), np.zeros(dim, np.float64))

    def add(self, other: "GaussStats") -> "GaussStats":
        return GaussStats(self.count + other.count, self.sum + other.sum,
                          self.sumsq + other.sumsq)

    def objf(self, var_floor: float = 0.01) -> float:
        """Data log-likelihood under the ML diagonal Gaussian
        (GaussClusterable::Objf, variances floored)."""
        if self.count <= 0:
            return 0.0
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean * mean, var_floor)
        d = self.sum.shape[0]
        return float(-0.5 * self.count
                     * (np.log(var).sum() + d * (_LOG_2PI + 1.0)))


TreeStats = Dict[Event, GaussStats]


def acc_tree_stats(
        utterances: Iterable[Tuple],
        N: int = 3, P: int = 1,
        ci_phones: Sequence[int] = (),
        pdf_classes: Optional[Dict[int, int]] = None) -> TreeStats:
    """Accumulate per-event stats from (features [T, D], per-frame phone
    alignment [T][, instance-start flags [T]]) tuples.

    Phone windows span phone *segments* (a run of identical phones is
    one instance, unless the optional per-frame ``starts`` flags mark a
    re-entry — transition-id alignments distinguish adjacent instances
    of the same phone by their non-self-loop entry tid); context-
    independent phones get zeroed context so they can never be split on
    it.  ``pdf_classes`` optionally maps a phone to its number of
    pdf-classes — frames of a segment are spread evenly over the
    classes (1-state CTC topologies have exactly one).
    """
    ci = frozenset(int(p) for p in ci_phones)
    stats: TreeStats = {}
    for utt in utterances:
        feats, phones = utt[0], utt[1]
        starts = utt[2] if len(utt) > 2 else None
        feats = np.asarray(feats, np.float64)
        phones = np.asarray(phones).ravel()
        if feats.shape[0] != phones.shape[0]:
            raise ValueError("features/alignment length mismatch")
        if len(phones) == 0:
            continue
        # segment the alignment into phone instances
        bounds = [0] + [i for i in range(1, len(phones))
                        if phones[i] != phones[i - 1]
                        or (starts is not None and starts[i])] \
            + [len(phones)]
        seg_phones = [int(phones[b]) for b in bounds[:-1]]
        for si in range(len(seg_phones)):
            c = seg_phones[si]
            if c == 0:
                continue
            window = []
            for k in range(N):
                j = si + k - P
                p = seg_phones[j] if 0 <= j < len(seg_phones) else 0
                window.append(0 if (c in ci and k != P) else p)
            b, e = bounds[si], bounds[si + 1]
            n_cls = (pdf_classes or {}).get(c, 1)
            for t in range(b, e):
                cls = min((t - b) * n_cls // max(e - b, 1), n_cls - 1)
                event = ((-1, cls),) + tuple(
                    (k, window[k]) for k in range(N))
                st = stats.get(event)
                if st is None:
                    st = GaussStats.zero(feats.shape[1])
                    stats[event] = st
                x = feats[t]
                st.count += 1.0
                st.sum += x
                st.sumsq += x * x
    return stats


def sum_tree_stats(parts: Iterable[TreeStats]) -> TreeStats:
    out: TreeStats = {}
    for part in parts:
        for event, st in part.items():
            if event in out:
                out[event] = out[event].add(st)
            else:
                out[event] = GaussStats(st.count, st.sum.copy(),
                                        st.sumsq.copy())
    return out


def save_tree_stats(path: str, stats: TreeStats) -> None:
    events = sorted(stats)
    keys = np.array([[kv for kv in ev] for ev in events], np.int32)
    # write through a handle so numpy cannot append '.npz' and break
    # the save(path)/load(path) round trip
    with open(path, "wb") as f:
        np.savez_compressed(
            f, keys=keys,
            count=np.array([stats[e].count for e in events]),
            sum=np.stack([stats[e].sum for e in events])
            if events else np.zeros((0, 0)),
            sumsq=np.stack([stats[e].sumsq for e in events])
            if events else np.zeros((0, 0)))


def load_tree_stats(path: str) -> TreeStats:
    z = np.load(path)
    out: TreeStats = {}
    for i in range(z["keys"].shape[0]):
        event = tuple((int(k), int(v)) for k, v in z["keys"][i])
        out[event] = GaussStats(float(z["count"][i]), z["sum"][i].copy(),
                                z["sumsq"][i].copy())
    return out


def _marginalize_by_phone(stats: TreeStats, P: int) -> Dict[int, GaussStats]:
    out: Dict[int, GaussStats] = {}
    for event, st in stats.items():
        phone = dict(event)[P]
        if phone in out:
            out[phone] = out[phone].add(st)
        else:
            out[phone] = GaussStats(st.count, st.sum.copy(),
                                    st.sumsq.copy())
    return out


def cluster_phones(stats: TreeStats, sets: Sequence[Sequence[int]],
                   P: int = 1, var_floor: float = 0.01
                   ) -> List[frozenset]:
    """Agglomerative clustering of phone sets into questions.

    Starts from the given phone sets (``sets.int``; typically one set
    per base phone) and repeatedly merges the pair with the smallest
    likelihood loss; the questions are all clusters ever formed
    (cluster-phones' tree-clustering contract: every node of the merge
    tree is a question).
    """
    by_phone = _marginalize_by_phone(stats, P)
    dim = next(iter(by_phone.values())).sum.shape[0] if by_phone else 1

    def set_stats(phones):
        st = GaussStats.zero(dim)
        for p in phones:
            if p in by_phone:
                st = st.add(by_phone[p])
        return st

    clusters = [(frozenset(int(p) for p in s), set_stats(s))
                for s in sets if s]
    questions = [c[0] for c in clusters]
    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                merged = clusters[i][1].add(clusters[j][1])
                loss = (clusters[i][1].objf(var_floor)
                        + clusters[j][1].objf(var_floor)
                        - merged.objf(var_floor))
                if best is None or loss < best[0]:
                    best = (loss, i, j, merged)
        _, i, j, merged = best
        new = (clusters[i][0] | clusters[j][0], merged)
        clusters = [c for k, c in enumerate(clusters) if k not in (i, j)]
        clusters.append(new)
        questions.append(new[0])
    # drop the all-phones question (splits nothing) and duplicates
    seen = set()
    out = []
    for q in questions:
        if q in seen or len(q) == 0:
            continue
        seen.add(q)
        out.append(q)
    return out


def parse_roots(path: str) -> List[Tuple[bool, bool, List[int]]]:
    """roots.int lines: 'shared|not-shared split|not-split p1 p2 ...'."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 3 or parts[0] not in ("shared", "not-shared") \
                    or parts[1] not in ("split", "not-split"):
                raise ValueError(f"bad roots line: {line!r}")
            out.append((parts[0] == "shared", parts[1] == "split",
                        [int(p) for p in parts[2:]]))
    return out


@dataclasses.dataclass
class _Leaf:
    items: List[Tuple[Event, GaussStats]]
    stats: GaussStats
    keys: Tuple[int, ...]            # keys this leaf may split on
    trail: List                     # (key, question, yes?) path from root
    root_idx: int
    sub: int = 0                    # pdf-class, for non-shared roots
    pdf: int = -1


def _best_split(leaf: _Leaf, questions_by_key, var_floor):
    base = leaf.stats.objf(var_floor)
    best = None
    dim = leaf.stats.sum.shape[0]
    for key in leaf.keys:
        vals = {}
        for event, st in leaf.items:
            v = dict(event)[key]
            if v in vals:
                vals[v] = vals[v].add(st)
            else:
                vals[v] = st
        if len(vals) < 2:
            continue
        for q in questions_by_key.get(key, ()):
            yes = GaussStats.zero(dim)
            no = GaussStats.zero(dim)
            for v, st in vals.items():
                if v in q:
                    yes = yes.add(st)
                else:
                    no = no.add(st)
            if yes.count <= 0 or no.count <= 0:
                continue
            gain = yes.objf(var_floor) + no.objf(var_floor) - base
            if best is None or gain > best[0]:
                best = (gain, key, q)
    return best


def build_tree(stats: TreeStats,
               questions: Sequence[frozenset],
               roots: Sequence[Tuple[bool, bool, Sequence[int]]],
               N: int = 3, P: int = 1,
               max_leaves: int = 0,
               cluster_thresh: float = 0.0,
               thresh: float = 0.0,
               var_floor: float = 0.01,
               num_phones: Optional[int] = None) -> ContextDependency:
    """Greedy likelihood-gain tree building (build-tree).

    roots: (shared, split, phones) per line of roots.int — non-split
    roots stay single leaves; non-shared roots get one leaf per
    pdf-class.  max_leaves 0 = unbounded; splitting also stops when the
    best gain drops to ``thresh``.  cluster_thresh > 0 merges leaf pairs
    within a root whose combined loss is below it (Kaldi's restricted
    post-clustering).
    """
    questions = [frozenset(q) for q in questions]
    # question sets apply to phone-position keys; pdf-class key -1
    # splits on singleton classes (compile-questions' automatic ones)
    classes = sorted({dict(e)[-1] for e in stats})
    questions_by_key = {k: questions for k in range(N) if k != P}
    questions_by_key[P] = questions
    questions_by_key[-1] = [frozenset([c]) for c in classes]

    phone_root = {}
    for idx, (_shared, _split, phones) in enumerate(roots):
        for p in phones:
            if p in phone_root:
                raise ValueError(f"phone {p} in two roots")
            phone_root[int(p)] = idx

    by_root: Dict[Tuple[int, int], List[Tuple[Event, GaussStats]]] = {}
    dim = (next(iter(stats.values())).sum.shape[0] if stats else 1)
    for event, st in stats.items():
        ev = dict(event)
        phone = ev[P]
        if phone not in phone_root:
            raise ValueError(f"phone {phone} has stats but no root")
        idx = phone_root[phone]
        shared = roots[idx][0]
        sub = 0 if shared else ev[-1]
        by_root.setdefault((idx, sub), []).append((event, st))

    def total(items):
        st = GaussStats.zero(dim)
        for _e, s in items:
            st = st.add(s)
        return st

    leaves: List[_Leaf] = []
    versions: List[int] = []
    heap = []
    counter = 0

    def push_best(li: int) -> None:
        nonlocal counter
        best = _best_split(leaves[li], questions_by_key, var_floor)
        if best is not None:
            heapq.heappush(heap, (-best[0], counter, li, versions[li],
                                  best))
            counter += 1

    for (idx, sub), items in sorted(by_root.items()):
        shared, split, _phones = roots[idx]
        keys: Tuple[int, ...] = ()
        if split:
            keys = tuple(k for k in range(N)) + ((-1,) if shared else ())
        leaves.append(_Leaf(items, total(items), keys, [], idx, sub))
        versions.append(0)
        if keys:
            push_best(len(leaves) - 1)

    n_leaves = len(leaves)
    while heap and (max_leaves <= 0 or n_leaves < max_leaves):
        neg_gain, _c, li, ver, (gain, key, q) = heapq.heappop(heap)
        if ver != versions[li]:
            continue                 # stale entry for a replaced leaf
        if gain <= thresh:
            break
        leaf = leaves[li]
        yes_items = [(e, s) for e, s in leaf.items if dict(e)[key] in q]
        no_items = [(e, s) for e, s in leaf.items if dict(e)[key] not in q]
        yes = _Leaf(yes_items, total(yes_items), leaf.keys,
                    leaf.trail + [(key, q, True)], leaf.root_idx, leaf.sub)
        no = _Leaf(no_items, total(no_items), leaf.keys,
                   leaf.trail + [(key, q, False)], leaf.root_idx, leaf.sub)
        leaves[li] = yes
        versions[li] += 1
        leaves.append(no)
        versions.append(0)
        n_leaves += 1
        push_best(li)
        push_best(len(leaves) - 1)

    # post-clustering: merge low-loss leaf pairs within each root
    merged_into = list(range(len(leaves)))
    if cluster_thresh > 0:
        by_r: Dict[Tuple[int, int], List[int]] = {}
        for i, leaf in enumerate(leaves):
            by_r.setdefault((leaf.root_idx, leaf.sub), []).append(i)
        for _r, idxs in by_r.items():
            live = set(idxs)
            while len(live) > 1:
                best = None
                ll = sorted(live)
                for a in range(len(ll)):
                    for b in range(a + 1, len(ll)):
                        i, j = ll[a], ll[b]
                        m = leaves[i].stats.add(leaves[j].stats)
                        loss = (leaves[i].stats.objf(var_floor)
                                + leaves[j].stats.objf(var_floor)
                                - m.objf(var_floor))
                        if best is None or loss < best[0]:
                            best = (loss, i, j, m)
                if best is None or best[0] >= cluster_thresh:
                    break
                _loss, i, j, m = best
                merged_into[j] = i
                leaves[i] = dataclasses.replace(
                    leaves[i], stats=m, items=leaves[i].items
                    + leaves[j].items)
                live.discard(j)
        # path-compress merge links
        for i in range(len(merged_into)):
            while merged_into[merged_into[i]] != merged_into[i]:
                merged_into[i] = merged_into[merged_into[i]]

    # assign pdf ids in deterministic (root, trail) order
    order = sorted(range(len(leaves)),
                   key=lambda i: (leaves[i].root_idx, leaves[i].sub,
                                  [(k, sorted(q), y)
                                   for k, q, y in leaves[i].trail]))
    next_pdf = 0
    for i in order:
        if merged_into[i] == i:
            leaves[i].pdf = next_pdf
            next_pdf += 1
    for i in order:
        if merged_into[i] != i:
            leaves[i].pdf = leaves[merged_into[i]].pdf

    # build per-root subtree from the split trails
    def subtree(leaf_idxs: List[int], depth_trail: List) -> tuple:
        first = leaves[leaf_idxs[0]]
        d = len(depth_trail)
        if all(len(leaves[i].trail) == d for i in leaf_idxs):
            assert len(leaf_idxs) == 1
            return CE(first.pdf)
        # all leaves here share trail prefix depth_trail; split on the
        # (key, question) of the first deeper leaf
        deeper = next(i for i in leaf_idxs if len(leaves[i].trail) > d)
        key, q, _y = leaves[deeper].trail[d]
        yes_idxs = [i for i in leaf_idxs if leaves[i].trail[d][2]]
        no_idxs = [i for i in leaf_idxs if not leaves[i].trail[d][2]]
        return SE(key, q,
                  subtree(yes_idxs, depth_trail + [(key, q, True)]),
                  subtree(no_idxs, depth_trail + [(key, q, False)]))

    root_subtrees: Dict[int, tuple] = {}
    by_r2: Dict[int, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_r2.setdefault(leaf.root_idx, []).append(i)
    for ridx, idxs in by_r2.items():
        shared, _split, _phones = roots[ridx]
        if shared:
            root_subtrees[ridx] = subtree(sorted(idxs), [])
        else:
            # one sub-root per pdf-class: TE on key -1
            by_cls: Dict[int, List[int]] = {}
            for i in idxs:
                by_cls.setdefault(leaves[i].sub, []).append(i)
            n_cls = max(by_cls) + 1
            children = [None] * n_cls
            for cls, cidxs in by_cls.items():
                children[cls] = subtree(sorted(cidxs), [])
            root_subtrees[ridx] = TE(-1, children)

    # roots with no stats at all: map to a fresh pdf each (Kaldi warns
    # 'no stats'; a constant leaf keeps the tree total)
    for ridx in range(len(roots)):
        if ridx not in root_subtrees:
            root_subtrees[ridx] = CE(next_pdf)
            next_pdf += 1

    max_phone = num_phones or max(phone_root)
    children = [None] * (max_phone + 1)
    for p, ridx in phone_root.items():
        if p <= max_phone:
            children[p] = root_subtrees[ridx]
    return ContextDependency(N=N, P=P, root=TE(P, children))
