"""Const-ARPA: the ARPA LM compiled into flat sorted-array tries.

Counterpart of ``kaldi_ctc_tpu/lm/const_arpa.py``: the same host code over the
port's modules.

The src/lm ``ConstArpaLm`` analogue (``lm/const-arpa-lm.{h,cc}``,
``arpa-to-const-arpa``, ``lattice-lmrescore-const-arpa``): instead of a
per-n-gram Python dict, the model lives in contiguous numpy arrays —
one level per n-gram order, each node's children a contiguous
word-sorted span in the next level, looked up by binary search.  Scoring
semantics are identical to :class:`~kaldi_ctc_tpu_torch.lm.arpa.ArpaLm`
(standard backoff), so a compiled LM drops into ``lattice_tool
lmrescore`` and perplexity scoring unchanged.

Save/load is a single ``.npz`` — the memory-mappable artifact the
reference's const-arpa binary format corresponds to.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.lm.arpa import ArpaLm

__all__ = ["ConstArpaLm", "compile_const_arpa"]

_NO_PROB = np.float32(np.nan)   # "structural node, no explicit prob"


class ConstArpaLm:
    """Flat-array n-gram trie with backoff scoring.

    Per level n (1-based): ``words[n]`` (last word id, sorted within the
    parent's span), ``logp[n]`` (log10 prob, NaN = structural node with
    no explicit probability), ``bo[n]`` (log10 backoff),
    ``lo[n]``/``hi[n]`` (children span in level n+1).
    """

    def __init__(self, order: int, vocab: List[str],
                 levels: List[Dict[str, np.ndarray]]):
        self.order = order
        self.vocab = list(vocab)
        self.word_id = {w: i for i, w in enumerate(vocab)}
        self._levels = levels
        self._unk_logp: Optional[float] = None
        u = self.word_id.get("<unk>")
        if u is not None:
            idx = self._find_child(0, u, level=0,
                                   span=(0, len(levels[0]["words"])))
            if idx >= 0 and not math.isnan(float(levels[0]["logp"][idx])):
                self._unk_logp = float(levels[0]["logp"][idx])

    # -- lookup ----------------------------------------------------------
    def _find_child(self, _node: int, word: int, level: int,
                    span: Tuple[int, int]) -> int:
        lo, hi = span
        words = self._levels[level]["words"]
        i = int(np.searchsorted(words[lo:hi], word)) + lo
        if i < hi and words[i] == word:
            return i
        return -1

    def _lookup(self, ids: Tuple[int, ...]) -> Tuple[int, int]:
        """→ (level, index) of the n-gram node, or (-1, -1)."""
        span = (0, len(self._levels[0]["words"]))
        idx = -1
        for level, w in enumerate(ids):
            if level >= self.order:
                return -1, -1
            idx = self._find_child(idx, w, level, span)
            if idx < 0:
                return -1, -1
            if level + 1 < self.order:
                span = (int(self._levels[level]["lo"][idx]),
                        int(self._levels[level]["hi"][idx]))
        return len(ids) - 1, idx

    def has_ngram(self, words: Tuple[str, ...]) -> bool:
        ids = tuple(self.word_id.get(w, -1) for w in words)
        if -1 in ids or not ids:
            return False
        level, idx = self._lookup(ids)
        if idx < 0:
            return False
        # structural nodes (added for missing prefixes) are not n-grams
        return not math.isnan(float(self._levels[level]["logp"][idx]))

    def logprob(self, word: str, history: Tuple[str, ...]) -> float:
        """log10 P(word | history), ArpaLm.logprob-compatible."""
        wid = self.word_id.get(word)
        # OOV history words become -1: they match no n-gram and no
        # backoff entry, so the loop shortens past them naturally
        hist = tuple(self.word_id.get(h, -1) for h in history)
        if self.order > 1:
            hist = hist[-(self.order - 1):]
        else:
            hist = ()
        total_bo = 0.0
        while True:
            if wid is not None:
                level, idx = self._lookup(hist + (wid,))
                if idx >= 0:
                    lp = float(self._levels[level]["logp"][idx])
                    if not math.isnan(lp):
                        return total_bo + lp
            if not hist:
                if self._unk_logp is not None:
                    return total_bo + self._unk_logp
                return total_bo - 99.0
            hlevel, hidx = self._lookup(hist)
            if hidx >= 0:
                total_bo += float(self._levels[hlevel]["bo"][hidx])
            hist = hist[1:]

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        data = {"order": np.int32(self.order),
                "vocab": np.asarray("\n".join(self.vocab))}
        for n, lv in enumerate(self._levels):
            for k, arr in lv.items():
                data[f"l{n}_{k}"] = arr
        # write through a handle so numpy cannot append '.npz' and
        # break the save(path)/load(path) round trip
        with open(path, "wb") as f:
            np.savez_compressed(f, **data)

    @classmethod
    def load(cls, path: str) -> "ConstArpaLm":
        z = np.load(path)
        order = int(z["order"])
        vocab = str(z["vocab"]).split("\n")
        levels = []
        for n in range(order):
            lv = {k: z[f"l{n}_{k}"] for k in ("words", "logp", "bo")
                  if f"l{n}_{k}" in z}
            if f"l{n}_lo" in z:
                lv["lo"] = z[f"l{n}_lo"]
                lv["hi"] = z[f"l{n}_hi"]
            levels.append(lv)
        return cls(order, vocab, levels)


def compile_const_arpa(lm: ArpaLm) -> ConstArpaLm:
    """ArpaLm → ConstArpaLm (arpa-to-const-arpa).

    Missing prefixes (an n-gram whose history has no explicit entry) get
    structural nodes with no probability, exactly the nodes the trie
    needs to descend through.
    """
    vocab: List[str] = []
    word_id: Dict[str, int] = {}
    for ng in lm.ngrams:
        for w in ng:
            if w not in word_id:
                word_id[w] = len(vocab)
                vocab.append(w)

    # collect all nodes per level, adding structural parents
    nodes: List[Dict[Tuple[int, ...], Tuple[float, float]]] = \
        [dict() for _ in range(lm.order)]
    for ng, (logp, bo) in lm.ngrams.items():
        ids = tuple(word_id[w] for w in ng)
        nodes[len(ids) - 1][ids] = (logp, bo)
    for n in range(lm.order - 1, 0, -1):
        for ids in list(nodes[n]):
            parent = ids[:-1]
            if parent not in nodes[n - 1]:
                nodes[n - 1][parent] = (float(_NO_PROB), 0.0)

    levels: List[Dict[str, np.ndarray]] = []
    # order levels so children of one parent are contiguous + word-sorted
    prev_order: List[Tuple[int, ...]] = []
    for n in range(lm.order):
        if n == 0:
            ordered = sorted(nodes[0])
        else:
            by_parent: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
            for ids in nodes[n]:
                by_parent.setdefault(ids[:-1], []).append(ids)
            ordered = []
            spans = []
            for parent in prev_order:
                kids = sorted(by_parent.get(parent, ()),
                              key=lambda x: x[-1])
                spans.append((len(ordered), len(ordered) + len(kids)))
                ordered.extend(kids)
            levels[n - 1]["lo"] = np.asarray([s[0] for s in spans],
                                             np.int64)
            levels[n - 1]["hi"] = np.asarray([s[1] for s in spans],
                                             np.int64)
        lv = {
            "words": np.asarray([ids[-1] for ids in ordered], np.int64),
            "logp": np.asarray([nodes[n][ids][0] for ids in ordered],
                               np.float32),
            "bo": np.asarray([nodes[n][ids][1] for ids in ordered],
                             np.float32),
        }
        levels.append(lv)
        prev_order = ordered
    return ConstArpaLm(lm.order, vocab, levels)
