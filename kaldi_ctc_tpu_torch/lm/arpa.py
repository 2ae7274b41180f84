r"""ARPA n-gram LM: parser, backoff scoring, and G acceptor compilation.

Counterpart of ``kaldi_ctc_tpu/lm/arpa.py``: the same host code over the
port's modules.

The src/lm slice (``lm/arpa-file-parser.h``, ``lm/arpa-lm-compiler.{h,cc}``
as used by Kaldi's ``arpa2fst`` in data prep): parse the \data\ /
\N-grams: sections, score word sequences with standard backoff, and
compile the LM into a G word acceptor (states = histories, word arcs =
n-grams, epsilon arcs = backoffs) whose arrays feed NativeFst — removing
the "G.fst must be prebuilt by Kaldi" fixture for simple setups.

Weights: ARPA stores log10 probabilities; FST costs are -ln(p)
(tropical), so cost = -log(10) * log10prob, matching arpa2fst.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, IO, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["ArpaLm", "parse_arpa", "sentence_logprob",
           "arpa_to_fst_arrays"]

_LN10 = math.log(10.0)


@dataclasses.dataclass
class ArpaLm:
    """n-gram table: (words...) -> (log10 prob, log10 backoff)."""

    order: int
    ngrams: Dict[Tuple[str, ...], Tuple[float, float]]
    counts: List[int]

    def has_ngram(self, words: Tuple[str, ...]) -> bool:
        return tuple(words) in self.ngrams

    def logprob(self, word: str, history: Tuple[str, ...]) -> float:
        """log10 P(word | history) with standard backoff recursion."""
        history = tuple(history)[-(self.order - 1):] if self.order > 1 \
            else ()
        while True:
            ng = history + (word,)
            if ng in self.ngrams:
                return self.ngrams[ng][0]
            if not history:
                # OOV: treat as <unk> if present, else hard floor
                if ("<unk>",) in self.ngrams:
                    return self.ngrams[("<unk>",)][0]
                return -99.0
            bo = self.ngrams.get(history, (0.0, 0.0))[1]
            history = history[1:]
            if bo:
                return bo + self.logprob(word, history)
            # zero backoff weight: continue shortening


def parse_arpa(f: Union[str, IO]) -> ArpaLm:
    """Parse an ARPA file (path or text stream)."""
    if isinstance(f, str):
        with open(f) as fh:
            return parse_arpa(fh)
    counts: List[int] = []
    ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
    section = 0  # 0 = preamble, n>0 = n-grams section
    for raw in f:
        line = raw.strip()
        if not line:
            continue
        if line == "\\data\\":
            section = 0
            continue
        if line.startswith("ngram "):
            # "ngram 1=4"
            try:
                n, c = line[6:].split("=")
                counts.append(int(c))
            except ValueError:
                pass
            continue
        if line.endswith("-grams:") and line.startswith("\\"):
            section = int(line[1:].split("-")[0])
            continue
        if line == "\\end\\":
            break
        if section > 0:
            parts = line.split()
            if len(parts) < section + 1:
                continue
            logp = float(parts[0])
            words = tuple(parts[1:1 + section])
            backoff = (float(parts[1 + section])
                       if len(parts) > section + 1 else 0.0)
            ngrams[words] = (logp, backoff)
    if not counts:
        counts = [0]
    return ArpaLm(order=len(counts), ngrams=ngrams, counts=counts)


def sentence_logprob(lm: ArpaLm, words: Sequence[str],
                     bos: str = "<s>", eos: str = "</s>") -> float:
    """log10 P(words </s> | <s>) — the perplexity building block."""
    hist: Tuple[str, ...] = (bos,)
    total = 0.0
    for w in list(words) + [eos]:
        total += lm.logprob(w, hist)
        hist = hist + (w,)
    return total


def arpa_to_fst_arrays(
    lm: ArpaLm,
    word_to_id: Optional[Dict[str, int]] = None,
    bos: str = "<s>",
    eos: str = "</s>",
    eps_id: int = 0,
) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray, Dict[str, int]]:
    """Compile to G acceptor arrays (arpa2fst semantics).

    States are n-gram histories; each non-</s> n-gram (h, w) becomes a
    w:w arc state(h) → state(next-history); backoffs become epsilon arcs
    to the shortened history; </s> n-grams set final weights.

    Returns (start, num_states, arcs [N,4] int32, weights [N] f32,
    finals [S] f32, word_to_id).  Feed directly to NativeFst.from_arrays.
    """
    if word_to_id is None:
        word_to_id = {"<eps>": eps_id}
        for ng in lm.ngrams:
            for w in ng:
                if w not in (bos, eos) and w not in word_to_id:
                    word_to_id[w] = len(word_to_id)

    # histories that need states: every n-gram of order < max that has a
    # continuation or a backoff weight, plus () (unigram state) and (bos,)
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(h: Tuple[str, ...]) -> int:
        while h and h not in lm.ngrams and len(h) > 0:
            # histories with no explicit n-gram entry back off implicitly
            if len(h) == 0:
                break
            h = h[1:]
        if h not in state_of:
            state_of[h] = len(state_of)
        return state_of[h]

    uni = get_state(())
    # order-1 LMs have no <s>-conditioned continuations: the (bos,) state
    # would be a dead end (no backoff arc is emitted at max order), so
    # start at the unigram state directly.
    start = (get_state((bos,))
             if lm.order > 1 and (bos,) in lm.ngrams else uni)

    arcs: List[List[int]] = []
    weights: List[float] = []
    finals: Dict[int, float] = {}

    # next-free id computed once: caller tables may be sparse (len()
    # could collide), and a per-miss max() scan would be O(V^2)
    next_wid = max(word_to_id.values(), default=-1) + 1
    for ng, (logp, backoff) in lm.ngrams.items():
        h, w = ng[:-1], ng[-1]
        cost = -_LN10 * logp
        if w == eos:
            s = get_state(h)
            prev = finals.get(s)
            if prev is None or cost < prev:
                finals[s] = cost
        elif w == bos:
            pass  # <s> unigram: start state only, no arc
        else:
            s = get_state(h)
            # next history: longest suffix of (h, w) that is a history
            nh = (h + (w,))[-(lm.order - 1):] if lm.order > 1 else ()
            while nh and nh not in lm.ngrams:
                nh = nh[1:]
            t = get_state(nh)
            if w not in word_to_id:
                word_to_id[w] = next_wid
                next_wid += 1
            wid = word_to_id[w]
            arcs.append([s, wid, wid, t])
            weights.append(cost)
        # backoff (epsilon) arc for this n-gram viewed as a history —
        # emitted even at zero weight, otherwise paths strand in states
        # whose continuations don't cover the next word
        if len(ng) < lm.order and w != eos:
            s = get_state(ng)
            t = get_state(ng[1:])
            arcs.append([s, eps_id, eps_id, t])
            weights.append(-_LN10 * backoff)

    n_states = len(state_of)
    finals_arr = np.full(n_states, np.inf, np.float32)
    for s, c in finals.items():
        finals_arr[s] = c
    return (start, n_states,
            np.asarray(arcs, np.int32).reshape(-1, 4),
            np.asarray(weights, np.float32),
            finals_arr, word_to_id)
