"""Lexicon → L transducer (phones in, words out).

A numpy copy of ``kaldi_ctc_tpu/lm/lexicon.py``.

The L.fst piece of the graph chain (``utils/mkgraph.sh``'s
prepare_lang-produced lexicon transducer): each pronunciation is a chain
of phone:eps arcs with the word emitted on the first arc, closed through
a loop state; optional inter-word silence is a sil:eps arc on the loop
weighted -log(sil_prob) (a simplification of Kaldi's L_disambig — no
disambiguation symbols, which the nondeterminism-tolerant token-passing
decoder does not need).

Phone ids must match the acoustic model's training labels (pdf+1 with
blank = 0), so phone 1 scores against model column 1 after the CTC graph
shift.
"""

from __future__ import annotations

import math
from typing import Dict, IO, List, Optional, Tuple, Union

import numpy as np

__all__ = ["parse_lexicon", "add_lex_disambig", "lexicon_to_fst_arrays",
           "labels_from_text"]


def parse_lexicon(f: Union[str, IO]) -> List[Tuple[str, List[str]]]:
    """Read 'word phone1 phone2 ...' lines (multiple prons allowed)."""
    if isinstance(f, str):
        with open(f) as fh:
            return parse_lexicon(fh)
    out: List[Tuple[str, List[str]]] = []
    for raw in f:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        out.append((parts[0], parts[1:]))
    return out


def add_lex_disambig(
    lexicon: List[Tuple[str, List[str]]],
) -> Tuple[List[Tuple[str, List[str]]], int]:
    """Append disambiguation symbols ``#1..#N`` to pronunciations that are
    homophones or prefixes of other pronunciations, so L ∘ G is
    determinizable (utils/add_lex_disambig.pl semantics).  Returns the
    augmented lexicon and the number of disambig symbols used (0 when the
    lexicon needed none)."""
    from collections import Counter

    counts = Counter(tuple(p) for _, p in lexicon)
    prefixes = set()
    for _, phones in lexicon:
        for i in range(1, len(phones)):
            prefixes.add(tuple(phones[:i]))
    last_used: Dict[Tuple[str, ...], int] = {}
    out: List[Tuple[str, List[str]]] = []
    max_disambig = 0
    for word, phones in lexicon:
        t = tuple(phones)
        if counts[t] > 1 or t in prefixes:
            cur = last_used.get(t, 0) + 1
            last_used[t] = cur
            max_disambig = max(max_disambig, cur)
            out.append((word, phones + [f"#{cur}"]))
        else:
            out.append((word, phones))
    return out, max_disambig


def lexicon_to_fst_arrays(
    lexicon: List[Tuple[str, List[str]]],
    phone_to_id: Optional[Dict[str, int]] = None,
    word_to_id: Optional[Dict[str, int]] = None,
    sil_phone: Optional[str] = None,
    sil_prob: float = 0.5,
):
    """→ (start, num_states, arcs [N,4] int32, weights [N] f32,
    finals [S] f32, phone_to_id, word_to_id)."""
    def is_disambig(p: str) -> bool:
        return p.startswith("#") and p[1:].isdigit()

    if phone_to_id is None:
        phone_to_id = {}
        if sil_phone:
            phone_to_id[sil_phone] = 1
        for _, phones in lexicon:
            for p in phones:
                if p not in phone_to_id and not is_disambig(p):
                    phone_to_id[p] = len(phone_to_id) + 1
    # disambiguation symbols (from add_lex_disambig) go after the real
    # phones so they can be stripped post-determinization by id range
    next_id = max(phone_to_id.values(), default=0) + 1
    for _, phones in lexicon:
        for p in phones:
            if is_disambig(p) and p not in phone_to_id:
                phone_to_id[p] = next_id
                next_id += 1
    if word_to_id is None:
        word_to_id = {"<eps>": 0}
        for w, _ in lexicon:
            if w not in word_to_id:
                word_to_id[w] = len(word_to_id)

    arcs: List[List[int]] = []
    weights: List[float] = []
    loop = 0
    n_states = 1
    if sil_phone:
        sil_cost = -math.log(max(sil_prob, 1e-10))
        arcs.append([loop, phone_to_id[sil_phone], 0, loop])
        weights.append(sil_cost)
    # next-free ids computed once (caller tables may be sparse, so
    # len() could collide with an existing id; a per-miss max() scan
    # would be O(V^2) on real lexicons)
    next_wid = max(word_to_id.values(), default=-1) + 1
    next_pid = max(phone_to_id.values(), default=0) + 1
    for word, phones in lexicon:
        if word not in word_to_id:
            word_to_id[word] = next_wid
            next_wid += 1
        wid = word_to_id[word]
        cur = loop
        for i, p in enumerate(phones):
            if p not in phone_to_id:
                phone_to_id[p] = next_pid
                next_pid += 1
            pid = phone_to_id[p]
            last = i == len(phones) - 1
            nxt = loop if last else n_states
            if not last:
                n_states += 1
            arcs.append([cur, pid, wid if i == 0 else 0, nxt])
            weights.append(0.0)
            cur = nxt
    finals = np.full(n_states, np.inf, np.float32)
    finals[loop] = 0.0
    return (loop, n_states, np.asarray(arcs, np.int32).reshape(-1, 4),
            np.asarray(weights, np.float32), finals, phone_to_id,
            word_to_id)


def labels_from_text(
    words: List[str],
    lexicon: Dict[str, List[List[str]]],
    phone_to_id: Dict[str, int],
) -> Optional[np.ndarray]:
    """Transcript words → CTC phone-label sequence (flat-start training:
    CTC needs only the label ORDER, so transcripts + a lexicon replace
    the reference's GMM alignments entirely — no bootstrap system).

    Uses the first pronunciation of each word; returns None when a word
    or phone is missing (caller skips the utterance with a count)."""
    out: List[int] = []
    for w in words:
        prons = lexicon.get(w)
        if not prons:
            return None
        for p in prons[0]:
            pid = phone_to_id.get(p)
            if pid is None:
                return None
            out.append(pid)
    return np.asarray(out, np.int32)
