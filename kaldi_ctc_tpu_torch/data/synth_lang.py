"""Synthetic language generator: lexicon + pruned-trigram ARPA + utterances.

Counterpart of ``kaldi_ctc_tpu/data/synth_lang.py``: the same host code over
the port's modules.

The offline stand-in for librispeech data prep (the reference recipe's
``data/local/lm/3-gram.pruned.*.arpa.gz`` + ``data/local/dict/lexicon.txt``
inputs to ``egs/librispeech/ctc/run.sh:21-46``): generates a vocabulary
with random pronunciations, a *pruned-trigram-shaped* ARPA LM (Zipf
unigrams, sparse bigram/trigram continuations with backoff mass — the
structure that gives a real TLG its wide per-frame active sets), word
sequences sampled from that LM, and CTC-shaped posterior matrices for
them.  Everything is seeded → bit-reproducible corpora of any size.

Used by ``bench.py --decode`` (realistic-graph decode RTF) and
``recipes/medium`` (end-to-end WER on a non-trivial synthetic task).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SynthLanguage", "make_language", "synth_posteriors",
           "edit_distance"]


@dataclasses.dataclass
class SynthLanguage:
    """A generated language: lexicon, ARPA text, and sampling tables."""

    words: List[str]                       # index = word rank (Zipf order)
    lexicon: List[Tuple[str, List[str]]]   # word -> phone-name pronunciation
    prons: List[np.ndarray]                # word -> phone *ids* (1-based)
    num_phones: int
    arpa_text: str
    # sampling tables (successor ids + conditional probs, normalized)
    uni_p: np.ndarray
    bi: Dict[int, Tuple[np.ndarray, np.ndarray]]
    tri: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]
    bos_succ: Tuple[np.ndarray, np.ndarray]

    def sample_sentence(self, rng: np.random.Generator,
                        min_len: int = 8, max_len: int = 30) -> List[int]:
        """Sample a word-id sequence by walking the LM (trigram →
        bigram → unigram backoff, exactly the distribution the decoder's
        G models), so decode difficulty matches a matched-domain task."""
        n = int(rng.integers(min_len, max_len + 1))
        out: List[int] = []
        while len(out) < n:
            succ = None
            if len(out) >= 2:
                succ = self.tri.get((out[-2], out[-1]))
            if succ is None and len(out) >= 1:
                succ = self.bi.get(out[-1])
            if succ is None and not out:
                succ = self.bos_succ
            # 20% forced backoff even when continuations exist: real
            # speech strays off the LM's dense paths
            if succ is not None and rng.random() > 0.2:
                ids, p = succ
                out.append(int(rng.choice(ids, p=p)))
            else:
                out.append(int(rng.choice(len(self.words), p=self.uni_p)))
        return out


def _dirichlet_probs(rng: np.random.Generator, k: int,
                     mass: float) -> np.ndarray:
    p = rng.dirichlet(np.ones(k)) * mass
    return np.maximum(p, 1e-7)


def make_language(vocab: int = 20000, num_phones: int = 41,
                  bigram_hist_frac: float = 0.6,
                  bigram_avg_succ: float = 12.0,
                  trigram_hist_frac: float = 1.4,
                  trigram_avg_succ: float = 5.0,
                  seed: int = 0) -> SynthLanguage:
    """Generate the language.  Default shape ≈ a pruned trigram: with
    vocab=100k this yields ~1M n-grams (cf. librispeech tgsmall)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i:06d}" for i in range(vocab)]
    lens = rng.integers(3, 8, vocab)
    prons = [rng.integers(1, num_phones + 1, l).astype(np.int32)
             for l in lens]
    lexicon = [(words[i], [f"p{p:02d}" for p in prons[i]])
               for i in range(vocab)]

    # --- unigrams: Zipf over rank, 97% of the mass (3% to </s>) ---
    uni_p = 1.0 / (np.arange(vocab) + 2.7)
    uni_p /= uni_p.sum()
    lines = ["-99\t<s>\t-0.5", f"{np.log10(0.03):.4f}\t</s>"]
    lp = np.log10(uni_p * 0.97)
    for i in range(vocab):
        lines.append(f"{lp[i]:.4f}\t{words[i]}\t-0.7")
    n1 = len(lines)
    lines1 = lines

    # --- bigrams: the most frequent `bigram_hist_frac` of words carry
    # explicit continuations (60% of the conditional mass; backoff -0.4)
    bi: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    lines2: List[str] = []
    n_hist2 = int(vocab * bigram_hist_frac)
    lo, hi = max(2, int(bigram_avg_succ * 0.3)), int(bigram_avg_succ * 1.7)
    for h in range(n_hist2):
        k = int(rng.integers(lo, hi + 1))
        succ = rng.choice(vocab, size=k, replace=False)
        p = _dirichlet_probs(rng, k, 0.6)
        logp = np.log10(p)
        wh = words[h]
        for j in range(k):
            lines2.append(f"{logp[j]:.4f}\t{wh} {words[succ[j]]}\t-0.4")
        bi[h] = (succ, p / p.sum())
    k = min(50, vocab)
    succ = rng.choice(vocab, size=k, replace=False)
    p = _dirichlet_probs(rng, k, 0.6)
    logp = np.log10(p)
    for j in range(k):
        lines2.append(f"{logp[j]:.4f}\t<s> {words[succ[j]]}\t-0.4")
    bos_succ = (succ, p / p.sum())

    # --- trigrams: histories sampled from the explicit bigrams ---
    all_bi = [(h, int(s)) for h, (ids, _) in bi.items() for s in ids]
    tri: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    lines3: List[str] = []
    n_hist3 = min(len(all_bi), int(vocab * trigram_hist_frac))
    lo3 = max(2, int(trigram_avg_succ * 0.4))
    hi3 = int(trigram_avg_succ * 1.6)
    idx = rng.choice(len(all_bi), size=n_hist3, replace=False)
    for bi_idx in idx:
        h1, h2 = all_bi[bi_idx]
        k = int(rng.integers(lo3, hi3 + 1))
        succ = rng.choice(vocab, size=k, replace=False)
        p = _dirichlet_probs(rng, k, 0.5)
        logp = np.log10(p)
        w1, w2 = words[h1], words[h2]
        for j in range(k):
            lines3.append(f"{logp[j]:.4f}\t{w1} {w2} {words[succ[j]]}")
        tri[(h1, h2)] = (succ, p / p.sum())

    arpa = ("\\data\\\n"
            f"ngram 1={n1}\nngram 2={len(lines2)}\nngram 3={len(lines3)}\n"
            "\n\\1-grams:\n" + "\n".join(lines1) +
            "\n\n\\2-grams:\n" + "\n".join(lines2) +
            "\n\n\\3-grams:\n" + "\n".join(lines3) +
            "\n\n\\end\\\n")
    return SynthLanguage(words=words, lexicon=lexicon, prons=prons,
                         num_phones=num_phones, arpa_text=arpa,
                         uni_p=uni_p, bi=bi, tri=tri, bos_succ=bos_succ)


def synth_posteriors(
    phone_seq: Sequence[int], num_phones: int, rng: np.random.Generator,
    spike_p: Tuple[float, float] = (0.45, 0.85),
    n_competitors: int = 4,
) -> np.ndarray:
    """CTC-shaped posteriors [T, 1+num_phones] for a phone-id sequence.

    What a *trained* CTC net emits (the peaky blank-dominated pattern in
    the reference's decode logs): per phone, 1–2 spike frames where the
    true phone holds 45–85% of the mass against a handful of confusable
    competitors, separated by high-blank frames (the frames
    --blank-threshold 0.98 skipping drops).  Competitor mass is what
    forces the decoder's beam to actually branch — the difficulty knob."""
    a = num_phones + 1
    rows: List[np.ndarray] = []
    prev = -1
    for ph in phone_seq:
        n_blank = int(rng.integers(0, 3))
        if ph == prev:
            n_blank = max(n_blank, 1)  # CTC needs a blank between repeats
        for _ in range(n_blank):
            row = np.full(a, 1e-5, np.float64)
            row[0] = 0.995
            rows.append(row)
        for _ in range(int(rng.integers(1, 3))):
            row = np.full(a, 1e-4, np.float64)
            p_true = rng.uniform(*spike_p)
            row[ph] = p_true
            row[0] = rng.uniform(0.02, 0.10)
            comp = rng.choice(num_phones, size=n_competitors,
                              replace=False) + 1
            row[comp] += rng.dirichlet(np.ones(n_competitors)) * \
                (0.9 - p_true)
            rows.append(row)
        prev = ph
    for _ in range(2):
        row = np.full(a, 1e-5, np.float64)
        row[0] = 0.995
        rows.append(row)
    post = np.stack(rows)
    post /= post.sum(axis=1, keepdims=True)
    return post.astype(np.float32)


def edit_distance(ref: Sequence[int], hyp: Sequence[int]) -> int:
    """Levenshtein distance (WER numerator), O(|ref|·|hyp|) vectorized
    over the hyp dimension."""
    r, h = list(ref), list(hyp)
    if not r:
        return len(h)
    prev = np.arange(len(h) + 1)
    for i, rw in enumerate(r, 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (np.asarray(h) != rw)
        for j in range(1, len(h) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])
