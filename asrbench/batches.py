"""Which utterances form each training batch, worked out again.

A frozen copy of the rules that ``train_ctc``'s egs pipeline applies
(``data/pipeline.py`` ``EgsPipeline.epoch`` and ``data/bucketing.py``
``batch_by_length`` as of the benchmark's first version), on the
benchmark's own utterance table: the epoch's permutation from
``default_rng(seed + epoch)``, frame subsampling at ``epoch % factor``,
the reader's skip rules (``ctc-nnet-train.cc:84-94``), a stable sort by
length within windows of 4,096, full batches only, and the batches
shuffled by the same generator.  Numpy only.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from asrbench.traffic import Utterance, subsampled_frames

__all__ = ["MAX_LABEL_LENGTH", "example_ok", "epoch_batches",
           "rank_shards", "global_batches"]

MAX_LABEL_LENGTH = 639
SORT_WINDOW = 4096


def example_ok(frames: int, phones: int, max_allow_frames: int) -> bool:
    if max_allow_frames > 0 and frames > max_allow_frames:
        return False
    if phones > MAX_LABEL_LENGTH or phones == 0:
        return False
    return frames >= 2 * phones + 1


def epoch_batches(pool: Sequence[Utterance], seed: int, epoch: int,
                  minibatch: int, max_allow_frames: int, factor: int
                  ) -> List[List[int]]:
    """The epoch's batches as lists of indices into ``pool``, in the
    order the steps take them."""
    rng = np.random.default_rng(seed + epoch)
    shift = epoch % factor if factor > 1 else 0
    kept = []
    for i in rng.permutation(len(pool)):
        u = pool[int(i)]
        t = subsampled_frames(u.frames, factor, shift)
        if example_ok(t, u.phones, max_allow_frames):
            kept.append((int(i), t))
    batches: List[List[int]] = []
    leftover: list = []
    for start in range(0, len(kept), SORT_WINDOW):
        chunk = sorted(leftover + kept[start:start + SORT_WINDOW],
                       key=lambda e: e[1])
        n_full = (len(chunk) // minibatch) * minibatch
        for i in range(0, n_full, minibatch):
            batches.append([e[0] for e in chunk[i:i + minibatch]])
        leftover = chunk[n_full:]
    rng.shuffle(batches)
    return batches


def rank_shards(pool: Sequence[Utterance], processes: int,
                max_allow_frames: int, factor: int) -> List[List[int]]:
    """Each process's utterances (indices into ``pool``): all of them in
    one process; across processes the ones every frame shift keeps,
    truncated to a multiple of the process count and dealt out
    ``[r::processes]`` (``train_ctc``'s ``shard_for_spmd``)."""
    if processes <= 1:
        return [list(range(len(pool)))]
    kept = [i for i, u in enumerate(pool)
            if all(example_ok(subsampled_frames(u.frames, factor, s),
                              u.phones, max_allow_frames)
                   for s in range(max(factor, 1)))]
    kept = kept[:(len(kept) // processes) * processes]
    return [kept[r::processes] for r in range(processes)]


def global_batches(pool: Sequence[Utterance], seed: int, minibatch: int,
                   max_allow_frames: int, factor: int, processes: int,
                   steps: int) -> List[dict]:
    """The first ``steps`` global batches: {"epoch", "ranks": [indices
    into ``pool`` of each process's rows]}; each process batches its own
    shard with ``minibatch / processes`` rows."""
    shards = rank_shards(pool, processes, max_allow_frames, factor)
    host_mb = minibatch // processes
    out: List[dict] = []
    epoch = 0
    while len(out) < steps:
        per_rank = []
        for shard in shards:
            sub = [pool[i] for i in shard]
            per_rank.append([[shard[j] for j in b] for b in epoch_batches(
                sub, seed, epoch, host_mb, max_allow_frames, factor)])
        n = min(len(b) for b in per_rank)
        if n == 0:
            raise ValueError("an epoch forms no batch")
        out += [{"epoch": epoch, "ranks": [b[k] for b in per_rank]}
                for k in range(n)]
        epoch += 1
    return out[:steps]
