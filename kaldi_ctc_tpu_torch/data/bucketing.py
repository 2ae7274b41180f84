"""Length bucketing and batch padding with a fixed shape menu.

The rules of ``kaldi_ctc_tpu/data/bucketing.py`` (host-only numpy), its
grouping split out as :func:`group_by_length` so that the pipeline can
time an epoch's preparation apart from each batch's padding.  The port
runs eagerly and recompiles nothing, but keeps the menu so a batch has
the shape the JAX package gives it.

The reference sorts egs by length (``ctcbin/nnet-ctc-sort-egs.cc:82-90``,
``get_egs2.sh:326-338``) and pads each minibatch to its max length
(``ctc/ctc-nnet-update.cc:371-419``); cuDNN re-inits descriptors when a new
max length shows up.  On TPU every distinct padded shape is an XLA
recompile, so lengths are rounded up to a small geometric menu of bucket
sizes — recompiles are bounded by the menu size while padding waste stays
≤ the menu's growth factor.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from kaldi_ctc_tpu_torch.data.egs import CtcExample

__all__ = ["make_buckets", "bucket_length", "pad_batch", "batch_by_length",
           "group_by_length", "default_menus"]


def make_buckets(
    min_len: int = 32,
    max_len: int = 2048,
    growth: float = 1.25,
) -> List[int]:
    """Geometric menu of padded lengths."""
    out = [min_len]
    while out[-1] < max_len:
        nxt = int(math.ceil(out[-1] * growth))
        nxt = min(nxt, max_len)
        if nxt == out[-1]:
            break
        out.append(nxt)
    return out


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; lengths past the menu pad to themselves
    (exact shape — rare recompile beats an undersized allocation)."""
    for b in buckets:
        if n <= b:
            return b
    return int(n)


def pad_batch(
    egs: Sequence[CtcExample],
    frame_buckets: Sequence[int],
    label_buckets: Sequence[int],
) -> Dict[str, np.ndarray]:
    """Pad a minibatch of examples to bucketed shapes.

    Features are edge-padded with the last frame (the reference replicates
    edge frames rather than zero-padding, ctc-nnet-update.cc:399-409).
    """
    b = len(egs)
    t_max = bucket_length(max(e.num_frames for e in egs), frame_buckets)
    l_max = bucket_length(max(e.num_labels for e in egs), label_buckets)
    d = egs[0].feats.shape[1]
    feats = np.zeros((b, t_max, d), dtype=np.float32)
    labels = np.zeros((b, l_max), dtype=np.int32)
    input_lens = np.zeros(b, dtype=np.int32)
    label_lens = np.zeros(b, dtype=np.int32)
    for i, e in enumerate(egs):
        t, l = e.num_frames, e.num_labels
        feats[i, :t] = e.feats
        if t < t_max:
            feats[i, t:] = e.feats[-1]  # edge replication
        labels[i, :l] = e.labels
        input_lens[i] = t
        label_lens[i] = l
    return {
        "feats": feats,
        "labels": labels,
        "input_lens": input_lens,
        "label_lens": label_lens,
        "keys": [e.key for e in egs],
    }


def group_by_length(
    egs: Iterable[CtcExample],
    minibatch_size: int,
    sort_window: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> List[List[CtcExample]]:
    """Length-homogeneous minibatches of examples, in the order
    :func:`batch_by_length` pads them (its sorting and shuffle)."""
    egs = list(egs)
    if not egs:
        return []
    window = sort_window if sort_window > 0 else len(egs)
    batches: List[List[CtcExample]] = []
    leftover: List[CtcExample] = []
    for start in range(0, len(egs), window):
        # window remainders carry over so only the final < minibatch tail
        # of the whole epoch is dropped (not the longest of every window)
        chunk = sorted(leftover + egs[start:start + window],
                       key=lambda e: e.num_frames)
        n_full = (len(chunk) // minibatch_size) * minibatch_size
        for i in range(0, n_full, minibatch_size):
            batches.append(chunk[i:i + minibatch_size])
        leftover = chunk[n_full:]
    if rng is not None:
        rng.shuffle(batches)
    return batches


def default_menus(
    frame_buckets: Optional[Sequence[int]] = None,
    label_buckets: Optional[Sequence[int]] = None,
):
    """The padded-length menus :func:`batch_by_length` uses where none is
    given."""
    if frame_buckets is None:
        frame_buckets = make_buckets()
    if label_buckets is None:
        label_buckets = make_buckets(min_len=8, max_len=640, growth=1.5)
    return frame_buckets, label_buckets


def batch_by_length(
    egs: Iterable[CtcExample],
    minibatch_size: int,
    frame_buckets: Optional[Sequence[int]] = None,
    label_buckets: Optional[Sequence[int]] = None,
    sort_window: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Group examples into length-homogeneous padded minibatches.

    sort_window > 0: sort within sliding windows of that many examples
    (the windowed variant of nnet-ctc-sort-egs) so batches are
    length-homogeneous without a global sort; 0 sorts everything.
    A final short batch is dropped (static batch shapes for XLA).
    """
    frame_buckets, label_buckets = default_menus(frame_buckets,
                                                 label_buckets)
    for group in group_by_length(egs, minibatch_size, sort_window, rng):
        yield pad_batch(group, frame_buckets, label_buckets)
