"""Host-side egs pipeline with background prefetch.

Counterpart of ``kaldi_ctc_tpu/data/pipeline.py`` (get_egs2.sh + the
ctcbin egs tools + the double-buffered background reader,
``ctc/ctc-nnet-train.cc:31-177``): reads Kaldi-format features and
alignments, applies CMVN, collapses alignments to CTC labels, filters,
applies frame-subsampling/shift augmentation, buckets into padded numpy
minibatches, and prefetches batches on a background thread while the
device computes.  Numpy only: an epoch draws from
``np.random.default_rng(seed + epoch)`` in the JAX package's order, so
both packages yield the same batches, bit for bit.  An epoch's
preparation (filter, subsampling, shuffle, grouping), each batch's
padding and the producer's wait on a full queue are spans of
``utils/profiling.py`` (``pipeline.prepare``, ``pipeline.batch``,
``pipeline.put_wait``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from kaldi_ctc_tpu_torch.data.bucketing import (default_menus,
                                                group_by_length, pad_batch)
from kaldi_ctc_tpu_torch.data.egs import (
    CtcExample,
    collapse_alignment,
    example_ok,
    frame_subsample,
)
from kaldi_ctc_tpu_torch.features.cmvn import apply_cmvn
from kaldi_ctc_tpu_torch.utils import kaldi_io
from kaldi_ctc_tpu_torch.utils.profiling import profiler

__all__ = ["load_examples", "EgsPipeline", "Prefetcher"]


def load_examples(
    feats_rspecifier: str,
    ali_rspecifier: str,
    cmvn_rspecifier: Optional[str] = None,
    utt2spk: Optional[Dict[str, str]] = None,
    label_shift: int = 1,
    collapse: bool = True,
    tid_to_pdf: Optional[np.ndarray] = None,
) -> Iterator[CtcExample]:
    """Stream (features, alignment) pairs joined by key → CtcExamples.

    Alignments are pdf-id sequences; `collapse` applies the
    `ali-to-pdf --shift=1 --unique=true` transform.  If `tid_to_pdf` is
    given (from a Kaldi TransitionModel), alignments are transition-id
    sequences and are mapped to pdf-ids first (bin/ali-to-pdf.cc:39-74).
    CMVN stats are looked up per speaker via utt2spk (or per utterance if
    no map given).
    """
    ali = {k: v for k, v in kaldi_io.SequentialIntVectorReader(ali_rspecifier)}
    if tid_to_pdf is not None:
        # the map is itself 1-based-indexed: tid_to_pdf[tid] = pdf
        tid_to_pdf = np.asarray(tid_to_pdf, np.int32)
        ali = {k: tid_to_pdf[np.asarray(v, np.int64)]
               for k, v in ali.items()}
    cmvn = None
    if cmvn_rspecifier is not None:
        cmvn = kaldi_io.open_random_access_matrices(cmvn_rspecifier)
    for key, feats in kaldi_io.SequentialMatrixReader(feats_rspecifier):
        if key not in ali:
            continue
        if cmvn is not None:
            spk = utt2spk.get(key, key) if utt2spk else key
            if spk in cmvn:
                feats = apply_cmvn(torch.from_numpy(
                    np.asarray(feats, np.float32)), cmvn[spk]).numpy()
        labels = ali[key]
        if collapse:
            labels = collapse_alignment(labels, shift=label_shift)
        else:
            labels = np.asarray(labels, dtype=np.int32)
        yield CtcExample(key=key, feats=np.asarray(feats, np.float32),
                         labels=labels)


class EgsPipeline:
    """In-memory epoch pipeline: filter → subsample/shift → shuffle → bucket.

    Holds examples in host RAM; each process's pipeline sees its own
    shard (the analogue of per-job archives in steps/ctc/train.sh:408-419).
    """

    def __init__(
        self,
        examples: Iterable[CtcExample],
        minibatch_size: int = 48,
        max_allow_frames: int = 2000,
        frame_subsampling_factor: int = 1,
        sort_window: int = 4096,
        seed: int = 0,
        fixed_shape=None,
        time_stride: int = 1,
    ):
        self.examples: List[CtcExample] = list(examples)
        self.minibatch_size = minibatch_size
        self.max_allow_frames = max_allow_frames
        self.fs_factor = frame_subsampling_factor
        self.sort_window = sort_window
        self.seed = seed
        self.num_skipped = 0
        # fixed_shape: (t_max, l_max) — pad every batch to this one shape
        # (several processes contributing shards of one global batch must
        # agree on it; computed from the global example list)
        self.fixed_shape = fixed_shape
        # model output frames per input frame denominator (DS2 conv
        # front end): the 2L+1 filter checks the model's output length
        self.time_stride = time_stride

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One pass: frame-shift cycles with the epoch index
        (steps/ctc/train.sh:412: frame_shift = iter % factor)."""
        with profiler.span("pipeline.prepare"):
            rng = np.random.default_rng(self.seed + epoch_idx)
            shift = epoch_idx % self.fs_factor if self.fs_factor > 1 else 0
            egs = []
            self.num_skipped = 0
            order = rng.permutation(len(self.examples))
            for i in order:
                e = self.examples[i]
                feats = frame_subsample(e.feats, self.fs_factor, shift)
                eg = CtcExample(e.key, feats, e.labels)
                if not example_ok(eg, self.max_allow_frames,
                                  time_stride=self.time_stride):
                    self.num_skipped += 1
                    continue
                egs.append(eg)
            frame_buckets = label_buckets = None
            if self.fixed_shape is not None:
                frame_buckets = [max(int(self.fixed_shape[0]), 1)]
                label_buckets = [max(int(self.fixed_shape[1]), 1)]
            frame_buckets, label_buckets = default_menus(frame_buckets,
                                                         label_buckets)
            groups = group_by_length(egs, self.minibatch_size,
                                     sort_window=self.sort_window, rng=rng)
        profiler.count("pipeline.skipped", self.num_skipped)
        for group in groups:
            with profiler.span("pipeline.batch"):
                batch = pad_batch(group, frame_buckets, label_buckets)
            profiler.count("pipeline.batches")
            yield batch


class Prefetcher:
    """Background-thread prefetch (double buffering), the analogue of
    NnetCtcExampleBackgroundReader's two-semaphore handoff
    (ctc/ctc-nnet-train.cc:31-177).  A producer's exception is raised in
    the consumer after the batches before it."""

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterator:
                    with profiler.span("pipeline.put_wait"):
                        self._q.put(item)
            except BaseException as e:  # surface in consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
