"""On-disk CTC example archives + the egs stream-tool family.

A copy of ``kaldi_ctc_tpu/data/egs_io.py`` (host-only numpy).

The TPU-native counterpart of NnetCtcExample serialization
(``ctc/ctc-nnet-example.h:37-79``, ``ctc/ctc-nnet-example.cc:29-60``) and
the ctcbin archive tools: ``nnet-ctc-copy-egs`` (round-robin/random
split), ``nnet-ctc-sort-egs`` (sort by NumFrames, full or windowed,
``nnet-ctc-sort-egs.cc:28-30,82-90``), ``nnet-ctc-shuffle-egs`` (buffered
random shuffle + frame subsample/shift, ``nnet-ctc-shuffle-egs.cc:41-58,
85-110``), ``nnet-ctc-subset-egs``, ``nnet-ctc-relabel-egs``
(``nnet-ctc-relabel-egs.cc:60-70``).

Record format (ark value, after the key + binary marker): token-tagged
like Kaldi objects — ``<CtcEg> <Labels> int-vector <Feats>
matrix </CtcEg>``, with features stored as a Kaldi CompressedMatrix by
default (the reference stores CompressedMatrix too,
``ctc/ctc-nnet-example.h:50``). Archives written as ``ark,scp:`` pairs
support random access.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np

from kaldi_ctc_tpu_torch.data.egs import CtcExample, collapse_alignment, frame_subsample
from kaldi_ctc_tpu_torch.utils.kaldi_io import (
    SequentialReader,
    _read_binary_int_vector,
    _read_binary_object,
    _read_token,
    _write_binary_int_vector,
    _write_binary_matrix,
    _write_token,
    _Writer,
)

__all__ = [
    "EgsWriter", "SequentialEgsReader", "copy_egs", "sort_egs",
    "shuffle_egs", "subset_egs", "relabel_egs",
]


def _expect(f, token: str) -> None:
    tok = _read_token(f)
    if tok != token:
        raise ValueError(f"Expected {token}, got {tok}")


def _write_example(f, eg: CtcExample, compress: bool = True) -> None:
    _write_token(f, "<CtcEg>")
    _write_token(f, "<Labels>")
    _write_binary_int_vector(f, eg.labels)
    _write_token(f, "<Feats>")
    _write_binary_matrix(f, np.asarray(eg.feats, np.float32),
                         compress=compress)
    _write_token(f, "</CtcEg>")


def _read_example(f):
    _expect(f, "<CtcEg>")
    _expect(f, "<Labels>")
    labels = _read_binary_int_vector(f)
    _expect(f, "<Feats>")
    feats = _read_binary_object(f)
    _expect(f, "</CtcEg>")
    return feats.astype(np.float32), labels


def EgsWriter(wspecifier: str, compress: bool = True) -> _Writer:
    def _w(f, eg):
        _write_example(f, eg, compress=compress)
    return _Writer(wspecifier, _w)


class SequentialEgsReader:
    """Iterate CtcExamples from an egs archive rspecifier."""

    def __init__(self, rspecifier: str):
        self._inner = SequentialReader(rspecifier, _read_example)

    def __iter__(self) -> Iterator[CtcExample]:
        for key, (feats, labels) in self._inner:
            yield CtcExample(key=key, feats=feats, labels=labels)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def copy_egs(
    egs: Iterable[CtcExample],
    num_outputs: int,
    random: bool = False,
    seed: int = 0,
) -> Iterator[tuple]:
    """Yield (output_index, example): round-robin (or random) split across
    N archives (nnet-ctc-copy-egs)."""
    rng = np.random.default_rng(seed)
    for i, eg in enumerate(egs):
        idx = int(rng.integers(num_outputs)) if random else i % num_outputs
        yield idx, eg


def sort_egs(
    egs: Iterable[CtcExample],
    window: int = 0,
) -> Iterator[CtcExample]:
    """Sort by NumFrames — globally, or within sliding windows so only
    `window` examples are held in memory (nnet-ctc-sort-egs.cc:82-90)."""
    if window <= 0:
        yield from sorted(egs, key=lambda e: e.num_frames)
        return
    buf: List[CtcExample] = []
    for eg in egs:
        buf.append(eg)
        if len(buf) >= window:
            yield from sorted(buf, key=lambda e: e.num_frames)
            buf = []
    if buf:
        yield from sorted(buf, key=lambda e: e.num_frames)


def shuffle_egs(
    egs: Iterable[CtcExample],
    buffer_size: int = 5000,
    seed: int = 0,
    frame_subsampling_factor: int = 1,
    frame_shift: int = 0,
) -> Iterator[CtcExample]:
    """Buffered random shuffle with optional frame subsample/shift applied
    on the way through (nnet-ctc-shuffle-egs.cc:41-58,85-110)."""
    rng = np.random.default_rng(seed)

    def _aug(eg: CtcExample) -> CtcExample:
        if frame_subsampling_factor > 1:
            return CtcExample(
                eg.key,
                frame_subsample(eg.feats, frame_subsampling_factor,
                                frame_shift),
                eg.labels)
        return eg

    buf: List[CtcExample] = []
    for eg in egs:
        if len(buf) < buffer_size:
            buf.append(eg)
            continue
        i = int(rng.integers(len(buf)))
        out, buf[i] = buf[i], eg
        yield _aug(out)
    rng.shuffle(buf)
    for eg in buf:
        yield _aug(eg)


def subset_egs(egs: Iterable[CtcExample], n: int) -> Iterator[CtcExample]:
    """First n examples (nnet-ctc-subset-egs; diagnostics subsets)."""
    for i, eg in enumerate(egs):
        if i >= n:
            return
        yield eg


def relabel_egs(
    egs: Iterable[CtcExample],
    ali: dict,
    label_shift: int = 1,
    collapse: bool = True,
) -> Iterator[CtcExample]:
    """Swap label sequences from newer alignments, keyed by utterance;
    examples with no new alignment are dropped with a count
    (nnet-ctc-relabel-egs.cc:60-70)."""
    for eg in egs:
        if eg.key not in ali:
            continue
        labels = ali[eg.key]
        labels = (collapse_alignment(labels, shift=label_shift)
                  if collapse else np.asarray(labels, np.int32))
        yield CtcExample(eg.key, eg.feats, labels)
