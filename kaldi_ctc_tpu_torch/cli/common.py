"""What the port's CLIs share: the device they run on, the feature
archives they read, and the batched forward."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

__all__ = ["resolve_device", "read_feature_examples", "batches"]


def resolve_device(name: str) -> torch.device:
    """The device a CLI runs on; asking for CUDA where there is none
    raises rather than running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} but no CUDA device is "
                           "available (pass --device cpu to run on the "
                           "CPU)")
    return device


def read_feature_examples(feats: str, cmvn: Optional[str],
                          utt2spk: Optional[str],
                          frame_subsampling_factor: int) -> List:
    """Utterances of the ``feats`` rspecifier as ``CtcExample``s with
    per-speaker CMVN applied (stats from the ``cmvn`` rspecifier, keyed by
    ``utt2spk``'s speaker, or by the utterance without it), then
    subsampled: decode_ctc's and nnet_compute's reading, as the JAX
    package's CLIs do it."""
    from kaldi_ctc_tpu_torch.data import CtcExample, frame_subsample
    from kaldi_ctc_tpu_torch.features.cmvn import apply_cmvn
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (
        SequentialMatrixReader, SequentialTextReader,
        open_random_access_matrices)

    spk_of = dict(SequentialTextReader(utt2spk)) if utt2spk else None
    stats = open_random_access_matrices(cmvn) if cmvn else None
    egs = []
    for key, mat in SequentialMatrixReader(feats):
        mat = np.asarray(mat, np.float32)
        if stats is not None:
            spk = spk_of.get(key, key) if spk_of else key
            if spk in stats:
                mat = apply_cmvn(torch.from_numpy(mat), stats[spk]).numpy()
        mat = frame_subsample(mat, frame_subsampling_factor)
        egs.append(CtcExample(key, mat, np.zeros(1, np.int32)))
    return egs


def batches(egs: List, minibatch_size: int) -> Iterator:
    """Consecutive groups of ``minibatch_size`` examples, each padded to
    the JAX package's frame buckets → (group, padded batch)."""
    from kaldi_ctc_tpu_torch.data.bucketing import make_buckets, pad_batch

    frame_buckets = make_buckets()
    for i in range(0, len(egs), minibatch_size):
        group = egs[i:i + minibatch_size]
        yield group, pad_batch(group, frame_buckets, [4])
