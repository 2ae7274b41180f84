"""Accumulate CMVN stats — the compute-cmvn-stats analogue.

Counterpart of ``kaldi_ctc_tpu/cli/compute_cmvn.py`` with the same
flags, defaults and archives; host-only numpy, as there.

Reads a feature archive, accumulates per-speaker (via --spk2utt or
utt2spk) or per-utterance [2, D+1] stats in the Kaldi on-disk convention,
and writes a stats archive usable as the ``--cmvn`` input of every
consumer (train_ctc, decode_ctc, prepare_egs, ...).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats", required=True, help="feature rspecifier")
    p.add_argument("--utt2spk", default=None,
                   help="per-speaker stats keyed by speaker (default: "
                        "per-utterance)")
    p.add_argument("--out", required=True,
                   help="stats wspecifier, e.g. ark,scp:cmvn.ark,cmvn.scp")
    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.features.cmvn import acc_cmvn_stats
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (
        MatrixWriter, SequentialMatrixReader, SequentialTextReader)

    args = parse_args(argv)
    log = get_logger("compute_cmvn")

    utt2spk = (dict(SequentialTextReader(args.utt2spk))
               if args.utt2spk else None)
    acc = {}
    n_utts = 0
    for key, feats in SequentialMatrixReader(args.feats):
        spk = utt2spk.get(key, key) if utt2spk else key
        stats = acc_cmvn_stats(feats)
        if spk in acc:
            acc[spk] += stats
        else:
            acc[spk] = stats
        n_utts += 1
    if not acc:
        log.error("no features read"); sys.exit(1)
    with MatrixWriter(args.out) as w:
        for spk in sorted(acc):
            w[spk] = acc[spk].astype(np.float64)
    log.info("wrote CMVN stats for %d %s (%d utterances)",
             len(acc), "speakers" if utt2spk else "utterances", n_utts)


if __name__ == "__main__":
    main()
