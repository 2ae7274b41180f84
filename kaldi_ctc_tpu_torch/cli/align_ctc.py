"""CTC forced alignment — the realignment surface of the reference
(``steps/nnet2/align.sh`` + ``steps/ctc/relabel_egs2.sh``; wired but
left TODO in ``steps/ctc/train.sh:111-115``), done the CTC-native way:
the batched Viterbi best path through the blank-interleaved label
lattice the loss uses.

Counterpart of ``kaldi_ctc_tpu/cli/align_ctc.py`` with the same flags,
files and summary line, plus ``--device`` (default ``cuda``; with no card
it raises).  The forward runs on the device (on the card the recurrent
kernels of the model's layers), then ``ops.ctc.ctc_viterbi_align`` there.

Inputs: features (``--feats`` [+ cmvn] or ``--egs``) and label
sequences, either per-frame alignments (``--ali``, collapsed like the
egs pipeline: ali-to-pdf --shift=1 --unique=true) or already-collapsed
shifted label sequences (``--labels``).

Outputs:
- ``--frame-labels``: per-output-frame symbol ids in the model's output
  space (0 = blank), for ``prepare_egs relabel --frame-labels 1`` and
  ``adjust_priors --ali ... --frame-labels 1``;
- ``--ctm``: label timings (utt channel start dur label), one row per
  emitted label instance, at the logit frame rate.

Prints one JSON summary line (aligned/failed counts, mean path log-prob
per frame).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats", default=None)
    p.add_argument("--egs", default=None,
                   help="egs archive (labels come from the egs)")
    p.add_argument("--ali", default=None,
                   help="GMM-style alignments; collapsed+shifted like "
                        "the egs pipeline")
    p.add_argument("--labels", default=None,
                   help="already collapsed+shifted label sequences")
    p.add_argument("--cmvn", default=None)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--dir", default=None)
    p.add_argument("--model", default=None, help="inference artifact (.npz)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--frame-labels", default=None,
                   help="wspecifier for per-frame symbol ids")
    p.add_argument("--ctm", default=None,
                   help="file for label timings ('-' = stdout)")
    p.add_argument("--frame-shift", type=float, default=0.01,
                   help="seconds per *input* frame before subsampling")
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--minibatch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on; 'cuda' with no "
                        "card raises")
    return p.parse_args(argv)


def _load_examples(args, log) -> list:
    """The (features, labels) pairs to align, as ``CtcExample``s."""
    from kaldi_ctc_tpu_torch.cli.common import read_feature_examples
    from kaldi_ctc_tpu_torch.data import (CtcExample, collapse_alignment,
                                          frame_subsample)
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialIntVectorReader

    label_seqs = {}
    if args.ali:
        for key, ali in SequentialIntVectorReader(args.ali):
            label_seqs[key] = collapse_alignment(np.asarray(ali))
    elif args.labels:
        for key, seq in SequentialIntVectorReader(args.labels):
            label_seqs[key] = np.asarray(seq, np.int32)

    if args.egs:
        from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
        return [CtcExample(e.key,
                           frame_subsample(e.feats,
                                           args.frame_subsampling_factor),
                           np.asarray(label_seqs.get(e.key, e.labels),
                                      np.int32))
                for e in SequentialEgsReader(args.egs)]
    if not args.feats:
        log.error("need --feats or --egs"); sys.exit(1)
    if not label_seqs:
        log.error("--feats needs --ali or --labels"); sys.exit(1)
    egs, missing = [], 0
    for e in read_feature_examples(args.feats, args.cmvn, args.utt2spk,
                                   args.frame_subsampling_factor):
        if e.key not in label_seqs:
            missing += 1
            continue
        egs.append(CtcExample(e.key, e.feats, label_seqs[e.key]))
    if missing:
        log.warning("%d utterances had no labels; skipped", missing)
    return egs


def main(argv=None):
    from kaldi_ctc_tpu_torch.cli.common import resolve_device
    from kaldi_ctc_tpu_torch.data import pad_batch
    from kaldi_ctc_tpu_torch.data.bucketing import make_buckets
    from kaldi_ctc_tpu_torch.models.artifact import load_acoustic_model
    from kaldi_ctc_tpu_torch.training.realign import align_batch
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.kaldi_io import IntVectorWriter

    args = parse_args(argv)
    log = get_logger("align_ctc")
    if not args.frame_labels and not args.ctm:
        log.error("need --frame-labels and/or --ctm"); sys.exit(1)
    device = resolve_device(args.device)
    try:
        params, cfg, _, _ = load_acoustic_model(args.model, args.dir,
                                                args.step, device)
    except ValueError as e:
        log.error("%s", e); sys.exit(1)

    egs = _load_examples(args, log)
    # range-check labels before the gather clamps them silently
    # (out-of-range ids mean the wrong input kind: transition-ids or
    # unshifted labels, which would write corrupt alignments)
    kept, n_oor = [], 0
    for e in egs:
        labs = np.asarray(e.labels)
        if labs.size and (labs.min() < 1 or labs.max() >= cfg.num_targets):
            if n_oor == 0:
                log.warning(
                    "%s: label ids outside [1, %d) (unshifted labels or "
                    "transition-ids?) — utterance skipped", e.key,
                    cfg.num_targets)
            n_oor += 1
            continue
        kept.append(e)
    if n_oor:
        log.warning("skipped %d utterances with out-of-range labels",
                    n_oor)
    egs = kept
    # length-sorted groups: homogeneous pads
    egs.sort(key=lambda e: e.num_frames)

    # seconds per logit frame (input shift × subsampling × conv stride)
    sec = args.frame_shift * args.frame_subsampling_factor * cfg.time_stride

    frame_buckets = make_buckets()
    label_buckets = make_buckets(min_len=8, max_len=640, growth=1.5)
    n_ok = n_bad = 0
    tot_lp = tot_frames = 0.0
    fw = IntVectorWriter(args.frame_labels) if args.frame_labels else None
    ctm = (sys.stdout if args.ctm == "-" else
           open(args.ctm, "w")) if args.ctm else None
    try:
        for i in range(0, len(egs), args.minibatch_size):
            group = egs[i:i + args.minibatch_size]
            batch = pad_batch(group, frame_buckets, label_buckets)
            frame_labels, lp, ok, out_lens = align_batch(params, cfg, batch)
            for j, e in enumerate(group):
                t = int(out_lens[j])
                if not ok[j]:
                    n_bad += 1
                    log.warning("alignment failed for %s (too few "
                                "frames for the label sequence)", e.key)
                    continue
                n_ok += 1
                tot_lp += float(lp[j])
                tot_frames += t
                fl = frame_labels[j, :t]
                if fw is not None:
                    fw[e.key] = fl.astype(np.int32)
                if ctm is not None:
                    # one row per maximal run of a non-blank symbol
                    # (repeated labels always have a blank between them
                    # on a valid CTC path, so runs == label instances)
                    change = np.flatnonzero(np.diff(fl) != 0) + 1
                    starts = np.concatenate([[0], change])
                    ends = np.concatenate([change, [t]])
                    for s, en in zip(starts, ends):
                        if fl[s] != 0:
                            ctm.write(f"{e.key} 1 {s * sec:.3f} "
                                      f"{(en - s) * sec:.3f} "
                                      f"{int(fl[s])}\n")
    finally:
        if fw is not None:
            fw.close()
        if ctm is not None and ctm is not sys.stdout:
            ctm.close()
    print(json.dumps({
        "aligned": n_ok, "failed": n_bad,
        "avg_logprob_per_frame": (tot_lp / tot_frames
                                  if tot_frames else 0.0)}))
    log.info("aligned %d utterances (%d failed)", n_ok, n_bad)


if __name__ == "__main__":
    main()
