"""Set the model's class priors — the nnet-adjust-priors analogue.

Counterpart of ``kaldi_ctc_tpu/cli/adjust_priors.py`` with the same
flags, defaults, files and log lines, plus ``--device`` (default
``cuda``; with no card it raises).  Three modes, mirroring
``nnet2bin/nnet-adjust-priors.cc:93-137`` as used by
``steps/ctc/train.sh:469-510``:

- ``--google-prior-const C`` (the CTC recipe default, C=9): priors = ones
  with prior[blank] = C (``nnet-adjust-priors.cc:128-132``).
- posterior mode (no const): run the net forward over typical data on
  the device (K2 per BLSTM layer on the card; eagerly, where the JAX
  package jits it) and use the average pdf posterior, renormalized and
  floored at ``--prior-floor`` (``nnet-adjust-priors.cc:92,133-137``);
  prints the reference's diagnostics (largest absolute difference, K-L
  divergence from old to new, ``nnet-adjust-priors.cc:49-66``).
- label-count mode (``--ali``): count CTC labels from alignments with one
  blank interleaved per label (``steps/ctc/train.sh:495-503``).
  Frame-level alignments are collapsed (``ali-to-pdf --shift=1
  --unique``) first; pass ``--trans-model`` for transition-id inputs.

The prior vector is written to ``<dir>/priors.npy``; decode_ctc picks it
up automatically.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """One-sided KL(p||q) over normalized copies (nnet-adjust-priors.cc:31-47)."""
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum(p * np.log(p / q)))


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="experiment directory")
    p.add_argument("--google-prior-const", type=float, default=0.0,
                   help="if nonzero: priors = ones, prior[blank] = const")
    p.add_argument("--feats", default=None,
                   help="feats rspecifier for posterior mode")
    p.add_argument("--ali", default=None,
                   help="alignment rspecifier for label-count mode")
    p.add_argument("--trans-model", default=None,
                   help="map --ali transition-ids to pdfs first")
    p.add_argument("--raw-labels", type=int, default=0,
                   help="treat --ali values as already-collapsed CTC "
                        "labels (no collapse/shift)")
    p.add_argument("--frame-labels", type=int, default=0,
                   help="treat --ali as align_ctc per-frame symbol ids "
                        "(blank=0): count true frame occupancies instead "
                        "of the one-blank-per-label approximation")
    p.add_argument("--cmvn", default=None)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--prior-floor", type=float, default=1.0e-15)
    p.add_argument("--minibatch-size", type=int, default=16)
    p.add_argument("--max-allow-frames", type=int, default=2000)
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--max-utts", type=int, default=0,
                   help="cap utterances used for posterior estimation (0=all)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the posterior forward; 'cuda' "
                        "with no card raises")
    return p.parse_args(argv)


def label_counts(args, num_targets: int, log) -> np.ndarray:
    """Label-count mode → prior vector (floored)."""
    from kaldi_ctc_tpu_torch.data.egs import collapse_alignment
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialIntVectorReader

    tid_map = None
    if args.trans_model:
        from kaldi_ctc_tpu_torch.utils.transition_model import (
            read_transition_model)
        tid_map = np.asarray(
            read_transition_model(args.trans_model).tid_to_pdf(), np.int32)
    counts = np.zeros(num_targets, np.float64)
    n_utts = 0
    n_oor = 0
    for key, ali in SequentialIntVectorReader(args.ali):
        labels = np.asarray(ali, np.int32)
        if tid_map is not None:
            labels = tid_map[labels.astype(np.int64)]
        if not args.raw_labels and not args.frame_labels:
            labels = collapse_alignment(labels)
        if labels.size == 0:
            continue
        oor = int(np.sum(labels >= num_targets))
        if oor:
            # out-of-range values mean the wrong alignment kind (e.g.
            # transition-ids without --trans-model): counting the
            # in-range ones as labels would corrupt the priors
            if n_oor == 0:
                log.warning(
                    "%s: %d alignment values >= num_targets=%d "
                    "(transition-ids without --trans-model?) — "
                    "dropped from the counts", key, oor, num_targets)
            n_oor += oor
        counts += np.bincount(labels, minlength=num_targets)[:num_targets]
        if not args.frame_labels:
            # the awk gsub inserts one blank per label (train.sh:498);
            # frame-label input counts the true blank occupancy instead
            counts[0] += labels.size
        n_utts += 1
    if n_utts == 0:
        log.error("no alignments loaded"); sys.exit(1)
    if n_oor:
        log.warning("dropped %d out-of-range alignment values in total",
                    n_oor)
    log.info("label counts over %d utterances, %d tokens",
             n_utts, int(counts.sum()))
    priors = (counts / counts.sum()).astype(np.float32)
    return np.maximum(priors, args.prior_floor)


def posterior_priors(args, cfg, device, log) -> np.ndarray:
    """Posterior mode → prior vector (floored): softmax of the forward,
    summed over each utterance's unpadded frames."""
    import torch

    from kaldi_ctc_tpu_torch.data.bucketing import make_buckets, pad_batch
    from kaldi_ctc_tpu_torch.data.egs import CtcExample, frame_subsample
    from kaldi_ctc_tpu_torch.features.cmvn import apply_cmvn
    from kaldi_ctc_tpu_torch.models import am_forward
    from kaldi_ctc_tpu_torch.training.checkpoint import restore_params
    from kaldi_ctc_tpu_torch.utils import kaldi_io
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader

    utt2spk = None
    if args.utt2spk:
        utt2spk = dict(SequentialTextReader(args.utt2spk))
    cmvn = (kaldi_io.open_random_access_matrices(args.cmvn)
            if args.cmvn else None)
    examples = []
    for key, feats in kaldi_io.SequentialMatrixReader(args.feats):
        feats = np.asarray(feats, np.float32)
        if cmvn is not None:
            spk = utt2spk.get(key, key) if utt2spk else key
            if spk in cmvn:
                feats = apply_cmvn(torch.from_numpy(feats),
                                   cmvn[spk]).numpy()
        feats = frame_subsample(feats, args.frame_subsampling_factor)
        if feats.shape[0] > args.max_allow_frames:
            continue
        examples.append(CtcExample(key, feats, np.ones(1, np.int32)))
        if args.max_utts and len(examples) >= args.max_utts:
            break
    if not examples:
        log.error("no utterances loaded"); sys.exit(1)

    params, _ = restore_params(os.path.join(args.dir, "checkpoints"), cfg,
                               device=device)

    def post_sum(feats, lens):
        logits = am_forward(params, feats, cfg, input_lens=lens)
        out_lens = cfg.output_lens(lens)
        post = torch.softmax(logits, dim=-1)
        valid = (torch.arange(logits.shape[1], device=device)[None, :]
                 < out_lens[:, None])[..., None]
        return torch.sum(torch.where(valid, post, 0.0), dim=(0, 1))

    # decode-style batching: length-sorted groups, short tail kept
    examples.sort(key=lambda e: e.num_frames)
    frame_buckets = make_buckets()
    acc = np.zeros(cfg.num_targets, np.float64)
    n_frames = 0
    with torch.inference_mode():
        for i in range(0, len(examples), args.minibatch_size):
            batch = pad_batch(examples[i:i + args.minibatch_size],
                              frame_buckets, [4])
            acc += post_sum(
                torch.as_tensor(batch["feats"], device=device),
                torch.as_tensor(batch["input_lens"], device=device)
            ).cpu().numpy().astype(np.float64)
            n_frames += int(batch["input_lens"].sum())
    if n_frames == 0:
        log.error("no frames accumulated"); sys.exit(1)
    log.info("averaged posteriors over %d frames", n_frames)
    priors = (acc / acc.sum()).astype(np.float32)
    return np.maximum(priors, args.prior_floor)


def main(argv=None):
    import json

    from kaldi_ctc_tpu_torch.cli.common import resolve_device
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.training.checkpoint import cfg_for_checkpoint
    from kaldi_ctc_tpu_torch.utils import get_logger

    args = parse_args(argv)
    log = get_logger("adjust_priors")
    device = resolve_device(args.device)

    with open(os.path.join(args.dir, "model_config.json")) as f:
        cfg = AmConfig.from_dict(json.load(f))
    # growth rewrites the config before a checkpoint at the new size
    # exists; the checkpoint meta is the template's truth
    cfg = cfg_for_checkpoint(os.path.join(args.dir, "checkpoints"), cfg)

    priors_path = os.path.join(args.dir, "priors.npy")
    old = np.load(priors_path) if os.path.exists(priors_path) else None

    if args.google_prior_const:
        priors = np.ones(cfg.num_targets, np.float32)
        priors[0] = args.google_prior_const
    elif args.ali:
        priors = label_counts(args, cfg.num_targets, log)
    else:
        if not args.feats:
            log.error("posterior mode requires --feats"); sys.exit(1)
        priors = posterior_priors(args, cfg, device, log)

    # reference diagnostics for any data-estimated priors
    # (nnet-adjust-priors.cc:49-66)
    if not args.google_prior_const and old is not None \
            and old.shape == priors.shape:
        d = np.abs(priors - old / old.sum())
        i = int(d.argmax())
        log.info("largest absolute difference: pdf %d, %.6f -> %.6f",
                 i, old[i] / old.sum(), priors[i])
        log.info("K-L divergence from old to new: %.6f",
                 kl_divergence(old, priors))

    np.save(priors_path, priors)
    log.info("wrote %s", priors_path)


if __name__ == "__main__":
    main()
