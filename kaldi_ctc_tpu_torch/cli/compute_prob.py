"""Diagnostic objf/accuracy on a fixed egs set (nnet2-ctc-compute-prob).

Counterpart of ``kaldi_ctc_tpu/cli/compute_prob.py`` with the same flags,
defaults and output, plus ``--device`` (default ``cuda``; with no card it
raises).  Reads a checkpoint + diagnostic data (feats+ali or a prepared
egs archive, steps/ctc/train.sh:330-349), prints loss per frame and the
greedy-collapse label accuracy with the reference's parseable line.
Every utterance is evaluated: batches are length-sorted groups and the
short tail batch is kept.  The loss takes the alpha recursion alone (K11
on the card).
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats", default=None)
    p.add_argument("--ali", default=None)
    p.add_argument("--egs", default=None,
                   help="prepared egs archive (alternative to --feats/--ali)")
    p.add_argument("--cmvn", default=None)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--dir", required=True, help="experiment dir with "
                   "model_config.json + checkpoints/")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--minibatch-size", type=int, default=48)
    p.add_argument("--max-allow-frames", type=int, default=2000)
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward; 'cuda' with no card "
                        "raises")
    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.cli.common import resolve_device
    from kaldi_ctc_tpu_torch.data import load_examples
    from kaldi_ctc_tpu_torch.data.bucketing import make_buckets, pad_batch
    from kaldi_ctc_tpu_torch.data.egs import (CtcExample, example_ok,
                                              frame_subsample)
    from kaldi_ctc_tpu_torch.models.artifact import load_acoustic_model
    from kaldi_ctc_tpu_torch.training import (accuracy_from_outputs,
                                              make_eval_step)
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader
    from kaldi_ctc_tpu_torch.utils.logging import MetricsLogger

    args = parse_args(argv)
    log = get_logger("compute_prob")
    device = resolve_device(args.device)
    params, cfg, _, meta = load_acoustic_model(dir=args.dir, step=args.step,
                                               device=device)

    if args.egs:
        from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
        raw = list(SequentialEgsReader(args.egs))
    elif args.feats and args.ali:
        utt2spk = (dict(SequentialTextReader(args.utt2spk))
                   if args.utt2spk else None)
        raw = list(load_examples(args.feats, args.ali,
                                 cmvn_rspecifier=args.cmvn,
                                 utt2spk=utt2spk))
    else:
        log.error("need --egs or both --feats and --ali"); sys.exit(1)

    examples = []
    n_skip = 0
    for e in raw:
        eg = CtcExample(e.key,
                        frame_subsample(e.feats,
                                        args.frame_subsampling_factor),
                        e.labels)
        if example_ok(eg, args.max_allow_frames,
                      time_stride=cfg.time_stride):
            examples.append(eg)
        else:
            n_skip += 1
    if not examples:
        log.error("no examples"); sys.exit(1)
    if n_skip:
        log.info("skipped %d examples (length filters)", n_skip)

    eval_step = make_eval_step(cfg)
    examples.sort(key=lambda e: e.num_frames)
    frame_buckets = make_buckets()
    label_buckets = make_buckets(min_len=8, max_len=640, growth=1.5)
    tot_loss = 0.0
    tot_frames = tot_err = tot_ref = 0
    for i in range(0, len(examples), args.minibatch_size):
        batch = pad_batch(examples[i:i + args.minibatch_size],
                          frame_buckets, label_buckets)
        batch.pop("keys")
        out = eval_step(params, batch)
        _, e, r = accuracy_from_outputs(out, batch["labels"],
                                        batch["label_lens"])
        tot_err += e; tot_ref += r
        tot_loss += float(out["loss_total"])
        tot_frames += int(out["num_frames"])
    acc = 1.0 - tot_err / max(tot_ref, 1)
    MetricsLogger().log_accuracy(acc, step=meta["step"])
    print(json.dumps({
        "step": meta["step"],
        "loss_per_frame": tot_loss / max(tot_frames, 1),
        "accuracy": acc,
        "num_utts": len(examples),
        "num_frames": tot_frames,
    }))


if __name__ == "__main__":
    main()
