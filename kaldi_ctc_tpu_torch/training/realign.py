"""Trainer-integrated CTC realignment: the align → relabel → priors loop
the reference wires into training but leaves TODO
(``steps/ctc/train.sh:111-115``), closed in memory inside one
``train_ctc`` process.

Counterpart of ``kaldi_ctc_tpu/training/realign.py``, with its numpy
bookkeeping copied.  At a realign epoch the current model Viterbi-aligns
every training utterance through the label lattice the loss uses
(``ops.ctc.ctc_viterbi_align``, on the parameters' device), and:

- **relabel**: each label sequence is replaced by the run-collapse +
  blank-drop of its new alignment (the nnet-ctc-relabel-egs rule; on a
  feasible utterance this reproduces the sequence);
- **drop infeasible utterances**: no path exists when the logit-rate
  frame count cannot carry the labels;
- **priors**: per-frame symbol occupancies (blank included) counted from
  the alignments, the ``adjust_priors --frame-labels`` estimate.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["realign_examples", "parse_realign_epochs", "align_batch"]


def parse_realign_epochs(spec: str) -> frozenset:
    """'2,4' → {2, 4}; '' → {} (the train.sh realign_epochs list)."""
    if not spec:
        return frozenset()
    return frozenset(int(x) for x in spec.replace(" ", ",").split(",")
                     if x)


def align_batch(params, cfg, batch) -> Tuple[np.ndarray, ...]:
    """One padded batch (``pad_batch``'s feats, input_lens, labels,
    label_lens) through ``am_forward`` and ``ctc_viterbi_align`` on the
    device of ``params`` → numpy (frame_labels [B, T'], path_logprob [B],
    feasible [B], logit-rate lens [B]); realign_examples' and
    align_ctc's alignment."""
    from kaldi_ctc_tpu_torch.models import am_forward
    from kaldi_ctc_tpu_torch.ops.ctc import ctc_viterbi_align
    from kaldi_ctc_tpu_torch.params import tree_flatten

    device = tree_flatten(params)[0].device
    feats, input_lens, labels, label_lens = (
        torch.as_tensor(batch[k], device=device)
        for k in ("feats", "input_lens", "labels", "label_lens"))
    with torch.inference_mode():
        logits = am_forward(params, feats, cfg, input_lens=input_lens)
        out = ctc_viterbi_align(logits, labels, cfg.output_lens(input_lens),
                                label_lens)
    return tuple(a.cpu().numpy() for a in out) + (
        np.asarray(cfg.output_lens(batch["input_lens"])),)


def realign_examples(
    examples: List,                     # List[CtcExample], raw-rate feats
    params,
    cfg,
    frame_subsampling_factor: int = 1,
    minibatch_size: int = 16,
    log=None,
) -> Tuple[List, np.ndarray, dict]:
    """→ (kept_examples (original order, relabeled), frame_counts
    [num_targets] float64, stats).

    Alignment runs at subsample shift 0 in length-sorted groups padded to
    the JAX package's buckets, on the device of ``params``.
    """
    from kaldi_ctc_tpu_torch.data.bucketing import make_buckets, pad_batch
    from kaldi_ctc_tpu_torch.data.egs import CtcExample, frame_subsample

    subs = [CtcExample(e.key,
                       frame_subsample(e.feats, frame_subsampling_factor),
                       e.labels)
            for e in examples]
    order = sorted(range(len(subs)), key=lambda i: subs[i].num_frames)

    frame_buckets = make_buckets()
    label_buckets = make_buckets(min_len=8, max_len=640, growth=1.5)
    counts = np.zeros(cfg.num_targets, np.float64)
    counts_by_key: dict = {}
    new_labels: dict = {}
    dropped: List[str] = []
    tot_lp = tot_frames = 0.0
    for i in range(0, len(order), minibatch_size):
        idx = order[i:i + minibatch_size]
        group = [subs[j] for j in idx]
        batch = pad_batch(group, frame_buckets, label_buckets)
        frame_labels, lp, ok, out_lens = align_batch(params, cfg, batch)
        for row, j in enumerate(idx):
            t = int(out_lens[row])
            if not ok[row]:
                dropped.append(subs[j].key)
                continue
            fl = frame_labels[row, :t]
            c = np.bincount(fl, minlength=cfg.num_targets)[
                :cfg.num_targets].astype(np.float64)
            counts += c
            counts_by_key[subs[j].key] = c
            # relabel rule: run-collapse + blank-drop (valid CTC paths
            # separate repeated labels with a blank, so runs == labels)
            runs = fl[np.concatenate([[True], np.diff(fl) != 0])]
            new_labels[j] = runs[runs != 0].astype(np.int32)
            tot_lp += float(lp[row])
            tot_frames += t

    kept = [CtcExample(e.key, e.feats, new_labels[j])
            for j, e in enumerate(examples) if j in new_labels]
    stats = {
        "aligned": len(kept), "dropped": len(dropped),
        "dropped_keys": dropped[:8],
        # per-utterance occupancies, so a caller that truncates the kept
        # list can re-sum over survivors
        "counts_by_key": counts_by_key,
        "avg_logprob_per_frame": tot_lp / tot_frames if tot_frames else 0.0,
    }
    if log is not None:
        log.info("realigned %d utterances (%d dropped as infeasible), "
                 "avg path logprob/frame %.4f", stats["aligned"],
                 stats["dropped"], stats["avg_logprob_per_frame"])
    return kept, counts, stats
