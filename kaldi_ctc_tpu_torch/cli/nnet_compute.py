"""Forward-pass dumps — the nnet2-ctc-compute analogue
(``ctcbin/nnet2-ctc-compute.cc``): run the acoustic model over
utterances and write per-frame outputs (raw logits, log-softmax, or
posteriors) as a Kaldi matrix archive, for prior estimation, inspection,
or external decoders.

Counterpart of ``kaldi_ctc_tpu/cli/nnet_compute.py`` with the same flags
plus ``--device`` (default ``cuda``; with no card it raises, it never
runs on the CPU unasked).  On the card the forward runs the kernels of
the model's layers (K2 for a BLSTM).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats", default=None)
    p.add_argument("--egs", default=None,
                   help="prepared egs archive instead of --feats "
                        "(nnet2-ctc-compute-from-egs: the posterior-"
                        "prior route of steps/ctc/train.sh:485-492 "
                        "forwards stored egs)")
    p.add_argument("--cmvn", default=None)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--dir", default=None)
    p.add_argument("--model", default=None, help="inference artifact (.npz)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--output", required=True,
                   help="wspecifier for outputs (ark: / ark,scp:)")
    p.add_argument("--what", choices=["logits", "log-post", "post"],
                   default="log-post")
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--minibatch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on; 'cuda' with no "
                        "card raises")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from kaldi_ctc_tpu_torch.cli.common import (batches,
                                                read_feature_examples,
                                                resolve_device)
    from kaldi_ctc_tpu_torch.data import CtcExample, frame_subsample
    from kaldi_ctc_tpu_torch.models import am_forward
    from kaldi_ctc_tpu_torch.models.artifact import (load_acoustic_model,
                                                     load_norm_stats)
    from kaldi_ctc_tpu_torch.utils import get_logger, kaldi_io

    args = parse_args(argv)
    log = get_logger("nnet_compute")
    device = resolve_device(args.device)
    try:
        params, cfg, _, _ = load_acoustic_model(args.model, args.dir,
                                                args.step, device=device)
        stats = load_norm_stats(cfg, args.model, args.dir, args.step, device)
    except ValueError as e:
        log.error("%s", e); sys.exit(1)

    if args.egs:
        from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
        egs = [CtcExample(e.key, frame_subsample(
                   e.feats, args.frame_subsampling_factor), e.labels)
               for e in SequentialEgsReader(args.egs)]
    elif args.feats:
        egs = read_feature_examples(args.feats, args.cmvn, args.utt2spk,
                                    args.frame_subsampling_factor)
    else:
        log.error("need --feats or --egs"); sys.exit(1)

    n = 0
    with kaldi_io.MatrixWriter(args.output) as w, torch.inference_mode():
        for group, batch in batches(egs, args.minibatch_size):
            logits = am_forward(
                params, torch.as_tensor(batch["feats"], device=device), cfg,
                input_lens=torch.as_tensor(batch["input_lens"],
                                           device=device), stats=stats)
            if args.what == "logits":
                out = logits
            else:
                out = torch.log_softmax(logits, dim=-1)
                if args.what == "post":
                    out = torch.exp(out)
            out = out.cpu().numpy()
            score_lens = cfg.output_lens(batch["input_lens"])
            for j, e in enumerate(group):
                w[e.key] = out[j, :int(score_lens[j])]
                n += 1
    log.info("wrote %s for %d utterances", args.what, n)


if __name__ == "__main__":
    main()
