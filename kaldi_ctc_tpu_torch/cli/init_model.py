"""Initialize a model directory — the nnet-init + nnet2-ctc-init-model
analogue (``ctcbin/nnet2-ctc-init-model.cc:58-79``).

Counterpart of ``kaldi_ctc_tpu/cli/init_model.py`` with the same flags and
files: ``<dir>/model_config.json``, a step-0 checkpoint with randomly
initialized parameters, and the default prior vector (ones with
prior[blank] = ``--blank-prior`` 9, ``nnet2-ctc-init-model.cc:64-67``).
The weights come from the port's ``init_am_params`` with a
``torch.Generator`` seeded by ``--seed``: the same distributions as the
JAX package's, not the same numbers (``jax.random`` draws other bits).
Splicing, the FT front (``--front-affine-dim``, relu) and the DS2 conv
front (``--conv-layers``) take the JAX CLI's flags; ``--front-nonlin``
and ``--front-group`` exist only in ``train_ctc``, as there.  The port
adds ``--conv-norm`` (with "batch": deepspeech.pytorch's DS2, whose
batch norms start their running statistics at mean 0, variance 1 in the
checkpoint).  A
DS2 front combined with splicing or the FT front raises ``ValueError``
before any file is written.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True)
    p.add_argument("--input-dim", type=int, required=True)
    p.add_argument("--num-targets", type=int, required=True,
                   help="pdfs + 1 blank")
    p.add_argument("--hidden-dim", type=int, default=320)
    p.add_argument("--num-layers", type=int, default=5)
    p.add_argument("--rnn-mode", type=int, default=2,
                   help="0=relu 1=tanh 2=lstm 3=gru")
    p.add_argument("--bidirectional", type=int, default=1)
    p.add_argument("--splice-left", type=int, default=0)
    p.add_argument("--splice-right", type=int, default=0)
    p.add_argument("--front-affine-dim", type=int, default=0,
                   help="FT model type front layer width (0 = google)")
    p.add_argument("--conv-layers", type=int, default=0,
                   help="DS2 model type: conv front-end layers")
    p.add_argument("--conv-channels", type=int, default=32)
    p.add_argument("--conv-time-stride", type=int, default=2)
    # "batch": deepspeech.pytorch's DS2 (the port's; train_ctc's flag)
    p.add_argument("--conv-norm", default="seq",
                   choices=["seq", "none", "batch"])
    p.add_argument("--param-stddev", type=float, default=0.02)
    p.add_argument("--bias-stddev", type=float, default=0.2)
    p.add_argument("--blank-prior", type=float, default=9.0)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from kaldi_ctc_tpu_torch.models import (AmConfig, default_priors,
                                            init_am_params)
    from kaldi_ctc_tpu_torch.models.acoustic import init_norm_stats
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import init_train_state
    from kaldi_ctc_tpu_torch.training.checkpoint import save_checkpoint
    from kaldi_ctc_tpu_torch.utils import get_logger

    args = parse_args(argv)
    log = get_logger("init_model")

    cfg = AmConfig(input_dim=args.input_dim, num_targets=args.num_targets,
                   hidden_dim=args.hidden_dim, num_layers=args.num_layers,
                   mode=RnnMode(args.rnn_mode),
                   bidirectional=bool(args.bidirectional),
                   param_stddev=args.param_stddev,
                   bias_stddev=args.bias_stddev,
                   splice_left=args.splice_left,
                   splice_right=args.splice_right,
                   front_affine_dim=args.front_affine_dim,
                   conv_layers=args.conv_layers,
                   conv_channels=args.conv_channels,
                   conv_time_stride=args.conv_time_stride,
                   conv_norm=args.conv_norm)
    # a DS2 front with splicing or the FT front raises before any write
    params = init_am_params(cfg, torch.Generator().manual_seed(args.seed))

    os.makedirs(args.dir, exist_ok=True)
    with open(os.path.join(args.dir, "model_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    save_checkpoint(os.path.join(args.dir, "checkpoints"), 0,
                    init_train_state(params,
                                     stats=init_norm_stats(cfg)),
                    extra={"epoch": 0, "num_layers": cfg.num_layers})
    np.save(os.path.join(args.dir, "priors.npy"),
            default_priors(cfg.num_targets, args.blank_prior))
    n_params = sum(int(leaf.numel()) for leaf in tree_flatten(params))
    log.info("initialized %s: %d parameters, %d targets",
             args.dir, n_params, cfg.num_targets)


if __name__ == "__main__":
    main()
