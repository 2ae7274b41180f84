"""Model surgery + export — the nnet-am-copy analogue.

Counterpart of ``kaldi_ctc_tpu/cli/copy_model.py``: pick a checkpoint,
optionally remove dropout (``--remove-dropout``, the reference's
final.mdl step, ``steps/ctc/train.sh:458-509``), attach the prior vector,
and write a single-file inference artifact that decode_ctc and serve
consume via ``--model``.  Artifacts and checkpoints of either package
load in the other.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="experiment directory")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--remove-dropout", type=int, default=1)
    p.add_argument("--output", required=True,
                   help="inference artifact path (.npz)")
    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.training.checkpoint import (
        cfg_for_checkpoint, restore_norm_stats, restore_params)
    from kaldi_ctc_tpu_torch.utils import get_logger

    args = parse_args(argv)
    log = get_logger("copy_model")

    with open(os.path.join(args.dir, "model_config.json")) as f:
        cfg = AmConfig.from_dict(json.load(f))
    ckpt_dir = os.path.join(args.dir, "checkpoints")
    # growth rewrites the config before a checkpoint at the new size
    # exists; the chosen checkpoint's meta is the truth for the template
    cfg = cfg_for_checkpoint(ckpt_dir, cfg, step=args.step)
    if args.remove_dropout and cfg.dropout > 0:
        cfg = dataclasses.replace(cfg, dropout=0.0)
        log.info("removed dropout")

    params, meta = restore_params(ckpt_dir, cfg, step=args.step)
    stats = restore_norm_stats(ckpt_dir, cfg, step=args.step)

    priors = None
    priors_path = os.path.join(args.dir, "priors.npy")
    if os.path.exists(priors_path):
        priors = np.load(priors_path)
        log.info("attached priors from %s", priors_path)

    save_inference_artifact(args.output, params, cfg, priors, stats)
    log.info("wrote %s (step %d)", args.output, meta["step"])


if __name__ == "__main__":
    main()
