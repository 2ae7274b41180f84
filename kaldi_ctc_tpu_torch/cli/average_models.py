"""Average model checkpoints (nnet-am-average — the reference's DP combiner,
steps/ctc/train.sh:431-435).

Counterpart of ``kaldi_ctc_tpu/cli/average_models.py``: the whole training
state (params and momentum) is averaged leaf by leaf in f32, the step is
the largest source step, and the result is written as a new checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="experiment dir")
    p.add_argument("--steps", type=int, nargs="+", required=True,
                   help="checkpoint steps to average")
    p.add_argument("--out-step", type=int, required=True,
                   help="step id for the averaged checkpoint")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np
    import torch

    from kaldi_ctc_tpu_torch.models import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.params import tree_map
    from kaldi_ctc_tpu_torch.training import init_train_state
    from kaldi_ctc_tpu_torch.training.checkpoint import (cfg_for_checkpoint,
                                                         restore_checkpoint,
                                                         save_checkpoint)

    args = parse_args(argv)
    with open(os.path.join(args.dir, "model_config.json")) as f:
        cfg = AmConfig.from_dict(json.load(f))
    ckpt_dir = os.path.join(args.dir, "checkpoints")
    # templates must match each SOURCE checkpoint's saved layer count
    # (growth rewrites the config before checkpoints at the new size
    # exist), and averaging across different sizes is meaningless
    cfgs = [cfg_for_checkpoint(ckpt_dir, cfg, step=s) for s in args.steps]
    if len({c.num_layers for c in cfgs}) != 1:
        raise SystemExit(
            "checkpoints span different layer counts "
            f"({[c.num_layers for c in cfgs]}): cannot average")
    cfg = cfgs[0]
    like = init_train_state(init_am_params(cfg))

    states = []
    metas = []
    for s in args.steps:
        st, m = restore_checkpoint(ckpt_dir, like, step=s)
        states.append(st)
        metas.append(m)
    n = len(states)
    # numpy f32, summed in the order of --steps: the JAX package's
    # sum(xs) / n, rounding for rounding
    avg = tree_map(lambda *xs: torch.from_numpy(
        np.asarray(sum(x.numpy() for x in xs) / n)), *states)
    avg = avg._replace(step=max(st.step for st in states))
    # carry the resume/serve metadata of the newest source so the
    # averaged checkpoint remains a valid resume/restore point
    newest = max(metas, key=lambda m: m["step"])
    extra = dict(newest.get("extra", {}))
    extra["averaged_from"] = args.steps
    extra["num_layers"] = cfg.num_layers
    save_checkpoint(ckpt_dir, args.out_step, avg, extra=extra)
    print(f"averaged {n} checkpoints -> step_{args.out_step}")


if __name__ == "__main__":
    main()
