"""Print model info (nnet-am-info equivalent).

Counterpart of ``kaldi_ctc_tpu/cli/model_info.py``: the model config, the
checkpoint step, the parameter count and the parameter norm as JSON."""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True)
    p.add_argument("--step", type=int, default=None)
    args = p.parse_args(argv)

    import numpy as np

    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training.checkpoint import (cfg_for_checkpoint,
                                                         latest_step,
                                                         restore_params)

    with open(os.path.join(args.dir, "model_config.json")) as f:
        cfg_d = json.load(f)
    cfg = AmConfig.from_dict(cfg_d)
    ckpt_dir = os.path.join(args.dir, "checkpoints")
    info = dict(cfg_d)
    step = args.step if args.step is not None else latest_step(ckpt_dir)
    if step is not None:
        # growth rewrites the config before a checkpoint at the new
        # size exists; the checkpoint meta is the template's truth
        cfg = cfg_for_checkpoint(ckpt_dir, cfg, step=step)
        info["num_layers"] = cfg.num_layers
        params, meta = restore_params(ckpt_dir, cfg, step=step)
        leaves = [leaf.numpy() for leaf in tree_flatten(params)]
        info["checkpoint_step"] = meta["step"]
        info["num_parameters"] = int(sum(leaf.size for leaf in leaves))
        info["parameter_norm"] = float(np.sqrt(sum(
            float((leaf ** 2).sum()) for leaf in leaves)))
    print(json.dumps(info, indent=2))


if __name__ == "__main__":
    main()
