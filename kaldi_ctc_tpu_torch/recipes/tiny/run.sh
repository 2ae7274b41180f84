#!/usr/bin/env bash
# Tiny synthetic end-to-end recipe (the yesno/rm-class smoke test):
# data gen -> egs archives -> train -> priors -> decode -> score.
# On the PyTorch/CUDA port's CLIs: the stages, defaults and outputs of
# recipes/tiny/run.sh.  Every stage that takes a device runs on
# ${device:-cuda}; on the CPU:  device=cpu ./run.sh
set -euo pipefail

cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
stage=${stage:-0}
work=${work:-work}
epochs=${epochs:-600}

if [ "$stage" -le 0 ]; then
  python make_data.py --dir "$work/data"
fi

if [ "$stage" -le 1 ]; then
  python -m kaldi_ctc_tpu_torch.cli.prepare_egs get \
    --feats "ark:$work/data/feats.ark" --ali "ark:$work/data/ali.ark" \
    --output "ark,scp:$work/egs.ark,$work/egs.scp"
  python -m kaldi_ctc_tpu_torch.cli.prepare_egs info --egs "ark:$work/egs.ark"
fi

if [ "$stage" -le 2 ]; then
  python -m kaldi_ctc_tpu_torch.cli.train_ctc \
    --egs "scp:$work/egs.scp" --num-targets 6 \
    --hidden-dim 24 --num-layers 2 \
    --epochs "$epochs" --minibatch-size 24 \
    --initial-learning-rate 1.5e-2 --final-learning-rate 1.5e-3 \
    --momentum 0.9 --dir "$work/exp" --checkpoint-period 100 \
    --device "${device:-cuda}"
fi

if [ "$stage" -le 3 ]; then
  python -m kaldi_ctc_tpu_torch.cli.adjust_priors \
    --dir "$work/exp" --feats "ark:$work/data/feats.ark" \
    --device "${device:-cuda}"
fi

if [ "$stage" -le 4 ]; then
  python -m kaldi_ctc_tpu_torch.cli.decode_ctc \
    --feats "ark:$work/data/feats.ark" --dir "$work/exp" \
    --method beam --use-priors 1 --blank-threshold 1.0 \
    --text "$work/data/text" --output "$work/hyps.txt" \
    --device "${device:-cuda}"
fi

if [ "$stage" -le 5 ]; then
  python -m kaldi_ctc_tpu_torch.cli.generate_report --dir "$work/exp" --plot || \
    python -m kaldi_ctc_tpu_torch.cli.generate_report --dir "$work/exp"
fi

echo "tiny recipe done; hypotheses in $work/hyps.txt"
