#!/usr/bin/env bash
# The hard-recipe ablation matrix: every arm x seed sequentially (the
# device serializes anyway), then a summary table with bootstrap CIs.
#
#   bash kaldi_ctc_tpu_torch/recipes/hard/ablate.sh [work_dir]
#
# Baseline gets 3 seeds (training-seed spread estimate), each ablation
# arm 2.  Results: $work/ABLATION.md + per-run wer_ci.json.
set -euo pipefail
cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
work=${1:-/tmp/kctpu_hard}
export work

run_one() {
  local a=$1 s=$2
  if [ -f "$work/$a.s$s/wer_ci.json" ]; then
    echo "=== $a.s$s already done, skipping"
    return 0
  fi
  echo "=== ablate: arm=$a seed=$s"
  arm=$a seed=$s bash run.sh
}

# 3 seeds per arm: power the paired comparisons so every quality claim
# traces to a CI, not a 2-seed trend
for s in 0 1 2; do run_one baseline "$s"; done
for s in 0 1 2; do run_one bf16 "$s"; done
for s in 0 1 2; do run_one ds2 "$s"; done
for s in 0 1 2; do run_one ng "$s"; done
for s in 0 1 2; do run_one realign "$s"; done

python summarize_ablation.py "$work" | tee "$work/ABLATION.md"
