#!/usr/bin/env bash
# Medium synthetic end-to-end WER recipe — one command, bounded runtime.
#
# Exercises the librispeech recipe's ACTUAL code path (same CLI stages as
# kaldi_ctc_tpu_torch/recipes/librispeech_ctc/run.sh: egs -> train -> priors -> TLG -> WFST
# lattice decode -> score_lattices lm-weight sweep -> MBR -> report) on a
# generated corpus big enough to be non-trivial: ~1h audio-equivalent,
# 5k-word vocab, pruned-trigram LM (make_data.py), so the WER at the end
# checks the entire chain — graph construction, decoding, lattice
# determinization, scoring — not a 16-utterance toy.
#
#   bash kaldi_ctc_tpu_torch/recipes/medium/run.sh            # all stages
#   stage=5 bash kaldi_ctc_tpu_torch/recipes/medium/run.sh    # decode + score only
#
# The headline WER is tracked in README.md (## Medium synthetic recipe).
#
# On the PyTorch/CUDA port's CLIs: the stages, defaults and outputs of
# recipes/medium/run.sh.  Every stage that takes a device runs on
# ${device:-cuda} (device=cpu for the plain path on the CPU).
set -euo pipefail

stage=${stage:-0}
work=${work:-/tmp/kctpu_medium}
vocab=${vocab:-5000}
train_utts=${train_utts:-400}
test_utts=${test_utts:-40}
num_targets=${num_targets:-42}     # 41 phones + blank

# training knobs (scaled-down flagship: same family, bounded runtime).
# lr: updates are lr*sum over the global minibatch (reference semantics,
# run_ctc_phone.sh:32-33 uses 5e-4); a 4-config TPU sweep of the JAX
# recipe showed
# 1e-3 converges to train acc 1.0 in ~150 steps while 4e-3 thrashes
# (elementwise-clipped updates reach the weight-init scale) and never
# escapes blank collapse.
hidden_dim=${hidden_dim:-128}
num_layers=${num_layers:-3}
epochs=${epochs:-40}
minibatch_size=${minibatch_size:-48}
fs_factor=${fs_factor:-3}
lr_initial=${lr_initial:-1e-3}
lr_final=${lr_final:-1e-4}
# exercise the realign loop; realign_epochs= (set-but-empty) disables it
# for the no-realign ablation, hence ${-} not ${:-}
realign_epochs=${realign_epochs-20}

# decode knobs (run_ctc_phone.sh:36-40)
wfst_beam=${wfst_beam:-16}
lattice_beam=${lattice_beam:-8}
blank_threshold=${blank_threshold:-0.98}

cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"

# Every device stage is a fresh process attaching to the device, which
# can wedge — at device init, or on the first kernel execution of a fresh
# process — leaving the stage at 0% CPU forever.  pyrun runs the CLI
# under the devwatch wrapper (exit 66 = device-init hang; its probe runs
# on the stage's --device) AND a hard wall-clock timeout (exit 124),
# retrying either failure with a fresh process.  hostrun runs a
# host-only stage (no device to probe) under the same timeout.
# KCTPU_STAGE_TIMEOUT bounds one attempt; raise it for big training
# stages.
pyrun() {
  local attempt rc
  for attempt in 1 2 3; do
    # '&& rc=0 || rc=$?' keeps set -e from aborting the subshell on the
    # very failure this loop exists to retry
    timeout -k 10 "${KCTPU_STAGE_TIMEOUT:-600}" \
      python -m kaldi_ctc_tpu_torch.cli.devwatch "$@" && rc=0 || rc=$?
    { [ "$rc" -ne 66 ] && [ "$rc" -ne 124 ]; } && return "$rc"
    echo "pyrun: stage wedged (rc=$rc, attempt $attempt); retrying in 15s" >&2
    sleep 15
  done
  echo "pyrun: stage failed after 3 wedged attempts" >&2
  return 1
}
hostrun() {
  timeout -k 10 "${KCTPU_STAGE_TIMEOUT:-600}" python -m "$@"
}
data="$work/data"; exp="$work/exp"; graph="$work/graph"
mkdir -p "$data" "$exp" "$graph"

if [ "$stage" -le 0 ]; then
  echo "=== stage 0: synthesize corpus (data prep analogue)"
  python make_data.py --out "$data" --vocab "$vocab" \
    --train-utts "$train_utts" --test-utts "$test_utts" \
    | tee "$work/data.json"
fi

if [ "$stage" -le 1 ]; then
  echo "=== stage 1: egs archives (get_egs2.sh analogue)"
  mkdir -p "$exp/egs"
  hostrun kaldi_ctc_tpu_torch.cli.prepare_egs get \
    --feats "ark:$data/train/feats.ark" --ali "ark:$data/train/ali.ark" \
    --max-allow-frames $((700 * fs_factor)) \
    --output "ark,scp:$exp/egs/egs.1.ark,$exp/egs/egs.1.scp" \
    --num-archives 1
  hostrun kaldi_ctc_tpu_torch.cli.prepare_egs sort \
    --egs "ark:$exp/egs/egs.1.ark" \
    --output "ark,scp:$exp/egs/sorted.1.ark,$exp/egs/egs.scp"
fi

if [ "$stage" -le 2 ]; then
  echo "=== stage 2: train (+in-loop realignment at epoch $realign_epochs)"
  KCTPU_STAGE_TIMEOUT=${train_timeout:-2400} \
  pyrun kaldi_ctc_tpu_torch.cli.train_ctc \
    --egs "scp:$exp/egs/egs.scp" --num-targets "$num_targets" \
    --hidden-dim "$hidden_dim" --num-layers "$num_layers" \
    --bidirectional 1 --epochs "$epochs" \
    --minibatch-size "$minibatch_size" \
    --frame-subsampling-factor "$fs_factor" \
    --initial-learning-rate "$lr_initial" \
    --final-learning-rate "$lr_final" --momentum 0.9 \
    --clip-gradient 5.0 --realign-epochs "$realign_epochs" \
    --dir "$exp" --checkpoint-period 200 --device "${device:-cuda}"
fi

if [ "$stage" -le 3 ]; then
  echo "=== stage 3: diagnostics (compute_prob on train egs)"
  pyrun kaldi_ctc_tpu_torch.cli.compute_prob \
    --egs "ark:$exp/egs/sorted.1.ark" --dir "$exp" \
    --frame-subsampling-factor "$fs_factor" --device "${device:-cuda}" \
    | tee "$work/train_prob.json"
fi

if [ "$stage" -le 4 ]; then
  echo "=== stage 4: TLG graph (mkgraph analogue, full native chain)"
  hostrun kaldi_ctc_tpu_torch.cli.graph_tool make-tlg \
    --lexicon "$data/lexicon.txt" --arpa "$data/lm.arpa" \
    --phones "$data/phones.txt" --output "$graph/TLG.fst"
fi

if [ "$stage" -le 5 ]; then
  echo "=== stage 5: WFST lattice decode + score (decode.sh + score.sh)"
  pyrun kaldi_ctc_tpu_torch.cli.decode_ctc \
    --feats "ark:$data/test/feats.ark" --dir "$exp" \
    --method wfst --graph "$graph/TLG.fst" \
    --words "$graph/TLG.fst.words.txt" \
    --wfst-beam "$wfst_beam" --lattice "$exp/lat.test.ark.txt" \
    --lattice-beam "$lattice_beam" --determinize 1 \
    --blank-threshold "$blank_threshold" \
    --frame-subsampling-factor "$fs_factor" \
    --text "$data/test/text" \
    --output "$exp/hyps.test.txt" --device "${device:-cuda}" | tee "$work/decode.json"
  hostrun kaldi_ctc_tpu_torch.cli.score_lattices \
    --lattices "$exp/lat.test.ark.txt" --text "$data/test/text" \
    --words "$graph/TLG.fst.words.txt" --compact 1 \
    --min-lmwt 5 --max-lmwt 15 \
    --output "$exp/best_hyps.test.txt" | tee "$work/wer.json"
  hostrun kaldi_ctc_tpu_torch.cli.lattice_tool mbr \
    --lattices "$exp/lat.test.ark.txt" --compact 1 \
    --words "$graph/TLG.fst.words.txt" \
    --output "$exp/mbr_hyps.test.txt"
  python - "$data/test/text" "$exp/mbr_hyps.test.txt" <<'EOF' | tee "$work/wer_mbr.json"
import json, sys
from kaldi_ctc_tpu_torch.utils.edit_distance import edit_distance
refs = {l.split()[0]: l.split()[1:] for l in open(sys.argv[1])}
errs = n = 0
for l in open(sys.argv[2]):
    parts = l.split()
    if parts[0] in refs:
        errs += edit_distance(refs[parts[0]], parts[1:])
        n += len(refs[parts[0]])
print(json.dumps({"metric": "wer_mbr", "wer": round(100.0*errs/max(n,1), 2)}))
EOF
fi

if [ "$stage" -le 6 ]; then
  echo "=== stage 6: report"
  hostrun kaldi_ctc_tpu_torch.cli.generate_report --dir "$exp" || true
  echo "WER sweep:"; cat "$work/wer.json"
fi
