#!/usr/bin/env bash
# Librispeech CTC-monophone recipe — the run_ctc_phone.sh analogue
# (reference: egs/librispeech/ctc/run.sh + run_ctc_phone.sh), on the
# PyTorch/CUDA port's CLIs: the stages, defaults and outputs of
# recipes/librispeech_ctc/run.sh.  Every stage that takes a device runs
# on ${device:-cuda} (device=cpu for the plain path on the CPU).
#
# DATA-PREP CONTRACT (produced once with Kaldi tooling, consumed here as
# fixtures — see README.md in this directory):
#   $data/train/{feats.scp,cmvn.scp,utt2spk}   40-d hires MFCC, 3-way
#                                              speed perturbed
#   $data/<test>/{feats.scp,cmvn.scp,utt2spk,text}
#   $ali/ali.pdf.ark       pdf-id alignments already collapsed by
#                          `ali-to-pdf --shift=1 --unique=true`
#                          (build_tree.sh:195-205)
#   $graph/CTC.fst         ctc-make-decoding-graph output (TLG)
#   $graph/words.txt       word symbol table
#   $graph/final.mdl       transition model (for graph label mapping)
#
# Headline config = the reference's README run: 5-layer BLSTM cell 320,
# minibatch 48, frame_subsampling_factor 3, lr 5e-4 -> 1e-5, 5 epochs
# (run.sh:148-151, run_ctc_phone.sh:32-40, steps/ctc/train.sh:7-116).
set -euo pipefail

stage=${stage:-0}
data=${data:?set data= to the prepared Kaldi data dir}
ali=${ali:?set ali= to the alignment dir}
graph=${graph:?set graph= to the CTC graph dir}
exp=${exp:-exp/ctc_blstm}
num_targets=${num_targets:?set num_targets= (#pdfs + 1 blank)}

# training knobs (reference defaults)
minibatch_size=${minibatch_size:-48}
max_allow_frames=${max_allow_frames:-700}
fs_factor=${fs_factor:-3}
epochs=${epochs:-5}
lr_initial=${lr_initial:-5e-4}
lr_final=${lr_final:-1e-5}
hidden_dim=${hidden_dim:-320}
num_layers=${num_layers:-5}
num_archives=${num_archives:-16}
# bfloat16 mixed precision (bf16-stored projections/outputs, f32 gate
# math/carries/accumulation/weight-grads) is the default, as in the JAX
# recipe, whose quality validation (3-seed paired dWER vs f32 centered
# on zero on the hard recipe) is in recipes/hard/RESULTS.md.
# compute_dtype=float32 pins reference numerics.
compute_dtype=${compute_dtype:-bfloat16}

# decode knobs (run_ctc_phone.sh:36-40)
wfst_beam=${wfst_beam:-20}
lattice_beam=${lattice_beam:-10}
blank_threshold=${blank_threshold:-0.98}
lattice_acoustic_scale=${lattice_acoustic_scale:-10}

cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../../.. && pwd)${PYTHONPATH:+:$PYTHONPATH}"

if [ "$stage" -le 0 ]; then
  echo "=== stage 0: egs archives (get_egs2.sh analogue)"
  mkdir -p "$exp/egs"
  python -m kaldi_ctc_tpu_torch.cli.prepare_egs get \
    --feats "scp:$data/train/feats.scp" --ali "ark:$ali/ali.pdf.ark" \
    --cmvn "scp:$data/train/cmvn.scp" --utt2spk "$data/train/utt2spk" \
    --max-allow-frames $((max_allow_frames * fs_factor)) \
    --output "ark,scp:$exp/egs/egs.JOB.ark,$exp/egs/egs.JOB.scp" \
    --num-archives "$num_archives"
  for j in $(seq 1 "$num_archives"); do
    python -m kaldi_ctc_tpu_torch.cli.prepare_egs sort \
      --egs "ark:$exp/egs/egs.$j.ark" \
      --output "ark,scp:$exp/egs/sorted.$j.ark,$exp/egs/sorted.$j.scp"
  done
  cat "$exp"/egs/sorted.*.scp > "$exp/egs/egs.scp"
  # held-out diagnostic subset (train.sh train_diagnostic analogue)
  python -m kaldi_ctc_tpu_torch.cli.prepare_egs subset \
    --egs "ark:$exp/egs/sorted.1.ark" --n 300 \
    --output "ark:$exp/egs/diagnostic.ark"
fi

if [ "$stage" -le 1 ]; then
  echo "=== stage 1: train (steps/ctc/train.sh analogue, single SPMD run)"
  python -m kaldi_ctc_tpu_torch.cli.train_ctc \
    --egs "scp:$exp/egs/egs.scp" --num-targets "$num_targets" \
    --hidden-dim "$hidden_dim" --num-layers "$num_layers" \
    --bidirectional 1 --compute-dtype "$compute_dtype" \
    --epochs "$epochs" --minibatch-size "$minibatch_size" \
    --max-allow-frames "$max_allow_frames" \
    --frame-subsampling-factor "$fs_factor" \
    --initial-learning-rate "$lr_initial" \
    --final-learning-rate "$lr_final" \
    --clip-gradient 5.0 \
    --dir "$exp" --checkpoint-period 500 --resume \
    --device "${device:-cuda}"
fi

if [ "$stage" -le 2 ]; then
  echo "=== stage 2: diagnostics + priors (nnet-adjust-priors, const 9)"
  python -m kaldi_ctc_tpu_torch.cli.compute_prob \
    --egs "ark:$exp/egs/diagnostic.ark" --dir "$exp" \
    --frame-subsampling-factor "$fs_factor" --device "${device:-cuda}"
  python -m kaldi_ctc_tpu_torch.cli.adjust_priors --dir "$exp" \
    --google-prior-const 9 --device "${device:-cuda}"
fi

if [ "$stage" -le 3 ]; then
  echo "=== stage 3: decode + score (decode.sh + local/score.sh analogue)"
  for t in test_clean test_other dev_clean dev_other; do
    [ -d "$data/$t" ] || continue
    # final.mdl exists only for Kaldi-built graph fixtures; graphs from
    # the native chain (graph_tool make-tlg / make_synth_data.py) carry
    # CTC ilabels already and need no transition-model mapping
    trans_flag=()
    [ -f "$graph/final.mdl" ] && trans_flag=(--trans-model "$graph/final.mdl")
    python -m kaldi_ctc_tpu_torch.cli.decode_ctc \
      --feats "scp:$data/$t/feats.scp" --cmvn "scp:$data/$t/cmvn.scp" \
      --utt2spk "$data/$t/utt2spk" --dir "$exp" \
      --method wfst --graph "$graph/CTC.fst" \
      "${trans_flag[@]}" --words "$graph/words.txt" \
      --wfst-beam "$wfst_beam" --lattice "$exp/lat.$t.ark.txt" \
      --lattice-beam "$lattice_beam" \
      --blank-threshold "$blank_threshold" \
      --frame-subsampling-factor "$fs_factor" \
      --output "$exp/hyps.$t.txt" --device "${device:-cuda}"
    python -m kaldi_ctc_tpu_torch.cli.score_lattices \
      --lattices "$exp/lat.$t.ark.txt" --text "$data/$t/text" \
      --words "$graph/words.txt" \
      --acoustic-scale "$lattice_acoustic_scale" \
      --min-lmwt 9 --max-lmwt 20 \
      --output "$exp/best_hyps.$t.txt" | tee "$exp/wer.$t.json"
  done
fi

if [ "$stage" -le 4 ]; then
  echo "=== stage 4: report"
  python -m kaldi_ctc_tpu_torch.cli.generate_report --dir "$exp" --plot || true
fi
