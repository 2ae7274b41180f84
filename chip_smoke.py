"""Smoke run of the PyTorch/CUDA port (kaldi_ctc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kaldi_ctc_tpu_torch/csrc`` (one nvcc
per source, all started together) and drives the serving path, the
streaming path and the training step at the full width of the flagship
model and of its unidirectional variant, each with LSTM and with GRU
layers, and of the 3x128 BLSTM of recipes/medium and recipes/hard, and
offline decoding with word output (decode_ctc, nnet_compute, the model
CLIs and serve --graph) on the flagship, the training drive from WAV
files to a trained flagship (compute_feats, prepare_egs, train_ctc,
compute_prob, adjust_priors, decode_ctc, decode_stream), and slice 8:
bench.py's DS2 flagship served and trained, NG-SGD, realignment,
align_ctc and an FT-front stream on the 3x128 BLSTM and a uni LSTM, and
slice 9: train_ctc on one NCCL rank, the launcher and the multi-process
dry run, then lattice output and its tools, and slice 10: the recipes'
scripts, the tree and graph builders and the LM tools.  Each
phase prints one JSON line; any failed phase exits non-zero with no
result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: every kernel source in csrc/ (nine; the recurrent kernels
   share csrc/bilstm_cell.cuh, K2, K5, K7, K8a, K9a and K10a the forward
   chain of csrc/fwd_chain.cuh, K3, K6, K8b, K9b and K10b the backward
   chain of csrc/bwd_chain.cuh and the phase-1 bodies of
   csrc/lstm_gates.cuh, the row-keeping kernels csrc/row_ceiling.cuh)
   compiled by nvcc for sm_90a, timed;
3. k4_log_mel: the log-mel kernel on MFCC-hires frames of 8 s of 16 kHz
   audio (798 frames, a request) and of one 0.2 s stream chunk (20
   frames), with its plan (k4_plan): the wrapper, which must take the fft
   route, against its plain version and against the dft route on the
   same operands; both routes timed (one call, 50 back to back, the
   card's time in a trace) beside the plain version and two bounds (the
   FFT's work and the direct DFT's); then a 400-point transform
   (round_to_power_of_two off) through the dft route;
4. k2_bilstm: the BiLSTM forward kernel against its plain version at
   T=800, B=1 and B=8 (serving) and T=240, B=48 and B=600 (training),
   H=320, in f32 and bf16, with its plan: max errors, median ms; at
   T=800, B=1 and T=240, B=48 both routes (the forward chain in clusters,
   the cooperative kernel) timed on the same operands;
5. k1_ctc: the CTC alpha-beta kernels K1 (fused), K11 (alpha) and K12
   (beta) against their plain loops at bench.py's shapes (B=48, T=240,
   A=72, L=70, S=141) with short, label-less and infeasible rows: alphas,
   betas, loss and gradient, max error, median ms; K1's plan (k1_plan),
   its wrapper on the warp route, both routes (one warp per utterance and
   recursion; the block kernel) timed as K4's and held equal bit for bit
   at B=48 and B=1; K11's and K12's plans (k11_plan, k12_plan), their
   wrappers on the band route, both routes (bands of states on the warps
   of one block per utterance; the block kernel) timed as K4's, and the
   band route held equal bit for bit to the block route and to K1's warp
   route at B=48 and B=1; then the "separate" path of
   ``ctc_loss_and_grad`` (K11 + K12), with its launch counts;
6. k3_bilstm_bwd: the BiLSTM backward kernel against its plain version at
   T=240, B=48, H=320 with ragged lengths, f32 and bf16, with its plan,
   both routes (phase 1 and the backward chain with both directions in
   clusters; the cooperative kernel) timed on the same operands, the
   cluster route's two phases timed apart, and the two routes held equal
   bit for bit at each row's first valid walk step;
   then wide: K2's and K3's wide route (csrc/lstm_wide.cuh) at the DS2
   cell's layer shape (T'=750, B=64, H=1024, f32, ragged rows; both
   plans must take it): K2 with the store and K3 on its sums through
   their wrappers against the plain versions at K2's and K3's f32
   tolerances, the wide and store counters zeroed before those two calls
   and read after them (one each), card ms, plain ms, cuDNN's
   bidirectional nn.LSTM(1024, 1024) forward and backward on the same
   shape and the bound; then one train step of deepspeech.pytorch's DS2
   at its published widths (161 bins, 2 convs of 32 channels, 5 summed
   BLSTM layers of 1,024, 29 targets) on 64 seeded rows of up to 1,500
   frames, its launches counted (K2 and K3 5x each on the wide route, K1
   on its block route), its ms and memory peak;
7. serve: the 5x320 BLSTM flagship (random weights from a seed) written as
   a JAX-format artifact and served by the port's own HTTP server on cuda;
   4 /recognize requests of 2, 4, 6 and 8 s of seeded audio per compute
   dtype (f32, then bf16); status, frames and labels checked; the kernel
   launch counters must rise by 5 (K2, one per layer), 0 (K10a: no
   flagship layer takes it) and >= 1 (K4) per request; scores compared
   with the same engine running the plain
   versions on the card; per-request latency and RTF;
8. train: the flagship at bench.py's shapes (B=48, T=240, L=70, seeded
   feats and labels, TrainOptions() defaults), f32 then bf16: 3 steps of
   ``build_train_step`` through the kernels (each step must launch K2 5x,
   K3 5x, K1 once and K10a, K10b never) and the same 3 steps from the
   same state on the
   plain versions on the card, per-step loss and grad norm and the final
   parameters compared; the eval step (K2 5x, K11 once), and one eval
   step under torch.profiler (K11's card time and share); 5 timed calls
   of 3 steps (audio-s/s, B*T*0.03 s of audio per step); one step under
   torch.profiler (device time by kernel, K1/K2/K3 shares, idle share);
9. profile: one 8 s request per dtype under torch.profiler: device time
   by kernel, K2's (either route) and K4's shares, the device's idle share of the traced
   request's wall time, and the untraced wall beside it;
10. k5_lstm: the unidirectional LSTM forward kernel against its plain
   version at T=800, B=1 and B=8, T=240, B=48 and B=600, and one reverse
   case, H=320, f32 and bf16, with its plan (the cluster route: the
   forward chain of csrc/fwd_chain.cuh);
11. k6_lstm_bwd: its backward at T=240, B=48, H=320, ragged lengths,
   with its plan, both routes (phase 1 and the backward chain of
   csrc/bwd_chain.cuh in clusters; the cooperative kernel) timed on the
   same operands and the cluster route's two phases timed apart;
12. k7_lstm_stack: the wavefront stack kernel at L=5, H=320, T=20, B=8
   with carries from a previous chunk, ragged lengths and an idle slot
   (y, h_fin, c_fin against the plain version), with its plan, both
   routes (the wavefront of per-layer clusters; the cooperative kernel)
   timed on the same operands and held equal bit for bit at B=8 and B=1,
   the co-residency guarantee its launches held, then one 8 s utterance
   streamed in 20-frame chunks through it against K5's offline forward;
13. serve_uni: the unidirectional 5x320 (random weights from a seed)
   served per dtype: 4 /recognize requests (K5 5x and K4 >= 1x each),
   then 8 concurrent streams of 2-4 s in 0.2 s chunks through
   /stream/start|chunk|end (K7 once per engine tick), /healthz, chunk
   latency median and p90, and the chunk function's scores against the
   plain versions on the card and against the offline K5 forward;
14. train_uni: the train phase for the unidirectional 5x320 (K5 5x, K6
   5x, K1 once per step; eval K5 5x, K11 once);
15. profile_stream: one 8-slot tick per dtype under torch.profiler: K7's
   share of device time (either route) and the device's idle share;
16. k9_gru: the unidirectional GRU forward kernel K9a against its plain
   version at T=800, B=1 and B=8, T=240, B=48 and B=600, and one reverse
   case, with its plan and, at T=800, B=1 and T=240, B=48, both routes
   timed on the same operands, and its backward K9b at T=240, B=48 with
   ragged lengths, H=320, f32 and bf16, with its plan, both routes and
   its cluster route's two phases timed as K6's, with cuDNN's nn.GRU as the
   library yardstick; in f32 K9a also against nn.GRU holding the same
   function (full-length rows);
17. k8_bigru: the same for the BiGRU kernels K8a and K8b (K8a with its
   plan and both routes, its cluster route held equal bit for bit to its
   cooperative kernel and, a direction each, to K9a's cluster route; K8b
   with its plan, both routes and its cluster route's two phases timed as
   K9b's, its cluster route equal bit for bit to its cooperative kernel
   at each row's first valid walk step and, a direction each, to K9b's
   cluster route over the whole walk);
18. serve_gru: the 5x320 BiGRU served per dtype as in 7 (K8a 5x per
   request, K4 >= 1x), scores against the plain versions;
19. serve_gru_uni: the unidirectional 5x320 GRU as in 13: /recognize
   through K9a 5x, 8 concurrent streams through the per-layer loop in
   torch ops (the JAX package runs its XLA scan there: no kernel, no K7
   launch), every stream's labels equal to its /recognize labels;
20. train_gru, train_gru_uni: the train phase for both GRU models (K8a
   and K8b, or K9a and K9b, 5x each and K1 once per step; eval K8a or
   K9a 5x and K11 once);
21. profile_gru, profile_gru_uni, profile_stream_gru: phases 9 and 15 for
   the GRU models (K8a's share of a BiGRU request, K9a's of a uni GRU
   request; the GRU tick's wall and idle share);
22. k10_bilstm_proj: the in-kernel-projection BiLSTM kernels at the 3x128
   model's layers 2-3 (D=256, H=128), f32 and bf16: K10a against its
   plain version at T=800, B=1 and B=8 and T=240, B=48 and B=600, with
   its plan and, at B=48, its two phases timed apart (phase 1, every
   frame's projection; phase 2, both directions' forward chains in
   thread-block clusters); K10b at T=240, B=48 with ragged lengths, its
   plan and its two phases timed apart (phase 1, the gate pre-activations
   of every step; phase 2, the dh/dc chain in clusters), and in f32 at
   B=600 (three chunks of steps); beside each, cuDNN's nn.LSTM(256, 128,
   bidirectional) and the hoisted route on the same layer (projection
   GEMM plus K2 forward, K3 on the stored projection backward);
23. f7: each kernel that keeps every batch row in one block's shared
   memory (the cooperative routes of K3, K5, K6, K7 one layer, K8a, K8b,
   K9a and K9b) once at one row above the most one launch takes (its
   source's *_max_rows query), where W_h fits no cluster (K3, K5, K6 and
   K7 at H=512, K8a, K8b, K9a and K9b at H=576), T=20, f32, against its
   plain version: the wrapper runs row slices and counts one launch; then
   K3, K6, K7 one layer, K8a, K8b and K9b at B=600, H=320 on their
   cluster route (one call, no ceiling);
24. serve_proj: the 3x128 BLSTM (40-dim input, 42 targets, random weights
   from a seed) served per dtype as in 7: per request K2 1x and K10a 2x
   in f32 (layer 1 unaligned, layers 2-3 in-kernel), K2 3x and K10a 0x in
   bf16, K4 >= 1x;
25. train_proj: its training step at bench.py's shapes with the recipes'
   momentum 0.9 and learning rate 1e-3, as in 8: per step K2 1x, K10a 2x,
   K3 1x, K10b 2x and K1 once in f32, K2 3x, K3 3x and K1 once in bf16;
   the eval step K2 1x, K10a 2x (f32) and K11 once; the profiled step
   gives K10a's and K10b's shares;
26. decode (after the serve and train phases): offline decoding with
   word output through the port alone.  decode_setup: the native WFST
   library built by the port's loader into build/native (its path and
   build seconds; no libctc_native.so may appear in the JAX package), the
   flagship made by ``init_model`` (seed 0) and a bf16 twin (its
   model_config.json with compute_dtype bfloat16), ``copy_model`` to an
   artifact equal to the checkpoint, ``model_info``, DECODE_UTTS (8)
   utterances of 2-8 s of seeded noise as MFCC-hires from the card (K4)
   written as ark,scp,
   a word-loop graph (words = labels 1..71) and a seeded lexicon loop of
   2,000 words of 2-6 labels with unigram costs, both CTC-transformed by
   the port's NativeFst (states and arcs printed).  Per dtype:
   ``nnet_compute --what log-post`` on the card against the same on the
   CPU's plain versions (SCORE_TOL) and ``--what post`` (rows sum to 1
   within 1e-4); ``decode_ctc`` greedy, beam and wfst (the lexicon graph,
   --words) on the card, each launching K2, against the plain path (the
   CPU's log posteriors, ``acoustic_scores`` and the port's decoders on
   the CPU): in f32 greedy and beam exactly; otherwise equal or, where a
   hypothesis differs, the two paths' best-path scores within
   DECODE_COST_RTOL (printed); a line per method and dtype with
   utterances, audio seconds, wall, RTF and the share of non-empty
   hypotheses; the prefix beam loop alone on the card (f32).  Then
   ``serve --graph --words`` (the word loop, as tests/test_serve.py
   serves it) on the flagship (f32) and the uni LSTM: 4
   /recognize requests of 2-8 s with words and text (latencies printed),
   and on the uni LSTM 2 streams whose end words equal their /recognize
   words.
27. pipeline (after decode): features → egs → a trained model through
   the port's CLIs on the card.  144 seeded utterances of 2-8 s written as
   WAV files of 12 speakers; ``compute_feats --type mfcc --config hires``
   (K4 once per utterance, fft route), its archive equal to the kernel's
   features and the kernel's log-mel within K4_TOL of the plain version on
   4 utterances; ``compute_cmvn`` per speaker; seeded pdf alignments over
   71 ids; ``prepare_egs get`` (96 train, 48 valid) and ``info``;
   ``train_ctc`` on the flagship (5x320 BLSTM, 72 targets, minibatch 48,
   5 epochs of 2 steps, cv at step 10) in f32 and bf16: K2 5x, K3 5x and
   K1 once a step and K2 5x and K11 once in cv, the first step's loss per
   frame and grad norm against one step of the plain versions from the
   same initial parameters on the same first batch (TRAIN_TOL), steps/s,
   audio-s/s and the steps' share of the wall from metrics.jsonl; the f32
   run once more under torch.profiler (the device's busy and the host's
   share of the wall); ``compute_prob`` on the valid egs (K11) and
   ``adjust_priors --feats`` (K2) against the same CLIs on the plain
   versions; ``decode_ctc --method greedy --use-priors 1`` on the trained
   model; ``init_model`` of the uni LSTM 5x320 and ``decode_stream`` of 16
   utterances in chunks of 50 frames (K7 once a chunk, with k7_plan's route
   at B=1) equal to that model's offline greedy ``decode_ctc`` (K5); then
   one summary line (feature RTF, train_ctc's steps/s and audio-s/s, the
   compute_prob loss, the decode_stream RTF, K7's route) with the card's
   name and power limit.
28. serve_ds2, train_ds2 (after pipeline): bench.py's DS2 flagship
   (``_bench_cfg(ds2=True)``: 2 conv layers of 32 channels, time stride
   2, then the 5x320 BLSTM at half the frames; the convs cuDNN's, f32 in
   both dtypes) served as in 7 and trained as in 8 (K2 5x, K3 5x and K1
   once a step; eval K2 5x and K11 once), with the convs' share of the
   profiled step's device time;
29. extras: slice 8's CLIs on the card.  ``decode_ctc`` greedy on the
   DS2 flagship (``init_model --conv-layers 2``, and its bf16 twin) over
   16 of the pipeline's utterances, equal to the plain path; the 3x128
   BLSTM on the pipeline's egs: ``train_ctc --affine-type natural`` (10
   steps, cv at step 10; the first step's loss and grad norm against one
   plain step of NG-SGD from the same parameters, TRAIN_TOL; K2 1x, K10a
   2x, K3 1x, K10b 2x and K1 once a step) and ``train_ctc
   --realign-epochs 1 --epochs 2`` (B=16; the realign fires at epoch 1
   and the lr decay horizon is recomputed: later steps' lr equal the new
   horizon's); ``align_ctc`` on the 48 valid utterances (RTF, the Viterbi
   loop's seconds and share of the wall) against the same CLI on the
   plain versions (mean path log-prob within ALIGN_LP_RTOL), ``prepare_egs
   relabel --frame-labels 1`` on its frame labels (equal to the egs'
   labels) and ``adjust_priors --frame-labels 1`` (equal to the
   frame-label occupancies); a uni LSTM 5x320 behind a pnorm FT front
   (group 2) streamed by ``decode_stream`` (K7 a chunk), equal to its
   offline greedy ``decode_ctc`` (K5); ``train_ctc --dropout 0.1
   --splice-left 2 --splice-right 2`` on the 3x128; one summary line; then
   ``extras_launches``, which fails unless the slice's paths launched K2,
   K3, K1, K11, K10a, K10b, K5 and K7.
30. distributed (after extras): the pipeline's f32 ``train_ctc`` twice
   with no process group, twice with one NCCL rank on cuda:0
   (COORDINATOR_ADDRESS, PROCESS_ID=0, NUM_PROCESSES=1; the backend
   checked), twice more with no group: K2 5x, K3 5x and
   K1 once a step, K2 5x and K11 once in cv, in each; the final
   checkpoints equal within DIST_CKPT_ATOL (the one-rank all-reduce is an
   identity); steps/s of both with the card's name and power limit; then
   ``launch --num-processes 1 -- train_ctc`` as a subprocess (exit 0, a
   final checkpoint), ``dryrun_multichip(1)`` on the card (NCCL), and one
   rank more than the cards through ``launch``, which must exit non-zero
   with the NCCL device-count error within its time limit.  Scaling
   across cards is not measurable on one card;
31. lattice: ``decode_ctc --method wfst --lattice --determinize 1`` on a
   5x320 BLSTM flagship (init_model seed 0 at LATTICE_STDDEV, f32) over
   decode's DECODE_UTTS utterances on the word loop and 4 on the 2,000-word
   lexicon graph (LATTICE_FLAGS: lattice beam and max-active), on the
   card (K2) and on the CPU's plain path: equal best
   paths or near ties, best-path costs within DECODE_COST_RTOL, RTF;
   ``score_lattices`` (lm weights 1-5), ``lattice_tool best-path`` (equal
   to decode_ctc's hypotheses) and ``mbr`` on the word-loop lattices,
   ``align-words`` with the lexicon and ``lmrescore`` with a seeded
   bigram ARPA over the lexicon's words and its const-ARPA form on the
   lexicon lattices; then ``slice9_launches``, which fails unless the
   distributed phase launched K2, K3, K1 and K11 and the lattice phase K2.
32. recipes (after lattice): the port's recipe scripts on the card, each
   stage a process (``build/smoke/recipes``; a sitecustomize hook first on
   PYTHONPATH appends each process's wall and launch counts to a file).
   ``devwatch model_info --help`` exits 0, and 66 with
   KCTPU_DEVICE_TIMEOUT=0.0001; the librispeech_ctc chain at the
   flagship's width: ``make_synth_data.py --num-phones 71`` (80 train and
   16 test utterances, vocab 150: WAVs → compute_feats MFCC-hires on the
   card (K4) → compute_cmvn → graph_tool make-tlg), then ``run.sh`` with
   device=cuda and num_targets 72 (prepare_egs get/sort/subset, train_ctc
   at its defaults, 5x320 bf16 B=48 fs 3, for RECIPE_EPOCHS epochs (K2,
   K3, K1), compute_prob (K11), adjust_priors, decode_ctc --method wfst
   --lattice, score_lattices, its report) and generate_report without
   --plot; the decode held to the same call on the CPU's plain path
   (equal best paths, or best-path costs within DECODE_COST_RTOL); the
   triphone chain on that corpus: tree_tool acc-stats, sum-stats,
   questions, build (TRI_LEAVES leaves) and info, prepare_egs get --tree,
   f32 train_ctc at 5x320 with num_pdfs + 1 targets, graph_tool make-tlg
   --tree, decode_ctc --lattice on the card against the plain path,
   score_lattices; lm_tool arpa-to-fst, compile-const and perplexity
   (ARPA and const-ARPA agree), graph_tool compose (the CTC graph with
   G) and info; each with stage walls, graph sizes and build seconds,
   the tree's leaves, steps/s, decode RTF and WERs; then
   ``slice10_launches``, which fails unless the phase launched K4, K2,
   K3, K1 and K11 (K10a and K10b where the triphone chain's f32 layers
   take them).

Every profiled window (a request, a step, a tick) runs its work as the
profiler's warm-up for 50 ms or more, then a marker kernel, then the
measured run, whose kernels are those the device ran after the marker: a
trace lacked the device records of its first milliseconds.

Then a line ``driven_routes``: K4's launches on the driven paths by
route and by frames, K1's, K11's and K12's by route (the run fails
unless every served K4 launch took the fft route, every K1 launch the
warp route and every K11 and K12 launch the band route).  Then
a line ``{"kernels": [...], "launch_floor_ms": ...}`` with each kernel's
launches during the
driven paths (serve, train, eval, the separate CTC path, serve_uni with
its streams, train_uni, the same four for the GRU models, serve_proj,
train_proj, decode's decode_ctc runs and served requests, the
pipeline's CLI runs, serve_ds2, train_ds2, the extras' CLI runs, the
distributed phase's NCCL train_ctc, the lattice phase's card decodes and
the recipes phase's processes and card runs;
counts set to 0 before each and read after it),
its error, its time beside the plain version's, its bound (the larger of
its bytes over 3.35 TB/s and its operations over the peak rate of its
type: 67 TFLOP/s f32, 989 TFLOP/s bf16, H100 SXM data sheet) and the
time of one PyTorch library call computing the same function (null where
there is none), K4's two shapes and the routes of K1, K11 and K12 beside
their rows,
and the time of one empty launch (CUDA events over back-to-back calls
of a null kernel); the card's ``nvidia-smi`` name and power limit; and,
last, ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``.  Exits non-zero without a CUDA device, and when run
outside the repository.
"""

import collections
import concurrent.futures
import contextlib
import http.client
import json
import logging
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each against the plain PyTorch version on the same inputs
# on the card.  K4: rtol/atol of the JAX package's own kernel-vs-XLA
# feature test; K2 f32: another f32 summation order compounded over 800
# steps of a contracting recurrence; K2 bf16: y is stored in bf16 (ulp
# 2^-8 near 1) and h enters each step rounded to bf16, so a flipped
# rounding moves later steps by ~an ulp.  Scores are log posteriors.
K4_TOL = 2e-4
K2_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SCORE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# K1/K11/K12: the same f32 log-space sums as the plain loops with the
# card's expf/log1pf; alphas and betas reach ~-1000 (f32 ulp 6e-5).  The
# gradient holds posteriors exp(alpha + beta - lp - log Z), so that ulp
# is their relative error; the loss is -log Z of ~1000.
CTC_RTOL, CTC_ATOL = 1e-5, 1e-4
CTC_GRAD_TOL = 2e-4
# K10a and K10b are held to K2's and K3's tolerances: the same recurrence,
# and a projection whose f32 sums run in another order than cuBLAS's
# (in bf16 a rounding of the stored projection may flip, as y's may).
# K3 f32: dh and dc carried over 240 steps in another summation order;
# bf16: dgates stored in bf16 and rounded to bf16 as the dh operand, so a
# flipped rounding moves later steps by ~a bf16 ulp.
K3_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# Train step, kernels against plain versions after 3 steps: (loss rtol,
# grad-norm rtol, params atol).  f32: another summation order; bf16: the
# bf16 storage sites are the same, their rounding flips differ.
TRAIN_TOL = {"float32": (1e-5, 1e-4, 1e-6), "bfloat16": (2e-3, 2e-2, 1e-4)}
# The GRU models' steps: f32 params 3e-6.  Their kernels agree with the
# plain versions as closely as the LSTM's (~1e-6 on dgates of ~5), but the
# 3 steps at lr 5e-4 on gradient sums swing the BiGRU's loss 40k -> 16k ->
# 34k, and each step multiplies the difference by ~5 (grad-norm rel 1e-6,
# 8e-6, 3e-5): the measured params error is 1.5e-6.
TRAIN_TOL_GRU = {"float32": (1e-5, 1e-4, 3e-6),
                 "bfloat16": TRAIN_TOL["bfloat16"]}
# K8a / K9a in f32 against cuDNN's nn.GRU holding the same function:
# cuDNN's own summation order and transcendentals over 240 steps.
NN_GRU_TOL = 1e-3
# bench.py's training shapes and its audio per step
TRAIN_B, TRAIN_T, TRAIN_L = 48, 240, 70
SECONDS_PER_FRAME = 0.03
TRAIN_STEPS_PER_CALL, TRAIN_TIMED_CALLS = 3, 5
# the streaming server: slots and frames per tick (serve.py's defaults)
STREAMS, CHUNK_FRAMES = 8, 20
KERNELS = ("log_mel", "bilstm_fwd", "bilstm_bwd", "ctc_alpha_beta",
           "ctc_alphas", "ctc_betas", "lstm_fwd", "lstm_bwd", "lstm_stack",
           "bigru_fwd", "bigru_bwd", "gru_fwd", "gru_bwd", "bilstm_proj_fwd",
           "bilstm_proj_bwd")
# K5 and K9a take their cooperative routes (W_h fits no cluster of 16)
# from these f32 H on (ops/rnn_cuda.py::fwd_chain_plan with 4 and 3
# gates); the f7 phase drives their ceilings there
K5_COOPERATIVE_H = 512
K9A_COOPERATIVE_H = 576
# K8a takes its cooperative route from K9a's f32 H on (the same plan with
# both directions); K3, K6 and K9b take theirs (W_h's gate columns as f32
# fit no cluster of 16) from these H on, in either dtype
# (ops/rnn_cuda.py::bwd_chain_plan)
K8A_COOPERATIVE_H = K9A_COOPERATIVE_H
BWD_COOPERATIVE_H = {"K3": 512, "K6": 512, "K9b": 576}
# the 3x128 BLSTM of recipes/medium and recipes/hard: hidden units,
# layers, targets (its input is the flagship's 40-dim features)
PROJ_H, PROJ_LAYERS, PROJ_TARGETS = 128, 3, 42
# K2's and K3's wide route at the DS2 cell's layer shape: deepspeech.pytorch's
# 5x1024 BLSTM at batch 64, 1,500 frames halved by the conv front's stride
WIDE_T, WIDE_B, WIDE_H = 750, 64, 1024
WIDE_KERNELS = ("bilstm_fwd_wide", "bilstm_bwd_wide")
# bench.py's DS2 configuration (_bench_cfg(ds2=True)): the flagship behind
# a 2-layer conv front of 32 channels, time stride 2
DS2_CONV = dict(conv_layers=2, conv_channels=32, conv_time_stride=2)
DTYPES = ("float32", "bfloat16")
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 and bf16
# FLOP/s; the bound of a kernel is the larger of its two times
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def back_to_back_ms(fn, calls, torch):
    """Mean ms a call over ``calls`` calls enqueued back to back between
    two CUDA events, after a warm-up: the host enqueues ahead of the card,
    so where the card's time exceeds the host's, this is the card's time
    per call (a single timed call also holds the host's time before its
    first launch)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def median_ms(fn, runs, torch):
    """Median of per-run CUDA-event times (ms), after one warm-up run."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def max_err(got, ref, rtol, atol):
    """(max |got-ref|, whether every element is within atol + rtol*|ref|)."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + rtol * ref.float().abs()).all())
    return float(d.max()) if d.numel() else 0.0, ok


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, dtype):
    """The least time the card could take: {bound_ms, bound_by} from the
    bytes moved (each input read once, each output written once) and the
    operations done, at the peak rate of ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lstm_ops(lens, h, products):
    """FLOPs of ``products`` [B, H] x [H, 4H] products per valid frame."""
    return 2.0 * products * int(lens.sum()) * h * 4 * h


def proj_ops(lens, d, h):
    """FLOPs of both directions' [B, D] x [D, 4H] projections per valid
    frame."""
    return 2.0 * 2 * int(lens.sum()) * d * 4 * h


def gru_ops(lens, h, products):
    """FLOPs of ``products`` [B, H] x [H, 3H] products per valid frame."""
    return 2.0 * products * int(lens.sum()) * h * 3 * h


def library_rnn_ms(torch, dev, dtype, t, b, d_in, h, num_layers=1,
                   bidirectional=False, backward=False, state=False,
                   cell="LSTM"):
    """Median ms of cuDNN's torch.nn.LSTM, or torch.nn.GRU with
    ``cell="GRU"`` (TF32 off), on the same shapes: forward, or the
    backward of one forward (input and weight gradients)."""
    rnn = getattr(torch.nn, cell)(d_in, h, num_layers=num_layers,
                                  bidirectional=bidirectional).to(dev, dtype)
    x = torch.randn(t, b, d_in, device=dev, dtype=dtype,
                    requires_grad=backward)
    hc = None
    if state:
        n = num_layers * (2 if bidirectional else 1)
        hc = tuple(torch.randn(n, b, h, device=dev, dtype=dtype)
                   for _ in range(2))
    if not backward:
        with torch.no_grad():
            return median_ms(lambda: rnn(x, hc), 10, torch)
    y, _ = rnn(x, hc)
    dy = torch.randn_like(y)
    leaves = [x] + list(rnn.parameters())
    return median_ms(lambda: torch.autograd.grad(
        y, leaves, dy, retain_graph=True), 10, torch)


def wrappers():
    """Each kernel's wrapper function, by kernel name (the functions
    carry the launch counters)."""
    from kaldi_ctc_tpu_torch.features import stft_cuda
    from kaldi_ctc_tpu_torch.ops import ctc_cuda, gru_cuda, rnn_cuda
    return {"log_mel": stft_cuda.log_mel,
            "bilstm_fwd": rnn_cuda.bilstm_seq_fwd,
            "bilstm_bwd": rnn_cuda.bilstm_seq_bwd_dgates,
            "ctc_alpha_beta": ctc_cuda.alpha_beta,
            "ctc_alphas": ctc_cuda.forward_alphas,
            "ctc_betas": ctc_cuda.backward_betas,
            "lstm_fwd": rnn_cuda.lstm_seq_fwd,
            "lstm_bwd": rnn_cuda.lstm_seq_bwd_dgates,
            "lstm_stack": rnn_cuda.lstm_stack_fwd,
            "bigru_fwd": gru_cuda.bigru_seq_fwd,
            "bigru_bwd": gru_cuda.bigru_seq_bwd_dgates,
            "gru_fwd": gru_cuda.gru_seq_fwd,
            "gru_bwd": gru_cuda.gru_seq_bwd_dgates,
            "bilstm_proj_fwd": rnn_cuda.bilstm_seq_fwd_proj,
            "bilstm_proj_bwd": rnn_cuda.bilstm_seq_bwd_dgates_proj}


# the per-route launch counters of K4, K1, K11 and K12, beside each
# wrapper's
# ``launches``: key in the counts → (kernel, the wrapper's attribute)
ROUTE_COUNTERS = {"log_mel.fft": ("log_mel", "fft_launches"),
                  "log_mel.dft": ("log_mel", "dft_launches"),
                  "ctc_alpha_beta.warp": ("ctc_alpha_beta", "warp_launches"),
                  "ctc_alpha_beta.block": ("ctc_alpha_beta",
                                           "block_launches"),
                  "ctc_alphas.band": ("ctc_alphas", "band_launches"),
                  "ctc_alphas.block": ("ctc_alphas", "block_launches"),
                  "ctc_betas.band": ("ctc_betas", "band_launches"),
                  "ctc_betas.block": ("ctc_betas", "block_launches")}
# K4's launches by the frames of the launch: keys "log_mel.frames.<F>"
K4_FRAMES = "log_mel.frames."


def reset_counts():
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    for name, attr in ROUTE_COUNTERS.values():
        setattr(fns[name], attr, 0)
    fns["log_mel"].frame_counts.clear()


def read_counts():
    """Each wrapper's launches, K4's, K1's, K11's and K12's by route,
    K4's by frames."""
    fns = wrappers()
    counts = {name: fn.launches for name, fn in fns.items()}
    counts.update({key: getattr(fns[name], attr)
                   for key, (name, attr) in ROUTE_COUNTERS.items()})
    counts.update({f"{K4_FRAMES}{f}": n
                   for f, n in fns["log_mel"].frame_counts.items()})
    return counts


@contextlib.contextmanager
def plain_versions():
    """Route the wrappers' callers to the plain versions (for the
    comparison runs; no kernel launches and no counts)."""
    from kaldi_ctc_tpu_torch.features import stft_cuda
    from kaldi_ctc_tpu_torch.ops import ctc_cuda, gru_cuda, rnn_cuda
    swaps = [(stft_cuda, "log_mel", stft_cuda.log_mel_reference),
             (rnn_cuda, "bilstm_seq_fwd", rnn_cuda.bilstm_seq_fwd_reference),
             (rnn_cuda, "bilstm_seq_bwd_dgates",
              rnn_cuda.bilstm_seq_bwd_dgates_reference),
             (rnn_cuda, "bilstm_seq_fwd_proj",
              rnn_cuda.bilstm_seq_fwd_proj_reference),
             (rnn_cuda, "bilstm_seq_bwd_dgates_proj",
              rnn_cuda.bilstm_seq_bwd_dgates_proj_reference),
             (ctc_cuda, "alpha_beta", ctc_cuda.alpha_beta_reference),
             (ctc_cuda, "forward_alphas", ctc_cuda.forward_alphas_reference),
             (ctc_cuda, "backward_betas", ctc_cuda.backward_betas_reference),
             (rnn_cuda, "lstm_seq_fwd", rnn_cuda.lstm_seq_fwd_reference),
             (rnn_cuda, "lstm_seq_bwd_dgates",
              rnn_cuda.lstm_seq_bwd_dgates_reference),
             (rnn_cuda, "lstm_stack_fwd", rnn_cuda.lstm_stack_fwd_reference)]
    swaps += [(gru_cuda, name, getattr(gru_cuda, name + "_reference"))
              for name in ("gru_seq_fwd", "gru_seq_bwd_dgates",
                           "bigru_seq_fwd", "bigru_seq_bwd_dgates")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def pcm(seconds, seed, np):
    """Seeded band-limited-ish noise as s16le PCM (the serve tests')."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(int(16000 * seconds)))
    x = (x - x.mean()) / (np.abs(x).max() + 1e-6)
    return (x * 20000).astype("<i2")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi[0] if smi else "not read"


def phase_build():
    """One nvcc per kernel source in csrc/, all started together."""
    from kaldi_ctc_tpu_torch import _kernels
    names = sorted(f[:-3] for f in os.listdir(_kernels._CSRC)
                   if f.endswith(".cu"))

    def build(name):
        t0 = time.perf_counter()
        path = _kernels.build(name)
        return {"seconds": round(time.perf_counter() - t0, 3),
                "library": os.path.relpath(path, ROOT)}

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        out = {name: f.result() for name, f in futures.items()}
    emit({"phase": "build", "nvcc_flags": " ".join(_kernels.NVCC_FLAGS),
          "wall_seconds": round(time.perf_counter() - t0, 3), **out})


def device_ms(torch, fn, tags, calls=20):
    """The card's mean ms a call of the kernels whose names hold one of
    ``tags``, from a torch.profiler trace of ``calls`` calls of ``fn``
    (``profiled``: after a warm-up and a marker); None where the trace
    holds none of them."""
    from torch.profiler import DeviceType

    def run():
        for _ in range(calls):
            fn()
    prof, _ = profiled(torch, run)
    hits = [k for k in device_kernels(prof, DeviceType)
            if any(tag in k[2] for tag in tags)]
    n = sum(k[1] for k in hits)
    return sum(k[0] for k in hits) / n / 1000 if n else None


def route_times(torch, fn, tags):
    """One route's times: one call (CUDA events around it, the host's time
    before its launch included), 50 calls back to back, and the card's
    time a call in a trace."""
    return {"ms": median_ms(fn, 20, torch),
            "back_to_back_ms": back_to_back_ms(fn, 50, torch),
            "device_ms": device_ms(torch, fn, tags)}


def launch_floor_ms(torch, dev):
    """One empty launch: CUDA events over 200 back-to-back calls of a null
    kernel through ctypes, as each wrapper calls its kernel."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.features import stft_cuda
    lib = _kernels.load("log_mel", stft_cuda._SIGNATURES)
    stream = _kernels.stream_ptr(dev)
    return back_to_back_ms(lambda: lib.kctpu_null_launch(stream), 200, torch)


def fft_ops(n_frames, length, padded, k_bins, mel):
    """The operations K4's function needs on these inputs, by an FFT:
    frame processing (~6 a sample), an N/2-point complex FFT (5 (N/2)
    log2(N/2)), the real split and power (~17 a bin), the mel rows'
    nonzero products (2 each)."""
    nh = padded // 2
    nnz = int((mel != 0).sum())
    return n_frames * (6.0 * length + 5.0 * nh * math.log2(nh)
                       + 17.0 * k_bins + 2.0 * nnz)


def phase_k4(torch, np, dev):
    """K4 on MFCC-hires frames of 8 s (798 frames, a request) and of one
    0.2 s stream chunk (20 frames): its plan; the wrapper (the fft route)
    against the plain version and against the dft route on the same
    operands; both routes timed; a 400-point transform
    (round_to_power_of_two off) through the dft route."""
    from kaldi_ctc_tpu_torch.features import MfccOptions, stft_cuda
    from kaldi_ctc_tpu_torch.features.mel import mel_banks
    from kaldi_ctc_tpu_torch.features.window import (FrameOptions,
                                                     feature_window,
                                                     frame_signal)
    opts = MfccOptions.hires()
    fo = opts.frame_opts
    wave = torch.as_tensor(pcm(8.0, 100, np).astype(np.float32), device=dev)
    all_frames = frame_signal(wave, fo).contiguous()
    window = torch.as_tensor(feature_window(fo), device=dev)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, fo), device=dev)
    padded = fo.padded_window_size
    m_bins, k_bins = mel.shape
    length = fo.window_size
    plan = stft_cuda.k4_plan(length, padded, k_bins, m_bins)
    emit({"phase": "k4_plan", "length": length, "padded": padded,
          "k_bins": k_bins, "m_bins": m_bins, "plan": plan._asdict()})
    if plan.route != "fft" or all_frames.shape[0] != 798:
        fail(f"K4 at the hires shape: {plan}, {all_frames.shape[0]} frames")
    flags = (fo.remove_dc_offset, fo.preemph_coeff, True, True)
    tw = stft_cuda._device_twiddles(padded, dev)
    tables = stft_cuda._device_tables(length, padded, k_bins, dev)
    shapes, errs = [], []
    for count in (798, 20):
        frames = all_frames[:count].contiguous()
        args = (frames, window, mel, padded)
        before = read_counts()
        got = stft_cuda.log_mel(*args)
        after = read_counts()
        ref = stft_cuda.log_mel_reference(*args)
        dft = stft_cuda._log_mel_dft(*args, *flags)
        torch.cuda.synchronize()
        taken = {k: after[k] - before[k] for k in ("log_mel.fft",
                                                   "log_mel.dft")}
        checks = {"vs_plain": [max_err(g, r, K4_TOL, K4_TOL)
                               for g, r in zip(got, ref)],
                  "vs_dft_route": [max_err(g, r, K4_TOL, K4_TOL)
                                   for g, r in zip(got, dft)]}
        fft_b = bound(nbytes(frames, window, mel, tw, *got),
                      fft_ops(count, length, padded, k_bins, mel),
                      "float32")
        dft_b = bound(nbytes(frames, window, mel, *tables, *got),
                      count * (4.0 * length * k_bins
                               + 2.0 * m_bins * k_bins), "float32")
        row = {"frames": count, "route_taken": taken,
               **{f"max_abs_err_{k}": max(e for e, _ in v)
                  for k, v in checks.items()},
               "tol": K4_TOL,
               "ms": median_ms(lambda: stft_cuda.log_mel(*args), 20, torch),
               "plain_ms": median_ms(
                   lambda: stft_cuda.log_mel_reference(*args), 20, torch),
               "fft_route": route_times(
                   torch, lambda: stft_cuda._log_mel_fft(*args, *flags,
                                                         plan),
                   ("log_mel_fft_kernel",)),
               "dft_route": route_times(
                   torch, lambda: stft_cuda._log_mel_dft(*args, *flags),
                   ("log_mel_kernel",)),
               **fft_b, "bound_work": "FFT: bytes of the frames, window, "
               "mel, twiddles and outputs; ~6 ops a sample, 5 (N/2) "
               "log2(N/2), ~17 a bin, 2 a nonzero mel entry",
               "bound_ms_direct_dft": dft_b["bound_ms"],
               "bound_by_direct_dft": dft_b["bound_by"],
               "library_ms": None}
        emit({"phase": "k4_log_mel", **row})
        shapes.append(row)
        errs.append(row["max_abs_err_vs_plain"])
        if taken != {"log_mel.fft": 1, "log_mel.dft": 0}:
            fail(f"K4 at {count} frames did not take the fft route: {row}")
        if not all(ok for v in checks.values() for _, ok in v):
            fail(f"K4 at {count} frames disagrees with its plain version "
                 f"or its dft route: {row}")
    # round_to_power_of_two off: a 400-point transform, the dft route
    fo4 = FrameOptions(round_to_power_of_two=False)
    mel4 = torch.as_tensor(mel_banks(opts.mel_opts, fo4), device=dev)
    args4 = (frame_signal(wave, fo4).contiguous(), window, mel4,
             fo4.padded_window_size)
    before = read_counts()
    got = stft_cuda.log_mel(*args4)
    after = read_counts()
    ref = stft_cuda.log_mel_reference(*args4)
    torch.cuda.synchronize()
    e4 = [max_err(g, r, K4_TOL, K4_TOL) for g, r in zip(got, ref)]
    row4 = {"phase": "k4_log_mel_400_points",
            "padded": fo4.padded_window_size,
            "plan": stft_cuda.k4_plan(length, fo4.padded_window_size,
                                      mel4.shape[1], mel4.shape[0])._asdict(),
            "route_taken": {k: after[k] - before[k]
                            for k in ("log_mel.fft", "log_mel.dft")},
            "max_abs_err_vs_plain": max(e for e, _ in e4), "tol": K4_TOL}
    emit(row4)
    if row4["route_taken"] != {"log_mel.fft": 0, "log_mel.dft": 1} or \
            not all(ok for _, ok in e4):
        fail(f"K4's 400-point transform: {row4}")
    main = shapes[0]
    return {"max_abs_err": max(errs + [row4["max_abs_err_vs_plain"]]),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "bound_ms_direct_dft")},
            "shapes": [{k: r[k] for k in (
                "frames", "ms", "plain_ms", "fft_route", "dft_route",
                "bound_ms", "bound_by", "bound_ms_direct_dft",
                "max_abs_err_vs_plain", "max_abs_err_vs_dft_route")}
                for r in shapes]}


def phase_k2(torch, np, dev):
    """K2 against its plain version at T=800, B=1 and B=8 (serving) and
    T=240, B=48 and B=600 (training), H=320, f32 and bf16, with its plan;
    at T=800, B=1 and T=240, B=48 both of its routes timed on the same
    operands (the cluster route and the cooperative kernel); at T=240,
    B=48 also the instance with the store, which training runs
    (store_witness)."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    h = 320
    lib = _kernels.load("bilstm_fwd", rnn_cuda._SIGNATURES)
    rows = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for t_max, b in ((800, 1), (800, 8), (TRAIN_T, TRAIN_B),
                         (TRAIN_T, 600)):
            rng = np.random.default_rng(b)
            xp = torch.as_tensor(rng.standard_normal((t_max, b, 8 * h))
                                 .astype(np.float32) * 0.5, device=dev)
            w = [torch.as_tensor((rng.standard_normal((h, 4 * h))
                                  / np.sqrt(h)).astype(np.float32),
                                 device=dev).to(dtype) for _ in range(2)]
            lens = np.full(b, t_max, np.int32)
            lens[1:] = rng.integers(t_max // 2, t_max + 1, size=b - 1)
            args = (xp.to(dtype), w[0], w[1],
                    torch.as_tensor(lens, device=dev))
            got = rnn_cuda.bilstm_seq_fwd(*args)
            ref = rnn_cuda.bilstm_seq_fwd_reference(*args)
            torch.cuda.synchronize()
            errs = [max_err(g, r, 0.0, K2_TOL[dtype_name])
                    for g, r in zip(got, ref)]
            plan = rnn_cuda.k2_plan(lib, b, h, dtype, dev)
            row = {"dtype": dtype_name, "T": t_max, "B": b, "H": h,
                   "max_abs_err": max(e for e, _ in errs),
                   "tol": K2_TOL[dtype_name], "plan": plan._asdict(),
                   "ms": median_ms(lambda: rnn_cuda.bilstm_seq_fwd(*args),
                                   10, torch),
                   "plain_ms": median_ms(
                       lambda: rnn_cuda.bilstm_seq_fwd_reference(*args), 3,
                       torch),
                   **bound(nbytes(*args, *got),
                           lstm_ops(args[3], h, 2), dtype_name),
                   "library_ms": None}
            if b in (1, TRAIN_B):
                # both routes on the same operands, through their exports
                chain = rnn_cuda.fwd_chain_plan(
                    b, 0, h, dtype, 2, torch.cuda.get_device_properties(
                        dev).multi_processor_count,
                    rnn_cuda._smem_optin(lib, "bilstm_fwd_smem_optin", dev))
                lens32 = args[3].to(torch.int32)
                row["chain_route_ms"] = median_ms(
                    lambda: rnn_cuda._bilstm_fwd_chain(lib, *args[:3],
                                                       lens32, chain),
                    10, torch)
                row["cooperative_route_ms"] = median_ms(
                    lambda: rnn_cuda._bilstm_fwd_cooperative(
                        lib, *args[:3], lens32), 10, torch)
            if b == TRAIN_B:
                # cuDNN's layer includes the input projection (a layer
                # above the first: 2H inputs), so the kernel's own
                # projection GEMM stands beside it
                row["library_ms"] = library_rnn_ms(
                    torch, dev, dtype, t_max, b, 2 * h, h,
                    bidirectional=True)
                row["projection_plus_kernel_ms"] = projection_plus_kernel_ms(
                    torch, dev, dtype, t_max, b, 2 * h, 8 * h,
                    lambda p: rnn_cuda.bilstm_seq_fwd(p, *args[1:]))
                row.update(store_witness(torch, rnn_cuda.bilstm_seq_fwd,
                                         args, got, ref, K2_TOL[dtype_name]))
            rows.append(row)
            emit({"phase": "k2_bilstm", **row})
            if not all(ok for _, ok in errs) or not row.get("store_ok", True):
                fail(f"K2 bilstm_seq_fwd disagrees with its plain version: "
                     f"{row}")
    # the kernels line reports the training shape in bf16
    train_row = next(r for r in rows
                     if r["dtype"] == "bfloat16" and r["B"] == TRAIN_B)
    return kernel_row(rows, train_row)


def kernel_row(rows, row):
    """The kernels line's entry from a phase's rows: the largest error
    of all, the times, bound and library time of one row (and its time
    with the store, K2's and K8a's training row)."""
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "store_ms") if k in row}}


def plain_sums(torch, y_f, y_b, w_f, w_b, lens):
    """The recurrent sums a bidirectional forward formed its gates from,
    in the backward's walk order, recomputed in f64 from its y: row s the
    forward direction's at t = T-1-s over the h it carried (y_f[min(t,
    len) - 1], zeros before the first frame) and the backward
    direction's at t = s over y_b[t+1] (zeros at t = T-1)."""
    t_max, b, _ = y_f.shape
    dev = y_f.device
    prev = torch.minimum(torch.arange(t_max, device=dev)[:, None],
                         lens.long()[None, :]) - 1
    rows = torch.arange(b, device=dev).expand(t_max, b)
    h_f = y_f[prev.clamp(min=0), rows].double() * (prev >= 0)[..., None]
    h_b = torch.cat([y_b[1:], torch.zeros_like(y_b[:1])]).double()
    return torch.cat([(h_f @ w_f.double()).flip(0), h_b @ w_b.double()],
                     dim=-1)


def store_witness(torch, fwd, args, outs, refs, tol):
    """K2's or K8a's instance with the store (``fwd`` its wrapper, which
    training runs with ``store_sums``) on ``args`` (xp, w_h_f, w_h_b,
    lens): its outputs against the plain version's ``refs`` within
    ``tol`` and bit for bit the outputs ``outs`` of the instance without
    the store, its sums within ``tol`` of plain_sums from its y, and its
    median ms beside the other's."""
    *got, sums = fwd(*args, store_sums=True)
    torch.cuda.synchronize()
    errs = [max_err(g, r, 0.0, tol) for g, r in zip(got, refs)]
    ref_sums = plain_sums(torch, got[0], got[len(got) // 2], *args[1:])
    sums_err, sums_ok = max_err(sums, ref_sums, 0.0, tol)
    equal = all(torch.equal(g, o) for g, o in zip(got, outs))
    return {"store_max_abs_err": max(e for e, _ in errs),
            "store_sums_max_abs_err": sums_err,
            "store_bit_equal_no_store": equal,
            "store_ok": all(ok for _, ok in errs) and sums_ok and equal,
            "store_ms": median_ms(lambda: fwd(*args, store_sums=True), 10,
                                  torch)}


def projection_plus_kernel_ms(torch, dev, dtype, t, b, d_in, g, kernel):
    """Median ms of the hoisted projection (f32-accumulated GEMM plus
    bias, stored in the compute dtype) followed by ``kernel`` on it: the
    work of one cuDNN layer call."""
    from kaldi_ctc_tpu_torch.ops.rnn import matmul_f32acc
    x = torch.randn(t * b, d_in, device=dev)
    w = torch.randn(d_in, g, device=dev) * d_in ** -0.5
    bias = torch.zeros(g, device=dev)

    def run():
        kernel((matmul_f32acc(x, w, dtype) + bias).to(dtype).reshape(t, b, g))
    return median_ms(run, 10, torch)


def ctc_batch(np, seed):
    """bench.py's CTC shapes with ragged rows: frames and labels of full
    length for most utterances, some short, one label-less, and two
    with fewer frames than labels (infeasible)."""
    rng = np.random.default_rng(seed)
    b, t, l, a = TRAIN_B, TRAIN_T, TRAIN_L, 72
    labels = rng.integers(1, a, (b, l)).astype(np.int32)
    label_lens = np.full(b, l, np.int32)
    input_lens = np.full(b, t, np.int32)
    label_lens[1:8] = rng.integers(1, l, size=7)
    input_lens[4:12] = rng.integers(2 * l + 1, t, size=8)
    label_lens[12] = 0
    input_lens[13:15] = (69, 40)            # fewer frames than L = 70
    for i in range(b):
        labels[i, label_lens[i]:] = 0
    return {"logits": (rng.standard_normal((b, t, a)) * 2).astype(np.float32),
            "labels": labels, "input_lens": input_lens,
            "label_lens": label_lens}


def phase_k1(torch, np, dev):
    """K1, K11 and K12 against their plain loops on the card, then the
    separate path of ctc_loss_and_grad as a driven path."""
    from kaldi_ctc_tpu_torch.ops import ctc, ctc_cuda
    data = ctc_batch(np, 1)
    logits, labels, input_lens, label_lens = (
        torch.as_tensor(data[k], device=dev)
        for k in ("logits", "labels", "input_lens", "label_lens"))
    b = logits.shape[0]
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    skip_down = ctc._skip_down(skip_ok)
    ref_a, ref_b = ctc_cuda.alpha_beta_reference(lp, skip_ok, skip_down,
                                                 input_lens, label_lens)
    runs = {
        "ctc_alpha_beta": (
            lambda: ctc_cuda.alpha_beta(lp, skip_ok, skip_down, input_lens,
                                        label_lens),
            lambda: ctc_cuda.alpha_beta_reference(
                lp, skip_ok, skip_down, input_lens, label_lens),
            (ref_a, ref_b)),
        "ctc_alphas": (
            lambda: (ctc_cuda.forward_alphas(lp, skip_ok, input_lens),),
            lambda: ctc_cuda.forward_alphas_reference(lp, skip_ok,
                                                      input_lens),
            (ref_a,)),
        "ctc_betas": (
            lambda: (ctc_cuda.backward_betas(lp, skip_down, input_lens,
                                             label_lens),),
            lambda: ctc_cuda.backward_betas_reference(
                lp, skip_down, input_lens, label_lens),
            (ref_b,)),
    }
    with plain_versions():
        ref_loss, ref_grad = ctc.ctc_loss_and_grad(
            logits, labels, input_lens, label_lens)
    # each kernel's inputs and outputs, and ~10 f32 operations (a
    # log-add of up to three terms) per lattice state and step of each
    # recursion it runs
    cells = float(lp.shape[0] * lp.shape[1] * lp.shape[2]) * 10
    bounds = {
        "ctc_alpha_beta": bound(nbytes(lp, skip_ok, skip_down, input_lens,
                                       label_lens, ref_a, ref_b),
                                2 * cells, "float32"),
        "ctc_alphas": bound(nbytes(lp, skip_ok, input_lens, ref_a), cells,
                            "float32"),
        "ctc_betas": bound(nbytes(lp, skip_down, input_lens, label_lens,
                                  ref_b), cells, "float32")}
    # the library's CTC on the same logits and labels: forward and
    # backward for the fused kernel, forward alone for the alphas; none
    # computes the betas alone
    log_probs = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    ctc_args = (labels, input_lens, label_lens)

    def library_loss(grad):
        lp_ = log_probs.detach().requires_grad_(grad)
        loss = torch.nn.functional.ctc_loss(lp_, *ctc_args, blank=0,
                                            reduction="sum",
                                            zero_infinity=True)
        if grad:
            loss.backward()
    library = {"ctc_alpha_beta": median_ms(lambda: library_loss(True), 20,
                                           torch),
               "ctc_alphas": median_ms(lambda: library_loss(False), 20,
                                       torch),
               "ctc_betas": None}
    out = {}
    k1_ops = (lp, skip_ok, skip_down, input_lens.to(torch.int32),
              label_lens.to(torch.int32))
    routes = {"ctc_alpha_beta": k1_routes(torch, *k1_ops),
              "ctc_alphas": band_routes(torch, "k11", k1_ops),
              "ctc_betas": band_routes(torch, "k12", k1_ops)}
    want_route = {"ctc_alpha_beta": "ctc_alpha_beta.warp",
                  "ctc_alphas": "ctc_alphas.band",
                  "ctc_betas": "ctc_betas.band"}
    for name, (kern, plain, refs) in runs.items():
        before = read_counts()
        got = kern()
        torch.cuda.synchronize()
        after = read_counts()
        errs = [max_err(g, r, CTC_RTOL, CTC_ATOL) for g, r in zip(got, refs)]
        impl = "fused" if name == "ctc_alpha_beta" else "separate"
        loss, grad = ctc.ctc_loss_and_grad(logits, labels, input_lens,
                                           label_lens, implementation=impl)
        e_loss = max_err(loss, ref_loss, CTC_RTOL, CTC_ATOL)
        e_grad = max_err(grad, ref_grad, 0.0, CTC_GRAD_TOL)
        row = {"kernel": name, "B": b, "T": int(lp.shape[0]),
               "S": int(lp.shape[2]),
               "max_abs_err_lattice": max(e for e, _ in errs),
               "lattice_rtol_atol": [CTC_RTOL, CTC_ATOL],
               "max_abs_err_loss": e_loss[0], "max_abs_err_grad": e_grad[0],
               "grad_tol": CTC_GRAD_TOL,
               "infeasible_rows_loss": [float(v) for v in loss[13:15]],
               "ms": median_ms(kern, 20, torch),
               "plain_ms": median_ms(plain, 3, torch), **bounds[name],
               "library_ms": library[name]}
        emit({"phase": "k1_ctc", **row})
        if not (all(ok for _, ok in errs) and e_loss[1] and e_grad[1]):
            fail(f"{name} disagrees with its plain version: {row}")
        if any(row["infeasible_rows_loss"]) or grad[13:15].abs().max() > 0:
            fail(f"infeasible rows not masked: {row}")
        out[name] = kernel_row([{"max_abs_err": max(e for e, _ in errs)}],
                               row)
        key = want_route[name]
        if after[key] - before[key] != 1:
            fail(f"{name} at S={row['S']} did not take its route {key}")
        out[name]["routes"] = routes[name]
    # the separate path: a user's ctc_loss_and_grad(implementation=
    # "separate") at bench shapes, counts from this call alone
    reset_counts()
    loss, _ = ctc.ctc_loss_and_grad(logits, labels, input_lens, label_lens,
                                    implementation="separate")
    torch.cuda.synchronize()
    counts = read_counts()
    emit({"phase": "ctc_separate_path", "launches": counts,
          "loss_total": float(loss.sum())})
    if counts["ctc_alphas"] != 1 or counts["ctc_betas"] != 1:
        fail(f"the separate CTC path did not launch K11 and K12 once: "
             f"{counts}")
    return out, counts


def band_routes(torch, kernel, k1_ops):
    """K11's (``kernel`` "k11") or K12's ("k12") plan at bench's S, its
    two routes timed on the same operands (the band route; the block
    kernel), and the witness: the band route's rows equal the block
    route's and K1's warp route's bit for bit, at bench's B and at B=1
    (the first row).  ``k1_ops`` are K1's checked operands."""
    from kaldi_ctc_tpu_torch.ops import ctc_cuda
    alpha = kernel == "k11"
    plan = (ctc_cuda.k11_plan if alpha else ctc_cuda.k12_plan)(
        k1_ops[0].shape[2])
    route = ctc_cuda._alphas_route if alpha else ctc_cuda._betas_route
    pick = (0, 1, 3) if alpha else (0, 2, 3, 4)
    one = (k1_ops[0][:, :1].contiguous(),
           *(v[:1].contiguous() for v in k1_ops[1:]))
    equal = {}
    for key, args in (("B", k1_ops), ("B1", one)):
        sub = [args[i] for i in pick]
        band = route("band", *sub)
        k1 = ctc_cuda._alpha_beta_route("warp", *args)[0 if alpha else 1]
        equal[key] = {"block": torch.equal(band, route("block", *sub)),
                      "k1_warp_route": torch.equal(band, k1)}
    ops = [k1_ops[i] for i in pick]
    rec = "<true, false" if alpha else "<false, true"
    band_tag = "ctc_band_kernel" + ("<true" if alpha else "<false")
    res = {"phase": f"{kernel}_routes", "B": int(k1_ops[0].shape[1]),
           "T": int(k1_ops[0].shape[0]), "S": int(k1_ops[0].shape[2]),
           "plan": plan._asdict(), "bit_equal": equal,
           "band_route": route_times(torch, lambda: route("band", *ops),
                                     (band_tag,)),
           "block_route": route_times(torch, lambda: route("block", *ops),
                                      ("ctc_kernel" + rec,))}
    emit(res)
    if plan.route != "band" or not all(all(v.values())
                                       for v in equal.values()):
        fail(f"{kernel}'s band route at bench's shape: {res}")
    return {k: res[k] for k in ("plan", "bit_equal", "band_route",
                                "block_route")}


def k1_routes(torch, lp, skip_ok, skip_down, lens, label_lens):
    """K1's plan at bench's S, its two routes timed on the same operands
    (the warp route; the block kernel), and the witness: both give alphas
    and betas bit for bit, at bench's B and at B=1 (the first row)."""
    from kaldi_ctc_tpu_torch.ops import ctc_cuda
    plan = ctc_cuda.k1_plan(lp.shape[2])
    ops = (lp, skip_ok, skip_down, lens, label_lens)
    one = (lp[:, :1].contiguous(), *(v[:1].contiguous() for v in ops[1:]))
    equal = {}
    for key, args in (("B", ops), ("B1", one)):
        warp = ctc_cuda._alpha_beta_route("warp", *args)
        block = ctc_cuda._alpha_beta_route("block", *args)
        equal[key] = all(torch.equal(w, k) for w, k in zip(warp, block))
    res = {"phase": "k1_routes", "B": int(lp.shape[1]), "T": int(lp.shape[0]),
           "S": int(lp.shape[2]), "plan": plan._asdict(),
           "bit_equal_block_route": equal,
           "warp_route": route_times(
               torch, lambda: ctc_cuda._alpha_beta_route("warp", *ops),
               ("ctc_warp_kernel",)),
           "block_route": route_times(
               torch, lambda: ctc_cuda._alpha_beta_route("block", *ops),
               ("ctc_kernel<true, true>",))}
    emit(res)
    if plan.route != "warp" or not all(equal.values()):
        fail(f"K1's warp route at bench's shape: {res}")
    return {k: res[k] for k in ("plan", "bit_equal_block_route",
                                "warp_route", "block_route")}


def phase_k3(torch, np, dev):
    """K3 against its plain version at T=240, B=48, H=320 with ragged
    lengths, f32 and bf16, with its plan (the cluster route), both routes
    timed on the same operands and the cluster route's two phases timed
    apart (bwd_routes), and the recompute witness: at each row's first
    valid walk step, where dh and dc are zero, the cluster route equals
    the cooperative kernel bit for bit."""
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    t_max, b, h = TRAIN_T, TRAIN_B, 320
    rows = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        rng = np.random.default_rng(3)
        xp = torch.as_tensor(rng.standard_normal((t_max, b, 8 * h))
                             .astype(np.float32) * 0.5, device=dev).to(dtype)
        w = [torch.as_tensor((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                             .astype(np.float32), device=dev).to(dtype)
             for _ in range(2)]
        lens = np.full(b, t_max, np.int32)
        lens[1:] = rng.integers(t_max // 2, t_max + 1, size=b - 1)
        lens = torch.as_tensor(lens, device=dev)
        y_f, c_f, y_b, c_b, sums = rnn_cuda.bilstm_seq_fwd(
            xp, w[0], w[1], lens, store_sums=True)
        dy = [torch.as_tensor(rng.standard_normal((t_max, b, h)).astype(
            np.float32), device=dev).to(dtype) for _ in range(2)]
        args = (dy[0], dy[1], xp, y_f, c_f, y_b, c_b, w[0], w[1], lens)
        got = rnn_cuda.bilstm_seq_bwd_dgates(*args, sums)
        ref = rnn_cuda.bilstm_seq_bwd_dgates_reference(*args)
        torch.cuda.synchronize()
        errs = [max_err(g, r, 0.0, K3_TOL[dtype_name])
                for g, r in zip(got, ref)]
        row = {"dtype": dtype_name, "T": t_max, "B": b, "H": h,
               "max_abs_err": max(e for e, _ in errs),
               "max_abs_ref": max(float(r.float().abs().max()) for r in ref),
               "tol": K3_TOL[dtype_name],
               "ms": median_ms(
                   lambda: rnn_cuda.bilstm_seq_bwd_dgates(*args, sums), 10,
                   torch),
               "plain_ms": median_ms(
                   lambda: rnn_cuda.bilstm_seq_bwd_dgates_reference(*args),
                   3, torch),
               # the gate recompute and the dh product, per direction (the
               # bound of the recompute pair; the cluster route reads K2's
               # sums instead of recomputing them)
               **bound(nbytes(*args, *got), lstm_ops(lens, h, 4),
                       dtype_name),
               "library_ms": library_rnn_ms(
                   torch, dev, dtype, t_max, b, 2 * h, h,
                   bidirectional=True, backward=True)}
        row.update(bwd_routes(torch, dev, "K3", args, sums))
        row["first_step_bit_equal_cooperative"] = k3_first_steps_equal(
            torch, dev, args, sums)
        row["below_library"] = row["ms"] < row["library_ms"]
        rows.append(row)
        emit({"phase": "k3_bilstm_bwd", **row})
        if not all(ok for _, ok in errs):
            fail(f"K3 bilstm_seq_bwd_dgates disagrees with its plain "
                 f"version: {row}")
        if not row["first_step_bit_equal_cooperative"]:
            fail(f"K3's routes differ where dh and dc are zero: {row}")
    return kernel_row(rows, rows[1])     # bf16


def wide_counts(fwd, bwd):
    """The wide route's counters: K2's wide and store launches, K3's wide
    launches and those on stored sums."""
    return {"bilstm_fwd.wide": fwd.wide_launches,
            "bilstm_fwd.store": fwd.store_launches,
            "bilstm_bwd.wide": bwd.wide_launches,
            "bilstm_bwd.stored": bwd.stored_launches}


def zero_wide_counts(fwd, bwd):
    fwd.wide_launches = fwd.store_launches = 0
    bwd.wide_launches = bwd.stored_launches = 0


def phase_wide(torch, np, dev):
    """K2's and K3's wide route at T'=750, B=64, H=1024 in f32 with
    ragged rows against their plain versions, timed beside them, cuDNN
    and the bound; then one DS2 train step at its published widths with
    its launches counted → (the kernels line's two rows, the step's
    launches by kernel)."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import ctc_cuda, rnn_cuda
    t_max, b, h = WIDE_T, WIDE_B, WIDE_H
    dtype = torch.float32
    fwd, bwd = rnn_cuda.bilstm_seq_fwd, rnn_cuda.bilstm_seq_bwd_dgates
    plans = {"k2": rnn_cuda.k2_plan(_kernels.load(
                 "bilstm_fwd", rnn_cuda._SIGNATURES), b, h, dtype, dev),
             "k3": rnn_cuda.k3_plan(_kernels.load(
                 "bilstm_bwd", rnn_cuda._BWD_SIGNATURES), b, h, dtype, dev)}
    if {p.route for p in plans.values()} != {"wide"}:
        fail(f"at H={h}, B={b} K2 and K3 must take the wide route: {plans}")
    rng = np.random.default_rng(25)
    xp = torch.as_tensor(rng.standard_normal((t_max, b, 8 * h))
                         .astype(np.float32) * 0.5, device=dev)
    w = [torch.as_tensor((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                         .astype(np.float32), device=dev) for _ in range(2)]
    # the cell's utterances run 1.5-15 s: 75-750 frames after the stride
    lens = np.full(b, t_max, np.int32)
    lens[1:] = rng.integers(t_max // 10, t_max + 1, size=b - 1)
    lens = torch.as_tensor(lens, device=dev)
    dy = [torch.as_tensor(rng.standard_normal((t_max, b, h)).astype(
        np.float32), device=dev) for _ in range(2)]
    zero_wide_counts(fwd, bwd)
    y_f, c_f, y_b, c_b, sums = fwd(xp, w[0], w[1], lens, store_sums=True)
    args = (dy[0], dy[1], xp, y_f, c_f, y_b, c_b, w[0], w[1], lens)
    got_b = bwd(*args, sums)
    torch.cuda.synchronize()
    counts = wide_counts(fwd, bwd)
    ref_f = rnn_cuda.bilstm_seq_fwd_reference(xp, w[0], w[1], lens)
    ref_b = rnn_cuda.bilstm_seq_bwd_dgates_reference(*args)
    errs_f = [max_err(g, r, 0.0, K2_TOL["float32"])
              for g, r in zip((y_f, c_f, y_b, c_b), ref_f)]
    errs_b = [max_err(g, r, 0.0, K3_TOL["float32"])
              for g, r in zip(got_b, ref_b)]
    ops = lstm_ops(lens, h, 2)
    rows = [{"kernel": "bilstm_fwd_wide", "dtype": "float32", "T": t_max,
             "B": b, "H": h, "plan": plans["k2"]._asdict(),
             "max_abs_err": max(e for e, _ in errs_f),
             "tol": K2_TOL["float32"],
             "ms": median_ms(lambda: fwd(xp, w[0], w[1], lens,
                                         store_sums=True), 10, torch),
             "ms_no_store": median_ms(lambda: fwd(xp, w[0], w[1], lens),
                                      10, torch),
             "plain_ms": median_ms(lambda: rnn_cuda.bilstm_seq_fwd_reference(
                 xp, w[0], w[1], lens), 3, torch),
             # cuDNN's layer includes the input projection (a layer above
             # the first: the summed directions' 1,024 inputs)
             "library_ms": library_rnn_ms(torch, dev, dtype, t_max, b, h, h,
                                          bidirectional=True),
             **bound(nbytes(xp, *w, lens, y_f, c_f, y_b, c_b, sums), ops,
                     "float32")},
            {"kernel": "bilstm_bwd_wide", "dtype": "float32", "T": t_max,
             "B": b, "H": h, "plan": plans["k3"]._asdict(),
             "max_abs_err": max(e for e, _ in errs_b),
             "max_abs_ref": max(float(r.abs().max()) for r in ref_b),
             "tol": K3_TOL["float32"],
             "ms": median_ms(lambda: bwd(*args, sums), 10, torch),
             "plain_ms": median_ms(
                 lambda: rnn_cuda.bilstm_seq_bwd_dgates_reference(*args), 3,
                 torch),
             # cuDNN's backward computes dx and dW too
             "library_ms": library_rnn_ms(torch, dev, dtype, t_max, b, h, h,
                                          bidirectional=True, backward=True),
             # the dh product a direction; the gates come from the sums
             **bound(nbytes(*args, sums, *got_b), ops, "float32")}]
    for row in rows:
        row["launches_checked_run"] = counts
        emit({"phase": "wide_" + row["kernel"], **row})
    if counts != {k: 1 for k in counts}:
        fail(f"the wide route's checked run counted {counts} (want one "
             f"each)")
    if not all(ok for _, ok in errs_f + errs_b):
        fail(f"K2's or K3's wide route disagrees with its plain version: "
             f"{rows}")
    del xp, w, dy, y_f, c_f, y_b, c_b, sums, args, got_b, ref_f, ref_b
    step_launches = wide_train_step(torch, np, dev, ctc_cuda, fwd, bwd)
    return {r["kernel"]: {k: r[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for r in rows}, step_launches


def wide_train_step(torch, np, dev, ctc_cuda, fwd, bwd):
    """One train step of deepspeech.pytorch's DS2 at its published widths
    (the ds2blstm5x1024 configuration) on 64 seeded rows of 150-1,500
    frames and 15 characters a second, after a warm-up step: its launches
    (K2 and K3 on the wide route once a layer, K1 on its block route),
    its ms (median of 3, host clock over a synchronised step) and the
    card's memory peak."""
    from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig,
                                                     init_am_params,
                                                     init_norm_stats)
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train
    cfg = AmConfig(input_dim=161, num_targets=29, hidden_dim=WIDE_H,
                   num_layers=5, conv_layers=2, conv_channels=32,
                   conv_time_stride=2, conv_norm="batch")
    b, t = WIDE_B, 2 * WIDE_T
    rng = np.random.default_rng(26)
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(t // 10, t + 1, size=b - 1)
    label_lens = (lens * 0.15).astype(np.int32)
    feats = rng.standard_normal((b, t, 161)).astype(np.float32)
    feats[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    batch = {k: torch.as_tensor(v, device=dev) for k, v in {
        "feats": feats,
        "labels": rng.integers(1, 29, (b, int(label_lens.max())))
        .astype(np.int32),
        "input_lens": lens, "label_lens": label_lens}.items()}
    params = init_am_params(cfg, torch.Generator().manual_seed(0), dev)
    opts = train.TrainOptions()
    state = train.init_train_state(params, opts, init_norm_stats(cfg, dev))
    step = train.build_train_step(cfg, opts)
    torch.cuda.reset_peak_memory_stats(dev)
    state, _ = step(state, batch)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    zero_wide_counts(fwd, bwd)
    state, m = step(state, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {**{k: counts[k] for k in ("bilstm_fwd", "bilstm_bwd",
                                          "ctc_alpha_beta",
                                          "ctc_alpha_beta.warp",
                                          "ctc_alpha_beta.block")},
                **wide_counts(fwd, bwd)}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        bool(m["finite"])
        times.append((time.perf_counter() - t0) * 1e3)
    res = {"phase": "wide_ds2_train_step", "B": b, "T": t,
           "T_logits": int(cfg.output_lens(lens).max()),
           "max_label_len": int(label_lens.max()),
           "parameters": sum(p.numel() for p in tree_flatten(
               state.params)),
           "launches": launches, "step_ms": sorted(times)[1],
           "loss_total": float(m["loss_total"]),
           "finite": bool(m["finite"]),
           "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    emit(res)
    want = {"bilstm_fwd.wide": 5, "bilstm_fwd.store": 5,
            "bilstm_bwd.wide": 5, "bilstm_bwd.stored": 5,
            "ctc_alpha_beta": 1, "ctc_alpha_beta.block": 1}
    if any(launches[k] != n for k, n in want.items()) or not res["finite"]:
        fail(f"the DS2 train step: {res} (want {want})")
    return launches


def k3_first_steps_equal(torch, dev, args, sums):
    """Whether K3's cluster route (on K2's stored ``sums``) and its
    cooperative kernel give the same dgates bit for bit at each row's
    first valid walk step (t = len - 1 for the forward direction, t = 0
    for the backward one), where dh and dc are still zero: the gates from
    K2's sums and from the cooperative kernel's recompute in warp_dot's
    order."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    *ops, lens = args
    xp = ops[2]
    b, h = xp.shape[1], xp.shape[2] // 8
    lib = _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)
    lens32 = lens.to(torch.int32)
    chain = rnn_cuda._bilstm_bwd_chain(
        lib, *ops, lens32, sums, rnn_cuda.k3_plan(lib, b, h, xp.dtype, dev))
    coop = rnn_cuda._bilstm_bwd_cooperative(lib, *ops, lens32)
    rows = torch.arange(b, device=dev)
    valid = lens > 0
    first = (lens.long() - 1).clamp(min=0)
    return (torch.equal(chain[0][first, rows][valid],
                        coop[0][first, rows][valid])
            and torch.equal(chain[1][0][valid], coop[1][0][valid]))


def uni_inputs(torch, np, dev, t_max, b, h, dtype, seed):
    """Seeded K5 operands: x_proj, w_h, lengths (row 0 full, the rest
    ragged from T/2 up)."""
    rng = np.random.default_rng(seed)
    xp = torch.as_tensor(rng.standard_normal((t_max, b, 4 * h))
                         .astype(np.float32) * 0.5, device=dev).to(dtype)
    w = torch.as_tensor((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                        .astype(np.float32), device=dev).to(dtype)
    lens = np.full(b, t_max, np.int32)
    lens[1:] = rng.integers(t_max // 2, t_max + 1, size=b - 1)
    return xp, w, torch.as_tensor(lens, device=dev)


def phase_k5(torch, np, dev):
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    h = 320
    rows = []
    for dtype_name in DTYPES:
        dtype = getattr(torch, dtype_name)
        # serving (T=800, B=1 and 8; one reverse direction) and training
        # (T=240, B=48) shapes
        for t_max, b, reverse in ((800, 1, False), (800, 8, False),
                                  (800, 1, True), (TRAIN_T, TRAIN_B, False),
                                  (TRAIN_T, 600, False)):
            xp, w, lens = uni_inputs(torch, np, dev, t_max, b, h, dtype, b)
            args = (xp, w, lens, reverse)
            got = rnn_cuda.lstm_seq_fwd(*args)
            ref = rnn_cuda.lstm_seq_fwd_reference(*args)
            torch.cuda.synchronize()
            errs = [max_err(g, r, 0.0, K2_TOL[dtype_name])
                    for g, r in zip(got, ref)]
            row = {"dtype": dtype_name, "T": t_max, "B": b, "H": h,
                   "reverse": reverse,
                   "max_abs_err": max(e for e, _ in errs),
                   "tol": K2_TOL[dtype_name],
                   "ms": median_ms(lambda: rnn_cuda.lstm_seq_fwd(*args), 10,
                                   torch),
                   "plain_ms": median_ms(
                       lambda: rnn_cuda.lstm_seq_fwd_reference(*args), 3,
                       torch),
                   **bound(nbytes(xp, w, lens, *got), lstm_ops(lens, h, 1),
                           dtype_name), "library_ms": None,
                   "plan": chain_plan(torch, dev, "lstm_fwd", b, 0, h,
                                      dtype, 1)}
            if b == TRAIN_B:
                row["library_ms"] = library_rnn_ms(torch, dev, dtype, t_max,
                                                   b, h, h)
                row["projection_plus_kernel_ms"] = projection_plus_kernel_ms(
                    torch, dev, dtype, t_max, b, h, 4 * h,
                    lambda p: rnn_cuda.lstm_seq_fwd(p, w, lens))
            rows.append(row)
            emit({"phase": "k5_lstm", **row})
            if not all(ok for _, ok in errs):
                fail(f"K5 lstm_seq_fwd disagrees with its plain version: "
                     f"{row}")
    return kernel_row(rows, next(r for r in rows if r["dtype"] == "bfloat16"
                                 and r["B"] == TRAIN_B))


def phase_k6(torch, np, dev):
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    t_max, b, h = TRAIN_T, TRAIN_B, 320
    rows = []
    for dtype_name in DTYPES:
        dtype = getattr(torch, dtype_name)
        xp, w, lens = uni_inputs(torch, np, dev, t_max, b, h, dtype, 6)
        y, c_seq = rnn_cuda.lstm_seq_fwd(xp, w, lens)
        dy = torch.as_tensor(np.random.default_rng(7).standard_normal(
            (t_max, b, h)).astype(np.float32), device=dev).to(dtype)
        args = (dy, xp, y, c_seq, w, lens)
        got = rnn_cuda.lstm_seq_bwd_dgates(*args)
        ref = rnn_cuda.lstm_seq_bwd_dgates_reference(*args)
        torch.cuda.synchronize()
        err, ok = max_err(got, ref, 0.0, K3_TOL[dtype_name])
        row = {"dtype": dtype_name, "T": t_max, "B": b, "H": h,
               "max_abs_err": err, "max_abs_ref": float(ref.float().abs()
                                                        .max()),
               "tol": K3_TOL[dtype_name],
               "ms": median_ms(lambda: rnn_cuda.lstm_seq_bwd_dgates(*args),
                               10, torch),
               "plain_ms": median_ms(
                   lambda: rnn_cuda.lstm_seq_bwd_dgates_reference(*args), 3,
                   torch),
               # the gate recompute and the dh product
               **bound(nbytes(*args, got), lstm_ops(lens, h, 2), dtype_name),
               "library_ms": library_rnn_ms(torch, dev, dtype, t_max, b, h,
                                            h, backward=True)}
        row.update(bwd_routes(torch, dev, "K6", args))
        rows.append(row)
        emit({"phase": "k6_lstm_bwd", **row})
        if not ok:
            fail(f"K6 lstm_seq_bwd_dgates disagrees with its plain version: "
                 f"{row}")
    return kernel_row(rows, rows[1])     # bf16


def bwd_routes(torch, dev, name, args, sums=None):
    """K3's, K6's, K8b's or K9b's plan and its two routes timed on the
    same operands (the cluster route: K3 and K8b on their forward's stored
    ``sums``, K6 and K9b phase 1 then the backward chain; the cooperative
    kernel in row slices), and K6's and K9b's two phases timed apart (one
    chunk of steps at the training shape): phase 1, the recurrent sums of
    every step, and phase 2, the chain in clusters."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import gru_cuda, rnn_cuda
    f32 = torch.float32
    *ops, lens = args
    lens32 = lens.to(torch.int32)
    stream = _kernels.stream_ptr(dev)
    phases = True
    if name == "K3":
        xp = ops[2]
        lib = _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)
        t, b, g = xp.shape
        h = g // 8
        plan = rnn_cuda.k3_plan(lib, b, h, xp.dtype, dev)
        phases = False

        def chain():
            rnn_cuda._bilstm_bwd_chain(lib, *ops, lens32, sums, plan)

        def coop():
            rnn_cuda._bilstm_bwd_cooperative(lib, *ops, lens32)
    elif name == "K8b":
        xp = ops[2]
        lib = _kernels.load("gru_bwd", gru_cuda._BWD_SIGNATURES)
        t, b, g = xp.shape
        h = g // 6
        plan = gru_cuda.k8b_plan(lib, b, h, xp.dtype, dev)
        phases = False

        def chain():
            gru_cuda._bigru_bwd_chain(lib, *ops, lens32, sums, plan)

        def coop():
            gru_cuda._bigru_bwd_cooperative(lib, *ops, lens32)
    else:
        if name == "K6":
            dy, xp, y, res, w = ops
            lib = _kernels.load("lstm_bwd", rnn_cuda._UNI_BWD_SIGNATURES)
            prefix, gates, carries, outputs = "lstm_bwd", 4, 2, 1
            chain_of, coop_of = (rnn_cuda._lstm_bwd_chain,
                                 rnn_cuda._lstm_bwd_cooperative)
            plan_of = rnn_cuda.k6_plan
        else:
            dy, xp, y, w = ops
            res = y
            lib = _kernels.load("gru_bwd", gru_cuda._BWD_SIGNATURES)
            prefix, gates, carries, outputs = "gru_bwd", 3, 1, 2
            chain_of, coop_of = (gru_cuda._gru_bwd_chain,
                                 gru_cuda._gru_bwd_cooperative)
            plan_of = gru_cuda.k9b_plan
        t, b, g = xp.shape
        h = g // gates
        plan = plan_of(lib, b, h, xp.dtype, dev)
        sfx = rnn_cuda._SUFFIX[xp.dtype]
        pre = torch.empty((t, b, g), dtype=f32, device=dev)
        state = torch.zeros((carries, 1, b, h), dtype=f32, device=dev)
        outs = [torch.empty((t, b, g), dtype=xp.dtype, device=dev)
                for _ in range(outputs)]

        def chain():
            chain_of(lib, *ops, lens32, False, plan)

        def coop():
            coop_of(lib, *ops, lens32, False)

        def phase1():
            _kernels.check(lib, getattr(lib, f"{prefix}_gates_{sfx}")(
                y.data_ptr(), w.data_ptr(), pre.data_ptr(), 0, t, t, b, h,
                plan.gate_cols, 0, stream), f"{name} phase 1")

        def phase2():
            _kernels.check(lib, getattr(lib, f"{prefix}_chain_{sfx}")(
                dy.data_ptr(), xp.data_ptr(), res.data_ptr(), w.data_ptr(),
                lens32.data_ptr(), pre.data_ptr(),
                *(o.data_ptr() for o in outs), state.data_ptr(), 0, t, t, b,
                h, plan.cluster, plan.rows, 0, stream), f"{name} phase 2")
    if plan.route != "cluster":
        fail(f"{name} at T={t}, B={b}, H={h} does not take its cluster "
             f"route: {plan}")
    out = {"plan": plan._asdict(),
           "chain_route_ms": median_ms(chain, 10, torch),
           "cooperative_route_ms": median_ms(coop, 10, torch)}
    if phases:
        out.update(phase1_gates_ms=median_ms(phase1, 10, torch),
                   phase2_chain_ms=median_ms(phase2, 10, torch))
    return out


def gru_inputs(torch, np, dev, t_max, b, h, dtype, seed, dirs=1):
    """Seeded K9a (dirs=1) or K8a (dirs=2) operands: the projection
    [T, B, dirs*3H], ``dirs`` recurrent weights [H, 3H], lengths (row 0
    full, the rest ragged from T/2 up)."""
    rng = np.random.default_rng(seed)
    xp = torch.as_tensor(rng.standard_normal((t_max, b, dirs * 3 * h))
                         .astype(np.float32) * 0.5, device=dev).to(dtype)
    ws = [torch.as_tensor((rng.standard_normal((h, 3 * h)) / np.sqrt(h))
                          .astype(np.float32), device=dev).to(dtype)
          for _ in range(dirs)]
    lens = np.full(b, t_max, np.int32)
    lens[1:] = rng.integers(t_max // 2, t_max + 1, size=b - 1)
    return xp, ws, torch.as_tensor(lens, device=dev)


def nn_gru_err(torch, xp, ws, ys):
    """Max |y - torch.nn.GRU's output| on full-length rows, f32, with
    cuDNN holding the same function: each direction's input weight
    selects its 3H columns of the projection (identity), its recurrent
    weight is w_h^T, its biases are 0 (gate order r, z, n and the
    reset gate on the recurrent term are cuDNN's own GRU)."""
    t, b, g = xp.shape
    g3 = g // len(ws)
    h = g3 // 3
    gru = torch.nn.GRU(g, h, bidirectional=len(ws) == 2).to(xp.device)
    eye = torch.eye(g, device=xp.device)
    with torch.no_grad():
        for d, (w, sfx) in enumerate(zip(ws, ("", "_reverse"))):
            getattr(gru, "weight_ih_l0" + sfx).copy_(eye[d * g3:(d + 1) * g3])
            getattr(gru, "weight_hh_l0" + sfx).copy_(w.float().T)
            getattr(gru, "bias_ih_l0" + sfx).zero_()
            getattr(gru, "bias_hh_l0" + sfx).zero_()
        out, _ = gru(xp.float())
    return float((out - torch.cat([y.float() for y in ys], -1)).abs().max())


def phase_gru_kernels(torch, np, dev, bidirectional):
    """K8a and K8b (``bidirectional``) or K9a and K9b against their plain
    versions: the forward at T=800, B=1 and B=8 (serving; K9a also one
    reverse case) and T=240, B=48 (training; K9a also B=600), the backward
    at T=240, B=48 with ragged lengths, H=320, f32 and bf16; in f32 the
    forward also against cuDNN's nn.GRU holding the same function.  The
    forward rows carry the plan, and at T=800, B=1 and T=240, B=48 both
    routes timed on the same operands; K8a's there also its witnesses:
    its cluster route equals its cooperative kernel bit for bit, and each
    direction equals K9a's cluster route on its half of xp; and at T=240,
    B=48 K8a's instance with the store, which training runs
    (store_witness)."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import gru_cuda
    h, dirs = 320, 2 if bidirectional else 1
    if bidirectional:
        phase, kname, prefix = "k8_bigru", "K8", "bigru"
        fwd, fwd_ref = gru_cuda.bigru_seq_fwd, gru_cuda.bigru_seq_fwd_reference
        bwd, bwd_ref = (gru_cuda.bigru_seq_bwd_dgates,
                        gru_cuda.bigru_seq_bwd_dgates_reference)
        shapes = ((800, 1, False), (800, 8, False), (TRAIN_T, TRAIN_B, False))
    else:
        phase, kname, prefix = "k9_gru", "K9", "gru"
        fwd, fwd_ref = gru_cuda.gru_seq_fwd, gru_cuda.gru_seq_fwd_reference
        bwd, bwd_ref = (gru_cuda.gru_seq_bwd_dgates,
                        gru_cuda.gru_seq_bwd_dgates_reference)
        shapes = ((800, 1, False), (800, 8, False), (800, 1, True),
                  (TRAIN_T, TRAIN_B, False), (TRAIN_T, 600, False))
    lib = _kernels.load("gru_fwd", gru_cuda._FWD_SIGNATURES)
    plan_of = gru_cuda.k8a_plan if bidirectional else gru_cuda.k9a_plan

    def fwd_args(xp, ws, lens, reverse):
        return (xp, *ws, lens) + (() if bidirectional else (reverse,))

    fwd_rows, bwd_rows = [], []
    for dtype_name in DTYPES:
        dtype = getattr(torch, dtype_name)
        for t_max, b, reverse in shapes:
            xp, ws, lens = gru_inputs(torch, np, dev, t_max, b, h, dtype, b,
                                      dirs)
            args = fwd_args(xp, ws, lens, reverse)
            got = fwd(*args)
            ref = fwd_ref(*args)
            got, ref = ((got, ref) if bidirectional else ((got,), (ref,)))
            torch.cuda.synchronize()
            errs = [max_err(g, r, 0.0, K2_TOL[dtype_name])
                    for g, r in zip(got, ref)]
            row = {"kernel": f"{kname}a", "dtype": dtype_name, "T": t_max,
                   "B": b, "H": h, "reverse": reverse,
                   "max_abs_err": max(e for e, _ in errs),
                   "tol": K2_TOL[dtype_name],
                   "ms": median_ms(lambda: fwd(*args), 10, torch),
                   "plain_ms": median_ms(lambda: fwd_ref(*args), 3, torch),
                   **bound(nbytes(xp, *ws, lens, *got), gru_ops(lens, h, dirs),
                           dtype_name), "library_ms": None}
            plan = plan_of(lib, b, h, dtype, dev)
            row["plan"] = plan._asdict()
            if plan.route != "cluster":
                fail(f"{kname}a at T={t_max}, B={b}, H={h} does not take "
                     f"its cluster route: {plan}")
            if b in (1, TRAIN_B) and not reverse:
                # both routes on the same operands, through their exports
                lens32 = lens.to(torch.int32)
                if bidirectional:
                    def chain():
                        return gru_cuda._bigru_fwd_chain(lib, xp, *ws,
                                                         lens32, plan)

                    def coop():
                        return gru_cuda._bigru_fwd_cooperative(lib, xp, *ws,
                                                               lens32)
                else:
                    def chain():
                        return gru_cuda._gru_fwd_chain(lib, xp, ws[0],
                                                       lens32, False, plan)

                    def coop():
                        return gru_cuda._gru_fwd_cooperative(
                            lib, xp, ws[0], lens32, False)
                row["chain_route_ms"] = median_ms(chain, 10, torch)
                row["cooperative_route_ms"] = median_ms(coop, 10, torch)
                if bidirectional:
                    row.update(k8a_witnesses(torch, lib, xp, ws, lens32,
                                             chain(), coop()))
            if b == TRAIN_B:
                # cuDNN's layer includes the input projection (a layer
                # above the first: dirs*H inputs), so the kernel's own
                # projection GEMM stands beside it
                row["library_ms"] = library_rnn_ms(
                    torch, dev, dtype, t_max, b, dirs * h, h,
                    bidirectional=bidirectional, cell="GRU")
                row["projection_plus_kernel_ms"] = projection_plus_kernel_ms(
                    torch, dev, dtype, t_max, b, dirs * h, dirs * 3 * h,
                    lambda p: fwd(*fwd_args(p, ws, lens, False)))
                row["projection_plus_kernel_below_library"] = (
                    row["projection_plus_kernel_ms"] < row["library_ms"])
                if bidirectional:
                    row.update(store_witness(torch, fwd, args, got, ref,
                                             K2_TOL[dtype_name]))
                    errs.append((row["store_max_abs_err"], row["store_ok"]))
                if dtype_name == "float32":
                    full = torch.full_like(lens, t_max)
                    ys = fwd(*fwd_args(xp, ws, full, False))
                    row["max_abs_err_vs_nn_gru_full_rows"] = nn_gru_err(
                        torch, xp, ws, ys if bidirectional else (ys,))
                    errs.append((row["max_abs_err_vs_nn_gru_full_rows"],
                                 row["max_abs_err_vs_nn_gru_full_rows"]
                                 <= NN_GRU_TOL))
            fwd_rows.append(row)
            emit({"phase": phase, **row})
            if not all(ok for _, ok in errs):
                fail(f"{kname}a {prefix}_seq_fwd disagrees: {row}")
            if not (row.get("bit_equal_cooperative", True)
                    and row.get("bit_equal_k9a", True)):
                fail(f"K8a's witnesses do not hold: {row}")

        # the backward at the training shape, on the kernel's forward (K8a
        # keeps its recurrent sums for K8b, as in training)
        xp, ws, lens = gru_inputs(torch, np, dev, TRAIN_T, TRAIN_B, h, dtype,
                                  6, dirs)
        if bidirectional:
            *ys, sums = fwd(*fwd_args(xp, ws, lens, False), store_sums=True)
            kw = {"sums": sums}
        else:
            ys, sums, kw = (fwd(*fwd_args(xp, ws, lens, False)),), None, {}
        rng = np.random.default_rng(7)
        dys = [torch.as_tensor(rng.standard_normal((TRAIN_T, TRAIN_B, h))
                               .astype(np.float32), device=dev).to(dtype)
               for _ in range(dirs)]
        args = ((*dys, xp, *ys, *ws, lens) if bidirectional
                else (dys[0], xp, ys[0], ws[0], lens))
        got = bwd(*args, **kw)
        ref = bwd_ref(*args)
        torch.cuda.synchronize()
        errs = [max_err(g, r, 0.0, K3_TOL[dtype_name])
                for g, r in zip(got, ref)]
        row = {"kernel": f"{kname}b", "dtype": dtype_name, "T": TRAIN_T,
               "B": TRAIN_B, "H": h,
               "max_abs_err": max(e for e, _ in errs),
               "max_abs_ref": max(float(r.float().abs().max()) for r in ref),
               "tol": K3_TOL[dtype_name],
               "ms": median_ms(lambda: bwd(*args, **kw), 10, torch),
               "plain_ms": median_ms(lambda: bwd_ref(*args), 3, torch),
               # the gate recompute and the dh product, per direction
               **bound(nbytes(*args, *got), gru_ops(lens, h, 2 * dirs),
                       dtype_name),
               "library_ms": library_rnn_ms(
                   torch, dev, dtype, TRAIN_T, TRAIN_B, dirs * h, h,
                   bidirectional=bidirectional, backward=True, cell="GRU")}
        row.update(bwd_routes(torch, dev, f"{kname}b", args, sums))
        if bidirectional:
            row.update(k8b_witnesses(torch, dev, args, sums))
        bwd_rows.append(row)
        emit({"phase": phase, **row})
        if not all(ok for _, ok in errs):
            fail(f"{kname}b {prefix}_seq_bwd_dgates disagrees: {row}")
        if not (row.get("first_step_bit_equal_cooperative", True)
                and row.get("bit_equal_k9b", True)):
            fail(f"K8b's witnesses do not hold: {row}")
    # the kernels line reports the training shape in bf16
    train_row = next(r for r in fwd_rows
                     if r["dtype"] == "bfloat16" and r["B"] == TRAIN_B)
    return {f"{prefix}_fwd": kernel_row(fwd_rows, train_row),
            f"{prefix}_bwd": kernel_row(bwd_rows, bwd_rows[1])}


def k8a_witnesses(torch, lib, xp, ws, lens32, chain, coop):
    """K8a's two witnesses on one set of operands: its cluster route's y
    (``chain``) equals its cooperative kernel's (``coop``) bit for bit,
    and each direction equals K9a's cluster route on that direction's
    half of xp (the backward one with reverse)."""
    from kaldi_ctc_tpu_torch.ops import gru_cuda
    b, h = xp.shape[1], xp.shape[2] // 6
    k9a = gru_cuda.k9a_plan(lib, b, h, xp.dtype, xp.device)
    uni = [gru_cuda._gru_fwd_chain(lib, xp[..., d * 3 * h:(d + 1) * 3 * h]
                                   .contiguous(), ws[d], lens32, d == 1, k9a)
           for d in range(2)]
    return {"bit_equal_cooperative": all(torch.equal(c, k)
                                         for c, k in zip(chain, coop)),
            "bit_equal_k9a": all(torch.equal(c, u)
                                 for c, u in zip(chain, uni))}


def k8b_witnesses(torch, dev, args, sums):
    """K8b's two witnesses on one set of operands and K8a's stored
    ``sums``: its cluster route equals its cooperative kernel (which
    recomputes the sums) bit for bit at each row's first valid
    walk step (t = len - 1 forward, t = 0 backward), where dh is zero; and
    each direction of its cluster route equals K9b's cluster route on that
    direction's operands (the backward one with reverse) over the whole
    walk."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import gru_cuda
    *ops, lens = args
    dy_f, dy_b, xp, y_f, y_b, w_f, w_b = ops
    lib = _kernels.load("gru_bwd", gru_cuda._BWD_SIGNATURES)
    b, h = xp.shape[1], xp.shape[2] // 6
    lens32 = lens.to(torch.int32)
    chain = gru_cuda._bigru_bwd_chain(
        lib, *ops, lens32, sums, gru_cuda.k8b_plan(lib, b, h, xp.dtype, dev))
    coop = gru_cuda._bigru_bwd_cooperative(lib, *ops, lens32)
    k9b = gru_cuda.k9b_plan(lib, b, h, xp.dtype, dev)
    uni = (gru_cuda._gru_bwd_chain(lib, dy_f, xp[..., :3 * h].contiguous(),
                                   y_f, w_f, lens32, False, k9b)
           + gru_cuda._gru_bwd_chain(lib, dy_b, xp[..., 3 * h:].contiguous(),
                                     y_b, w_b, lens32, True, k9b))
    rows = torch.arange(b, device=dev)
    valid = lens > 0
    first = (lens.long() - 1).clamp(min=0)
    first_equal = (
        all(torch.equal(c[first, rows][valid], k[first, rows][valid])
            for c, k in zip(chain[:2], coop[:2]))
        and all(torch.equal(c[0][valid], k[0][valid])
                for c, k in zip(chain[2:], coop[2:])))
    return {"first_step_bit_equal_cooperative": first_equal,
            "bit_equal_k9b": all(torch.equal(c, u)
                                 for c, u in zip(chain, uni))}


def phase_k10(torch, np, dev):
    """K10a and K10b at the 3x128 model's layers 2-3 (D=256, H=128)
    against their plain versions: K10a at T=800, B=1 and B=8 (serving)
    and T=240, B=48 (training, its two phases timed apart) and B=600,
    K10b at T=240, B=48 on K10a's outputs, ragged lengths, f32 and bf16.
    Beside each at the training shape:
    cuDNN's nn.LSTM(256, 128, bidirectional), which holds the projection
    too, and the hoisted route on the same inputs (the projection GEMM
    then K2; K3 on the stored projection)."""
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    h, d = PROJ_H, 2 * PROJ_H
    fwd, fwd_ref = (rnn_cuda.bilstm_seq_fwd_proj,
                    rnn_cuda.bilstm_seq_fwd_proj_reference)
    bwd, bwd_ref = (rnn_cuda.bilstm_seq_bwd_dgates_proj,
                    rnn_cuda.bilstm_seq_bwd_dgates_proj_reference)
    fwd_rows, bwd_rows = [], []
    for dtype_name in DTYPES:
        dtype = getattr(torch, dtype_name)
        for t_max, b in ((800, 1), (800, 8), (TRAIN_T, TRAIN_B),
                         (TRAIN_T, 600)):
            rng = np.random.default_rng(100 + b)

            def mat(*shape, scale=1.0):
                return torch.as_tensor((rng.standard_normal(shape) * scale)
                                       .astype(np.float32), device=dev)

            x = mat(t_max, b, d).to(dtype)
            w_x = mat(d, 8 * h, scale=d ** -0.5).to(dtype)
            bias = mat(8 * h, scale=0.2)
            w = [mat(h, 4 * h, scale=h ** -0.5).to(dtype) for _ in range(2)]
            lens = np.full(b, t_max, np.int32)
            lens[1:] = rng.integers(t_max // 2, t_max + 1, size=b - 1)
            lens = torch.as_tensor(lens, device=dev)
            args = (x, w_x, bias, w[0], w[1], lens)
            got = fwd(*args)
            ref = fwd_ref(*args)
            torch.cuda.synchronize()
            errs = [max_err(g, r, 0.0, K2_TOL[dtype_name])
                    for g, r in zip(got, ref)]
            row = {"kernel": "K10a", "dtype": dtype_name, "T": t_max, "B": b,
                   "D": d, "H": h, "max_abs_err": max(e for e, _ in errs),
                   "tol": K2_TOL[dtype_name],
                   "ms": median_ms(lambda: fwd(*args), 10, torch),
                   "plain_ms": median_ms(lambda: fwd_ref(*args), 3, torch),
                   # both directions' projection and recurrent product
                   **bound(nbytes(*args, *got),
                           proj_ops(lens, d, h) + lstm_ops(lens, h, 2),
                           dtype_name), "library_ms": None,
                   "plan": chain_plan(torch, dev, "bilstm_fwd", b, d, h,
                                      dtype, 2)}
            if b == TRAIN_B:
                row["library_ms"] = library_rnn_ms(
                    torch, dev, dtype, t_max, b, d, h, bidirectional=True)
                row["hoisted_route_ms"] = median_ms(
                    lambda: rnn_cuda.bilstm_seq_fwd(
                        rnn_cuda._project_bilstm(x, w_x, bias), w[0], w[1],
                        lens), 10, torch)
                row.update(k10a_phases(torch, dev, args))
                train = (x, w_x, bias, w, lens, got)
            fwd_rows.append(row)
            emit({"phase": "k10_bilstm_proj", **row})
            if not all(ok for _, ok in errs):
                fail(f"K10a bilstm_seq_fwd_proj disagrees with its plain "
                     f"version: {row}")

        # K10b at the training shape, on the B=48 forward's outputs
        x, w_x, bias, w, lens, got = train
        rng = np.random.default_rng(107)
        dy = [torch.as_tensor(rng.standard_normal((TRAIN_T, TRAIN_B, h))
                              .astype(np.float32), device=dev).to(dtype)
              for _ in range(2)]
        bargs = (dy[0], dy[1], x, *got, w_x, bias, w[0], w[1], lens)
        got_b = bwd(*bargs)
        ref_b = bwd_ref(*bargs)
        torch.cuda.synchronize()
        errs = [max_err(g, r, 0.0, K3_TOL[dtype_name])
                for g, r in zip(got_b, ref_b)]
        xp = rnn_cuda._project_bilstm(x, w_x, bias)
        # the hoisted route as training runs it: K3 on K2's stored sums
        *hoisted, hsums = rnn_cuda.bilstm_seq_fwd(xp, w[0], w[1], lens,
                                                  store_sums=True)
        row = {"kernel": "K10b", "dtype": dtype_name, "T": TRAIN_T,
               "B": TRAIN_B, "D": d, "H": h,
               "max_abs_err": max(e for e, _ in errs),
               "max_abs_ref": max(float(r.float().abs().max())
                                  for r in ref_b),
               "tol": K3_TOL[dtype_name],
               "ms": median_ms(lambda: bwd(*bargs), 10, torch),
               "plain_ms": median_ms(lambda: bwd_ref(*bargs), 3, torch),
               # the projection, the gate recompute and the dh product
               **bound(nbytes(*bargs, *got_b),
                       proj_ops(lens, d, h) + lstm_ops(lens, h, 4),
                       dtype_name),
               "library_ms": library_rnn_ms(
                   torch, dev, dtype, TRAIN_T, TRAIN_B, d, h,
                   bidirectional=True, backward=True),
               "hoisted_route_ms": median_ms(
                   lambda: rnn_cuda.bilstm_seq_bwd_dgates(
                       dy[0], dy[1], xp, *hoisted, w[0], w[1], lens, hsums),
                   10, torch)}
        row.update(k10b_phases(torch, dev, bargs))
        bwd_rows.append(row)
        emit({"phase": "k10_bilstm_proj", **row})
        if not all(ok for _, ok in errs):
            fail(f"K10b bilstm_seq_bwd_dgates_proj disagrees with its plain "
                 f"version: {row}")
    bwd_rows.append(k10b_large_batch(torch, np, dev))
    # the kernels line reports the training shape in f32, the only dtype
    # the main path runs them in
    train_row = next(r for r in fwd_rows
                     if r["dtype"] == "float32" and r["B"] == TRAIN_B)
    return {"bilstm_proj_fwd": kernel_row(fwd_rows, train_row),
            "bilstm_proj_bwd": kernel_row(bwd_rows, bwd_rows[0])}


def chain_plan(torch, dev, source, b, d, h, dtype, dirs):
    """The forward chain's launch shape (K10a, or K5 with d 0) as its
    wrapper plans it: ops/rnn_cuda.py::fwd_chain_plan."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    lib = _kernels.load(source, rnn_cuda._SIGNATURES if source == "bilstm_fwd"
                        else rnn_cuda._UNI_SIGNATURES)
    return rnn_cuda.fwd_chain_plan(
        b, d, h, dtype, dirs,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        rnn_cuda._smem_optin(lib, f"{source}_smem_optin", dev))._asdict()


def k10a_phases(torch, dev, args):
    """K10a's two phases timed apart on the same operands (one chunk of
    frames at the training shape): phase 1, every frame's projection, and
    phase 2, both directions' chains in clusters."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    x, w_x, bias, w_f, w_b, lens = args
    t, b, d = x.shape
    h = w_f.shape[0]
    lib = _kernels.load("bilstm_fwd", rnn_cuda._SIGNATURES)
    plan = rnn_cuda.FwdChainPlan(**chain_plan(torch, dev, "bilstm_fwd", b, d,
                                              h, x.dtype, 2))
    sfx = rnn_cuda._SUFFIX[x.dtype]
    stream = _kernels.stream_ptr(dev)
    pre = torch.empty((t, b, 8 * h), dtype=torch.float32, device=dev)
    state = torch.zeros((2, 2, b, h), dtype=torch.float32, device=dev)
    outs = rnn_cuda._fwd_outputs(t, b, h, x.dtype, dev)
    lens32 = lens.to(torch.int32)

    def proj():
        _kernels.check(lib, getattr(lib, "bilstm_proj_x_" + sfx)(
            x.data_ptr(), w_x.data_ptr(), bias.data_ptr(), pre.data_ptr(), 0,
            0, t, t, b, d, h, plan.proj_cols, stream), "K10a phase 1")

    def chain():
        _kernels.check(lib, getattr(lib, "bilstm_fwd_chain_" + sfx)(
            pre.data_ptr(), w_f.data_ptr(), w_b.data_ptr(), lens32.data_ptr(),
            *(v.data_ptr() for v in outs), state.data_ptr(), 0, t, t, b, h,
            plan.cluster, plan.rows, stream), "K10a phase 2")
    return {"phase1_proj_ms": median_ms(proj, 10, torch),
            "phase2_chain_ms": median_ms(chain, 10, torch)}


def k10b_phases(torch, dev, bargs):
    """K10b's plan and its two phases timed apart on the same operands
    (one chunk of steps at the training shape): phase 1, the gate
    pre-activations of every step, and phase 2, the dh/dc chain."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    dy_f, dy_b, x, y_f, c_f, y_b, c_b, w_x, bias, w_f, w_b, lens = bargs
    t, b, d = x.shape
    h = w_f.shape[0]
    lib = _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)
    plan = rnn_cuda.k10b_plan(
        b, d, h, torch.cuda.get_device_properties(dev).multi_processor_count,
        rnn_cuda._smem_optin(lib, "bilstm_bwd_smem_optin", dev))
    f32 = torch.float32
    pre = torch.empty((t, b, 8 * h), dtype=f32, device=dev)
    state = torch.zeros((2, 2, b, h), dtype=f32, device=dev)
    dg = [torch.empty((t, b, 4 * h), dtype=x.dtype, device=dev)
          for _ in range(2)]
    lens32 = lens.to(torch.int32)
    gates_ms = median_ms(lambda: rnn_cuda._k10b_gates(
        lib, x, y_f, y_b, w_x, bias, w_f, w_b, pre, 0, t, plan), 10, torch)
    chain_ms = median_ms(lambda: rnn_cuda._k10b_chain(
        lib, dy_f, dy_b, c_f, c_b, w_f, w_b, lens32, pre, *dg, state, 0, t,
        plan), 10, torch)
    return {"plan": plan._asdict(), "phase1_gates_ms": gates_ms,
            "phase2_chain_ms": chain_ms}


def k10b_large_batch(torch, np, dev):
    """K10b at B=600 (T=240, D=256, H=128, f32, ragged rows) on K10a's
    outputs against its plain version: 14 row groups of clusters, and a
    scratch above 256 MiB, so three chunks of steps with dh and dc
    carried between them."""
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    t, b, h, d = TRAIN_T, 600, PROJ_H, 2 * PROJ_H
    rng = np.random.default_rng(600)

    def mat(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=dev)

    x = mat(t, b, d)
    w_x = mat(d, 8 * h, scale=d ** -0.5)
    bias = mat(8 * h, scale=0.2)
    w = [mat(h, 4 * h, scale=h ** -0.5) for _ in range(2)]
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(t // 2, t + 1, size=b - 1)
    lens = torch.as_tensor(lens, device=dev)
    ys = rnn_cuda.bilstm_seq_fwd_proj(x, w_x, bias, w[0], w[1], lens)
    bargs = (mat(t, b, h), mat(t, b, h), x, *ys, w_x, bias, w[0], w[1],
             lens)
    got = rnn_cuda.bilstm_seq_bwd_dgates_proj(*bargs)
    ref = rnn_cuda.bilstm_seq_bwd_dgates_proj_reference(*bargs)
    torch.cuda.synchronize()
    errs = [max_err(g, r, 0.0, K3_TOL["float32"]) for g, r in zip(got, ref)]
    row = {"kernel": "K10b", "dtype": "float32", "T": t, "B": b, "D": d,
           "H": h, "max_abs_err": max(e for e, _ in errs),
           "tol": K3_TOL["float32"],
           "chunks": -(-t // max(1, rnn_cuda._K10_SCRATCH_BYTES
                                 // (b * 8 * h * 4))),
           "ms": median_ms(lambda: rnn_cuda.bilstm_seq_bwd_dgates_proj(
               *bargs), 3, torch)}
    emit({"phase": "k10_bilstm_proj", **row})
    if not all(ok for _, ok in errs):
        fail(f"K10b at B=600 disagrees with its plain version: {row}")
    return row


def bilstm_bwd_operands(torch, np, dev, t, b, h, mat):
    """K3's operands at T=t, B=b, H=h, f32, ragged rows: seeded cotangents
    and a forward of K2 with the store (``mat`` draws seeded matrices) →
    (operands, the sums K2 stored; None on its cooperative route)."""
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    xp, w, lens = uni_inputs(torch, np, dev, t, b, h, torch.float32, b)
    xp = torch.cat([xp, mat(t, b, 4 * h, scale=0.5)], dim=2)
    w2 = mat(h, 4 * h, scale=h ** -0.5)
    *ys, sums = rnn_cuda.bilstm_seq_fwd(xp, w, w2, lens, store_sums=True)
    return (mat(t, b, h), mat(t, b, h), xp, *ys, w, w2, lens), sums


def phase_f7(torch, np, dev):
    """Each kernel that keeps every batch row in one block's shared
    memory (the cooperative routes of K3, K5, K6, K7 one layer, K8a, K8b,
    K9a and K9b, each at an H whose W_h fits no cluster: K5 and K7:
    K5_COOPERATIVE_H, K8a and K9a: K9A_COOPERATIVE_H, K3, K6, K9b and K8b:
    BWD_COOPERATIVE_H), once at one row above the most its launch takes
    (its source's *_max_rows query), T=20, f32, ragged rows, against its
    plain version: the wrapper runs it as row slices and counts one
    launch.  Then K3, K6, K7 one layer, K8a, K8b and K9b at B=600, H=320
    on their cluster route (no ceiling: one call in waves of clusters)."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import gru_cuda, rnn_cuda
    t, h, f32 = 20, 320, torch.float32
    rng = np.random.default_rng(7)

    def mat(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=dev)

    def above(source, signatures, query, *dims):
        lib = _kernels.load(source, signatures)
        return rnn_cuda.max_rows(lib, query, dev, *dims) + 1

    def case(name):
        """(wrapper, plain version, operands, tolerance, B)"""
        if name == "K3":
            # only K3's cooperative route has a ceiling
            hk = BWD_COOPERATIVE_H["K3"]
            lib = _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)
            b = above("bilstm_bwd", rnn_cuda._BWD_SIGNATURES,
                      "bilstm_bwd_max_rows_f32", hk)
            if rnn_cuda.k3_plan(lib, b, hk, f32, dev).route != "cooperative":
                fail(f"F7: K3 at H={hk} does not take its cooperative "
                     f"route")
            return (rnn_cuda.bilstm_seq_bwd_dgates,
                    rnn_cuda.bilstm_seq_bwd_dgates_reference,
                    bilstm_bwd_operands(torch, np, dev, t, b, hk, mat)[0],
                    K3_TOL["float32"], b)
        if name in ("K5", "K6", "K7"):
            src, sigs, query, dims = {
                "K5": ("lstm_fwd", rnn_cuda._UNI_SIGNATURES,
                       "lstm_fwd_max_rows_f32", (K5_COOPERATIVE_H,)),
                "K6": ("lstm_bwd", rnn_cuda._UNI_BWD_SIGNATURES,
                       "lstm_bwd_max_rows_f32", (BWD_COOPERATIVE_H["K6"],)),
                "K7": ("lstm_stack", rnn_cuda._STACK_SIGNATURES,
                       "lstm_stack_max_rows_f32", (1, K5_COOPERATIVE_H))
            }[name]
            b = above(src, sigs, query, *dims)
            if name == "K5":
                # only K5's cooperative route has a ceiling
                if chain_plan(torch, dev, "lstm_fwd", b, 0, K5_COOPERATIVE_H,
                              f32, 1)["route"] != "cooperative":
                    fail(f"F7: K5 at H={K5_COOPERATIVE_H} does not take its "
                         f"cooperative route")
                xp, w, lens = uni_inputs(torch, np, dev, t, b,
                                         K5_COOPERATIVE_H, f32, b)
                return (rnn_cuda.lstm_seq_fwd, rnn_cuda.lstm_seq_fwd_reference,
                        (xp, w, lens, False), K2_TOL["float32"], b)
            if name == "K7":
                # one layer with carries, the per-layer route, where only
                # the cooperative route keeps its rows in one block
                hk = K5_COOPERATIVE_H
                if rnn_cuda.k7_plan(_kernels.load(src, sigs), 1, b, hk, f32,
                                    dev).route != "cooperative":
                    fail(f"F7: K7 at H={hk} does not take its cooperative "
                         f"route")
                xp, w, lens = uni_inputs(torch, np, dev, t, b, hk, f32, b)
                return (rnn_cuda.lstm_stack_fwd,
                        rnn_cuda.lstm_stack_fwd_reference,
                        (xp, [], [w], [], lens, mat(1, b, hk, scale=0.5),
                         mat(1, b, hk, scale=0.5)), K2_TOL["float32"], b)
            # only K6's cooperative route has a ceiling
            hk = BWD_COOPERATIVE_H["K6"]
            if rnn_cuda.k6_plan(_kernels.load(src, sigs), b, hk, f32,
                                dev).route != "cooperative":
                fail(f"F7: K6 at H={hk} does not take its cooperative "
                     f"route")
            xp, w, lens = uni_inputs(torch, np, dev, t, b, hk, f32, b)
            y, c = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens)
            return (rnn_cuda.lstm_seq_bwd_dgates,
                    rnn_cuda.lstm_seq_bwd_dgates_reference,
                    (mat(t, b, hk), xp, y, c, w, lens), K3_TOL["float32"], b)
        dirs = 2 if name.startswith("K8") else 1
        kernel = "bigru" if dirs == 2 else "gru"
        fwd = name.endswith("a")
        src, sigs = (("gru_fwd", gru_cuda._FWD_SIGNATURES) if fwd
                     else ("gru_bwd", gru_cuda._BWD_SIGNATURES))
        hg = {"K8a": K8A_COOPERATIVE_H, "K9a": K9A_COOPERATIVE_H,
              "K8b": BWD_COOPERATIVE_H["K9b"],
              "K9b": BWD_COOPERATIVE_H["K9b"]}[name]
        b = above(src, sigs, f"{kernel}_{src[4:]}_max_rows_f32", hg)
        # only their cooperative routes have a ceiling
        lib = _kernels.load(src, sigs)
        plan_of = {"K8a": gru_cuda.k8a_plan, "K9a": gru_cuda.k9a_plan,
                   "K8b": gru_cuda.k8b_plan, "K9b": gru_cuda.k9b_plan}[name]
        if plan_of(lib, b, hg, f32, dev).route != "cooperative":
            fail(f"F7: {name} at H={hg} does not take its cooperative "
                 f"route")
        xp, ws, lens = gru_inputs(torch, np, dev, t, b, hg, f32, b, dirs)
        fn = getattr(gru_cuda, kernel + ("_seq_fwd" if fwd
                                         else "_seq_bwd_dgates"))
        ref = getattr(gru_cuda, fn.__name__ + "_reference")
        if fwd:
            args = (xp, *ws, lens) if dirs == 2 else (xp, ws[0], lens, False)
            return fn, ref, args, K2_TOL["float32"], b
        ys = (gru_cuda.bigru_seq_fwd_reference(xp, *ws, lens) if dirs == 2
              else (gru_cuda.gru_seq_fwd_reference(xp, ws[0], lens),))
        dys = [mat(t, b, hg) for _ in range(dirs)]
        args = (*dys, xp, *ys, *ws, lens)
        return fn, ref, args, K3_TOL["float32"], b

    def cluster_case(name):
        """K3, K6, K7 (one layer), K8a, K8b or K9b on its cluster route at
        B=600, H=320: (wrapper, plain version, operands, the wrapper's
        keywords (K3's and K8b's: the sums their forward stored),
        tolerance, plan)"""
        b = 600
        if name == "K3":
            lib = _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)
            args, sums = bilstm_bwd_operands(torch, np, dev, t, b, h, mat)
            return (rnn_cuda.bilstm_seq_bwd_dgates,
                    rnn_cuda.bilstm_seq_bwd_dgates_reference, args,
                    {"sums": sums}, K3_TOL["float32"],
                    rnn_cuda.k3_plan(lib, b, h, f32, dev))
        if name == "K6":
            lib = _kernels.load("lstm_bwd", rnn_cuda._UNI_BWD_SIGNATURES)
            plan = rnn_cuda.k6_plan(lib, b, h, f32, dev)
            xp, w, lens = uni_inputs(torch, np, dev, t, b, h, f32, b)
            y, c = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens)
            return (rnn_cuda.lstm_seq_bwd_dgates,
                    rnn_cuda.lstm_seq_bwd_dgates_reference,
                    (mat(t, b, h), xp, y, c, w, lens), {}, K3_TOL["float32"],
                    plan)
        if name == "K7":
            lib = _kernels.load("lstm_stack", rnn_cuda._STACK_SIGNATURES)
            xp, w, lens = uni_inputs(torch, np, dev, t, b, h, f32, b)
            return (rnn_cuda.lstm_stack_fwd,
                    rnn_cuda.lstm_stack_fwd_reference,
                    (xp, [], [w], [], lens, mat(1, b, h, scale=0.5),
                     mat(1, b, h, scale=0.5)), {}, K2_TOL["float32"],
                    rnn_cuda.k7_plan(lib, 1, b, h, f32, dev))
        if name == "K8a":
            lib = _kernels.load("gru_fwd", gru_cuda._FWD_SIGNATURES)
            xp, ws, lens = gru_inputs(torch, np, dev, t, b, h, f32, b, 2)
            return (gru_cuda.bigru_seq_fwd, gru_cuda.bigru_seq_fwd_reference,
                    (xp, *ws, lens), {}, K2_TOL["float32"],
                    gru_cuda.k8a_plan(lib, b, h, f32, dev))
        if name == "K8b":
            lib = _kernels.load("gru_bwd", gru_cuda._BWD_SIGNATURES)
            xp, ws, lens = gru_inputs(torch, np, dev, t, b, h, f32, b, 2)
            *ys, sums = gru_cuda.bigru_seq_fwd(xp, *ws, lens,
                                               store_sums=True)
            return (gru_cuda.bigru_seq_bwd_dgates,
                    gru_cuda.bigru_seq_bwd_dgates_reference,
                    (mat(t, b, h), mat(t, b, h), xp, *ys, *ws, lens),
                    {"sums": sums}, K3_TOL["float32"],
                    gru_cuda.k8b_plan(lib, b, h, f32, dev))
        lib = _kernels.load("gru_bwd", gru_cuda._BWD_SIGNATURES)
        plan = gru_cuda.k9b_plan(lib, b, h, f32, dev)
        xp, ws, lens = gru_inputs(torch, np, dev, t, b, h, f32, b)
        y = gru_cuda.gru_seq_fwd_reference(xp, ws[0], lens)
        return (gru_cuda.gru_seq_bwd_dgates,
                gru_cuda.gru_seq_bwd_dgates_reference,
                (mat(t, b, h), xp, y, ws[0], lens), {}, K3_TOL["float32"],
                plan)

    rows = []
    for name in ("K3", "K5", "K6", "K7", "K8a", "K8b", "K9a", "K9b"):
        fn, ref, args, tol, b = case(name)
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        launched = fn.launches - before
        want = ref(*args)
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        errs = [max_err(g, r, 0.0, tol) for g, r in zip(got, want)]
        row = {"kernel": name, "wrapper": fn.__name__, "T": t,
               "H": {"K5": K5_COOPERATIVE_H, "K7": K5_COOPERATIVE_H,
                     "K8a": K8A_COOPERATIVE_H, "K8b": BWD_COOPERATIVE_H["K9b"],
                     "K9a": K9A_COOPERATIVE_H, **BWD_COOPERATIVE_H}[name],
               "B": b, "one_launch_max_rows": b - 1, "launches": launched,
               "max_abs_err": max(e for e, _ in errs), "tol": tol}
        rows.append(row)
        if not all(ok for _, ok in errs) or launched != 1:
            emit({"phase": "f7", "rows": rows})
            fail(f"F7: {name} above its ceiling disagrees: {row}")
    # K3, K6, K7 (one layer), K8a, K8b and K9b at H=320 take their cluster
    # route, which has no ceiling: B=600 in one call, waves of clusters,
    # no row slices
    for name in ("K3", "K6", "K7", "K8a", "K8b", "K9b"):
        fn, ref, args, kw, tol, plan = cluster_case(name)
        before = fn.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        launched = fn.launches - before
        got = got if isinstance(got, tuple) else (got,)
        want = ref(*args)
        want = want if isinstance(want, tuple) else (want,)
        errs = [max_err(g, r, 0.0, tol) for g, r in zip(got, want)]
        row = {"kernel": name, "wrapper": fn.__name__, "route": plan.route,
               "T": t, "H": h, "B": 600, "plan": plan._asdict(),
               "launches": launched, "max_abs_err": max(e for e, _ in errs),
               "tol": tol}
        rows.append(row)
        if (plan.route != "cluster" or not all(ok for _, ok in errs)
                or launched != 1):
            emit({"phase": "f7", "rows": rows})
            fail(f"F7: {name} at B=600 on its cluster route disagrees: "
                 f"{row}")
    emit({"phase": "f7", "rows": rows})


def uni_model(torch, dtype, dev, mode=None):
    """The unidirectional 5x320 streaming flagship (bench.py's
    ``dataclasses.replace(_flagship_cfg(), bidirectional=False)``), an
    LSTM or ``mode``'s cell, random weights from seed 0."""
    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=320,
                   num_layers=5, mode=mode or RnnMode.LSTM,
                   bidirectional=False, compute_dtype=dtype)
    return cfg, init_am_params(cfg, torch.Generator().manual_seed(0), dev)


def k7_routes(torch, dev, args):
    """K7's plan at ``args`` (the streaming shape), its two routes timed
    on the same operands (the wavefront of per-layer clusters, in row
    slices where its ceiling is below B; the cooperative kernel), and the
    witness: both routes give y, h_fin and c_fin bit for bit, at B and at
    B=1 (the first slot alone); the co-residency guarantee the cluster
    route's launches held (1: cooperative launch, 2: checked count) and
    the clusters of its shape the card holds at once.  Each route is timed
    as one call (median_ms: the host's time before its first launch
    included) and as 50 calls back to back (the card's time a call)."""
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    lib = _kernels.load("lstm_stack", rnn_cuda._STACK_SIGNATURES)
    xp0, wxs, whs, bs, lens, h0, c0 = args
    n_layers, b, h = len(whs), xp0.shape[1], xp0.shape[2] // 4
    plan = rnn_cuda.k7_plan(lib, n_layers, b, h, xp0.dtype, dev)
    if not plan.cluster:
        fail(f"K7 at L={n_layers}, B={b}, H={h} has no cluster route: "
             f"{plan}")
    one = (xp0[:, :1].contiguous(), wxs, whs, bs, lens[:1],
           h0[:, :1].contiguous(), c0[:, :1].contiguous())
    equal = {}
    for name, (x, *_, ln, hh, cc) in (("B", args), ("B1", one)):
        p = rnn_cuda.k7_plan(lib, n_layers, x.shape[1], h, x.dtype, dev)
        ops = (x, wxs, whs, bs, ln.to(torch.int32), hh, cc)
        chain = rnn_cuda._lstm_stack_chain(lib, *ops, p)
        coop = rnn_cuda._lstm_stack_cooperative(lib, *ops)
        equal[name] = all(torch.equal(g, k) for g, k in zip(chain, coop))
    ops = (xp0, wxs, whs, bs, lens.to(torch.int32), h0, c0)
    sfx = rnn_cuda._SUFFIX[xp0.dtype]

    def chain():
        rnn_cuda._lstm_stack_chain(lib, *ops, plan)

    def coop():
        rnn_cuda._lstm_stack_cooperative(lib, *ops)

    return {"plan": plan._asdict(),
            "chain_route_ms": median_ms(chain, 20, torch),
            "cooperative_route_ms": median_ms(coop, 20, torch),
            "chain_route_back_to_back_ms": back_to_back_ms(chain, 50, torch),
            "cooperative_route_back_to_back_ms": back_to_back_ms(coop, 50,
                                                                 torch),
            "bit_equal_cooperative": equal,
            "residency": lib.lstm_stack_chain_residency(),
            "co_resident_clusters": getattr(
                lib, "lstm_stack_chain_clusters_" + sfx)(
                    n_layers, h, plan.cluster, plan.rows)}


def phase_k7(torch, np, dev):
    """K7 at the streaming shapes against its plain version, with its
    plan, both routes timed and held equal bit for bit (k7_routes), then
    an 8 s utterance streamed through it against K5's offline forward."""
    from kaldi_ctc_tpu_torch.features import MfccOptions, compute_mfcc
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    from kaldi_ctc_tpu_torch.ops.rnn import (init_stream_state, rnn_forward,
                                             rnn_forward_stream)
    n_layers, h, t_max, b = 5, 320, CHUNK_FRAMES, STREAMS
    rows = []
    feats = compute_mfcc(torch.as_tensor(pcm(8.0, 21, np).astype(np.float32),
                                         device=dev), MfccOptions.hires())
    for dtype_name in DTYPES:
        dtype = getattr(torch, dtype_name)
        rng = np.random.default_rng(8)

        def mat(*shape, scale=1.0):
            return torch.as_tensor((rng.standard_normal(shape) * scale)
                                   .astype(np.float32), device=dev)

        whs = [mat(h, 4 * h, scale=h ** -0.5).to(dtype)
               for _ in range(n_layers)]
        wxs = [mat(h, 4 * h, scale=h ** -0.5).to(dtype)
               for _ in range(n_layers - 1)]
        bs = [mat(4 * h, scale=0.2) for _ in range(n_layers - 1)]
        # the carries of a previous full chunk, then a chunk with short,
        # nearly empty and idle slots
        full = torch.full((b,), t_max, dtype=torch.int32, device=dev)
        _, h0, c0 = rnn_cuda.lstm_stack_fwd(
            mat(t_max, b, 4 * h, scale=0.5).to(dtype), wxs, whs, bs, full)
        lens = torch.tensor([20, 20, 13, 0, 20, 7, 20, 1][:b],
                            dtype=torch.int32, device=dev)
        args = (mat(t_max, b, 4 * h, scale=0.5).to(dtype), wxs, whs, bs,
                lens, h0, c0)
        got = rnn_cuda.lstm_stack_fwd(*args)
        ref = rnn_cuda.lstm_stack_fwd_reference(*args)
        torch.cuda.synchronize()
        errs = [max_err(g, r, 0.0, K2_TOL[dtype_name])
                for g, r in zip(got, ref)]
        idle_kept = bool(torch.equal(got[1][:, 3], h0[:, 3])
                         and torch.equal(got[2][:, 3], c0[:, 3]))

        # 8 s of MFCC-hires features in 20-frame chunks through K7 (B=1)
        # against K5's offline per-layer forward of the same features
        cfg, params = uni_model(torch, dtype_name, dev)
        x = feats[:, None, :]
        with torch.inference_mode():
            offline = rnn_forward(params["rnn"], x, cfg.rnn)
            states = init_stream_state(cfg.rnn, 1, dev)
            k7_before = rnn_cuda.lstm_stack_fwd.launches
            chunks = []
            for lo in range(0, x.shape[0], t_max):
                y, states = rnn_forward_stream(params["rnn"],
                                               x[lo:lo + t_max], cfg.rnn,
                                               states)
                chunks.append(y)
            streamed = torch.cat(chunks)
        n_chunks = rnn_cuda.lstm_stack_fwd.launches - k7_before
        stream_err, stream_ok = max_err(streamed, offline, 0.0,
                                        K2_TOL[dtype_name])
        row = {"dtype": dtype_name, "L": n_layers, "T": t_max, "B": b,
               "H": h, "lens": lens.tolist(),
               "max_abs_err": max(e for e, _ in errs),
               "tol": K2_TOL[dtype_name], "idle_slot_state_kept": idle_kept,
               "ms": median_ms(lambda: rnn_cuda.lstm_stack_fwd(*args), 20,
                               torch),
               "plain_ms": median_ms(
                   lambda: rnn_cuda.lstm_stack_fwd_reference(*args), 3,
                   torch),
               # layer 0's recurrent product, and both products of the
               # layers above, per valid frame
               **bound(nbytes(args[0], *wxs, *whs, *bs, lens, h0, c0, *got),
                       lstm_ops(lens, h, 2 * n_layers - 1), dtype_name),
               "library_ms": library_rnn_ms(torch, dev, dtype, t_max, b, 40,
                                            h, num_layers=n_layers,
                                            state=True),
               "utterance_frames": int(x.shape[0]),
               "utterance_chunks": n_chunks,
               "max_abs_err_stream_vs_offline_k5": stream_err,
               **k7_routes(torch, dev, args)}
        rows.append(row)
        emit({"phase": "k7_lstm_stack", **row})
        if not (all(ok for _, ok in errs) and idle_kept and stream_ok
                and n_chunks == -(-x.shape[0] // t_max)
                and all(row["bit_equal_cooperative"].values())
                and row["residency"] in (1, 2)):
            fail(f"K7 lstm_stack_fwd disagrees: {row}")
    return kernel_row(rows, rows[1])     # bf16


def post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = json.loads(resp.read().decode())
    conn.close()
    return resp.status, data, time.perf_counter() - t0


def serve_launches(gru, proj, dtype):
    """The launches one /recognize request must add, by kernel: the
    flagship's K2 (K8a) once per layer and no K10a; the 3x128 BLSTM's
    layer 1 on K2 and, in f32 only, layers 2-3 on K10a (the JAX package's
    ``_use_in_kernel_proj``)."""
    if gru:
        return {"bigru_fwd": 5}
    if proj:
        k10 = PROJ_LAYERS - 1 if dtype == "float32" else 0
        return {"bilstm_fwd": PROJ_LAYERS - k10, "bilstm_proj_fwd": k10}
    return {"bilstm_fwd": 5, "bilstm_proj_fwd": 0}


def phase_serve(torch, np, mode=None, proj=False, ds2=False):
    """The bidirectional 5x320 flagship, a BLSTM or ``mode``'s cell, with
    ``proj`` the 3x128 BLSTM, or with ``ds2`` the flagship behind bench.py's
    DS2 conv front, served per dtype through /recognize (launches per
    request: ``serve_launches``)."""
    from kaldi_ctc_tpu_torch.cli import serve
    from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig,
                                                     default_priors,
                                                     init_am_params)
    from kaldi_ctc_tpu_torch.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode

    mode = mode or RnnMode.LSTM
    gru = mode == RnnMode.GRU
    tag = "bigru" if gru else ("proj" if proj else
                               "ds2" if ds2 else "flagship")
    hidden, layers, targets = ((PROJ_H, PROJ_LAYERS, PROJ_TARGETS) if proj
                               else (320, 5, 72))

    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    seconds = (2.0, 4.0, 6.0, 8.0)
    audio = [pcm(s, 10 + i, np) for i, s in enumerate(seconds)]
    launches = collections.Counter()
    engines = {}
    for dtype in ("float32", "bfloat16"):
        cfg = AmConfig(input_dim=40, num_targets=targets, hidden_dim=hidden,
                       num_layers=layers, mode=mode, bidirectional=True,
                       compute_dtype=dtype, **(DS2_CONV if ds2 else {}))
        params = init_am_params(cfg, torch.Generator().manual_seed(0))
        want = serve_launches(gru, proj, dtype)
        path = os.path.join(out_dir, f"{tag}_{dtype}.npz")
        save_inference_artifact(path, params, cfg,
                                priors=default_priors(cfg.num_targets))
        server, engine = serve.make_server(serve.parse_args(
            ["--model", path, "--device", "cuda", "--port", "0"]))
        engines[dtype] = engine
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            # warm-up: first cuBLAS / allocator use, not timed
            status, _, _ = post(port, "/recognize", pcm(1.0, 9, np).tobytes())
            if status != 200:
                fail(f"serve warm-up answered {status}")
            reqs = []
            # counts from the served requests only
            reset_counts()
            for secs, x in zip(seconds, audio):
                before = read_counts()
                status, data, wall = post(port, "/recognize", x.tobytes())
                after = read_counts()
                got = {k: after[k] - before[k] for k in want}
                k4 = after["log_mel"] - before["log_mel"]
                frames = 1 + (len(x) - 400) // 160
                reqs.append({"seconds": secs, "status": status,
                             "num_frames": data.get("num_frames"),
                             "num_labels": len(data.get("labels", [])),
                             "latency_ms": round(wall * 1000, 3),
                             "rtf": data.get("rtf"), "launches": got,
                             "k4_launches": k4})
                if status != 200 or data.get("num_frames") != frames:
                    fail(f"/recognize {secs}s: {status} {data}")
                labels = data["labels"]
                if not all(isinstance(l, int) and 0 < l < targets
                           for l in labels):
                    fail(f"/recognize {secs}s: bad labels {labels[:10]}")
                if got != want or k4 < 1:
                    fail(f"/recognize {secs}s ({tag}, {dtype}) launched "
                         f"{got} (want {want}) and K4 {k4}x (want >= 1)")
            for name, n in read_counts().items():
                launches[name] += n
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        # the same engine on the plain versions, on the card
        score_err, same_labels = 0.0, 0
        for x in audio:
            xf = x.astype(np.float32)
            feats = engine.feats_for(xf)
            _, _, raw = engine.score_utt(feats)
            with plain_versions():
                feats_p = engine.feats_for(xf)
                _, _, raw_p = engine.score_utt(feats_p)
            if not np.isfinite(raw).all() or raw.shape != (
                    cfg.output_lens(feats.shape[0]), targets):
                fail(f"scores not finite or misshapen: {raw.shape}")
            score_err = max(score_err, float(np.abs(raw - raw_p).max()))
            same_labels += int((raw.argmax(-1) == raw_p.argmax(-1)).all())
        res = {"phase": ("serve_gru" if gru else "serve_proj" if proj
                         else "serve_ds2" if ds2 else "serve"),
               "dtype": dtype,
               "model": "%s%dx%d %s, 40-dim MFCC-hires, %d targets"
                        % ("DS2 conv front (2 layers, 32 channels, time "
                           "stride 2) + " if ds2 else "", layers, hidden,
                           "BiGRU" if gru else "BLSTM", targets),
               "requests": reqs, "max_abs_score_err_vs_plain": score_err,
               "score_tol": SCORE_TOL[dtype],
               "utterances_with_equal_frame_argmax": same_labels}
        emit(res)
        if score_err > SCORE_TOL[dtype]:
            fail(f"served scores disagree with the plain versions: {res}")
    return launches, engines


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = json.loads(resp.read().decode())
    conn.close()
    return resp.status, data


def run_stream(port, audio, barrier, chunk_samples):
    """One client streaming ``audio`` through /stream/start|chunk|end →
    (the end's response, chunk latencies in ms, error or None)."""
    barrier.wait()
    status, start, _ = post(port, "/stream/start", b"")
    if status != 200:
        return None, [], f"/stream/start answered {status}"
    slot, walls = start["slot"], []
    for lo in range(0, len(audio), chunk_samples):
        status, _, wall = post(port, f"/stream/{slot}/chunk",
                               audio[lo:lo + chunk_samples].tobytes())
        if status != 200:
            return None, walls, f"chunk answered {status}"
        walls.append(wall * 1000)
    status, end, _ = post(port, f"/stream/{slot}/end", b"")
    if status != 200:
        return None, walls, f"end answered {status}"
    return end, walls, None


def stream_scores(torch, np, rec, feats, lens_of):
    """Per-stream scores of ``feats`` (one [n_i, D] tensor per slot)
    ticked through the recognizer's chunk function, all slots per tick,
    from zero state → list of [n_i, A] tensors."""
    from kaldi_ctc_tpu_torch.ops.rnn import init_stream_state
    dev = rec.chunk_fn.device
    n = [int(f.shape[0]) for f in feats]
    states = init_stream_state(rec._cfg.rnn, len(feats), dev)
    out = [[] for _ in feats]
    for lo in range(0, max(n), CHUNK_FRAMES):
        block = torch.zeros((CHUNK_FRAMES, len(feats), feats[0].shape[1]),
                            device=dev)
        lens = [lens_of(k, lo) for k in n]
        for i, f in enumerate(feats):
            block[:lens[i], i] = f[lo:lo + lens[i]]
        scores, states = rec.chunk_fn(
            block, torch.tensor(lens, dtype=torch.int32, device=dev), states)
        for i in range(len(feats)):
            out[i].append(scores[:lens[i], i])
    return [torch.cat(o) for o in out]


def phase_serve_uni(torch, np, mode=None):
    """The unidirectional 5x320 served per dtype: /recognize through K5
    (a GRU's through K9a), 8 concurrent streams through K7 (a GRU stack:
    the per-layer loop in torch ops, no kernel), and the chunk function's
    scores against the plain versions and the offline forward."""
    from kaldi_ctc_tpu_torch.cli import serve
    from kaldi_ctc_tpu_torch.features import stft_cuda
    from kaldi_ctc_tpu_torch.models.acoustic import am_forward, default_priors
    from kaldi_ctc_tpu_torch.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode

    gru = mode == RnnMode.GRU
    kname, tag = ("gru_fwd", "gru_uni") if gru else ("lstm_fwd", "uni")
    kern = wrappers()[kname]

    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    seconds = (2.0, 4.0, 6.0, 8.0)
    audio = [pcm(s, 30 + i, np) for i, s in enumerate(seconds)]
    streams = [pcm(2.0 + 2.0 * i / (STREAMS - 1), 40 + i, np)
               for i in range(STREAMS)]
    chunk_samples = 3200                      # 0.2 s at 16 kHz
    launches = collections.Counter()
    engines = {}
    for dtype in DTYPES:
        cfg, params = uni_model(torch, dtype, "cpu", mode)
        priors = default_priors(cfg.num_targets)
        path = os.path.join(out_dir, f"{tag}_{dtype}.npz")
        save_inference_artifact(path, params, cfg, priors=priors)
        server, engine = serve.make_server(serve.parse_args(
            ["--model", path, "--device", "cuda", "--port", "0",
             "--max-streams", str(STREAMS), "--chunk-frames",
             str(CHUNK_FRAMES)]))
        engines[dtype] = engine
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            # warm-up, not timed: cuBLAS, the allocator, a stream tick
            status, _, _ = post(port, "/recognize", pcm(1.0, 9, np).tobytes())
            _, _, err = run_stream(port, pcm(0.5, 8, np),
                                   threading.Barrier(1), chunk_samples)
            if status != 200 or err:
                fail(f"serve_uni warm-up: {status} {err}")
            health = get(port, "/healthz")
            if health != (200, {"ok": True, "streaming": True}):
                fail(f"serve_uni /healthz: {health}")
            # the main path: counts from the served requests and streams
            reset_counts()
            reqs = []
            for secs, x in zip(seconds, audio):
                k5_0 = kern.launches
                k4_0 = stft_cuda.log_mel.launches
                status, data, wall = post(port, "/recognize", x.tobytes())
                k5 = kern.launches - k5_0
                k4 = stft_cuda.log_mel.launches - k4_0
                reqs.append({"seconds": secs, "status": status,
                             "num_frames": data.get("num_frames"),
                             "num_labels": len(data.get("labels", [])),
                             "latency_ms": round(wall * 1000, 3),
                             "rtf": data.get("rtf"),
                             f"{kname}_launches": k5, "k4_launches": k4})
                if status != 200 or data.get("num_frames") != \
                        1 + (len(x) - 400) // 160:
                    fail(f"serve_uni /recognize {secs}s: {status} {data}")
                if k5 != cfg.num_layers or k4 < 1:
                    fail(f"serve_uni /recognize {secs}s launched {kname} "
                         f"{k5}x (want {cfg.num_layers}) and K4 {k4}x (want "
                         f">= 1)")
            ticks0 = engine.stream.ticks
            k7_0 = rnn_cuda.lstm_stack_fwd.launches
            barrier = threading.Barrier(STREAMS)
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(STREAMS) as pool:
                results = list(pool.map(
                    lambda a: run_stream(port, a, barrier, chunk_samples),
                    streams))
            stream_wall = time.perf_counter() - t0
            ticks = engine.stream.ticks - ticks0
            k7 = rnn_cuda.lstm_stack_fwd.launches - k7_0
            for name, n in read_counts().items():
                launches[name] += n
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        errors = [e for _, _, e in results if e]
        if errors or k7 != (0 if gru else ticks) or ticks == 0:
            fail(f"serve_uni streams: errors {errors}, K7 {k7} launches "
                 f"for {ticks} ticks")
        walls = sorted(w for _, ws, _ in results for w in ws)
        same_labels = sum(
            int(end["labels"] == engine.recognize(
                a.astype(np.float32))["labels"])
            for (end, _, _), a in zip(results, streams))

        if gru and same_labels != STREAMS:
            fail(f"serve_uni GRU: {same_labels} of {STREAMS} streams' "
                 f"labels equal their /recognize labels")
        # the chunk function's scores: kernels, plain versions on the
        # card, and the offline K5 (K9a) forward of the whole utterance
        feats = [engine.feats_for(a.astype(np.float32)) for a in streams]
        lens_of = lambda n, lo: max(0, min(CHUNK_FRAMES, n - lo))
        got = stream_scores(torch, np, engine.stream, feats, lens_of)
        with plain_versions():
            plain = stream_scores(torch, np, engine.stream, feats, lens_of)
        log_priors = torch.log(torch.as_tensor(priors, device=engine.device))
        err_plain = err_offline = 0.0
        with torch.inference_mode():
            for f, g, p_ in zip(feats, got, plain):
                logits = am_forward(engine.params, f[None], cfg)[0]
                offline = (torch.log_softmax(logits, -1) - log_priors)
                if not bool(torch.isfinite(g).all()) or g.shape != \
                        offline.shape:
                    fail(f"serve_uni scores not finite or misshapen: "
                         f"{tuple(g.shape)}")
                err_plain = max(err_plain, float((g - p_).abs().max()))
                err_offline = max(err_offline,
                                  float((g - offline).abs().max()))
        res = {"phase": "serve_gru_uni" if gru else "serve_uni",
               "dtype": dtype,
               "model": "5x320 %s (unidirectional), 40-dim MFCC-hires, 72 "
                        "targets" % ("GRU" if gru else "LSTM"),
               "requests": reqs, "streams": STREAMS,
               "stream_seconds": [round(len(a) / 16000, 3)
                                  for a in streams],
               "chunk_seconds": chunk_samples / 16000,
               "chunk_frames": CHUNK_FRAMES, "ticks": ticks,
               "k7_launches": k7, "chunk_requests": len(walls),
               "chunk_latency_ms_median": walls[len(walls) // 2],
               "chunk_latency_ms_p90": walls[int(0.9 * (len(walls) - 1))],
               "streams_wall_s": round(stream_wall, 3),
               "streams_equal_to_recognize_labels": same_labels,
               "max_abs_score_err_vs_plain": err_plain,
               "max_abs_score_err_vs_offline": err_offline,
               "score_tol": SCORE_TOL[dtype]}
        emit(res)
        if max(err_plain, err_offline) > SCORE_TOL[dtype]:
            fail(f"streamed scores disagree: {res}")
    return launches, engines


def phase_profile_stream(torch, np, engines, gru=False):
    """Where one 8-slot tick's time goes: device time by kernel from
    torch.profiler against the tick's wall time; K7's share for an LSTM
    stack (a GRU stack launches none of the port's kernels)."""
    from torch.profiler import DeviceType

    rng = np.random.default_rng(50)
    chunks = rng.standard_normal((STREAMS, CHUNK_FRAMES, 40)).astype(
        np.float32)
    valid = np.full(STREAMS, CHUNK_FRAMES)
    for dtype, engine in engines.items():
        rec = engine.stream
        for _ in range(3):
            rec.process(chunks, valid)
        walls = []
        for _ in range(11):
            t0 = time.perf_counter()
            rec.process(chunks, valid)
            walls.append((time.perf_counter() - t0) * 1000)
        walls.sort()
        prof, traced_ms = profiled(torch, lambda: rec.process(chunks, valid))
        kernels = device_kernels(prof, DeviceType)
        device_ms = sum(k[0] for k in kernels) / 1000
        k7_ms = sum(k[0] for k in kernels
                    if any(tag in k[2] for tag in kernel_tags("lstm_stack"))
                    ) / 1000
        emit({"phase": "profile_stream_gru" if gru else "profile_stream",
              "dtype": dtype, "slots": STREAMS,
              "chunk_frames": CHUNK_FRAMES,
              "untraced_tick_ms_median_of_11": round(walls[5], 3),
              "traced_tick_ms": round(traced_ms, 3),
              "device_kernel_ms": (round(device_ms, 3) if device_ms
                                   else "not measured"),
              "k7_ms": round(k7_ms, 4),
              "k7_share_of_device": (round(k7_ms / device_ms, 4)
                                     if device_ms else None),
              "device_idle_share_of_traced_wall":
                  (round(1 - device_ms / traced_ms, 4) if device_ms
                   else "not measured"),
              "top_kernels": [{"name": k[2][:80], "us": round(k[0], 1),
                               "count": k[1]} for k in kernels[:8]]})


# a traced window: its warm-up (at least this long) and the marker kernel
# that starts the measured run on the device's own clock (torch.cuda._sleep
# launches spin_kernel)
WARMUP_S = 0.05
MARK = "spin_kernel"


def profiled(torch, fn):
    """``fn()`` under torch.profiler after a warm-up of ``fn()`` runs
    (``WARMUP_S`` or more) and a marker kernel → (the profiler, the wall
    ms of the measured run, which ends in a synchronize).  A trace lacked
    the device records of its first milliseconds (the f32 3x128 step's
    K2, a uni GRU step's first K9a: absent from kineto's own records), so
    a window must not start with the work it measures; and the measured
    kernels are found by the device's clock (after the marker), not the
    host's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while True:
            fn()
            torch.cuda.synchronize()
            if time.perf_counter() - t0 >= WARMUP_S:
                break
        torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1000
    return prof, traced_ms


def device_kernels(prof, DeviceType):
    """[(device us, count, name)] of the CUDA kernels of the measured run
    of ``profiled`` (after its marker), by device time, largest first;
    none when the trace lost the marker."""
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.start for e in events if MARK in e.name]
    if not marks:
        return []
    sums = {}
    for e in events:
        if e.time_range.start > max(marks) and MARK not in e.name:
            us, count = sums.get(e.name, (0.0, 0))
            sums[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return sorted(((us, count, name) for name, (us, count) in sums.items()
                   if us > 0), reverse=True)


# the device kernels of a wrapper as a trace names them: one each, but
# K10a's two phases (bilstm_proj_x_tiled_kernel or bilstm_proj_x_kernel,
# then bilstm_fwd_chain_kernel), K10b's (bilstm_proj_gates_tiled_kernel or
# bilstm_proj_gates_kernel, then bilstm_proj_chain_kernel), the two
# routes of K2 (bilstm_xp_chain_kernel or bilstm_fwd_kernel), K5
# (lstm_fwd_chain_kernel or lstm_fwd_kernel), K9a (gru_fwd_chain_kernel
# or gru_fwd_kernel) and K8a (bigru_fwd_chain_kernel or bigru_fwd_kernel),
# those of K6 and K9b: the cluster route's two phases
# (lstm_bwd_gates_tiled_kernel or lstm_bwd_gates_kernel, then
# lstm_bwd_chain_kernel; the same with gru_bwd_), of K3 and K8b: the
# cluster route's chain alone (bilstm_bwd_chain_kernel,
# bigru_bwd_chain_kernel), or the cooperative kernel (bilstm_bwd_kernel,
# lstm_bwd_kernel, bigru_bwd_kernel, gru_bwd_kernel); and K7's two routes
# (lstm_stack_chain_kernel or lstm_stack_kernel)
KERNEL_TAGS = {"bilstm_proj_fwd": ("::bilstm_proj_x",
                                   "::bilstm_fwd_chain_kernel"),
               "bilstm_proj_bwd": ("::bilstm_proj_gates",
                                   "::bilstm_proj_chain_kernel"),
               "bilstm_fwd": ("::bilstm_xp_chain_kernel",
                              "::bilstm_fwd_kernel"),
               "lstm_fwd": ("::lstm_fwd_chain_kernel", "::lstm_fwd_kernel"),
               "gru_fwd": ("::gru_fwd_chain_kernel", "::gru_fwd_kernel"),
               "bigru_fwd": ("::bigru_fwd_chain_kernel",
                             "::bigru_fwd_kernel"),
               "bilstm_bwd": ("::bilstm_bwd_chain_kernel",
                              "::bilstm_bwd_kernel"),
               "lstm_bwd": ("::lstm_bwd_gates", "::lstm_bwd_chain_kernel",
                            "::lstm_bwd_kernel"),
               "gru_bwd": ("::gru_bwd_gates", "::gru_bwd_chain_kernel",
                           "::gru_bwd_kernel"),
               "bigru_bwd": ("::bigru_bwd_chain_kernel",
                             "::bigru_bwd_kernel"),
               "lstm_stack": ("::lstm_stack_chain_kernel",
                              "::lstm_stack_kernel")}
# of those, the ones a wrapper call launches once (once per chunk of
# steps: one chunk at the training shape)
LAUNCH_TAGS = {"bilstm_proj_fwd": ("::bilstm_fwd_chain_kernel",),
               "bilstm_proj_bwd": ("::bilstm_proj_chain_kernel",),
               "bilstm_bwd": ("::bilstm_bwd_chain_kernel",
                              "::bilstm_bwd_kernel"),
               "lstm_bwd": ("::lstm_bwd_chain_kernel", "::lstm_bwd_kernel"),
               "gru_bwd": ("::gru_bwd_chain_kernel", "::gru_bwd_kernel"),
               "bigru_bwd": ("::bigru_bwd_chain_kernel",
                             "::bigru_bwd_kernel")}


# K11's kernels as a trace names them, either route
K11_TAGS = ("ctc_band_kernel<true", "ctc_kernel<true, false>")


def kernel_tags(name):
    return KERNEL_TAGS.get(name, (f"::{name}_kernel",))


def launch_tags(name):
    return LAUNCH_TAGS.get(name, kernel_tags(name))


def train_launches(fwd, bwd, layers, proj, dtype):
    """The launches one train step must add, by kernel: ``fwd`` and
    ``bwd`` once per layer and K1 once; for a BLSTM, K10a and K10b where
    the JAX package's ``_use_in_kernel_proj`` holds (the 3x128's layers
    2-3 in f32) and K2 and K3 on the others."""
    want = {fwd: layers, bwd: layers, "ctc_alpha_beta": 1}
    if fwd == "bilstm_fwd":
        k10 = layers - 1 if proj and dtype == "float32" else 0
        want.update({fwd: layers - k10, bwd: layers - k10,
                     "bilstm_proj_fwd": k10, "bilstm_proj_bwd": k10})
    return want


def phase_train(torch, np, dev, bidirectional=True, mode=None, proj=False,
                ds2=False):
    """The flagship training step (or, with ``bidirectional=False``, its
    unidirectional variant's; an LSTM or ``mode``'s cell; with ``proj``
    the 3x128 BLSTM's, at the recipes' momentum and learning rate; with
    ``ds2`` the flagship behind bench.py's DS2 conv front, T halved
    before the stack) at bench.py's shapes: parity with the plain
    versions on the card, launch counts, the eval step, audio-s/s and one
    profiled step, for f32 then bf16."""
    from torch.profiler import DeviceType

    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train

    mode = mode or RnnMode.LSTM
    cell = "gru" if mode == RnnMode.GRU else "lstm"

    hidden, layers, targets = ((PROJ_H, PROJ_LAYERS, PROJ_TARGETS) if proj
                               else (320, 5, 72))
    # recipes/medium/run.sh:36,105: momentum 0.9, initial lr 1e-3
    opts = (train.TrainOptions(momentum=0.9, initial_learning_rate=1e-3)
            if proj else train.TrainOptions())
    b, t, l = TRAIN_B, TRAIN_T, TRAIN_L
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in {
        "feats": rng.standard_normal((b, t, 40)).astype(np.float32),
        "labels": rng.integers(1, targets, (b, l)).astype(np.int32),
        "input_lens": np.full((b,), t, np.int32),
        "label_lens": np.full((b,), l, np.int32)}.items()}
    audio_s_per_step = b * t * SECONDS_PER_FRAME
    fwd, bwd = ((f"bi{cell}_fwd", f"bi{cell}_bwd") if bidirectional
                else (f"{cell}_fwd", f"{cell}_bwd"))
    launches = collections.Counter()
    for dtype in DTYPES:
        cfg = AmConfig(input_dim=40, num_targets=targets, hidden_dim=hidden,
                       num_layers=layers, mode=mode,
                       bidirectional=bidirectional, compute_dtype=dtype,
                       **(DS2_CONV if ds2 else {}))
        params = init_am_params(cfg, torch.Generator().manual_seed(0), dev)
        state0 = train.init_train_state(params)
        step = train.build_train_step(cfg, opts)
        want = train_launches(fwd, bwd, layers, proj, dtype)
        step(state0, batch)          # warm-up: cuBLAS, allocator, kernels
        torch.cuda.synchronize()

        # the main path: 3 steps through the kernels, counts from them
        reset_counts()
        state, steps = state0, []
        for _ in range(3):
            before = read_counts()
            state, m = step(state, batch)
            after = read_counts()
            per_step = {k: after[k] - before[k] for k in want}
            steps.append({"loss_total": float(m["loss_total"]),
                          "grad_norm": float(m["grad_norm"]),
                          "finite": bool(m["finite"]),
                          "launches": per_step})
            if per_step != want:
                fail(f"train step {dtype} launched {per_step} (want "
                     f"{want})")
            if not (steps[-1]["finite"]
                    and np.isfinite(steps[-1]["loss_total"])):
                fail(f"train step {dtype} not finite: {steps[-1]}")
        for name, n in read_counts().items():
            launches[name] += n

        # the same 3 steps from the same state on the plain versions
        with plain_versions():
            state_p, plain = state0, []
            for _ in range(3):
                state_p, m = step(state_p, batch)
                plain.append({"loss_total": float(m["loss_total"]),
                              "grad_norm": float(m["grad_norm"])})
        loss_tol, norm_tol, param_tol = (
            TRAIN_TOL_GRU if cell == "gru" else TRAIN_TOL)[dtype]
        param_err = max(float((g - r).abs().max()) for g, r in zip(
            tree_flatten(state.params), tree_flatten(state_p.params)))
        loss_rel = max(abs(k["loss_total"] - p["loss_total"])
                       / abs(p["loss_total"]) for k, p in zip(steps, plain))
        norm_rel = max(abs(k["grad_norm"] - p["grad_norm"])
                       / abs(p["grad_norm"]) for k, p in zip(steps, plain))

        # the eval step: no gradient, so the loss takes K11 alone
        eval_step = train.make_eval_step(cfg)
        reset_counts()
        em = eval_step(state.params, batch)
        eval_loss = float(em["loss_total"])
        eval_counts = read_counts()
        for name, n in eval_counts.items():
            launches[name] += n
        # the step's forward kernels and K11
        want_eval = {k: n for k, n in want.items()
                     if k in (fwd, "bilstm_proj_fwd")}
        want_eval["ctc_alphas"] = 1
        if ({k: eval_counts[k] for k in want_eval} != want_eval
                or not np.isfinite(eval_loss)):
            fail(f"eval step {dtype}: launches {eval_counts} (want "
                 f"{want_eval}), loss {eval_loss}")
        # one eval step under the profiler: K11's share of its card time
        prof, eval_traced_ms = profiled(
            torch, lambda: eval_step(state.params, batch))
        eval_kernels = device_kernels(prof, DeviceType)
        eval_device_us = sum(k[0] for k in eval_kernels)
        k11_us = sum(k[0] for k in eval_kernels
                     if any(tag in k[2] for tag in K11_TAGS))
        eval_profile = {
            "traced_ms": round(eval_traced_ms, 3),
            "device_kernel_ms": (round(eval_device_us / 1000, 3)
                                 if eval_device_us else "not measured"),
            "k11_device_us": round(k11_us, 2),
            "k11_share_of_device": (round(k11_us / eval_device_us, 5)
                                    if eval_device_us else None)}

        # audio-s/s: timed calls of a few steps each, on the host clock
        rates = []
        for _ in range(TRAIN_TIMED_CALLS):
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS_PER_CALL):
                state, m = step(state, batch)
            float(m["loss_total"])   # sync point
            rates.append(audio_s_per_step * TRAIN_STEPS_PER_CALL
                         / (time.perf_counter() - t0))
        rates.sort()

        # one step under the profiler, after its warm-up step; a trace
        # that still lost one of the step's recurrent kernel launches is
        # taken again, up to three times
        def one_step():
            nonlocal state
            state, _ = step(state, batch)

        for traces in range(1, 4):
            prof, traced_ms = profiled(torch, one_step)
            kernels = device_kernels(prof, DeviceType)
            traced = {k: sum(c for _, c, name in kernels
                             if any(tag in name for tag in launch_tags(k)))
                      for k in want if k != "ctc_alpha_beta"}
            if all(traced[k] == want[k] for k in traced):
                break
        device_ms = sum(k[0] for k in kernels) / 1000

        def share(*tags):
            return round(sum(k[0] for k in kernels
                             if any(tag in k[2] for tag in tags))
                         / 1000 / device_ms, 4) if device_ms else None

        res = {"phase": ("train" + ("_gru" if cell == "gru" else "")
                         + ("" if bidirectional else "_uni")
                         + ("_proj" if proj else "")
                         + ("_ds2" if ds2 else "")),
               "dtype": dtype,
               "model": "%s%dx%d %s%s, 40-dim input, %d targets"
                        % ("DS2 conv front (2 layers, 32 channels, time "
                           "stride 2, T/2 into the stack) + " if ds2 else "",
                           layers, hidden, "B" if bidirectional else "",
                           cell.upper(), targets),
               "B": b, "T": t, "L": l, "steps": steps, "plain_steps": plain,
               "max_rel_err_loss": loss_rel, "max_rel_err_grad_norm":
                   norm_rel, "max_abs_err_params": param_err,
               "tol_loss_norm_params": [loss_tol, norm_tol, param_tol],
               "eval_loss_total": eval_loss, "eval_launches": eval_counts,
               "eval_profile": eval_profile,
               "audio_s_per_s": {"median": rates[len(rates) // 2],
                                 "min": rates[0], "max": rates[-1],
                                 "n": len(rates),
                                 "steps_per_call": TRAIN_STEPS_PER_CALL},
               "step_ms_median": (audio_s_per_step * 1000
                                  / rates[len(rates) // 2]),
               "traced_step_ms": round(traced_ms, 3),
               "traces_taken": traces, "traced_launches": traced,
               "device_kernel_ms": (round(device_ms, 3) if device_ms
                                    else "not measured"),
               "device_idle_share_of_traced_wall":
                   (round(1 - device_ms / traced_ms, 4) if device_ms
                    else "not measured"),
               "k1_share_of_device": share("ctc_kernel", "ctc_warp_kernel"),
               **({"conv_share_of_device": share("convolve", "dgrad",
                                                 "wgrad", "conv2d")}
                  if ds2 else {}),
               **{f"{k}_share_of_device": share(*kernel_tags(k))
                  for k in want if k != "ctc_alpha_beta"},
               "top_kernels": [{"name": k[2][:80], "us": round(k[0], 1),
                                "count": k[1]} for k in kernels[:10]]}
        emit(res)
        if loss_rel > loss_tol or norm_rel > norm_tol or param_err > param_tol:
            fail(f"train step {dtype} disagrees with the plain versions: "
                 f"loss {loss_rel}, grad norm {norm_rel}, params "
                 f"{param_err}")
    return launches


def phase_profile(torch, np, engines, kname="bilstm_fwd"):
    """Where one 8 s request's time goes: device time by kernel from
    torch.profiler (``kname``'s share: K2, K8a for the BiGRU or K9a for
    the uni GRU), against the request's wall time with and without the
    profiler."""
    from torch.profiler import DeviceType

    x = pcm(8.0, 13, np).astype(np.float32)
    for dtype, engine in engines.items():
        for _ in range(2):
            engine.recognize(x)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.recognize(x)
            walls.append((time.perf_counter() - t0) * 1000)
        walls.sort()
        prof, traced_ms = profiled(torch, lambda: engine.recognize(x))
        kernels = device_kernels(prof, DeviceType)
        device_ms = sum(k[0] for k in kernels) / 1000

        def share(*tags):
            return round(sum(k[0] for k in kernels
                             if any(tag in k[2] for tag in tags))
                         / 1000 / device_ms, 4) if device_ms else None

        emit({"phase": {"bilstm_fwd": "profile", "bigru_fwd": "profile_gru",
                        "gru_fwd": "profile_gru_uni"}[kname],
              "dtype": dtype, "audio_s": 8.0,
              "untraced_ms_median_of_5": round(walls[2], 3),
              "traced_ms": round(traced_ms, 3),
              "device_kernel_ms": (round(device_ms, 3) if device_ms
                                   else "not measured"),
              # busy and idle from the same traced window; the tracer
              # itself adds host time (traced vs untraced wall)
              "device_idle_share_of_traced_wall":
                  (round(1 - device_ms / traced_ms, 4) if device_ms
                   else "not measured"),
              f"{kname}_share_of_device": share(*kernel_tags(kname)),
              "k4_share_of_device": share("log_mel_kernel",
                                          "log_mel_fft_kernel"),
              "top_kernels": [{"name": k[2][:80], "us": round(k[0], 1),
                               "count": k[1]} for k in kernels[:8]]})


def driven_routes(launches, served):
    """K4's launches on the driven paths by route and by frames, K1's,
    K11's and K12's by route; fails unless every served K4 launch and
    every K1, K11 and K12 launch took the route its plan names at these
    shapes (fft; warp at S = 141; band at S = 141)."""
    frames = sorted((int(k[len(K4_FRAMES):]), n) for k, n in launches.items()
                    if k.startswith(K4_FRAMES))
    served_k4 = {k: sum(c[k] for c in served)
                 for k in ("log_mel", "log_mel.fft", "log_mel.dft")}
    res = {"phase": "driven_routes",
           "log_mel": {"fft": launches["log_mel.fft"],
                       "dft": launches["log_mel.dft"],
                       "by_frames": {str(f): n for f, n in frames},
                       "served": served_k4},
           "ctc_alpha_beta": {"warp": launches["ctc_alpha_beta.warp"],
                              "block": launches["ctc_alpha_beta.block"]},
           **{name: {"band": launches[f"{name}.band"],
                     "block": launches[f"{name}.block"]}
              for name in ("ctc_alphas", "ctc_betas")}}
    emit(res)
    if (served_k4["log_mel.dft"] or served_k4["log_mel"] < 1
            or served_k4["log_mel.fft"] != served_k4["log_mel"]):
        fail(f"the served paths' K4 launches did not all take the fft "
             f"route: {res}")
    if (launches["ctc_alpha_beta.block"]
            or launches["ctc_alpha_beta.warp"] != launches["ctc_alpha_beta"]):
        fail(f"K1's launches on the driven paths did not all take the warp "
             f"route: {res}")
    for name in ("ctc_alphas", "ctc_betas"):
        if (launches[f"{name}.block"] or launches[name] < 1
                or launches[f"{name}.band"] != launches[name]):
            fail(f"{name}'s launches on the driven paths did not all take "
                 f"the band route: {res}")


# the decode phase: DECODE_UTTS utterances of 2-8 s, a 2,000-word lexicon
# loop of 2-6 labels a word, decode_ctc's three methods and their
# tolerance; 8 utterances: a cut in depth that keeps the whole run, the
# recipes phase included, near 750 s
DECODE_UTTS, LEX_WORDS = 8, 2000
# the flagship's hidden units (a CPU rehearsal may set fewer)
DECODE_HIDDEN = 320
# where two paths' hypotheses differ, their best-path scores (greedy: the
# framewise maxima, beam: the prefix score, wfst: the graph cost) agree
# to this relative difference: a near-tie that the forward's tolerance
# flips, not a fault
DECODE_COST_RTOL = 1e-3


def run_cli(main, argv):
    """A CLI's main() in this process → its standard output."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def lexicon_prons(np, seed):
    """The seeded lexicon of ``lexicon_graph``: the words' unigram
    probabilities and each word's labels (2-6 of 1..71)."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(LEX_WORDS))
    return probs, [rng.integers(1, 72, int(rng.integers(2, 7)))
                   for _ in range(LEX_WORDS)]


def lexicon_graph(np, fst_cls, seed):
    """A seeded lexicon loop of LEX_WORDS words of 2-6 labels (1..71),
    each word's unigram cost on its first arc, with CTC self-loops and
    blanks → (graph, words table lines)."""
    probs, prons = lexicon_prons(np, seed)
    arcs, weights, n = [], [], 1
    for w, labels in enumerate(prons, 1):
        src = 0
        for i, lab in enumerate(labels):
            dst = 0 if i == len(labels) - 1 else n
            n += dst != 0
            arcs.append([src, int(lab), w if i == 0 else 0, dst])
            weights.append(-math.log(probs[w - 1]) if i == 0 else 0.0)
            src = dst
    finals = np.full(n, np.inf, np.float32)
    finals[0] = 0.0
    lg = fst_cls.from_arrays(0, n, np.asarray(arcs, np.int32),
                             np.asarray(weights, np.float32), finals)
    table = ["<eps> 0"] + [f"w{w} {w}" for w in range(1, LEX_WORDS + 1)]
    return lg.add_self_loops().make_ctc_graph().renumber_bfs(), table


def word_loop_graph(np, fst_cls):
    """The serve tests' word loop: words = labels 1..71, CTC-transformed
    → (graph, words table lines)."""
    arcs, weights = [], []
    for lab in range(1, 72):
        arcs += [[0, lab, lab, lab], [lab, lab, 0, lab], [lab, 0, 0, 0]]
        weights += [1.0, 0.0, 0.0]
    finals = np.full(72, np.inf, np.float32)
    finals[0] = 0.0
    base = fst_cls.from_arrays(0, 72, np.asarray(arcs, np.int32),
                               np.asarray(weights, np.float32), finals)
    return base.make_ctc_graph(), ["<eps> 0"] + [f"l{i} {i}"
                                                 for i in range(1, 72)]


def plain_decode(torch, np, post, method, graph, table):
    """decode_ctc's decoding, by the port's decoders on the CPU, over the
    log posteriors ``post`` (key → [T, A], nnet_compute's output) with
    decode_ctc's defaults → ({key: hypothesis}, {key: best-path score})."""
    from kaldi_ctc_tpu_torch.decoding import (acoustic_scores,
                                              greedy_decode,
                                              prefix_beam_search)
    from kaldi_ctc_tpu_torch.decoding.wfst import decode_best_path_batch
    from kaldi_ctc_tpu_torch.models import default_priors

    keys = sorted(post)
    lens = torch.as_tensor([post[k].shape[0] for k in keys])
    x = torch.zeros((len(keys), int(lens.max()), post[keys[0]].shape[1]))
    for j, k in enumerate(keys):
        x[j, :post[k].shape[0]] = torch.as_tensor(post[k])
    scores, skip = acoustic_scores(x, priors=default_priors(x.shape[-1]))
    hyps, costs = {}, {}
    if method == "wfst":
        words_of = dict(line.split()[::-1] for line in table)
        rows = [scores[j, :lens[j]][~skip[j, :lens[j]]].numpy()
                for j in range(len(keys))]
        todo = [j for j in range(len(keys)) if rows[j].shape[0]]
        out = decode_best_path_batch(graph, [rows[j] for j in todo])
        for j in range(len(keys)):
            hyps[keys[j]], costs[keys[j]] = [], 0.0
        for j, (words, _, cost, ok) in zip(todo, out):
            hyps[keys[j]] = ([words_of[str(int(w))] for w in words]
                             if ok else [])
            costs[keys[j]] = cost
        return hyps, costs
    if method == "greedy":
        labels, n = greedy_decode(scores, lens)
        mask = torch.arange(x.shape[1])[None] < lens[:, None]
        best = (scores.max(-1).values * mask).sum(-1)
    else:
        labels, n, best = prefix_beam_search(scores, lens)
    for j, k in enumerate(keys):
        hyps[k] = [str(int(v)) for v in labels[j, :n[j]]]
        costs[k] = float(best[j])
    return hyps, costs


def read_hyps(path):
    with open(path) as f:
        return {line.split()[0]: line.split()[1:] for line in f}


def phase_decode(torch, np, dev):
    """Offline decoding with word output through the port alone: the
    native library built by the port's loader, the flagship made by
    init_model (and a bf16 twin), copy_model and model_info, 16
    utterances' MFCC-hires from the card written as ark,scp, a word-loop
    and a 2,000-word lexicon graph, decode_ctc's three methods per dtype
    against the plain path (nnet_compute's CPU forward and the port's
    decoders on the CPU), nnet_compute --what post, and serve --graph on
    the flagship and the uni LSTM → the launch counts of the decode runs
    and the served requests."""
    import glob
    import shutil

    from kaldi_ctc_tpu_torch.cli import (copy_model, decode_ctc, init_model,
                                         model_info, nnet_compute)
    from kaldi_ctc_tpu_torch.decoding import wfst
    from kaldi_ctc_tpu_torch.features import MfccOptions, compute_mfcc
    from kaldi_ctc_tpu_torch.models.artifact import load_inference_artifact
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training.checkpoint import restore_params
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (MatrixWriter,
                                                    SequentialMatrixReader)

    def jax_libraries():
        return {p: os.path.getmtime(p) for p in glob.glob(os.path.join(
            ROOT, "kaldi_ctc_tpu", "**", "libctc_native*.so"),
            recursive=True)}

    before = jax_libraries()
    t0 = time.perf_counter()
    lib = wfst.ensure_built()
    build_s = time.perf_counter() - t0
    wfst._load()
    if os.path.dirname(lib) != os.path.join(ROOT, "build", "native") or \
            jax_libraries() != before:
        fail(f"the native library was built at {lib}; in the JAX package: "
             f"{jax_libraries()} (before: {before})")

    work = os.path.join(ROOT, "build", "smoke", "decode")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    exps = {"float32": os.path.join(work, "exp")}
    run_cli(init_model.main, [
        "--dir", exps["float32"], "--input-dim", "40", "--num-targets", "72",
        "--hidden-dim", str(DECODE_HIDDEN), "--num-layers", "5",
        "--seed", "0"])
    exps["bfloat16"] = os.path.join(work, "exp_bf16")
    shutil.copytree(exps["float32"], exps["bfloat16"])
    cfg_path = os.path.join(exps["bfloat16"], "model_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(cfg_path, "w") as f:
        json.dump({**cfg, "compute_dtype": "bfloat16"}, f)
    artifact = os.path.join(work, "final.npz")
    run_cli(copy_model.main, ["--dir", exps["float32"], "--output", artifact])
    info = json.loads(run_cli(model_info.main, ["--dir", exps["float32"]]))
    a_params, a_cfg, a_priors = load_inference_artifact(artifact)
    c_params, _ = restore_params(os.path.join(exps["float32"],
                                              "checkpoints"), a_cfg)
    if not all(torch.equal(a, c) for a, c in zip(
            tree_flatten(a_params), tree_flatten(c_params))) or \
            a_priors is None or info["num_parameters"] != sum(
                int(t.numel()) for t in tree_flatten(a_params)):
        fail(f"copy_model's artifact differs from its checkpoint: {info}")

    # DECODE_UTTS utterances of 2-8 s: MFCC-hires on the card (K4), ark,scp
    secs = [2.0 + 6.0 * i / (DECODE_UTTS - 1) for i in range(DECODE_UTTS)]
    feats_spec = (f"ark,scp:{work}/feats.ark,{work}/feats.scp")
    frames = 0
    with MatrixWriter(feats_spec) as w:
        for i, s in enumerate(secs):
            wave = torch.as_tensor(pcm(s, 60 + i, np).astype(np.float32),
                                   device=dev)
            f = compute_mfcc(wave, MfccOptions.hires()).cpu().numpy()
            w[f"utt{i:02d}"] = f
            frames += f.shape[0]
    audio_s = frames * 0.01

    graphs = {}
    for name, (g, table) in (
            ("word_loop", word_loop_graph(np, wfst.NativeFst)),
            ("lexicon", lexicon_graph(np, wfst.NativeFst, 70))):
        path = os.path.join(work, f"{name}.fst")
        g.write(path)
        with open(path + ".words.txt", "w") as f:
            f.write("\n".join(table) + "\n")
        graphs[name] = (g, path, table)
    emit({"phase": "decode_setup", "native_library": os.path.relpath(
              lib, ROOT), "native_build_s": round(build_s, 3),
          "model": f"5x{DECODE_HIDDEN} BLSTM, 40-dim MFCC-hires, 72 "
                   "targets (init_model --seed 0)",
          "model_info": {k: info[k] for k in ("num_parameters",
                                              "parameter_norm",
                                              "checkpoint_step")},
          "utterances": DECODE_UTTS, "frames": frames,
          "audio_seconds": round(audio_s, 3),
          "graphs": {k: {"states": g.num_states, "arcs": g.num_arcs}
                     for k, (g, _, _) in graphs.items()}})

    launches = collections.Counter()
    lex, lex_path, lex_table = graphs["lexicon"]
    for dtype in DTYPES:
        exp = exps[dtype]
        post = {}
        for device in ("cpu", dev.type):
            out = os.path.join(work, f"post_{device}_{dtype}")
            run_cli(nnet_compute.main, [
                "--feats", f"scp:{work}/feats.scp", "--dir", exp,
                "--what", "log-post", "--device", device,
                "--output", f"ark:{out}.ark"])
            post[device] = dict(SequentialMatrixReader(f"ark:{out}.ark"))
        post["kernels"] = post[dev.type]
        err = max(float(np.abs(post["kernels"][k] - post["cpu"][k]).max())
                  for k in post["cpu"])
        # nnet_compute --what post on the card: rows sum to 1
        out = os.path.join(work, f"post_{dtype}")
        run_cli(nnet_compute.main, [
            "--feats", f"scp:{work}/feats.scp", "--dir", exp,
            "--what", "post", "--device", dev.type,
            "--output", f"ark:{out}.ark"])
        probs = dict(SequentialMatrixReader(f"ark:{out}.ark"))
        row_err = max(float(np.abs(p.sum(-1) - 1.0).max())
                      for p in probs.values())
        log_err = max(float(np.abs(np.log(np.maximum(probs[k], 1e-30))
                                   - post["kernels"][k]).max())
                      for k in probs)
        res = {"phase": "nnet_compute", "dtype": dtype,
               "max_abs_log_post_err_vs_cpu_plain": err,
               "score_tol": SCORE_TOL[dtype], "post_row_sum_err": row_err,
               "max_abs_log_of_post_err": log_err}
        emit(res)
        if err > SCORE_TOL[dtype] or row_err > 1e-4 or log_err > \
                SCORE_TOL[dtype]:
            fail(f"nnet_compute disagrees: {res}")

        for method in ("greedy", "beam", "wfst"):
            plain, plain_cost = plain_decode(torch, np, post["cpu"], method,
                                             lex, lex_table)
            _, kern_cost = plain_decode(torch, np, post["kernels"], method,
                                        lex, lex_table)
            refs = os.path.join(work, f"refs_{method}_{dtype}.txt")
            with open(refs, "w") as f:
                f.writelines(f"{k} {' '.join(v)}\n" for k, v in
                             sorted(plain.items()))
            hyp_path = os.path.join(work, f"hyp_{method}_{dtype}.txt")
            argv = ["--feats", f"scp:{work}/feats.scp", "--dir", exp,
                    "--method", method, "--text", refs, "--output", hyp_path,
                    "--device", dev.type]
            if method == "wfst":
                argv += ["--graph", lex_path, "--words",
                         lex_path + ".words.txt"]
            before = read_counts()
            t1 = time.perf_counter()
            line = run_cli(decode_ctc.main, argv)
            wall = time.perf_counter() - t1
            after = read_counts()
            for name in after:
                launches[name] += after[name] - before[name]
            score = json.loads(line.strip().splitlines()[-1])
            hyps = read_hyps(hyp_path)
            differ = sorted(k for k in plain if hyps.get(k) != plain[k])
            far = [k for k in differ if abs(kern_cost[k] - plain_cost[k])
                   > DECODE_COST_RTOL * abs(plain_cost[k])]
            res = {"phase": "decode", "method": method, "dtype": dtype,
                   "utterances": len(hyps), "audio_seconds": round(
                       audio_s, 3), "wall_s": round(wall, 4),
                   "rtf": score["rtf"], "k2_launches":
                       after["bilstm_fwd"] - before["bilstm_fwd"],
                   "nonempty_share": sum(1 for v in hyps.values() if v)
                   / len(hyps),
                   "mean_hyp_len": sum(len(v) for v in hyps.values())
                   / len(hyps),
                   "differ_from_plain": len(differ),
                   "label_error_rate_vs_plain": score["label_error_rate"],
                   "max_cost_rel_diff": max(
                       [abs(kern_cost[k] - plain_cost[k])
                        / max(abs(plain_cost[k]), 1e-30) for k in differ],
                       default=0.0)}
            if method == "wfst":
                res["graph"] = "lexicon"
            emit(res)
            if len(hyps) != DECODE_UTTS or res["k2_launches"] < 5:
                fail(f"decode_ctc did not run the kernel path: {res}")
            exact = method != "wfst" and dtype == "float32"
            if (differ and exact) or far:
                fail(f"decode_ctc's hypotheses disagree with the plain "
                     f"path: {res}; {differ[:4]}")
        if dtype == "float32":
            # the prefix beam loop alone on the card, on the kernel scores
            from kaldi_ctc_tpu_torch.decoding import (acoustic_scores,
                                                      prefix_beam_search)
            keys = sorted(post["kernels"])
            lens = torch.as_tensor([post["kernels"][k].shape[0]
                                    for k in keys], device=dev)
            x = torch.zeros((len(keys), int(lens.max()), 72), device=dev)
            for j, k in enumerate(keys):
                x[j, :lens[j]] = torch.as_tensor(post["kernels"][k])
            sc, _ = acoustic_scores(x, priors=a_priors)
            sync(torch, dev)
            t1 = time.perf_counter()
            prefix_beam_search(sc, lens)
            sync(torch, dev)
            emit({"phase": "prefix_beam_loop", "dtype": dtype,
                  "frames_max": int(lens.max()), "batch": len(keys),
                  "wall_s": round(time.perf_counter() - t1, 4)})
    launches.update(serve_graph(torch, np, dev, work, exps["float32"],
                                graphs["word_loop"][1]))
    return launches


# the pipeline phase: 144 utterances of 2-8 s (96 train, 48 valid), pdf
# alignments over 71 ids in runs of 9-16 frames (at most 89 labels in
# 798 frames: the label bucket 93, S = 187, within K1's warp and K11's
# band routes), train_ctc's flagship defaults for 5 epochs of 2 steps,
# the streamed utterances and decode_stream's chunk
PIPE_UTTS, PIPE_TRAIN, PIPE_STREAMS, PIPE_CHUNK = 144, 96, 16, 50
PIPE_SECONDS, PIPE_RUN = (2.0, 8.0), (9, 17)
# the flagship's width, train_ctc's defaults (a CPU rehearsal may set less)
PIPE_HIDDEN, PIPE_LAYERS = 320, 5
# compute_prob's loss and adjust_priors' priors against the same CLI on
# the plain versions: f32 sums in another order
PIPE_PROB_RTOL, PIPE_PRIOR_ATOL = 1e-5, 1e-5


def write_wav(path, samples):
    import wave
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.tobytes())


def cli_counts(main, argv):
    """A CLI's main() → (its standard output, the kernel launches it
    made, its wall seconds)."""
    before = read_counts()
    t0 = time.perf_counter()
    out = run_cli(main, argv)
    wall = time.perf_counter() - t0
    after = read_counts()
    return out, collections.Counter(
        {k: after[k] - before.get(k, 0) for k in after}), wall


def plain_cli(main, argv):
    """A CLI's main() on the plain versions → (its standard output, the
    kernel launches it made: none, unless a wrapper escaped the swap)."""
    before = read_counts()
    with plain_versions():
        out = run_cli(main, argv)
    return out, sum(v - before.get(k, 0) for k, v in read_counts().items())


def train_records(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def pipeline_train_argv(work):
    """train_ctc on the pipeline's egs: the flagship's defaults, 5 epochs
    of 2 steps, cv over the 48 valid utterances at step 10."""
    return ["--egs", f"scp:{work}/train_egs.scp", "--valid-feats",
            f"scp:{work}/feats.scp", "--valid-ali",
            f"ark:{work}/ali_valid.ark", "--cmvn", f"ark:{work}/cmvn.ark",
            "--utt2spk", f"{work}/utt2spk", "--num-targets", "72",
            "--hidden-dim", str(PIPE_HIDDEN), "--num-layers",
            str(PIPE_LAYERS), "--epochs", "5", "--cv-period", "1",
            "--checkpoint-period", "5"]


def phase_pipeline(torch, np, dev, smi):
    """Features → egs → a trained flagship → eval, priors and decodes,
    through the port's CLIs on the card: compute_feats (K4 per
    utterance), compute_cmvn, prepare_egs get and info, train_ctc in f32
    and bf16 (K2, K3, K1 each step, K11 in cv; the first step against the
    plain versions), a profiled f32 train_ctc (device and host shares),
    compute_prob (K11) and adjust_priors --feats (K2) against the same
    CLIs on the plain versions, decode_ctc greedy with priors, and
    decode_stream on a uni LSTM (K7 per chunk) against that model's
    offline greedy decode → the launch counts of the CLI runs."""
    import shutil

    from torch.profiler import DeviceType, ProfilerActivity, profile

    from kaldi_ctc_tpu_torch.cli import (adjust_priors, compute_cmvn,
                                         compute_feats, compute_prob,
                                         decode_ctc, decode_stream,
                                         init_model, prepare_egs, train_ctc)
    from kaldi_ctc_tpu_torch import _kernels
    from kaldi_ctc_tpu_torch.data import EgsPipeline
    from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
    from kaldi_ctc_tpu_torch.features import MfccOptions, compute_mfcc
    from kaldi_ctc_tpu_torch.features import stft_cuda
    from kaldi_ctc_tpu_torch.features.window import (feature_window,
                                                     frame_signal)
    from kaldi_ctc_tpu_torch.features.mel import mel_banks
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    from kaldi_ctc_tpu_torch.parallel import make_mesh, shard_batch
    from kaldi_ctc_tpu_torch.training import (TrainOptions,
                                              build_train_step,
                                              init_train_state)
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (IntVectorWriter,
                                                    SequentialMatrixReader)

    work = os.path.join(ROOT, "build", "smoke", "pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    device = ["--device", dev.type]
    launches = collections.Counter()

    # 1. seeded WAVs and wav.scp; 12 speakers
    rng = np.random.default_rng(90)
    secs = rng.uniform(*PIPE_SECONDS, PIPE_UTTS)
    keys = [f"spk{i % 12:02d}-utt{i:03d}" for i in range(PIPE_UTTS)]
    waves = {}
    with open(os.path.join(work, "wav.scp"), "w") as scp, \
            open(os.path.join(work, "utt2spk"), "w") as u2s:
        for i, key in enumerate(keys):
            waves[key] = pcm(float(secs[i]), 300 + i, np)
            path = os.path.join(work, f"{key}.wav")
            write_wav(path, waves[key])
            scp.write(f"{key} {path}\n")
            u2s.write(f"{key} {key[:5]}\n")
    audio_s = float(sum(len(w) for w in waves.values())) / 16000

    # 2. compute_feats on the card (K4 once per utterance)
    feats_spec = f"ark,scp:{work}/feats.ark,{work}/feats.scp"
    _, counts, feat_wall = cli_counts(compute_feats.main, [
        "--wav-scp", f"{work}/wav.scp", "--type", "mfcc", "--config",
        "hires", "--compress", "0", "--out", feats_spec] + device)
    launches.update(counts)
    feats = dict(SequentialMatrixReader(f"scp:{work}/feats.scp"))
    opts = MfccOptions.hires()
    fo = opts.frame_opts
    window = torch.as_tensor(feature_window(fo), device=dev)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, fo), device=dev)
    k4_err, k4_ok, same = 0.0, True, True
    for key in keys[:4]:
        wave = torch.as_tensor(waves[key].astype(np.float32), device=dev)
        again = compute_mfcc(wave, opts).cpu().numpy()
        same &= bool(np.array_equal(again, feats[key]))
        frames = frame_signal(wave, fo).contiguous()
        got = stft_cuda.log_mel(frames, window, mel, fo.padded_window_size)
        ref = stft_cuda.log_mel_reference(frames, window, mel,
                                          fo.padded_window_size)
        for g, r in zip(got, ref):
            e, ok = max_err(g, r, K4_TOL, K4_TOL)
            k4_err, k4_ok = max(k4_err, e), k4_ok and ok
    res = {"phase": "pipeline_feats", "utterances": PIPE_UTTS,
           "audio_seconds": round(audio_s, 3),
           "frames": sum(f.shape[0] for f in feats.values()),
           "wall_s": round(feat_wall, 4),
           "feature_rtf": feat_wall / audio_s,
           "k4_launches": counts["log_mel"],
           "k4_fft_launches": counts["log_mel.fft"],
           "archive_equals_kernel_recompute": same,
           "k4_max_abs_err_vs_plain_4_utts": k4_err, "tol": K4_TOL}
    emit(res)
    if (len(feats) != PIPE_UTTS or counts["log_mel"] != PIPE_UTTS
            or not same or not k4_ok
            or any(f.shape[1] != 40 or not np.isfinite(f).all()
                   for f in feats.values())):
        fail(f"compute_feats: {res}")

    # 3. CMVN per speaker; 4. seeded alignments and egs
    run_cli(compute_cmvn.main, ["--feats", f"scp:{work}/feats.scp",
                                "--utt2spk", f"{work}/utt2spk",
                                "--out", f"ark:{work}/cmvn.ark"])
    for part, part_keys in (("train", keys[:PIPE_TRAIN]),
                            ("valid", keys[PIPE_TRAIN:])):
        with IntVectorWriter(f"ark:{work}/ali_{part}.ark") as w:
            for key in part_keys:
                t, ali = feats[key].shape[0], []
                while len(ali) < t:
                    ali += [int(rng.integers(0, 71))] * int(
                        rng.integers(*PIPE_RUN))
                w[key] = np.asarray(ali[:t], np.int32)
        run_cli(prepare_egs.main, [
            "get", "--feats", f"scp:{work}/feats.scp", "--ali",
            f"ark:{work}/ali_{part}.ark", "--cmvn", f"ark:{work}/cmvn.ark",
            "--utt2spk", f"{work}/utt2spk", "--output",
            f"ark,scp:{work}/{part}_egs.ark,{work}/{part}_egs.scp"])
    info = {part: json.loads(run_cli(prepare_egs.main, [
        "info", "--egs", f"scp:{work}/{part}_egs.scp"]))
        for part in ("train", "valid")}
    emit({"phase": "pipeline_egs", "info": info})
    if info["train"]["num_examples"] != PIPE_TRAIN or \
            info["valid"]["num_examples"] != PIPE_UTTS - PIPE_TRAIN:
        fail(f"prepare_egs: {info}")

    # 5. train_ctc per dtype: the flagship's defaults, 10 steps, cv at 10
    train_argv = pipeline_train_argv(work) + device
    examples = list(SequentialEgsReader(f"scp:{work}/train_egs.scp"))
    first = next(EgsPipeline(examples, minibatch_size=48).epoch(0))
    first.pop("keys")
    exps = {}
    for dtype in DTYPES:
        exps[dtype] = os.path.join(work, f"exp_{dtype}")
        _, counts, wall = cli_counts(train_ctc.main, train_argv + [
            "--dir", exps[dtype], "--compute-dtype", dtype])
        launches.update(counts)
        recs = train_records(exps[dtype])
        steps = [r for r in recs if r["event"] == "train_step"]
        valid = [r for r in recs if r["event"] == "valid"]
        n = len(steps)
        span = steps[-1]["t"] - steps[0]["t"]
        # the plain versions' first step from train_ctc's initial params
        cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=PIPE_HIDDEN,
                       num_layers=PIPE_LAYERS, compute_dtype=dtype)
        state = init_train_state(train_ctc.initial_params(cfg, 0, dev))
        before = read_counts()
        with plain_versions():
            _, m = build_train_step(cfg, TrainOptions(num_steps=10))(
                state, shard_batch(first, make_mesh(devices=[dev])))
            plain = {k: float(m[k]) for k in ("loss_per_frame",
                                              "grad_norm")}
        plain_launches = sum(v - before.get(k, 0)
                             for k, v in read_counts().items())
        loss_rtol, grad_rtol, _ = TRAIN_TOL[dtype]
        rel = {k: abs(steps[0][k] - v) / abs(v) for k, v in plain.items()}
        res = {"phase": "pipeline_train", "dtype": dtype, "steps": n,
               "wall_s": round(wall, 4),
               "steps_per_s": (n - 1) / span if span > 0 else None,
               "audio_s_per_s": (sum(r["num_frames"] for r in steps[1:])
                                 * 0.01 / span if span > 0 else None),
               "steps_share_of_wall": (span * n / (n - 1)) / wall,
               "loss_per_frame": [r["loss_per_frame"] for r in steps],
               "valid": valid,
               "first_step_rel_err_vs_plain": rel,
               "tol": {"loss_per_frame": loss_rtol, "grad_norm": grad_rtol},
               "launches": {k: counts[k] for k in (
                   "bilstm_fwd", "bilstm_bwd", "ctc_alpha_beta",
                   "ctc_alphas")}}
        emit(res)
        # one eval batch of 48 valid utterances at step 10
        if (n != 10 or len(valid) != 1
                or counts["bilstm_bwd"] != PIPE_LAYERS * n
                or counts["ctc_alpha_beta"] != n
                or counts["ctc_alphas"] != 1
                or counts["bilstm_fwd"] != PIPE_LAYERS * (n + 1)
                or rel["loss_per_frame"] > loss_rtol
                or rel["grad_norm"] > grad_rtol or plain_launches
                or not all(np.isfinite(r["loss_per_frame"])
                           for r in steps)):
            fail(f"train_ctc: {res}")

    # the f32 run once more under torch.profiler: the device's busy share
    prof_exp = os.path.join(work, "exp_profiled")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(train_ctc.main, train_argv + ["--dir", prof_exp])
        sync(torch, dev)
        traced_s = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    emit({"phase": "pipeline_train_profile", "dtype": "float32",
          "traced_wall_s": round(traced_s, 4),
          "device_kernel_s": round(busy, 4) if busy else "not measured",
          "device_busy_share": (round(busy / traced_s, 4) if busy
                                else "not measured"),
          "host_side_share": (round(1 - busy / traced_s, 4) if busy
                              else "not measured")})

    # 6. compute_prob on the valid egs (K11) against the plain versions
    exp = exps["float32"]
    prob_argv = ["--egs", f"scp:{work}/valid_egs.scp", "--dir", exp] + device
    out, counts, wall = cli_counts(compute_prob.main, prob_argv)
    launches.update(counts)
    prob = json.loads(out.strip().splitlines()[-1])
    out, plain_launches = plain_cli(compute_prob.main, prob_argv)
    plain = json.loads(out.strip().splitlines()[-1])
    rel = abs(prob["loss_per_frame"] - plain["loss_per_frame"]) / abs(
        plain["loss_per_frame"])
    res = {"phase": "pipeline_compute_prob", "dtype": "float32", **prob,
           "wall_s": round(wall, 4), "rel_err_vs_plain": rel,
           "tol": PIPE_PROB_RTOL, "k11_launches": counts["ctc_alphas"],
           "k2_launches": counts["bilstm_fwd"]}
    emit(res)
    if rel > PIPE_PROB_RTOL or counts["ctc_alphas"] < 1 or \
            prob["num_utts"] != PIPE_UTTS - PIPE_TRAIN or \
            prob["accuracy"] != plain["accuracy"] or plain_launches:
        fail(f"compute_prob: {res}")

    # 7. adjust_priors --feats (K2) against the plain versions
    plain_exp = os.path.join(work, "exp_priors_plain")
    shutil.copytree(exp, plain_exp)
    prior_argv = ["--feats", f"scp:{work}/feats.scp", "--cmvn",
                  f"ark:{work}/cmvn.ark", "--utt2spk",
                  f"{work}/utt2spk"] + device
    _, counts, wall = cli_counts(adjust_priors.main,
                                 prior_argv + ["--dir", exp])
    launches.update(counts)
    _, plain_launches = plain_cli(adjust_priors.main,
                                  prior_argv + ["--dir", plain_exp])
    priors = np.load(os.path.join(exp, "priors.npy"))
    plain = np.load(os.path.join(plain_exp, "priors.npy"))
    err = float(np.abs(priors - plain).max())
    res = {"phase": "pipeline_adjust_priors", "dtype": "float32",
           "wall_s": round(wall, 4), "max_abs_err_vs_plain": err,
           "tol": PIPE_PRIOR_ATOL, "blank_prior": float(priors[0]),
           "k2_launches": counts["bilstm_fwd"]}
    emit(res)
    if err > PIPE_PRIOR_ATOL or counts["bilstm_fwd"] < 5 or \
            abs(float(priors.sum()) - 1.0) > 1e-4 or plain_launches:
        fail(f"adjust_priors: {res}")

    # 8. decode_ctc greedy with the new priors
    hyp_path = os.path.join(work, "hyps_greedy.txt")
    _, counts, wall = cli_counts(decode_ctc.main, [
        "--feats", f"scp:{work}/feats.scp", "--cmvn", f"ark:{work}/cmvn.ark",
        "--utt2spk", f"{work}/utt2spk", "--dir", exp, "--method", "greedy",
        "--use-priors", "1", "--output", hyp_path] + device)
    launches.update(counts)
    hyps = read_hyps(hyp_path)
    emit({"phase": "pipeline_decode", "method": "greedy", "use_priors": 1,
          "utterances": len(hyps), "wall_s": round(wall, 4),
          "nonempty_share": sum(1 for v in hyps.values() if v) / len(hyps),
          "k2_launches": counts["bilstm_fwd"]})
    if len(hyps) != PIPE_UTTS or counts["bilstm_fwd"] < 5:
        fail("decode_ctc on the trained model did not decode every "
             "utterance through K2")

    # 9. decode_stream on a uni LSTM (K7 a chunk) against its offline
    # greedy decode (K5)
    uni = os.path.join(work, "exp_uni")
    run_cli(init_model.main, [
        "--dir", uni, "--input-dim", "40", "--num-targets", "72",
        "--hidden-dim", str(PIPE_HIDDEN), "--num-layers", str(PIPE_LAYERS),
        "--bidirectional", "0"])
    with open(os.path.join(work, "feats.scp")) as f:
        lines = f.readlines()[:PIPE_STREAMS]
    with open(os.path.join(work, "stream.scp"), "w") as f:
        f.writelines(lines)
    stream_audio = sum(feats[line.split()[0]].shape[0]
                       for line in lines) * 0.01
    lib = _kernels.load("lstm_stack", rnn_cuda._STACK_SIGNATURES)
    plan = rnn_cuda.k7_plan(lib, PIPE_LAYERS, 1, PIPE_HIDDEN, torch.float32,
                            dev)
    paths = {m: os.path.join(work, f"hyps_{m}.txt")
             for m in ("stream", "offline")}
    _, off_counts, _ = cli_counts(decode_ctc.main, [
        "--feats", f"scp:{work}/stream.scp", "--dir", uni, "--method",
        "greedy", "--use-priors", "0", "--output", paths["offline"]]
        + device)
    launches.update(off_counts)
    # the offline hypotheses as the reference text: decode_stream prints
    # its RTF and chunk latency beside the label error rate against them
    out, counts, wall = cli_counts(decode_stream.main, [
        "--feats", f"scp:{work}/stream.scp", "--dir", uni,
        "--chunk-frames", str(PIPE_CHUNK), "--output", paths["stream"],
        "--text", paths["offline"]] + device)
    launches.update(counts)
    stream_score = json.loads(out.strip().splitlines()[-1])
    stream, offline = read_hyps(paths["stream"]), read_hyps(paths["offline"])
    chunks = sum(-(-feats[line.split()[0]].shape[0] // PIPE_CHUNK)
                 for line in lines)
    res = {"phase": "pipeline_decode_stream", "dtype": "float32",
           "utterances": len(stream), "audio_seconds": round(stream_audio, 3),
           "chunk_frames": PIPE_CHUNK, "chunks": chunks,
           "wall_s": round(wall, 4), "rtf": stream_score["rtf"],
           "median_chunk_latency_ms":
               stream_score["median_chunk_latency_ms"],
           "k7_plan": plan._asdict(), "k7_launches": counts["lstm_stack"],
           "offline_k5_launches": off_counts["lstm_fwd"],
           "equal_to_offline_greedy": stream == offline,
           "label_error_rate_vs_offline": stream_score["label_error_rate"],
           "nonempty_share": sum(1 for v in stream.values() if v)
           / max(len(stream), 1)}
    emit(res)
    if (stream != offline or len(stream) != PIPE_STREAMS
            or counts["lstm_stack"] != chunks or off_counts["lstm_fwd"] < 5):
        fail(f"decode_stream: {res}")

    train = {}
    for dtype in DTYPES:
        steps = [r for r in train_records(exps[dtype])
                 if r["event"] == "train_step"]
        span = steps[-1]["t"] - steps[0]["t"]
        train[dtype] = {"steps_per_s": round((len(steps) - 1) / span, 3),
                        "audio_s_per_s": round(sum(
                            r["num_frames"] for r in steps[1:]) * 0.01
                            / span, 1)}
    emit({"phase": "pipeline_summary", "feature_rtf": feat_wall / audio_s,
          "train_ctc": train,
          "compute_prob_loss_per_frame": prob["loss_per_frame"],
          "decode_stream_rtf": stream_score["rtf"], "k7_route": plan.route,
          "card": smi})
    return launches


# the extras phase: the DS2 flagship's greedy decode, the 3x128 BLSTM's
# NG-SGD and realign runs on the pipeline phase's egs (recipes/medium's
# momentum and learning rate), align_ctc on its valid set, a uni LSTM
# 5x320 behind a pnorm FT front streamed, a spliced dropout run
EXTRAS_DECODE_UTTS, EXTRAS_STREAMS, NG_STEPS = 16, 8, 10
# the kernels slice 8's paths must launch: K2, K3, K1, K11, K10a, K10b,
# K5, K7
SLICE8_KERNELS = ("bilstm_fwd", "bilstm_bwd", "ctc_alpha_beta",
                  "ctc_alphas", "bilstm_proj_fwd", "bilstm_proj_bwd",
                  "lstm_fwd", "lstm_stack")
# the DS2 flagship's and the FT uni LSTM's width (a CPU rehearsal may set
# less)
EXTRAS_HIDDEN = 320
RECIPE_OPTS = ["--momentum", "0.9", "--initial-learning-rate", "1e-3"]
# align_ctc's mean path log-prob against the same CLI on the plain
# versions: sums of f32 log-softmax values of logits that differ by the
# kernels' f32 tolerance
ALIGN_LP_RTOL = 1e-4


def proj_step_launches(steps, cv_batches):
    """The launches of a train_ctc run of the 3x128 BLSTM in f32: per
    step layer 1 on K2/K3, layers 2-3 on K10a/K10b, K1 once; per cv
    batch the forwards and K11."""
    return {"bilstm_fwd": steps + cv_batches, "bilstm_bwd": steps,
            "bilstm_proj_fwd": 2 * (steps + cv_batches),
            "bilstm_proj_bwd": 2 * steps, "ctc_alpha_beta": steps,
            "ctc_alphas": cv_batches}


def timed_viterbi(torch, dev, seconds):
    """A context in which ``ops.ctc.ctc_viterbi_align`` adds its wall
    seconds (synchronised) to ``seconds[0]``."""
    from kaldi_ctc_tpu_torch.ops import ctc
    plain = ctc.ctc_viterbi_align

    def timed(*args, **kw):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = plain(*args, **kw)
        sync(torch, dev)
        seconds[0] += time.perf_counter() - t0
        return out

    @contextlib.contextmanager
    def swap():
        ctc.ctc_viterbi_align = timed
        try:
            yield
        finally:
            ctc.ctc_viterbi_align = plain
    return swap()


def phase_extras(torch, np, dev, smi):
    """Slice 8's paths through the port's CLIs on the card: decode_ctc
    greedy on the DS2 flagship per dtype against the plain path; the 3x128
    BLSTM trained by train_ctc --affine-type natural (its first step held
    to the plain versions, K11 in cv) and by train_ctc --realign-epochs 1
    (the realign fires and recomputes the lr decay horizon); align_ctc on
    the valid set against the plain path, then prepare_egs relabel
    --frame-labels 1 and adjust_priors --frame-labels 1 on its output; a
    uni LSTM 5x320 behind a pnorm FT front streamed by decode_stream (K7)
    and equal to its offline greedy decode (K5); one spliced train_ctc
    run with dropout → the launch counts of the CLI runs."""
    import shutil

    from kaldi_ctc_tpu_torch.cli import (adjust_priors, align_ctc,
                                         decode_ctc, decode_stream,
                                         init_model, prepare_egs, train_ctc)
    from kaldi_ctc_tpu_torch.data import EgsPipeline
    from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
    from kaldi_ctc_tpu_torch.models import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.parallel import make_mesh, shard_batch
    from kaldi_ctc_tpu_torch.training import (TrainOptions, build_train_step,
                                              exponential_lr,
                                              init_train_state)
    from kaldi_ctc_tpu_torch.training.checkpoint import save_checkpoint
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (SequentialIntVectorReader,
                                                    SequentialMatrixReader)

    pipe = os.path.join(ROOT, "build", "smoke", "pipeline")
    work = os.path.join(ROOT, "build", "smoke", "extras")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    device = ["--device", dev.type]
    launches = collections.Counter()
    summary = {"card": smi}
    with open(os.path.join(pipe, "feats.scp")) as f:
        scp_lines = f.readlines()
    feats = dict(SequentialMatrixReader(f"scp:{pipe}/feats.scp"))

    def subset(name, n):
        path = os.path.join(work, f"{name}.scp")
        with open(path, "w") as f:
            f.writelines(scp_lines[:n])
        return path, sum(feats[line.split()[0]].shape[0]
                         for line in scp_lines[:n]) * 0.01

    # 1. the DS2 flagship (init_model's defaults, as the decode phase's
    # flagship): decode_ctc greedy per dtype against the plain path
    scp, audio_s = subset("decode", EXTRAS_DECODE_UTTS)
    ds2 = {"float32": os.path.join(work, "exp_ds2")}
    run_cli(init_model.main, [
        "--dir", ds2["float32"], "--input-dim", "40", "--num-targets", "72",
        "--hidden-dim", str(EXTRAS_HIDDEN), "--num-layers", "5",
        "--conv-layers", "2", "--conv-channels", "32",
        "--conv-time-stride", "2"])
    ds2["bfloat16"] = ds2["float32"] + "_bf16"
    shutil.copytree(ds2["float32"], ds2["bfloat16"])
    cfg_path = os.path.join(ds2["bfloat16"], "model_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(cfg_path, "w") as f:
        json.dump({**cfg, "compute_dtype": "bfloat16"}, f)
    for dtype, exp in ds2.items():
        argv = ["--feats", f"scp:{scp}", "--dir", exp, "--method",
                "greedy", "--use-priors", "0"]
        hyp, plain_hyp = (os.path.join(work, f"ds2_{dtype}_{k}.txt")
                          for k in ("kernels", "plain"))
        _, counts, wall = cli_counts(decode_ctc.main, argv + [
            "--output", hyp] + device)
        launches.update(counts)
        _, plain_launches = plain_cli(decode_ctc.main, argv + [
            "--output", plain_hyp] + device)
        got, want = read_hyps(hyp), read_hyps(plain_hyp)
        res = {"phase": "extras_ds2_decode", "dtype": dtype,
               "model": "DS2 conv front (2 layers, 32 channels, time "
                        "stride 2) + 5x320 BLSTM, init_model --seed 0",
               "utterances": len(got), "audio_seconds": round(audio_s, 3),
               "wall_s": round(wall, 4), "rtf": wall / audio_s,
               "equal_to_plain": got == want,
               "utterances_equal": sum(got.get(k) == v
                                       for k, v in want.items()),
               "labels": sum(len(v) for v in got.values()),
               "k2_launches": counts["bilstm_fwd"]}
        emit(res)
        if (got != want or len(got) != EXTRAS_DECODE_UTTS or plain_launches
                or counts["bilstm_fwd"] != 5):
            fail(f"DS2 decode_ctc: {res}")

    # 2. the 3x128 BLSTM, train_ctc --affine-type natural, 10 steps, cv at
    # step 10; its first step against the plain versions
    proj = ["--egs", f"scp:{pipe}/train_egs.scp", "--num-targets", "72",
            "--hidden-dim", str(PROJ_H), "--num-layers", str(PROJ_LAYERS)]
    valid = ["--valid-feats", f"scp:{pipe}/feats.scp", "--valid-ali",
             f"ark:{pipe}/ali_valid.ark", "--cmvn", f"ark:{pipe}/cmvn.ark",
             "--utt2spk", f"{pipe}/utt2spk"]
    exp_ng = os.path.join(work, "exp_ng")
    epochs = NG_STEPS // (PIPE_TRAIN // 48)
    _, counts, wall = cli_counts(train_ctc.main, proj + valid + RECIPE_OPTS + [
        "--affine-type", "natural", "--epochs", str(epochs),
        "--cv-period", "1", "--dir", exp_ng] + device)
    launches.update(counts)
    recs = train_records(exp_ng)
    steps = [r for r in recs if r["event"] == "train_step"]
    examples = list(SequentialEgsReader(f"scp:{pipe}/train_egs.scp"))
    first = next(EgsPipeline(examples, minibatch_size=48).epoch(0))
    first.pop("keys")
    cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=PROJ_H,
                   num_layers=PROJ_LAYERS)
    opts = TrainOptions(initial_learning_rate=1e-3, momentum=0.9,
                        num_steps=NG_STEPS, affine_type="natural")
    state = init_train_state(train_ctc.initial_params(cfg, 0, dev), opts)
    with plain_versions():
        _, m = build_train_step(cfg, opts)(
            state, shard_batch(first, make_mesh(devices=[dev])))
    plain = {k: float(m[k]) for k in ("loss_per_frame", "grad_norm")}
    loss_rtol, grad_rtol, _ = TRAIN_TOL["float32"]
    rel = {k: abs(steps[0][k] - v) / abs(v) for k, v in plain.items()}
    span = steps[-1]["t"] - steps[0]["t"]
    want = proj_step_launches(NG_STEPS, 1)
    res = {"phase": "extras_train_ng", "dtype": "float32",
           "model": "3x128 BLSTM, 72 targets, --affine-type natural "
                    "(ranks 30 / 80)",
           "steps": len(steps), "wall_s": round(wall, 4),
           "steps_per_s": (len(steps) - 1) / span,
           "audio_s_per_s": sum(r["num_frames"] for r in steps[1:]) * 0.01
           / span,
           "loss_per_frame": [r["loss_per_frame"] for r in steps],
           "first_step_rel_err_vs_plain": rel,
           "tol": {"loss_per_frame": loss_rtol, "grad_norm": grad_rtol},
           "launches": {k: counts[k] for k in want}}
    emit(res)
    summary["train_ng"] = {k: res[k] for k in ("steps_per_s",
                                               "audio_s_per_s")}
    if (len(steps) != NG_STEPS or res["launches"] != want
            or rel["loss_per_frame"] > loss_rtol
            or rel["grad_norm"] > grad_rtol
            or not all(np.isfinite(r["loss_per_frame"]) for r in steps)):
        fail(f"train_ctc --affine-type natural: {res}")

    # 3. train_ctc --realign-epochs 1 --epochs 2 in minibatches of 16;
    # --max-allow-frames 500 keeps the long utterances out of the batches
    # but not out of the realignment, so the horizon changes
    exp_ra = os.path.join(work, "exp_realign")
    mb = 16
    _, counts, wall = cli_counts(train_ctc.main, proj + RECIPE_OPTS + [
        "--realign-epochs", "1", "--epochs", "2", "--minibatch-size",
        str(mb), "--max-allow-frames", "500", "--dir", exp_ra] + device)
    launches.update(counts)
    recs = train_records(exp_ra)
    steps = [r for r in recs if r["event"] == "train_step"]
    realign = [r for r in recs if r["event"] == "realign"]
    before = [r for r in steps if r["step"] <= realign[0]["step"]] \
        if realign else []
    old_horizon = (len(examples) // mb) * 2
    new_horizon = (realign[0]["step"] + realign[0]["aligned"] // mb
                   if realign else None)
    lr_opts = TrainOptions(initial_learning_rate=1e-3,
                           num_steps=new_horizon or old_horizon)
    lr_err = max((abs(r["lr"] - float(exponential_lr(lr_opts,
                                                     r["step"] - 1)))
                  / r["lr"] for r in steps if r not in before), default=1.0)
    realign_s = (realign[0]["t"] - before[-1]["t"]) if before else None
    res = {"phase": "extras_train_realign", "dtype": "float32",
           "steps": len(steps), "wall_s": round(wall, 4),
           "realign": realign, "realign_s": realign_s,
           "old_horizon": old_horizon, "new_horizon": new_horizon,
           "lr_rel_err_after_realign": lr_err,
           "priors_blank": float(np.load(os.path.join(exp_ra,
                                                      "priors.npy"))[0]),
           "launches": {k: counts[k] for k in proj_step_launches(0, 0)}}
    emit(res)
    summary["train_realign"] = {"realign_s": realign_s,
                                "steps": len(steps)}
    if (len(realign) != 1 or realign[0]["epoch"] != 1
            or new_horizon == old_horizon or lr_err > 1e-5
            or not os.path.exists(os.path.join(
                exp_ra, "realign_labels.host0.json"))
            or counts["ctc_alpha_beta"] != len(steps)):
        fail(f"train_ctc --realign-epochs: {res}")

    # 4. align_ctc on the valid set with the NG run's model, against the
    # plain path; its frame labels relabel the valid egs (a feasible
    # utterance keeps its labels) and give frame-occupancy priors
    valid_keys = [line.split()[0] for line in scp_lines[PIPE_TRAIN:]]
    valid_audio = sum(feats[k].shape[0] for k in valid_keys) * 0.01
    fl = os.path.join(work, "frame_labels.ark")
    align_argv = ["--feats", f"scp:{pipe}/feats.scp", "--ali",
                  f"ark:{pipe}/ali_valid.ark"] + valid[4:] + [
        "--dir", exp_ng, "--ctm", os.path.join(work, "ali.ctm")]
    viterbi_s = [0.0]
    with timed_viterbi(torch, dev, viterbi_s):
        out, counts, wall = cli_counts(align_ctc.main, align_argv + [
            "--frame-labels", f"ark:{fl}"] + device)
    launches.update(counts)
    summ = json.loads(out.strip().splitlines()[-1])
    out, plain_launches = plain_cli(align_ctc.main, align_argv + [
        "--frame-labels", f"ark:{work}/frame_labels_plain.ark"] + device)
    plain = json.loads(out.strip().splitlines()[-1])
    lp_rel = abs(summ["avg_logprob_per_frame"]
                 - plain["avg_logprob_per_frame"]) / abs(
                     plain["avg_logprob_per_frame"])
    run_cli(prepare_egs.main, [
        "relabel", "--egs", f"scp:{pipe}/valid_egs.scp", "--ali",
        f"ark:{fl}", "--frame-labels", "1", "--output",
        f"ark:{work}/relabeled.ark"])
    relabeled = {e.key: e.labels.tolist()
                 for e in SequentialEgsReader(f"ark:{work}/relabeled.ark")}
    originals = {e.key: e.labels.tolist()
                 for e in SequentialEgsReader(f"scp:{pipe}/valid_egs.scp")}
    prior_exp = os.path.join(work, "exp_priors")
    shutil.copytree(exp_ng, prior_exp)
    run_cli(adjust_priors.main, ["--dir", prior_exp, "--ali", f"ark:{fl}",
                                 "--frame-labels", "1"] + device)
    priors = np.load(os.path.join(prior_exp, "priors.npy"))
    occupancy = np.zeros(72)
    for _, v in SequentialIntVectorReader(f"ark:{fl}"):
        occupancy += np.bincount(np.asarray(v), minlength=72)[:72]
    prior_err = float(np.abs(priors - np.maximum(
        occupancy / occupancy.sum(), 1e-15)).max())
    res = {"phase": "extras_align", "dtype": "float32", **summ,
           "wall_s": round(wall, 4), "audio_seconds": round(valid_audio, 3),
           "rtf": wall / valid_audio,
           "viterbi_s": round(viterbi_s[0], 4),
           "viterbi_share_of_wall": viterbi_s[0] / wall,
           "avg_logprob_rel_err_vs_plain": lp_rel, "tol": ALIGN_LP_RTOL,
           "relabeled_equal_to_egs_labels": relabeled == originals,
           "frame_label_priors_max_abs_err": prior_err,
           "launches": {k: counts[k] for k in ("bilstm_fwd",
                                               "bilstm_proj_fwd")}}
    emit(res)
    summary["align_ctc"] = {k: res[k] for k in ("rtf",
                                                "viterbi_share_of_wall")}
    if (summ["aligned"] != len(valid_keys) or summ["failed"]
            or plain["aligned"] != summ["aligned"] or lp_rel > ALIGN_LP_RTOL
            or plain_launches or relabeled != originals or prior_err > 1e-6
            or counts["bilstm_proj_fwd"] < 2):
        fail(f"align_ctc: {res}")

    # 5. a uni LSTM 5x320 behind a pnorm FT front (group 2), init_model's
    # stddevs: decode_stream (K7 a chunk) equal to decode_ctc's offline
    # greedy labels (K5).  (At stddev 0.3 the stack amplifies the two
    # kernels' f32 summation orders over hundreds of frames: the first
    # card run's labels differed.)
    cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=EXTRAS_HIDDEN,
                   num_layers=5, bidirectional=False,
                   front_affine_dim=EXTRAS_HIDDEN, front_nonlin="pnorm",
                   front_group=2)
    exp_ft = os.path.join(work, "exp_ft")
    os.makedirs(exp_ft)
    with open(os.path.join(exp_ft, "model_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    save_checkpoint(os.path.join(exp_ft, "checkpoints"), 0, init_train_state(
        init_am_params(cfg, torch.Generator().manual_seed(0))),
        extra={"epoch": 0, "num_layers": 5})
    scp, stream_audio = subset("stream", EXTRAS_STREAMS)
    paths = {m: os.path.join(work, f"ft_{m}.txt")
             for m in ("stream", "offline")}
    _, off_counts, _ = cli_counts(decode_ctc.main, [
        "--feats", f"scp:{scp}", "--dir", exp_ft, "--method", "greedy",
        "--use-priors", "0", "--output", paths["offline"]] + device)
    launches.update(off_counts)
    out, counts, wall = cli_counts(decode_stream.main, [
        "--feats", f"scp:{scp}", "--dir", exp_ft, "--chunk-frames",
        str(PIPE_CHUNK), "--output", paths["stream"], "--text",
        paths["offline"]] + device)
    launches.update(counts)
    score = json.loads(out.strip().splitlines()[-1])
    stream, offline = read_hyps(paths["stream"]), read_hyps(paths["offline"])
    chunks = sum(-(-feats[line.split()[0]].shape[0] // PIPE_CHUNK)
                 for line in scp_lines[:EXTRAS_STREAMS])
    res = {"phase": "extras_ft_stream", "dtype": "float32",
           "model": "FT front 40 -> 640 pnorm group 2 -> 320, uni LSTM "
                    "5x320",
           "utterances": len(stream), "audio_seconds": round(stream_audio,
                                                             3),
           "chunk_frames": PIPE_CHUNK, "chunks": chunks,
           "wall_s": round(wall, 4), "rtf": score["rtf"],
           "median_chunk_latency_ms": score["median_chunk_latency_ms"],
           "equal_to_offline_greedy": stream == offline,
           "labels": sum(len(v) for v in stream.values()),
           "k7_launches": counts["lstm_stack"],
           "offline_k5_launches": off_counts["lstm_fwd"]}
    emit(res)
    summary["ft_stream"] = {k: res[k] for k in ("rtf",
                                                "median_chunk_latency_ms")}
    if (stream != offline or len(stream) != EXTRAS_STREAMS
            or counts["lstm_stack"] != chunks or off_counts["lstm_fwd"] < 5
            or not res["labels"]):
        fail(f"FT-front decode_stream: {res}")

    # 6. the 3x128 BLSTM with --dropout 0.1 --splice-left 2 --splice-right
    # 2: one epoch (layer 1 on K2/K3 at D = 200, layers 2-3 on K10a/K10b)
    exp_sp = os.path.join(work, "exp_splice_dropout")
    _, counts, wall = cli_counts(train_ctc.main, proj + RECIPE_OPTS + [
        "--dropout", "0.1", "--splice-left", "2", "--splice-right", "2",
        "--epochs", "1", "--dir", exp_sp] + device)
    launches.update(counts)
    steps = [r for r in train_records(exp_sp) if r["event"] == "train_step"]
    want = proj_step_launches(len(steps), 0)
    res = {"phase": "extras_train_splice_dropout", "dtype": "float32",
           "steps": len(steps), "wall_s": round(wall, 4),
           "loss_per_frame": [r["loss_per_frame"] for r in steps],
           "launches": {k: counts[k] for k in want}}
    emit(res)
    if (not steps or res["launches"] != want
            or not all(np.isfinite(r["loss_per_frame"]) for r in steps)):
        fail(f"train_ctc --dropout --splice: {res}")
    emit({"phase": "extras_summary", **summary})
    return launches


# the kernels slice 9's training run launches: K2, K3, K1 and K11 (cv)
SLICE9_KERNELS = ("bilstm_fwd", "bilstm_bwd", "ctc_alpha_beta", "ctc_alphas")
# the distributed phase: the pipeline's f32 train_ctc (the flagship, 10
# steps, cv at step 10) in one process with no process group, then with
# one NCCL rank on cuda:0; the one-rank all-reduce is an identity, so the
# final checkpoints agree to DIST_CKPT_ATOL (f32; expected 0, the
# difference is printed)
DIST_CKPT_ATOL = 1e-5
# the launched runs and the dry run start python processes: their limits
DIST_SUBPROCESS_S = 300


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def final_leaves(exp):
    """The leaves and meta of the latest checkpoint in exp/checkpoints."""
    ckpt = os.path.join(exp, "checkpoints")
    step = max(int(n.split("_")[1]) for n in os.listdir(ckpt)
               if n.startswith("step_") and not n.endswith(".tmp"))
    import numpy as np
    with np.load(os.path.join(ckpt, f"step_{step}", "arrays.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    with open(os.path.join(ckpt, f"step_{step}", "meta.json")) as f:
        return leaves, json.load(f)


def port_subprocess(argv, timeout):
    """``python -m`` a module of the port from the checkout → the
    completed process (output captured)."""
    import kaldi_ctc_tpu_torch
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(kaldi_ctc_tpu_torch.__file__))]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m"] + argv, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def step_collective_ms(torch, dev, calls=20):
    """The collective work the step adds on a one-rank NCCL group, timed
    with CUDA events: ``sum_over_data`` over the flagship's gradient
    leaves (10.8 M f32), the loss and the frame count (the flat copy in,
    the all-reduce, the views out)."""
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.models.acoustic import am_param_shapes
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.parallel import distributed, make_mesh
    from kaldi_ctc_tpu_torch.parallel.mesh import sum_over_data

    distributed.init_distributed(f"localhost:{free_port()}", 1, 0,
                                 device=dev.type)
    try:
        shapes = tree_flatten(am_param_shapes(AmConfig(
            input_dim=40, num_targets=72, hidden_dim=PIPE_HIDDEN,
            num_layers=PIPE_LAYERS)))
        grads = [torch.randn(s, device=dev) for s in shapes]
        extra = [torch.ones((), device=dev), torch.ones((), device=dev)]
        mesh = make_mesh()
        for _ in range(3):
            sum_over_data(mesh, grads + extra)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(calls):
            sum_over_data(mesh, grads + extra)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / calls
        n = sum(g.numel() for g in grads)
    finally:
        distributed.shutdown()
    return {"ms": ms, "parameters": n, "bytes": 4 * n,
            "calls": calls, "backend": "nccl", "ranks": 1}


def phase_distributed(torch, np, dev, smi):
    """Multi-process training on torch.distributed with the card's one
    rank: the pipeline's f32 train_ctc with no process group and with one
    NCCL rank (COORDINATOR_ADDRESS, PROCESS_ID=0, NUM_PROCESSES=1), in
    pairs (none, NCCL, none): the
    backend NCCL, K2, K3, K1 and K11 launched as in the pipeline phase,
    the final checkpoints equal to DIST_CKPT_ATOL, steps/s of both; then
    ``launch --num-processes 1 -- train_ctc`` as a subprocess (exit 0, a
    final checkpoint); ``dryrun_multichip(1)`` on the card; and one rank
    more than the cards launched, which must exit non-zero with the NCCL
    device-count error (time-limited) → the launches of the NCCL run."""
    import shutil

    from kaldi_ctc_tpu_torch.cli import train_ctc
    from kaldi_ctc_tpu_torch.parallel import distributed
    from kaldi_ctc_tpu_torch.parallel.dryrun import dryrun_multichip

    pipe = os.path.join(ROOT, "build", "smoke", "pipeline")
    work = os.path.join(ROOT, "build", "smoke", "distributed")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argv = pipeline_train_argv(pipe) + ["--device", dev.type]
    env_keys = ("COORDINATOR_ADDRESS", "PROCESS_ID", "NUM_PROCESSES")
    groups = []
    init = distributed.init_distributed

    def recording_init(*args, **kw):
        device = init(*args, **kw)
        groups.append((torch.distributed.get_backend()
                       if torch.distributed.is_initialized() else None,
                       distributed.process_count(), str(device)))
        return device

    runs, launches = {}, collections.Counter()
    distributed.init_distributed = recording_init
    try:
        # two runs with no group, two on one NCCL rank, two with no group
        # after them: the host's noise shows as the spread of each pair,
        # and whatever a group leaves in the process as the last pair's
        for name in ("no_group", "no_group_2", "nccl_one_rank",
                     "nccl_one_rank_2", "no_group_3", "no_group_4"):
            exp = os.path.join(work, name)
            if name.startswith("nccl"):
                os.environ.update(
                    COORDINATOR_ADDRESS=f"localhost:{free_port()}",
                    PROCESS_ID="0", NUM_PROCESSES="1")
            try:
                _, counts, wall = cli_counts(train_ctc.main,
                                             argv + ["--dir", exp])
            finally:
                for key in env_keys:
                    os.environ.pop(key, None)
            steps = [r for r in train_records(exp)
                     if r["event"] == "train_step"]
            span = steps[-1]["t"] - steps[0]["t"]
            runs[name] = {
                "steps": len(steps), "wall_s": round(wall, 4),
                "steps_per_s": (len(steps) - 1) / span if span > 0 else None,
                "group": groups[-1],
                "launches": {k: counts[k] for k in (
                    "bilstm_fwd", "bilstm_bwd", "ctc_alpha_beta",
                    "ctc_alphas")}}
            if name == "nccl_one_rank":
                launches.update(counts)
    finally:
        distributed.init_distributed = init
    finals = {n: final_leaves(os.path.join(work, n)) for n in runs}
    a, meta_a = finals["no_group"]
    ckpt_diff = max(float(np.abs(x - y).max()) for n in runs
                    for x, y in zip(a, finals[n][0]))
    res = {"phase": "distributed_train_ctc", "card": smi, "dtype": "float32",
           "runs": runs, "final_checkpoint_max_abs_diff": ckpt_diff,
           "tol": DIST_CKPT_ATOL,
           "group_left": not torch.distributed.is_initialized(),
           "step_collective": step_collective_ms(torch, dev)}
    emit(res)
    nccl = runs["nccl_one_rank"]
    b, meta_b = finals["nccl_one_rank"]
    if (any(runs[n]["group"] != ("nccl", 1, "cuda:0")
            for n in runs if n.startswith("nccl"))
            or any(runs[n]["group"][0] is not None
                   for n in runs if n.startswith("no_group"))
            or any(r["steps"] != 10 for r in runs.values())
            or any(r["launches"] != nccl["launches"] for r in runs.values())
            or nccl["launches"]["bilstm_bwd"] != PIPE_LAYERS * 10
            or nccl["launches"]["ctc_alpha_beta"] != 10
            or nccl["launches"]["ctc_alphas"] != 1
            or nccl["launches"]["bilstm_fwd"] != PIPE_LAYERS * 11
            or len(a) != len(b) or meta_a["step"] != meta_b["step"]
            or not meta_b["extra"].get("final")
            or ckpt_diff > DIST_CKPT_ATOL or not res["group_left"]):
        fail(f"train_ctc on one NCCL rank: {res}")

    # the launcher: one process on the card, one epoch (2 steps)
    short = pipeline_train_argv(pipe)[:2] + [
        "--num-targets", "72", "--hidden-dim", str(PIPE_HIDDEN),
        "--num-layers", str(PIPE_LAYERS), "--epochs", "1",
        "--device", dev.type]
    exp = os.path.join(work, "launched")
    t0 = time.perf_counter()
    proc = port_subprocess([
        "kaldi_ctc_tpu_torch.cli.launch", "--num-processes", "1", "--",
        sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.train_ctc"]
        + short + ["--dir", exp], DIST_SUBPROCESS_S)
    launch_s = time.perf_counter() - t0
    ok = proc.returncode == 0 and os.path.isdir(os.path.join(
        exp, "checkpoints")) and final_leaves(exp)[1]["extra"].get("final")
    # one rank more than the cards: every rank raises before any rendezvous
    ranks = torch.cuda.device_count() + 1
    t0 = time.perf_counter()
    over = port_subprocess([
        "kaldi_ctc_tpu_torch.cli.launch", "--num-processes", str(ranks),
        "--", sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.train_ctc"]
        + short + ["--dir", os.path.join(work, "over")], DIST_SUBPROCESS_S)
    over_s = time.perf_counter() - t0
    refused = (over.returncode != 0 and "NCCL cannot put two ranks on one "
               "device" in over.stderr and not os.path.isdir(
                   os.path.join(work, "over", "checkpoints")))
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, device=dev.type, timeout=DIST_SUBPROCESS_S)
    dry_s = time.perf_counter() - t0
    res = {"phase": "distributed_launch", "card": smi,
           "launch_one_rank": {"rc": proc.returncode,
                               "wall_s": round(launch_s, 3),
                               "final_checkpoint": bool(ok)},
           "ranks_over_cards": {"ranks": ranks, "rc": over.returncode,
                                "wall_s": round(over_s, 3),
                                "refused": refused},
           "dryrun_multichip_1": {"wall_s": round(dry_s, 3),
                                  "flagship_loss": float(
                                      dry[0]["flagship"][0]),
                                  "ds2_loss": float(dry[0]["ds2"][0])},
           "scaling_across_cards": "not measurable on one card"}
    emit(res)
    if not ok:
        fail(f"launch -- train_ctc: {res}\n{proc.stderr[-3000:]}")
    if not refused:
        fail(f"{ranks} ranks on {ranks - 1} card(s) did not refuse: {res}"
             f"\n{over.stderr[-3000:]}")
    return launches


# the lattice phase: decode_ctc --lattice --determinize 1 on a flagship
# of the decode phase's width (5x320 BLSTM, f32, init_model seed 0) over
# its DECODE_UTTS utterances on the word loop and 4 on the 2,000-word lexicon
# graph.  Its weights are drawn at LATTICE_STDDEV: at init_model's 0.02
# the posteriors are nearly flat (greedy and the WFST decode one label or
# word an utterance, PR 15), so a word-loop lattice holds nearly every
# label sequence; from ~0.3 the 5x320 stack amplifies the f32 summation
# orders into other labels (PR 17).  The lattice beam (also the
# determinization beam) and max-active bound the lattices.  The kernel
# path's lattices are held to the plain path's (the CPU forward): equal
# best paths or, where two differ, best-path costs within
# DECODE_COST_RTOL of each other (a near tie under the two forwards' f32
# sums), and every best-path cost within DECODE_COST_RTOL.
LATTICE_STDDEV = 0.1
LATTICE_FLAGS = {
    "word_loop": ["--lattice-beam", "2", "--max-active", "1000"],
    "lexicon": ["--lattice-beam", "2", "--max-active", "1000",
                "--wfst-beam", "12"]}
LATTICE_LEX_UTTS = 4
# lattice_tool lmrescore: the ARPA model and its const-ARPA form (f32
# log-probabilities) give graph costs within this
LMRESCORE_ATOL = 1e-3


def bigram_arpa(np, words, seed, bigrams):
    """A seeded bigram ARPA over ``words``: every unigram with a backoff,
    ``bigrams`` random word pairs (and <s> and </s> ones)."""
    rng = np.random.default_rng(seed)
    uni = ["<s>", "</s>"] + list(words)
    lines = [f"{-rng.uniform(0.5, 4.0):.4f} {w}"
             + ("" if w == "</s>" else f" {-rng.uniform(0.1, 0.5):.4f}")
             for w in uni]
    left = ["<s>"] + list(words)
    right = list(words) + ["</s>"]
    pairs = sorted({(left[int(i)], right[int(j)]) for i, j in zip(
        rng.integers(0, len(left), bigrams),
        rng.integers(0, len(right), bigrams))})
    bi = [f"{-rng.uniform(0.1, 2.0):.4f} {a} {b}" for a, b in pairs]
    return ("\\data\\\n" f"ngram 1={len(lines)}\n" f"ngram 2={len(bi)}\n\n"
            "\\1-grams:\n" + "\n".join(lines) + "\n\n\\2-grams:\n"
            + "\n".join(bi) + "\n\n\\end\\\n")


def phase_lattice(torch, np, dev, smi):
    """Lattice output and its tools on a 5x320 BLSTM flagship drawn at
    LATTICE_STDDEV, over the decode phase's features and graphs:
    ``decode_ctc --method wfst --lattice --determinize 1`` on the card
    (K2) and on the CPU's plain path, over the word loop (DECODE_UTTS)
    and the lexicon graph (4), the best paths and costs compared; then
    ``score_lattices`` (an lm-weight sweep) on the word-loop lattices,
    ``lattice_tool best-path`` and ``mbr`` on them, ``align-words`` on
    the lexicon lattices with the lexicon (unalignable ones passed
    through, as its default), and ``lmrescore`` with a
    seeded bigram ARPA over the lexicon's words and its const-ARPA form
    (the two within LMRESCORE_ATOL) → the launches of the card's
    decodes."""
    import shutil

    from kaldi_ctc_tpu_torch.cli import (decode_ctc, init_model,
                                         lattice_tool, score_lattices)
    from kaldi_ctc_tpu_torch.decoding.det_lattice import \
        read_compact_lattice_text_ark
    from kaldi_ctc_tpu_torch.lm import parse_arpa
    from kaldi_ctc_tpu_torch.lm.const_arpa import compile_const_arpa
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    dec = os.path.join(ROOT, "build", "smoke", "decode")
    work = os.path.join(ROOT, "build", "smoke", "lattice")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    exp = os.path.join(work, "exp")
    run_cli(init_model.main, [
        "--dir", exp, "--input-dim", "40", "--num-targets", "72",
        "--hidden-dim", str(DECODE_HIDDEN), "--num-layers", "5", "--seed",
        "0", "--param-stddev", str(LATTICE_STDDEV)])
    with open(os.path.join(dec, "feats.scp")) as f:
        scp = f.readlines()
    with open(os.path.join(work, "feats_lex.scp"), "w") as f:
        f.writelines(scp[:LATTICE_LEX_UTTS])
    frames = {k: m.shape[0] for k, m in SequentialMatrixReader(
        f"scp:{dec}/feats.scp")}
    launches = collections.Counter()
    summary, lats = {"card": smi}, {}
    for graph, feats in (("word_loop", os.path.join(dec, "feats.scp")),
                         ("lexicon", os.path.join(work, "feats_lex.scp"))):
        gpath = os.path.join(dec, f"{graph}.fst")
        base = ["--feats", f"scp:{feats}", "--dir", exp, "--method", "wfst",
                "--graph", gpath, "--words", gpath + ".words.txt",
                "--determinize", "1"] + LATTICE_FLAGS[graph]
        got = {}
        for path_of, device in (("plain", "cpu"), ("kernels", dev.type)):
            lat = os.path.join(work, f"{graph}_{path_of}.lat")
            hyp = os.path.join(work, f"{graph}_{path_of}.hyp")
            extra = ["--device", device, "--lattice", lat, "--output", hyp]
            if path_of == "kernels":
                # the plain path's hypotheses as the reference text
                extra += ["--text", os.path.join(work, f"{graph}_plain.hyp")]
            out, counts, wall = cli_counts(decode_ctc.main, base + extra)
            if path_of == "plain":
                if any(counts.values()):
                    fail(f"the plain decode launched kernels: {counts}")
            else:
                launches.update(counts)
                score = json.loads(out.strip().splitlines()[-1])
            got[path_of] = dict(read_compact_lattice_text_ark(lat))
        lats[graph] = os.path.join(work, f"{graph}_kernels.lat")
        keys = sorted(got["plain"])
        best = {p: {k: got[p][k].best_path() for k in keys} for p in got}
        differ = [k for k in keys if list(best["plain"][k][0])
                  != list(best["kernels"][k][0])]
        rel = {k: abs(best["kernels"][k][2] - best["plain"][k][2])
               / max(abs(best["plain"][k][2]), 1e-30) for k in keys}
        audio_s = sum(frames[k] for k in keys) * 0.01
        res = {"phase": "lattice_decode", "graph": graph,
               "flags": LATTICE_FLAGS[graph], "utterances": len(keys),
               "audio_seconds": round(audio_s, 3),
               "card_wall_s": round(wall, 4), "rtf": score["rtf"],
               "k2_launches": counts["bilstm_fwd"],
               "states": sum(got["kernels"][k].num_states for k in keys),
               "arcs": sum(got["kernels"][k].num_arcs for k in keys),
               "plain_states": sum(got["plain"][k].num_states for k in keys),
               "best_paths_differ": len(differ),
               "max_best_cost_rel_diff": max(rel.values()),
               "tol": DECODE_COST_RTOL,
               "label_error_rate_vs_plain": score["label_error_rate"]}
        emit(res)
        summary[graph] = {k: res[k] for k in ("rtf", "audio_seconds",
                                              "best_paths_differ")}
        if (sorted(got["kernels"]) != keys or len(keys) != (
                DECODE_UTTS if graph == "word_loop" else LATTICE_LEX_UTTS)
                or counts["bilstm_fwd"] < PIPE_LAYERS
                or res["max_best_cost_rel_diff"] > DECODE_COST_RTOL
                or not all(best["plain"][k][0].size for k in keys)):
            fail(f"decode_ctc --lattice: {res}; {differ[:4]}")

    # the word loop's lattices: an lm-weight sweep, best path and MBR
    wl_words = os.path.join(dec, "word_loop.fst.words.txt")
    sweep = run_cli(score_lattices.main, [
        "--lattices", lats["word_loop"], "--compact", "1", "--text",
        os.path.join(work, "word_loop_plain.hyp"), "--words", wl_words,
        "--min-lmwt", "1", "--max-lmwt", "5"])
    sweep = [json.loads(line) for line in sweep.strip().splitlines()]
    bp = os.path.join(work, "best_path.txt")
    run_cli(lattice_tool.main, [
        "best-path", "--lattices", lats["word_loop"], "--compact", "1",
        "--words", wl_words, "--output", bp])
    mbr = os.path.join(work, "mbr.txt")
    run_cli(lattice_tool.main, [
        "mbr", "--lattices", lats["word_loop"], "--words", wl_words,
        "--output", mbr, "--ctm", mbr + ".ctm"])
    card_hyps = read_hyps(os.path.join(work, "word_loop_kernels.hyp"))
    bp_hyps, mbr_hyps = read_hyps(bp), read_hyps(mbr)

    # the lexicon's lattices: word alignment and LM rescoring
    _, prons = lexicon_prons(np, 70)
    lexicon = os.path.join(work, "lexicon.txt")
    with open(lexicon, "w") as f:
        f.writelines(f"w{w} {' '.join(f'p{int(x)}' for x in labels)}\n"
                     for w, labels in enumerate(prons, 1))
    phones = os.path.join(work, "phones.txt")
    with open(phones, "w") as f:
        f.writelines(f"p{i} {i}\n" for i in range(1, 72))
    lex_words = os.path.join(dec, "lexicon.fst.words.txt")
    aligned = os.path.join(work, "aligned.lat")
    run_cli(lattice_tool.main, [
        "align-words", "--lattices", lats["lexicon"], "--output", aligned,
        "--lexicon", lexicon, "--words", lex_words, "--phones", phones])
    arpa = os.path.join(work, "bigram.arpa")
    with open(arpa, "w") as f:
        f.write(bigram_arpa(np, [f"w{w}" for w in range(1, LEX_WORDS + 1)],
                            71, 20 * LEX_WORDS))
    const = os.path.join(work, "bigram.npz")
    compile_const_arpa(parse_arpa(arpa)).save(const)
    rescored = {}
    for kind, flag, lm in (("arpa", "--arpa", arpa),
                           ("const_arpa", "--const-arpa", const)):
        rescored[kind] = os.path.join(work, f"rescored_{kind}.lat")
        t0 = time.perf_counter()
        run_cli(lattice_tool.main, [
            "lmrescore", "--lattices", lats["lexicon"], flag, lm, "--words",
            lex_words, "--lm-scale", "0.5", "--output", rescored[kind]])
        summary[f"lmrescore_{kind}_s"] = round(time.perf_counter() - t0, 4)
    resc = {k: dict(read_compact_lattice_text_ark(p))
            for k, p in rescored.items()}
    lex_in = dict(read_compact_lattice_text_ark(lats["lexicon"]))
    lm_diff = max(abs(a - b) for k in resc["arpa"] for a, b in zip(
        resc["arpa"][k].arc_graph_cost + resc["arpa"][k].final_graph_cost,
        resc["const_arpa"][k].arc_graph_cost
        + resc["const_arpa"][k].final_graph_cost)
        if math.isfinite(a) or math.isfinite(b))
    moved = sum(resc["arpa"][k].best_path()[2] != lex_in[k].best_path()[2]
                for k in lex_in)
    aligned_lats = dict(read_compact_lattice_text_ark(aligned))
    res = {"phase": "lattice_tools", **summary,
           "score_lattices": sweep[-1],
           "best_path_equal_decode": bp_hyps == card_hyps,
           "mbr_utterances": len(mbr_hyps),
           "aligned_lattices": len(aligned_lats),
           # the random lexicon's words repeat labels, which the dropped
           # blank-threshold frames can merge: some paths do not align
           "aligned_best_words_kept": sum(
               list(aligned_lats[k].best_path()[0])
               == list(lex_in[k].best_path()[0]) for k in aligned_lats),
           "lmrescore_arpa_vs_const_max_abs": lm_diff,
           "lmrescore_tol": LMRESCORE_ATOL,
           "lmrescore_costs_moved": moved}
    emit(res)
    if (len(sweep) != 6 or "best_wer" not in sweep[-1]
            or not res["best_path_equal_decode"]
            or len(mbr_hyps) != len(card_hyps)
            or sorted(aligned_lats) != sorted(lex_in)
            or lm_diff > LMRESCORE_ATOL or moved != len(lex_in)
            or sorted(resc["const_arpa"]) != sorted(lex_in)):
        fail(f"the lattice tools: {res}")
    return launches


# slice 10: the librispeech_ctc recipe of the port at the flagship's width
# (71 phones: 72 targets, the 5x320 BLSTM, bf16, B=48, fs 3) on the
# corpus of its make_synth_data.py (vocab 150, 80 train and 16 test
# utterances), cut in depth to RECIPE_EPOCHS epochs of 2 steps; then the
# triphone chain on the same corpus (a tree of TRI_LEAVES leaves, f32
# train_ctc for TRI_EPOCHS epochs) and the LM and graph tools.  The
# decodes search at RECIPE_WFST_BEAM (run.sh: 20) and keep lattices at
# RECIPE_LATTICE_BEAM (run.sh: 10): the barely trained models' near-flat
# posteriors make the host's search and lattices the phase's cost.  Egs
# in RECIPE_ARCHIVES archives (run.sh: 16): with 1, run.sh's sort loop
# finds no egs.1.ark (get expands JOB only for 2 or more).
RECIPE_PHONES = 71
RECIPE_EPOCHS, TRI_EPOCHS, TRI_LEAVES = 4, 3, 200
RECIPE_ARCHIVES, RECIPE_WFST_BEAM, RECIPE_LATTICE_BEAM = 2, 12, 2
# decode_ctc's flags in the librispeech run.sh's stage 3 (its blank
# threshold 0.98) with the beams above
RECIPE_DECODE = ["--method", "wfst", "--wfst-beam", str(RECIPE_WFST_BEAM),
                 "--lattice-beam", str(RECIPE_LATTICE_BEAM),
                 "--blank-threshold", "0.98", "--frame-subsampling-factor",
                 "3"]
RECIPE_STAGE_S = 900
SLICE10_KERNELS = ("log_mel", "bilstm_fwd", "bilstm_bwd", "ctc_alpha_beta",
                   "ctc_alphas")
# every python process of the recipe's scripts loads this as
# sitecustomize (its directory is first on PYTHONPATH) and, where it
# loaded the port, appends its argv, wall seconds and launch counts to
# the file that $SMOKE_LAUNCHES names: the counters live in each process
LAUNCH_HOOK = '''import atexit, json, os, sys, time
_T0 = time.perf_counter()


def _report():
    if "kaldi_ctc_tpu_torch" not in sys.modules:
        return
    sys.path.insert(0, {root!r})
    import chip_smoke
    rec = {{"argv": sys.argv, "wall_s": time.perf_counter() - _T0,
            "counts": chip_smoke.read_counts()}}
    with open(os.environ["SMOKE_LAUNCHES"], "a") as f:
        f.write(json.dumps(rec) + "\\n")


atexit.register(_report)
'''


def run_logged(cmd, env, timeout, ok=(0,)):
    """A command in a subprocess → (its completed process, wall seconds);
    fails the run unless it exits with a code in ``ok``."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"{cmd[:4]} ran past {timeout} s")
    wall = time.perf_counter() - t0
    if r.returncode not in ok:
        fail(f"{cmd[:4]} exited {r.returncode}: {r.stdout[-2000:]} "
             f"{r.stderr[-3000:]}")
    return r, wall


class LogLines(logging.Handler):
    """Keeps each record's message (a host CLI run in this process logs
    its summary rather than printing it)."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def tlg_line(text):
    """graph_tool make-tlg's log line → {states, arcs, stage seconds}."""
    import ast
    import re
    m = re.search(r"TLG: (\d+) states / (\d+) arcs .*stage seconds: "
                  r"(\{.*\})", text)
    if not m:
        fail(f"no make-tlg line in: {text[-2000:]}")
    return {"states": int(m.group(1)), "arcs": int(m.group(2)),
            "stage_seconds": ast.literal_eval(m.group(3))}


def best_costs(path, keys):
    """Each utterance's best-path cost in a lattice text archive."""
    from kaldi_ctc_tpu_torch.decoding.lattice import read_lattice_text_ark
    lats = dict(read_lattice_text_ark(path))
    return {k: lats[k].best_path()[2] for k in keys}


def hold_to_plain(name, card_hyp, plain_hyp, card_lat, plain_lat):
    """The card's decode against the plain path's: equal best paths, or
    best-path costs within DECODE_COST_RTOL where a near-tie flips (PR
    18's lattice rule) → the utterances that differ."""
    card, plain = read_hyps(card_hyp), read_hyps(plain_hyp)
    if sorted(card) != sorted(plain) or not card:
        fail(f"{name}: the card decoded {sorted(card)}, the plain path "
             f"{sorted(plain)}")
    differ = [k for k in plain if card[k] != plain[k]]
    rel = 0.0
    if differ:
        got = best_costs(card_lat, differ)
        want = best_costs(plain_lat, differ)
        rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                  for k in differ)
        if rel > DECODE_COST_RTOL:
            fail(f"{name}: best paths differ on {differ[:4]} with "
                 f"best-path costs {rel} apart")
    return {"utterances": len(card), "best_paths_differ": len(differ),
            "max_best_cost_rel_diff": rel, "tol": DECODE_COST_RTOL}


def steps_per_s(exp):
    """train_ctc's steps/s over its train_step records (from the first
    step's end to the last's)."""
    steps = [r for r in train_records(exp) if r.get("event") == "train_step"]
    if len(steps) < 2:
        fail(f"{exp}: {len(steps)} train steps")
    return (len(steps) - 1) / max(steps[-1]["t"] - steps[0]["t"], 1e-9)


def triphone_host_stages(np, ls, tri):
    """The triphone chain's host stages in this process: phone-id
    alignments (pdf + 1), tree_tool acc-stats, sum-stats, questions,
    build and info, then prepare_egs get --tree → (tree info, egs, walls).
    """
    from kaldi_ctc_tpu_torch.cli import prepare_egs, tree_tool
    from kaldi_ctc_tpu_torch.utils import kaldi_io

    os.makedirs(tri)
    data = os.path.join(ls, "data")
    t0 = time.perf_counter()
    with kaldi_io.IntVectorWriter(f"ark:{tri}/ali.phones.ark") as w:
        for key, pdfs in kaldi_io.SequentialIntVectorReader(
                f"ark:{ls}/ali/ali.pdf.ark"):
            w[key] = np.asarray(pdfs, np.int32) + 1     # pdf = phone - 1
    tr = os.path.join(data, "train")
    run_cli(tree_tool.main, ["acc-stats", "--feats", f"scp:{tr}/feats.scp",
                             "--ali", f"ark:{tri}/ali.phones.ark",
                             "--output", f"{tri}/stats.npz"])
    run_cli(tree_tool.main, ["sum-stats", f"{tri}/stats.npz", "--output",
                             f"{tri}/sum.npz"])
    run_cli(tree_tool.main, ["questions", "--stats", f"{tri}/sum.npz",
                             "--output", f"{tri}/questions.int"])
    run_cli(tree_tool.main, ["build", "--stats", f"{tri}/sum.npz",
                             "--questions", f"{tri}/questions.int",
                             "--max-leaves", str(TRI_LEAVES),
                             "--num-phones", str(RECIPE_PHONES),
                             "--output", f"{tri}/tree"])
    tree = json.loads(run_cli(tree_tool.main, [
        "info", "--tree", f"{tri}/tree"]).strip().splitlines()[-1])
    tri_walls = {"tree_tool": time.perf_counter() - t0}
    t0 = time.perf_counter()
    run_cli(prepare_egs.main, [
        "get", "--feats", f"scp:{tr}/feats.scp", "--cmvn",
        f"scp:{tr}/cmvn.scp", "--utt2spk", f"{tr}/utt2spk", "--text",
        f"{tr}/text", "--lexicon", f"{ls}/lexicon.txt", "--phones",
        f"{ls}/phones.txt", "--tree", f"{tri}/tree", "--output",
        f"ark,scp:{tri}/egs.ark,{tri}/egs.scp"])
    tri_walls["prepare_egs"] = time.perf_counter() - t0
    with open(f"{tri}/egs.scp") as f:
        n_egs = len(f.readlines())
    return tree, n_egs, tri_walls


def phase_recipes(torch, np, dev, smi):
    """Slice 10 on the card: the port's recipe scripts and tools, each
    stage a process as a user runs it.  devwatch's exit 0 through and
    exit 66 on a wedge; the librispeech_ctc chain (make_synth_data.py at
    71 phones → compute_feats (K4), compute_cmvn, graph_tool make-tlg;
    run.sh with device=cuda: prepare_egs get/sort/subset, train_ctc at
    its defaults (K2, K3, K1), compute_prob (K11), adjust_priors, decode_ctc
    --method wfst --lattice, score_lattices; generate_report) with the
    decode held to the same call on the CPU's plain path; the triphone
    chain on the same corpus (tree_tool acc-stats, sum-stats, questions,
    build, info; prepare_egs get --tree, these host stages in this
    process while run.sh runs; f32 train_ctc at the flagship's
    width; graph_tool make-tlg --tree; decode_ctc --lattice on the card
    and on the plain path; score_lattices); lm_tool arpa-to-fst,
    perplexity and compile-const, graph_tool info and compose → the
    phase's launches."""
    import shutil

    from kaldi_ctc_tpu_torch.cli import (decode_ctc, generate_report,
                                         graph_tool, lm_tool,
                                         score_lattices, train_ctc)
    from kaldi_ctc_tpu_torch.utils import kaldi_io

    work = os.path.join(ROOT, "build", "smoke", "recipes")
    shutil.rmtree(work, ignore_errors=True)
    hook = os.path.join(work, "hook")
    os.makedirs(hook)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_HOOK.format(root=ROOT))
    records = os.path.join(work, "launches.jsonl")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, SMOKE_LAUNCHES=records, device=dev.type,
               PYTHONPATH=os.pathsep.join(
                   [hook, ROOT] + ([path] if path else [])))
    recipes = os.path.join(ROOT, "kaldi_ctc_tpu_torch", "recipes")
    py = sys.executable
    walls = {}

    # devwatch: through to the CLI, and 66 when the probe cannot finish
    watch = [py, "-m", "kaldi_ctc_tpu_torch.cli.devwatch",
             "kaldi_ctc_tpu_torch.cli.model_info", "--help"]
    r, walls["devwatch"] = run_logged(watch, env, 120)
    if "--dir" not in r.stdout:
        fail(f"devwatch did not run model_info: {r.stdout[-500:]}")
    r, walls["devwatch_wedged"] = run_logged(
        watch, dict(env, KCTPU_DEVICE_TIMEOUT="0.0001"), 120, ok=(66,))
    if "wedged" not in r.stderr or "--dir" in r.stdout:
        fail(f"devwatch on a wedge: {r.stderr[-500:]}")

    # the librispeech_ctc chain: the corpus, then run.sh on the card
    ls = os.path.join(work, "ls")
    r, walls["make_synth_data"] = run_logged(
        [py, os.path.join(recipes, "librispeech_ctc", "make_synth_data.py"),
         "--out", ls, "--num-phones", str(RECIPE_PHONES), "--device",
         dev.type], env,
        RECIPE_STAGE_S)
    corpus = json.loads(r.stdout.strip().splitlines()[-1])
    mono_graph = tlg_line(r.stderr)
    if corpus["num_targets"] != RECIPE_PHONES + 1:
        fail(f"make_synth_data: {corpus}")
    data, graph = os.path.join(ls, "data"), os.path.join(ls, "graph")
    exp = os.path.join(work, "exp")
    knobs = {"data": data, "ali": os.path.join(ls, "ali"), "graph": graph,
             "exp": exp, "num_targets": str(corpus["num_targets"]),
             "epochs": str(RECIPE_EPOCHS),
             "num_archives": str(RECIPE_ARCHIVES),
             "wfst_beam": str(RECIPE_WFST_BEAM),
             "lattice_beam": str(RECIPE_LATTICE_BEAM)}
    # run.sh in the background; meanwhile the triphone chain's host stages
    # (the tree and its egs) run here
    tri = os.path.join(work, "tri")
    logs = [os.path.join(work, f"run.sh.{k}") for k in ("out", "err")]
    t0 = time.perf_counter()
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen(
            ["bash", os.path.join(recipes, "librispeech_ctc", "run.sh")],
            env=dict(env, **knobs), stdout=out, stderr=err)
        try:
            tree, n_egs, tri_walls = triphone_host_stages(np, ls, tri)
            try:
                proc.wait(timeout=RECIPE_STAGE_S)
            except subprocess.TimeoutExpired:
                fail(f"run.sh ran past {RECIPE_STAGE_S} s")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    walls["run.sh"] = time.perf_counter() - t0
    with open(logs[0]) as f_out, open(logs[1]) as f_err:
        run_out, run_err = f_out.read(), f_err.read()
    if proc.returncode:
        fail(f"run.sh exited {proc.returncode}: {run_out[-2000:]} "
             f"{run_err[-3000:]}")
    import re
    rtf = [float(x) for x in re.findall(r"RTF ([0-9.]+)", run_err)]
    with open(os.path.join(exp, "wer.test_clean.json")) as f:
        wer = json.loads(f.read().strip().splitlines()[-1])
    t0 = time.perf_counter()
    run_cli(generate_report.main, ["--dir", exp])
    walls["generate_report"] = time.perf_counter() - t0
    with open(records) as f:
        procs = [json.loads(line) for line in f]
    launches = collections.Counter()
    for p in procs:
        launches.update(p["counts"])
    per_cli = collections.defaultdict(float)
    for p in procs:
        per_cli[os.path.basename(p["argv"][0]).replace(".py", "")] += \
            p["wall_s"]
    # the same decode on the CPU's plain path, in this process
    t = os.path.join(data, "test_clean")
    base = ["--feats", f"scp:{t}/feats.scp", "--cmvn", f"scp:{t}/cmvn.scp",
            "--utt2spk", f"{t}/utt2spk", "--dir", exp, "--graph",
            f"{graph}/CTC.fst", "--words", f"{graph}/words.txt"] + \
        RECIPE_DECODE
    plain_lat = os.path.join(work, "lat.plain.ark.txt")
    plain_hyp = os.path.join(work, "hyps.plain.txt")
    _, leaked = plain_cli(decode_ctc.main, base + [
        "--lattice", plain_lat, "--output", plain_hyp, "--device", "cpu"])
    if leaked:
        fail(f"the plain decode launched {leaked} kernels")
    mono = hold_to_plain("librispeech_ctc decode",
                         os.path.join(exp, "hyps.test_clean.txt"), plain_hyp,
                         os.path.join(exp, "lat.test_clean.ark.txt"),
                         plain_lat)
    res = {"phase": "recipes_librispeech", "card": smi,
           "corpus": corpus | {"run": None}, "mono_graph": mono_graph,
           "stage_walls_s": {k: round(v, 3) for k, v in walls.items()},
           "process_walls_s": {k: round(v, 3) for k, v in per_cli.items()},
           "train_steps_per_s": steps_per_s(exp), "decode_rtf": rtf,
           "wer": wer, "decode_vs_plain": mono,
           "launches": {k: launches[k] for k in SLICE10_KERNELS}}
    emit(res)
    if len(rtf) != 1 or "best_wer" not in wer:
        fail(f"the librispeech_ctc chain: {res}")

    # the triphone chain: train and decode on the card
    exp_tri = os.path.join(work, "exp_tri")
    _, tri_counts, tri_walls["train_ctc"] = cli_counts(train_ctc.main, [
        "--egs", f"scp:{tri}/egs.scp", "--num-targets",
        str(tree["num_pdfs"] + 1), "--hidden-dim", str(PIPE_HIDDEN),
        "--num-layers", str(PIPE_LAYERS), "--epochs", str(TRI_EPOCHS),
        "--minibatch-size", "48", "--frame-subsampling-factor", "3",
        "--initial-learning-rate", "5e-4", "--final-learning-rate", "1e-5",
        "--clip-gradient", "5.0", "--dir", exp_tri, "--device", dev.type])
    tri_train = collections.Counter(tri_counts)
    t0 = time.perf_counter()
    lines = LogLines()
    logging.getLogger("graph_tool").addHandler(lines)
    try:
        run_cli(graph_tool.main, [
            "make-tlg", "--lexicon", f"{ls}/lexicon.txt", "--arpa",
            f"{ls}/lm.arpa", "--phones", f"{ls}/phones.txt", "--tree",
            f"{tri}/tree", "--output", f"{tri}/TLG.fst"])
    finally:
        logging.getLogger("graph_tool").removeHandler(lines)
    tri_walls["make_tlg_tree"] = time.perf_counter() - t0
    tri_graph = tlg_line("\n".join(lines.messages))
    base = ["--feats", f"scp:{t}/feats.scp", "--cmvn", f"scp:{t}/cmvn.scp",
            "--utt2spk", f"{t}/utt2spk", "--dir", exp_tri, "--graph",
            f"{tri}/TLG.fst", "--words", f"{tri}/TLG.fst.words.txt"] + \
        RECIPE_DECODE
    card_lat, card_hyp = f"{tri}/lat.card.ark.txt", f"{tri}/hyps.card.txt"
    out, dec_counts, tri_walls["decode_ctc"] = cli_counts(
        decode_ctc.main, base + ["--lattice", card_lat, "--output",
                                 card_hyp, "--device", dev.type])
    tri_dec = collections.Counter(dec_counts)
    _, leaked = plain_cli(decode_ctc.main, base + [
        "--lattice", f"{tri}/lat.plain.ark.txt", "--output",
        f"{tri}/hyps.plain.txt", "--device", "cpu"])
    if leaked:
        fail(f"the plain triphone decode launched {leaked} kernels")
    tri_vs = hold_to_plain("triphone decode", card_hyp,
                           f"{tri}/hyps.plain.txt", card_lat,
                           f"{tri}/lat.plain.ark.txt")
    t0 = time.perf_counter()
    sweep = [json.loads(line) for line in run_cli(score_lattices.main, [
        "--lattices", card_lat, "--text", f"{t}/text", "--words",
        f"{tri}/TLG.fst.words.txt", "--acoustic-scale", "10",
        "--min-lmwt", "9", "--max-lmwt", "20"]).strip().splitlines()]
    tri_walls["score_lattices"] = time.perf_counter() - t0
    audio_s = sum(m.shape[0] for _, m in kaldi_io.SequentialMatrixReader(
        f"scp:{t}/feats.scp")) * 0.01
    res = {"phase": "recipes_triphone", "card": smi, "tree": tree,
           "egs": n_egs, "num_targets": tree["num_pdfs"] + 1,
           "tri_graph": tri_graph,
           "stage_walls_s": {k: round(v, 3) for k, v in tri_walls.items()},
           "train_steps_per_s": steps_per_s(exp_tri),
           "decode_rtf": tri_walls["decode_ctc"] / audio_s,
           "wer": sweep[-1], "decode_vs_plain": tri_vs,
           "train_launches": {k: v for k, v in tri_train.items()
                              if v and "." not in k},
           "decode_launches": {k: v for k, v in tri_dec.items()
                               if v and "." not in k}}
    emit(res)
    if (tree["num_pdfs"] < RECIPE_PHONES or n_egs < 70
            or "best_wer" not in sweep[-1]
            or tri_train["bilstm_bwd"] + tri_train["bilstm_proj_bwd"] < 1
            or tri_dec["bilstm_fwd"] + tri_dec["bilstm_proj_fwd"] < 1):
        fail(f"the triphone chain: {res}")
    launches.update(tri_train)
    launches.update(tri_dec)

    # the LM and graph tools on the corpus' LM and the built graphs
    tools = os.path.join(work, "tools")
    os.makedirs(tools)
    t0 = time.perf_counter()
    run_cli(lm_tool.main, ["arpa-to-fst", "--arpa", f"{ls}/lm.arpa",
                           "--words", f"{graph}/words.txt", "--output",
                           f"{tools}/G.fst"])
    run_cli(lm_tool.main, ["compile-const", "--arpa", f"{ls}/lm.arpa",
                           "--output", f"{tools}/G.carpa.npz"])
    ppl = {kind: json.loads(run_cli(lm_tool.main, [
        "perplexity", flag, lm, "--text", f"{t}/text"]).strip().splitlines(
        )[-1]) for kind, flag, lm in (
            ("arpa", "--arpa", f"{ls}/lm.arpa"),
            ("const_arpa", "--const-arpa", f"{tools}/G.carpa.npz"))}
    run_cli(graph_tool.main, ["compose", "--a", f"{graph}/CTC.fst", "--b",
                              f"{tools}/G.fst", "--output",
                              f"{tools}/CTC_G.fst"])
    info = {name: json.loads(run_cli(graph_tool.main, [
        "info", "--graph", p]).strip().splitlines()[-1]) for name, p in (
            ("mono", f"{graph}/CTC.fst"), ("tri", f"{tri}/TLG.fst"),
            ("G", f"{tools}/G.fst"), ("CTC_G", f"{tools}/CTC_G.fst"))}
    res = {"phase": "recipes_tools", "perplexity": ppl, "graph_info": info,
           "wall_s": round(time.perf_counter() - t0, 3)}
    emit(res)
    if (abs(ppl["arpa"]["perplexity"] - ppl["const_arpa"]["perplexity"])
            > 1e-4 * ppl["arpa"]["perplexity"]
            or info["mono"]["num_states"] != mono_graph["states"]
            or info["tri"]["num_states"] != tri_graph["states"]
            or info["CTC_G"]["num_states"] < info["mono"]["num_states"]):
        fail(f"the tools: {res}")
    return launches


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_graph(torch, np, dev, work, flagship, graph):
    """serve --graph --words (the word loop) on the flagship (f32) and the
    uni LSTM: 4
    /recognize requests with words and text, and on the uni LSTM 2 streams
    whose end words equal their /recognize words → the launch counts of
    the served requests and streams."""
    from kaldi_ctc_tpu_torch.cli import init_model, serve

    uni = os.path.join(work, "exp_uni")
    run_cli(init_model.main, [
        "--dir", uni, "--input-dim", "40", "--num-targets", "72",
        "--hidden-dim", str(DECODE_HIDDEN), "--num-layers", "5",
        "--bidirectional", "0"])
    launches = collections.Counter()
    audio = [pcm(s, 80 + i, np) for i, s in enumerate((2.0, 4.0, 6.0, 8.0))]
    for tag, exp in (("flagship", flagship), ("uni", uni)):
        server, _ = serve.make_server(serve.parse_args(
            ["--dir", exp, "--device", dev.type, "--port", "0", "--graph",
             graph, "--words", graph + ".words.txt", "--max-streams", "2"]))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            status, _, _ = post(port, "/recognize", pcm(1.0, 9, np).tobytes())
            if status != 200:
                fail(f"serve --graph warm-up answered {status}")
            reset_counts()
            walls, words = [], []
            for x in audio:
                status, data, wall = post(port, "/recognize", x.tobytes())
                walls.append(round(wall * 1000, 3))
                words.append(data.get("words"))
                if status != 200 or "text" not in data or len(
                        data["text"].split()) != len(data["words"]):
                    fail(f"serve --graph /recognize ({tag}): {status} "
                         f"{str(data)[:300]}")
            ends = []
            if tag == "uni":
                for x in audio[:2]:
                    end, _, err = run_stream(port, x, threading.Barrier(1),
                                             3200)
                    if err:
                        fail(f"serve --graph stream: {err}")
                    ends.append(end.get("words"))
                if ends != words[:2]:
                    fail(f"serve --graph: stream end words {ends} differ "
                         f"from /recognize's {words[:2]}")
            counts = read_counts()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        launches.update(counts)
        emit({"phase": "serve_graph", "model": tag, "dtype": "float32",
              "request_seconds": [2.0, 4.0, 6.0, 8.0],
              "latency_ms": walls,
              "words_per_request": [len(w) for w in words],
              "streams_equal_to_recognize_words": len(ends),
              "launches": {k: v for k, v in counts.items()
                           if v and "." not in k}})
    return launches


def main():
    if not os.path.exists(os.path.join(ROOT, "kaldi_ctc_tpu_torch", "csrc",
                                       "bilstm_fwd.cu")):
        fail("run from a checkout of the repository: kaldi_ctc_tpu_torch/"
             "csrc is missing beside chip_smoke.py")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one NVIDIA card")
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    dev = torch.device("cuda", 0)
    smi = phase_device(torch)
    phase_build()
    measured = {"log_mel": phase_k4(torch, np, dev),
                "bilstm_fwd": phase_k2(torch, np, dev)}
    ctc_rows, launches = phase_k1(torch, np, dev)
    measured.update(ctc_rows)
    measured["bilstm_bwd"] = phase_k3(torch, np, dev)
    wide_rows, wide_step = phase_wide(torch, np, dev)
    measured["lstm_fwd"] = phase_k5(torch, np, dev)
    measured["lstm_bwd"] = phase_k6(torch, np, dev)
    measured["lstm_stack"] = phase_k7(torch, np, dev)
    measured.update(phase_gru_kernels(torch, np, dev, bidirectional=False))
    measured.update(phase_gru_kernels(torch, np, dev, bidirectional=True))
    measured.update(phase_k10(torch, np, dev))
    phase_f7(torch, np, dev)
    # the driven paths, each returning its launch counts
    served, engines = phase_serve(torch, np)
    trained = phase_train(torch, np, dev)
    served_uni, uni_engines = phase_serve_uni(torch, np)
    trained_uni = phase_train(torch, np, dev, bidirectional=False)
    served_gru, gru_engines = phase_serve(torch, np, RnnMode.GRU)
    trained_gru = phase_train(torch, np, dev, mode=RnnMode.GRU)
    served_gru_uni, gru_uni_engines = phase_serve_uni(torch, np, RnnMode.GRU)
    trained_gru_uni = phase_train(torch, np, dev, bidirectional=False,
                                  mode=RnnMode.GRU)
    served_proj, _ = phase_serve(torch, np, proj=True)
    trained_proj = phase_train(torch, np, dev, proj=True)
    decoded = phase_decode(torch, np, dev)
    piped = phase_pipeline(torch, np, dev, smi)
    # slice 8: the DS2 flagship served and trained, then the extras' CLIs
    served_ds2, _ = phase_serve(torch, np, ds2=True)
    trained_ds2 = phase_train(torch, np, dev, ds2=True)
    extras = phase_extras(torch, np, dev, smi)
    # slice 9: train_ctc on one NCCL rank and the launcher, then lattices
    dist = phase_distributed(torch, np, dev, smi)
    latticed = phase_lattice(torch, np, dev, smi)
    # slice 10: the recipes, the tree and graph builders and their tools
    reset_counts()
    recipes = phase_recipes(torch, np, dev, smi)
    launches = collections.Counter(launches)
    for counts in (served, trained, served_uni, trained_uni, served_gru,
                   trained_gru, served_gru_uni, trained_gru_uni, served_proj,
                   trained_proj, decoded, piped, served_ds2, trained_ds2,
                   extras, dist, latticed, recipes):
        launches.update(counts)
    if min(launches[name] for name in KERNELS) < 1:
        fail(f"a kernel of the driven paths never launched: {launches}")
    slice8 = collections.Counter(served_ds2)
    slice8.update(trained_ds2)
    slice8.update(extras)
    missing = [k for k in SLICE8_KERNELS if slice8[k] < 1]
    emit({"phase": "extras_launches", "launches": {
        k: slice8[k] for k in SLICE8_KERNELS}})
    if missing:
        fail(f"slice 8's paths never launched {missing}: {dict(slice8)}")
    slice9 = {"distributed": {k: dist[k] for k in SLICE9_KERNELS},
              "lattice": {"bilstm_fwd": latticed["bilstm_fwd"]}}
    emit({"phase": "slice9_launches", "launches": slice9})
    if min(slice9["distributed"].values()) < 1 or \
            slice9["lattice"]["bilstm_fwd"] < 1:
        fail(f"slice 9's paths never launched a kernel: {slice9}")
    slice10 = {k: recipes[k] for k in SLICE10_KERNELS + (
        "bilstm_proj_fwd", "bilstm_proj_bwd")}
    emit({"phase": "slice10_launches", "launches": slice10})
    if min(slice10[k] for k in SLICE10_KERNELS) < 1:
        fail(f"slice 10's paths never launched a kernel: {slice10}")
    driven_routes(launches, (served, served_uni, served_gru, served_gru_uni,
                             served_proj, decoded, piped, served_ds2,
                             extras, dist, latticed, recipes))
    phase_profile(torch, np, engines)
    phase_profile_stream(torch, np, uni_engines)
    phase_profile(torch, np, gru_engines, "bigru_fwd")
    phase_profile(torch, np, gru_uni_engines, "gru_fwd")
    phase_profile_stream(torch, np, gru_uni_engines, gru=True)
    sources = {"log_mel": ("log_mel.cu", "features/stft_pallas.py:79"),
               "bilstm_fwd": ("bilstm_fwd.cu", "ops/rnn_pallas.py:602"),
               "bilstm_bwd": ("bilstm_bwd.cu", "ops/rnn_pallas.py:747"),
               "ctc_alpha_beta": ("ctc_alpha_beta.cu",
                                  "ops/ctc_pallas.py:149"),
               "ctc_alphas": ("ctc_alpha_beta.cu", "ops/ctc_pallas.py:190"),
               "ctc_betas": ("ctc_alpha_beta.cu", "ops/ctc_pallas.py:215"),
               "lstm_fwd": ("lstm_fwd.cu", "ops/rnn_pallas.py:455"),
               "lstm_bwd": ("lstm_bwd.cu", "ops/rnn_pallas.py:531"),
               "lstm_stack": ("lstm_stack.cu", "ops/rnn_pallas.py:1110"),
               "bigru_fwd": ("gru_fwd.cu", "ops/gru_pallas.py:238"),
               "bigru_bwd": ("gru_bwd.cu", "ops/gru_pallas.py:274"),
               "gru_fwd": ("gru_fwd.cu", "ops/gru_pallas.py:178"),
               "gru_bwd": ("gru_bwd.cu", "ops/gru_pallas.py:204"),
               "bilstm_proj_fwd": ("bilstm_fwd.cu", "ops/rnn_pallas.py:654"),
               "bilstm_proj_bwd": ("bilstm_bwd.cu", "ops/rnn_pallas.py:698")}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"kaldi_ctc_tpu_torch/csrc/{sources[name][0]}",
         "replaces": f"kaldi_ctc_tpu/{sources[name][1]}",
         "launches": launches[name], **measured[name]}
        for name in KERNELS] + [
        {"name": name, "route": "cuda/wide",
         "source": f"kaldi_ctc_tpu_torch/csrc/{src} + csrc/lstm_wide.cuh",
         "replaces": f"kaldi_ctc_tpu/{sources[base][1]}",
         # one DS2 train step's (wide_ds2_train_step)
         "launches": wide_step[f"{base}.wide"], **wide_rows[name]}
        for name, base, src in zip(WIDE_KERNELS, ("bilstm_fwd", "bilstm_bwd"),
                                   ("bilstm_fwd.cu", "bilstm_bwd.cu"))],
        "launch_floor_ms": launch_floor_ms(torch, dev)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
