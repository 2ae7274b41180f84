"""CTC training driver — steps/ctc/train.sh + nnet2-ctc-train-simple.

Counterpart of ``kaldi_ctc_tpu/cli/train_ctc.py`` with the same flags,
defaults, files and printed lines, plus ``--device`` (default ``cuda``;
with no card it raises, it never runs on the CPU unasked).  Reads
Kaldi-format features + pdf-id alignments (or a prepared egs archive),
builds the egs pipeline, trains the CTC model on the device (on the card
the step runs K2 and K3 per BLSTM layer and K1 for the loss), writes
checkpoints with retention, logs the reference's parseable accuracy
line, and runs held-out diagnostics (K11 for the loss) every
``cv_period * 10`` steps (train.sh:330-349).

Under ``cli/launch.py`` (or any environment that names a coordinator,
see ``parallel.distributed``) N processes train one model, one device
each: every process loads the same list, keeps the utterances every
filter passes, truncates it to a multiple of N and takes its shard
(``items[i::N]``), pads every batch to the global maxima so that all
ranks run the same shapes, and batches ``--minibatch-size / N``
utterances; the step sums the gradient over the processes
(``training/train.py``), and the logged counts cover the global batch.
Only the first process writes metrics.jsonl, priors.npy and the
checkpoints.  ``--minibatch-size`` is the global batch and the final
short batch of an epoch is dropped, as in the JAX package.  The
model families and options of the JAX CLI all run: splicing, the FT
front (``--front-affine-dim``, five nonlinearities), the DS2 conv front
(``--conv-layers``; its time stride enters the egs 2L+1 filter; with
``--conv-norm batch`` deepspeech.pytorch's DS2, whose batch norms' running
statistics ride in the train state and its checkpoints),
``--dropout``, ``--affine-type natural`` (NG-SGD on the output affine
and the FT front) and ``--realign-epochs`` (at those epochs the current
model Viterbi-aligns the training set on the device: relabel, drop
infeasible utterances, write data-driven priors, recompute the lr decay
horizon, and persist the relabeled set to
``realign_labels.host0.json``, which ``--resume`` reapplies).
``init_model``'s caveat holds here too: the same ``--seed`` draws other
initial numbers than JAX's (``torch.Generator``), and dropout masks are
drawn from a ``torch.Generator`` seeded with the step, not from JAX's
keys, so runs are compared from one shared checkpoint with ``--resume``.

The loop's phases are spans of ``utils/profiling.py`` (``setup.*``,
``train.*``; the pipeline's producer thread adds ``pipeline.*``).  At
each epoch's end the first process appends a ``timing`` record to
metrics.jsonl: the spans and counters since the previous record, its
wall time and the part of it no top-level span covers (README.md lists
the fields).  ``--profile-dir`` traces the run, or with
``--profile-steps A:B`` steps A to B only.

Example (tiny sanity run on the CPU):
  python -m kaldi_ctc_tpu_torch.cli.train_ctc \\
      --feats scp:data/train/feats.scp --ali ark:exp/ali.ark \\
      --num-targets 72 --dir exp/ctc --epochs 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _step_range(text: str):
    """``A:B`` → (A, B), 1 <= A <= B."""
    try:
        a, b = (int(x) for x in text.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"want A:B, got {text!r}")
    if not 1 <= a <= b:
        raise argparse.ArgumentTypeError(f"want 1 <= A <= B, got {text!r}")
    return a, b


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    # data
    p.add_argument("--feats", default=None, help="feats rspecifier (ark:/scp:)")
    p.add_argument("--ali", default=None, help="pdf-id alignment rspecifier")
    p.add_argument("--egs", default=None,
                   help="prepared egs archive rspecifier (prepare_egs "
                        "output); replaces --feats/--ali")
    p.add_argument("--cmvn", default=None, help="cmvn stats rspecifier")
    p.add_argument("--utt2spk", default=None, help="utt2spk file for cmvn")
    p.add_argument("--valid-feats", default=None)
    p.add_argument("--valid-ali", default=None)
    # model (the make_configs.py surface)
    p.add_argument("--num-targets", type=int, required=True,
                   help="pdfs + 1 blank")
    p.add_argument("--hidden-dim", type=int, default=320)
    p.add_argument("--num-layers", type=int, default=5)
    p.add_argument("--rnn-mode", type=int, default=2,
                   help="0=relu 1=tanh 2=lstm 3=gru")
    p.add_argument("--bidirectional", type=int, default=1)
    p.add_argument("--splice-left", type=int, default=0,
                   help="input splice left context (SpliceComponent)")
    p.add_argument("--splice-right", type=int, default=0)
    p.add_argument("--front-nonlin", default="relu",
                   choices=["relu", "tanh", "sigmoid", "pnorm", "maxout"],
                   help="front-layer nonlinearity of the FT front")
    p.add_argument("--front-group", type=int, default=1,
                   help="group size for pnorm/maxout front layers")
    p.add_argument("--front-affine-dim", type=int, default=0,
                   help="FT model type: Affine + nonlinearity + renorm "
                        "front layer width before the RNN stack (0 = "
                        "google type)")
    p.add_argument("--conv-layers", type=int, default=0,
                   help="DS2 model type: this many 2D conv layers "
                        "(kernels (11,41)/(11,21)/(11,21), freq stride "
                        "2, leaky clipped ReLU) before the RNN stack")
    p.add_argument("--conv-channels", type=int, default=32)
    p.add_argument("--conv-time-stride", type=int, default=2,
                   help="time stride of the first conv layer (halves "
                        "the RNN sequence at 2)")
    p.add_argument("--conv-norm", default="seq",
                   choices=["seq", "none", "batch"],
                   help="conv-front normalization: 'seq' = per-utterance, "
                        "per-channel moments over valid frames; 'none'; "
                        "'batch' = deepspeech.pytorch's DS2: batch norm "
                        "then Hardtanh(0, 20), the directions summed, a "
                        "batch norm before every later layer and before "
                        "the bias-free output")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout after the RNN stack (training only)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="matmul operand dtype (bfloat16 = mixed "
                        "precision, f32 accumulation)")
    p.add_argument("--add-layers-period", type=int, default=0,
                   help="if >0, start from --start-layers RNN layers and "
                        "insert a fresh layer every N steps until "
                        "--num-layers (layer-wise growth, the nnet-insert "
                        "schedule of steps/ctc/train.sh:357-384; period is "
                        "in steps here, outer iterations there)")
    p.add_argument("--start-layers", type=int, default=1)
    # training (train.sh defaults)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--minibatch-size", type=int, default=48)
    p.add_argument("--max-allow-frames", type=int, default=2000)
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--initial-learning-rate", type=float, default=5e-4)
    p.add_argument("--lr-warmup-steps", type=int, default=0,
                   help="linear lr ramp over this many steps before the "
                        "exponential decay (0 = reference schedule)")
    p.add_argument("--final-learning-rate", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--clip-gradient", type=float, default=5.0)
    p.add_argument("--affine-type", choices=["simple", "natural"],
                   default="simple",
                   help="natural: online NG-SGD preconditioning of the "
                        "output affine and the FT front")
    p.add_argument("--ng-rank-in", type=int, default=30)
    p.add_argument("--ng-rank-out", type=int, default=80)
    p.add_argument("--ng-update-period", type=int, default=1)
    p.add_argument("--nonfinite-action", default="abort",
                   choices=["abort", "skip"],
                   help="on a non-finite loss/grad: abort like the "
                        "reference (ctc-nnet-update.cc:232-234 KALDI_ERR) "
                        "or skip the batch (the update is suppressed on "
                        "the device either way, so state stays clean)")
    p.add_argument("--realign-epochs", default="",
                   help="comma-separated epoch indices at whose start the "
                        "current model realigns the training set: Viterbi "
                        "align -> relabel -> data-driven priors "
                        "(steps/ctc/train.sh:111-115 realign loop)")
    p.add_argument("--cv-period", type=int, default=10,
                   help="diagnostic eval every N steps x 10")
    p.add_argument("--checkpoint-period", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dir", required=True, help="experiment directory")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=int, default=0,
                   help="1: print the table of spans and counters at exit "
                        "(AccuProfile analogue)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here, and the host "
                        "spans of every thread beside it")
    p.add_argument("--profile-steps", default=None, type=_step_range,
                   help="A:B: trace from step A to the end of step B "
                        "(1-based global steps; default: the whole run)")
    p.add_argument("--device", default="cuda",
                   help="torch device the model trains on; 'cuda' with no "
                        "card raises")
    return p.parse_args(argv)


def initial_params(cfg, seed: int, device):
    """The parameters a fresh run starts from: ``init_am_params`` drawn
    from ``torch.Generator().manual_seed(seed)``."""
    import torch

    from kaldi_ctc_tpu_torch.models import init_am_params
    return init_am_params(cfg, torch.Generator().manual_seed(seed), device)


def main(argv=None):
    from kaldi_ctc_tpu_torch.cli.common import resolve_device
    from kaldi_ctc_tpu_torch.parallel.distributed import (init_distributed,
                                                          shutdown)
    from kaldi_ctc_tpu_torch.utils.profiling import profiler

    # setup.imports: the process's start (the interpreter, torch, the
    # port) to here; the first timing record's interval starts there
    first = profiler.main_started()
    with profiler.span("setup.distributed"):
        args = parse_args(argv)
        # multi-process bring-up (no-op in one process; the run.pl
        # analogue)
        device = init_distributed(device=resolve_device(args.device))
    try:
        # _train closes setup.init when the loop is ready; an exception
        # in the set-up closes it here
        with contextlib.ExitStack() as setup:
            setup.enter_context(profiler.span("setup.init"))
            _train(args, device, first, setup)
    finally:
        # leave the group on every exit path, so that a caller in this
        # process can start again
        shutdown()


def _train(args, device, last, setup):
    """``last``: the snapshot the first timing record's interval starts
    from; ``setup``: the stack that holds the ``setup.init`` span."""
    import dataclasses

    import numpy as np
    import torch

    from kaldi_ctc_tpu_torch.data import (CtcExample, EgsPipeline, Prefetcher,
                                          load_examples)
    from kaldi_ctc_tpu_torch.data.egs import example_ok, frame_subsample
    from kaldi_ctc_tpu_torch.models import AmConfig, grow_rnn_layer
    from kaldi_ctc_tpu_torch.models.acoustic import init_norm_stats
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    from kaldi_ctc_tpu_torch.parallel import make_mesh, shard_batch
    from kaldi_ctc_tpu_torch.parallel.distributed import (
        host_shard, initialised_device, is_primary, process_allgather,
        process_count, process_index)
    from kaldi_ctc_tpu_torch.training import (
        TrainOptions, accuracy_from_outputs, init_train_state,
        make_eval_step, make_train_step)
    from kaldi_ctc_tpu_torch.training.checkpoint import (
        apply_retention, latest_step, read_meta, restore_train_state,
        save_checkpoint)
    from kaldi_ctc_tpu_torch.training.realign import (parse_realign_epochs,
                                                      realign_examples)
    from kaldi_ctc_tpu_torch.utils import get_logger, profiling
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader
    from kaldi_ctc_tpu_torch.utils.logging import MetricsLogger, Timer

    span = profiling.profiler.span
    count = profiling.profiler.count
    os.makedirs(args.dir, exist_ok=True)
    if args.profile:
        profiling.enable()
    log = get_logger("train_ctc")
    metrics_log = MetricsLogger(
        os.path.join(args.dir, "metrics.jsonl") if is_primary() else None,
        append=bool(args.resume))

    utt2spk = None
    if args.utt2spk:
        utt2spk = dict(SequentialTextReader(args.utt2spk))

    log.info("loading examples...")
    if not args.egs and not (args.feats and args.ali):
        log.error("need --egs or both --feats and --ali"); sys.exit(1)
    with span("setup.load_examples"):
        if args.egs:
            from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
            examples = list(SequentialEgsReader(args.egs))
        else:
            examples = list(load_examples(args.feats, args.ali,
                                          cmvn_rspecifier=args.cmvn,
                                          utt2spk=utt2spk))
    if not examples:
        log.error("no examples loaded"); sys.exit(1)
    # the conv stride math lives in AmConfig.time_stride (one source of
    # truth for the egs 2L+1 filters and the model)
    model_stride = AmConfig(
        input_dim=1, num_targets=2, conv_layers=args.conv_layers,
        conv_time_stride=args.conv_time_stride).time_stride

    def ok_all_shifts(e):
        for shift in range(max(args.frame_subsampling_factor, 1)):
            sub = CtcExample(
                e.key,
                frame_subsample(e.feats, args.frame_subsampling_factor,
                                shift),
                e.labels)
            if not example_ok(sub, args.max_allow_frames,
                              time_stride=model_stride):
                return False
        return True

    n_proc = process_count()

    def shard_for_spmd(exs, what):
        # every process must run the same steps at the same shapes:
        # pre-filter the global list (the same on every process) so that
        # per-shard filtering cannot diverge, truncate the shards to equal
        # length, and fix the padded shape at the global maxima
        exs = [e for e in exs if ok_all_shifts(e)]
        exs = exs[:(len(exs) // n_proc) * n_proc]
        fixed = (max((e.num_frames for e in exs), default=1),
                 max((e.num_labels for e in exs), default=1))
        exs = host_shard(exs)
        log.info("host %d/%d: %d %s utterances after sharding, "
                 "fixed shape %s", process_index(), n_proc, len(exs), what,
                 fixed)
        return exs, fixed

    fixed_shape = None
    if n_proc > 1:
        examples, fixed_shape = shard_for_spmd(examples, "train")
    if not examples:
        log.error("no usable examples after filtering/sharding "
                  "(check --max-allow-frames and the process count)")
        sys.exit(1)
    input_dim = examples[0].feats.shape[1]
    log.info("loaded %d utterances, input dim %d", len(examples), input_dim)

    # --minibatch-size is the GLOBAL batch (reference semantics: lr*sum
    # over that many utterances); each process batches its 1/n_proc
    if args.minibatch_size % n_proc:
        log.error("--minibatch-size %d not divisible by the %d processes",
                  args.minibatch_size, n_proc)
        sys.exit(1)
    host_mb = args.minibatch_size // n_proc
    if len(examples) < host_mb:
        # the final short batch is dropped, so fewer examples than one
        # batch would train zero steps silently
        log.error("only %d utterances for a per-host batch of %d: every "
                  "epoch would yield zero batches — reduce "
                  "--minibatch-size", len(examples), host_mb)
        sys.exit(1)

    def make_pipe(exs):
        return EgsPipeline(
            exs, minibatch_size=host_mb,
            max_allow_frames=args.max_allow_frames,
            frame_subsampling_factor=args.frame_subsampling_factor,
            seed=args.seed, fixed_shape=fixed_shape,
            time_stride=model_stride)

    pipe = make_pipe(examples)

    valid_pipe = None
    if args.valid_feats and args.valid_ali:
        with span("setup.load_examples"):
            valid_examples = list(load_examples(
                args.valid_feats, args.valid_ali,
                cmvn_rspecifier=args.cmvn, utt2spk=utt2spk))
        valid_fixed = None
        if n_proc > 1:
            # the same contract as training, the global pre-filter
            # included: per-process filtering inside the pipeline would
            # give the processes different batch counts
            valid_examples, valid_fixed = shard_for_spmd(valid_examples,
                                                         "valid")
        valid_pipe = EgsPipeline(
            valid_examples, minibatch_size=host_mb,
            max_allow_frames=args.max_allow_frames,
            frame_subsampling_factor=args.frame_subsampling_factor,
            seed=args.seed + 1000, fixed_shape=valid_fixed,
            time_stride=model_stride)

    grow = args.add_layers_period > 0 and args.start_layers < args.num_layers
    start_layers = args.start_layers if grow else args.num_layers
    ckpt_dir = os.path.join(args.dir, "checkpoints")
    if not args.resume and latest_step(ckpt_dir) is not None:
        # stale checkpoints from an earlier run would be silently picked
        # up by compute_prob/decode over this run's model — clear them
        log.warning("removing stale checkpoints in %s (pass --resume to "
                    "continue the previous run)", ckpt_dir)
        if is_primary():
            import shutil
            shutil.rmtree(ckpt_dir)
    if args.resume and latest_step(ckpt_dir) is not None:
        # rebuild the template at the layer count the checkpoint was saved at
        start_layers = read_meta(ckpt_dir)["extra"].get(
            "num_layers", start_layers)

    def build_cfg(num_layers):
        return AmConfig(input_dim=input_dim, num_targets=args.num_targets,
                        hidden_dim=args.hidden_dim, num_layers=num_layers,
                        mode=RnnMode(args.rnn_mode),
                        bidirectional=bool(args.bidirectional),
                        dropout=args.dropout,
                        compute_dtype=args.compute_dtype,
                        splice_left=args.splice_left,
                        splice_right=args.splice_right,
                        front_affine_dim=args.front_affine_dim,
                        front_nonlin=args.front_nonlin,
                        front_group=args.front_group,
                        conv_layers=args.conv_layers,
                        conv_channels=args.conv_channels,
                        conv_time_stride=args.conv_time_stride,
                        conv_norm=args.conv_norm)

    def write_cfg(cfg):
        with open(os.path.join(args.dir, "model_config.json"), "w") as f:
            json.dump(cfg.to_dict(), f)

    cfg = build_cfg(start_layers)
    write_cfg(cfg)

    # rough decay horizon: one step consumes host_mb utterances a process
    steps_per_epoch = max(len(examples) // host_mb, 1)
    num_steps = steps_per_epoch * args.epochs
    opts = TrainOptions(
        initial_learning_rate=args.initial_learning_rate,
        final_learning_rate=args.final_learning_rate,
        num_steps=num_steps,
        warmup_steps=args.lr_warmup_steps,
        momentum=args.momentum,
        clip_elementwise=args.clip_gradient,
        affine_type=args.affine_type,
        ng_rank_in=args.ng_rank_in,
        ng_rank_out=args.ng_rank_out,
        ng_update_period=args.ng_update_period,
    )

    mesh = make_mesh(devices=None if initialised_device() else [device])
    state = init_train_state(initial_params(cfg, args.seed, device), opts,
                             init_norm_stats(cfg, device))
    start_epoch = 0
    start_epoch_step = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        state, meta = restore_train_state(ckpt_dir, state)
        start_epoch = meta["extra"].get("epoch", 0)
        # resume mid-epoch: skip the batches already trained (the epoch
        # order is deterministic given the epoch seed), otherwise they
        # are double-trained and the lr decay horizon is overrun
        start_epoch_step = meta["extra"].get("epoch_step", 0)
        log.info("resumed from step %d (epoch %d, batch %d)",
                 meta["step"], start_epoch, start_epoch_step)

    train_step = make_train_step(cfg, opts, mesh)
    eval_step = make_eval_step(cfg, mesh)
    timer = Timer()
    tot_err = tot_ref = 0
    global_step = int(state.step)

    def global_counts(err, ref):
        # accuracy counts are computed on this process's rows; the logged
        # (parseable) numbers cover the whole global batch
        if n_proc == 1:
            return err, ref
        arr = process_allgather(np.asarray([err, ref], np.int64))
        arr = arr.reshape(-1, 2)
        return int(arr[:, 0].sum()), int(arr[:, 1].sum())

    realign_epochs = parse_realign_epochs(args.realign_epochs)
    realign_labels_path = os.path.join(
        args.dir, f"realign_labels.host{process_index()}.json")

    def run_realign(epoch):
        # align -> relabel -> priors with the current params (the train.sh
        # realign loop); infeasible utterances drop, so the pipeline is
        # rebuilt and (multi-process) the shards re-truncated to equal
        # length
        nonlocal examples, pipe, opts, train_step
        new_exs, counts, stats = realign_examples(
            examples, state.params, cfg,
            frame_subsampling_factor=args.frame_subsampling_factor,
            log=log)
        if n_proc > 1:
            sizes = process_allgather(
                np.asarray([len(new_exs)], np.int64)).reshape(-1)
            new_exs = new_exs[:int(sizes.min())]
            # occupancies must cover only utterances that stay in the
            # training set: truncate first, then sum per-utterance counts
            counts = np.zeros_like(counts)
            for e in new_exs:
                counts += stats["counts_by_key"][e.key]
            counts = process_allgather(counts[None]).reshape(
                -1, counts.shape[0]).sum(axis=0)
        if not new_exs:
            log.error("realignment dropped every utterance; keeping the "
                      "previous training set")
            return
        if len(new_exs) < host_mb:
            log.error("realignment left only %d utterances for a "
                      "per-host batch of %d: every remaining epoch "
                      "would yield zero batches", len(new_exs), host_mb)
            raise RuntimeError("realignment left too few utterances")
        examples = new_exs
        pipe = make_pipe(examples)
        # persist the relabeled/pruned set so a --resume past this epoch
        # keeps it (otherwise dropped utterances silently rejoin)
        with open(realign_labels_path, "w") as f:
            json.dump({"epoch": epoch,
                       "labels": {e.key: e.labels.tolist()
                                  for e in examples}}, f)
        # the lr decay horizon was sized on the pre-realign example
        # count; recompute it over the remaining epochs or the schedule
        # never reaches --final-learning-rate
        new_num_steps = global_step + max(
            len(examples) // host_mb, 1) * (args.epochs - epoch)
        if new_num_steps != opts.num_steps:
            opts = dataclasses.replace(opts, num_steps=new_num_steps)
            train_step = make_train_step(cfg, opts, mesh)
            log.info("lr decay horizon recomputed after realign: "
                     "%d steps", new_num_steps)
        priors = np.maximum((counts / counts.sum()).astype(np.float32),
                            1.0e-15)
        if is_primary():
            np.save(os.path.join(args.dir, "priors.npy"), priors)
        metrics_log.log("realign", step=global_step, epoch=epoch,
                        aligned=stats["aligned"], dropped=stats["dropped"],
                        avg_logprob_per_frame=stats[
                            "avg_logprob_per_frame"])
        log.info("realign @epoch %d: %d utterances kept, priors updated "
                 "(blank prior %.3f)", epoch, len(examples), priors[0])

    if (args.resume and realign_epochs
            and any(e <= start_epoch for e in realign_epochs)):
        # a realign epoch already fired before the checkpoint: restore
        # the relabeled/pruned training set it produced, or re-run the
        # alignment with the restored params if nothing was persisted
        if os.path.exists(realign_labels_path):
            with open(realign_labels_path) as f:
                saved = json.load(f)
            by_key = saved["labels"]
            examples = [CtcExample(e.key, e.feats,
                                   np.asarray(by_key[e.key], np.int32))
                        for e in examples if e.key in by_key]
            pipe = make_pipe(examples)
            log.info("resume: reapplied persisted realignment from epoch "
                     "%d (%d utterances)", saved["epoch"], len(examples))
        else:
            log.warning("resume past realign epoch %s with no persisted "
                        "labels — re-running realignment with the "
                        "restored params",
                        max(e for e in realign_epochs if e <= start_epoch))
            with span("train.realign"):
                run_realign(max(e for e in realign_epochs
                                if e <= start_epoch))
    setup.close()   # setup.init ends: the loop is ready

    def write_timing(epoch, last):
        # the registry's difference since the last record: the spans and
        # counters of the interval, its wall time, and the part of it that
        # no top-level span of the main thread covers (the span around
        # this write falls in the next record's interval)
        now = profiling.profiler.snapshot()
        d = profiling.diff(now, last)
        for v in d["spans"].values():
            v["p50_s"] = profiling.quantile(v, 0.5)
            v["p95_s"] = profiling.quantile(v, 0.95)
        metrics_log.log("timing", step=global_step, epoch=epoch,
                        wall_s=d["wall_s"],
                        unaccounted_s=d["wall_s"] - d["main_top_s"],
                        spans=d["spans"], counters=d["counters"])
        return now

    def checkpoint(extra):
        with span("train.checkpoint"):
            path = save_checkpoint(ckpt_dir, global_step, state, extra=extra)
            count("train.checkpoint_bytes",
                  os.path.getsize(os.path.join(path, "arrays.npz")))
            apply_retention(ckpt_dir)

    # the trace closes on the way out of the with, a failed step included,
    # or the profile directory is left unusable
    with profiling.Trace(args.profile_dir, args.profile_steps) as trace:
        for epoch in range(start_epoch, args.epochs):
            log.info("epoch %d", epoch)
            if (epoch in realign_epochs
                    and not (epoch == start_epoch and start_epoch_step > 0)):
                # skipped when resuming into the middle of this epoch: the
                # params that produced the in-flight epoch's alignment are
                # gone, and realigning with newer params would
                # double-apply the epoch's realignment
                with span("train.realign"):
                    run_realign(epoch)
            epoch_step = 0
            trained_batches = skipped_nonfinite = 0
            skip = start_epoch_step if epoch == start_epoch else 0
            batches = Prefetcher(pipe.epoch(epoch))
            while True:
                trace.step_begins(global_step + 1)
                with span("train.data_wait"):
                    batch_np = next(batches, None)
                if batch_np is None:
                    break
                if epoch_step < skip:
                    epoch_step += 1
                    continue
                epoch_step += 1
                keys = batch_np.pop("keys")
                count("train.frames_valid", int(batch_np["input_lens"].sum()))
                count("train.frames_padded", int(batch_np["feats"].shape[0]
                                                 * batch_np["feats"].shape[1]))
                with span("train.shard"):
                    batch = shard_batch(batch_np, mesh)
                with span("train.step"):
                    state, m = train_step(state, batch)
                count("train.steps")
                if state.stats:
                    # the batch norms the step ran (deepspeech.pytorch's)
                    count("train.norm_layers", len(state.stats))
                global_step += 1
                # the host's first read of the step: it waits for the device
                with span("train.device_wait"):
                    finite = bool(m["finite"])
                if not finite:
                    # the device already suppressed this update; decide
                    # whether the run survives (reference: KALDI_ERR)
                    if args.nonfinite_action == "abort":
                        log.error(
                            "non-finite loss/gradient at step %d (batch "
                            "keys %s); aborting — resume from the last "
                            "checkpoint in %s", global_step,
                            ",".join(keys[:4]), ckpt_dir)
                        raise RuntimeError(
                            f"non-finite loss/gradient at step {global_step}")
                    log.warning("non-finite loss/gradient at step %d — "
                                "batch skipped (keys %s)", global_step,
                                ",".join(keys[:4]))
                    with span("train.log"):
                        metrics_log.log("skipped_nonfinite", step=global_step)
                    count("train.skipped_nonfinite")
                    skipped_nonfinite += 1
                    trace.step_ended(global_step)
                    continue
                trained_batches += 1
                if (grow and cfg.num_layers < args.num_layers
                        and global_step % args.add_layers_period == 0):
                    with span("train.grow"):
                        new_params, cfg = grow_rnn_layer(
                            state.params, cfg, torch.Generator().manual_seed(
                                args.seed + 100 + cfg.num_layers))
                        # the tree changed: fresh velocity, rebuilt steps
                        state = init_train_state(
                            new_params, opts)._replace(step=state.step)
                        train_step = make_train_step(cfg, opts, mesh)
                        eval_step = make_eval_step(cfg, mesh)
                        write_cfg(cfg)
                    log.info("grew RNN stack to %d layers at step %d",
                             cfg.num_layers, global_step)
                with span("train.accuracy"):
                    acc, err, ref = accuracy_from_outputs(
                        m, batch_np["labels"], batch_np["label_lens"])
                tot_err += err; tot_ref += ref
                with span("train.log"):
                    metrics_log.log(
                        "train_step", step=global_step,
                        loss_per_frame=float(m["loss_per_frame"]),
                        lr=float(m["lr"]), accuracy=acc,
                        grad_norm=float(m["grad_norm"]),
                        num_frames=int(m["num_frames"]))
                    if global_step % 10 == 0:
                        log.info(
                            "step %d loss/frame %.4f acc %.4f lr %.3g (%.1fs)",
                            global_step, float(m["loss_per_frame"]), acc,
                            float(m["lr"]), timer.elapsed())
                        timer.reset()
                if (valid_pipe is not None
                        and global_step % (args.cv_period * 10) == 0):
                    with span("train.cv"):
                        v_err = v_ref = 0; v_loss = 0.0; v_frames = 0
                        for vb in valid_pipe.epoch(0):
                            vb.pop("keys")
                            out = eval_step(state.params,
                                            shard_batch(vb, mesh),
                                            stats=state.stats)
                            _, e, r = accuracy_from_outputs(
                                out, vb["labels"], vb["label_lens"])
                            v_err += e; v_ref += r
                            v_loss += float(out["loss_total"])
                            v_frames += int(out["num_frames"])
                        v_err, v_ref = global_counts(v_err, v_ref)
                        v_acc = 1.0 - v_err / max(v_ref, 1)
                        metrics_log.log("valid", step=global_step,
                                        accuracy=v_acc,
                                        loss_per_frame=v_loss / max(v_frames,
                                                                    1))
                    log.info("valid @%d: acc %.4f", global_step, v_acc)
                if global_step % args.checkpoint_period == 0 and is_primary():
                    checkpoint({"epoch": epoch, "epoch_step": epoch_step,
                                "num_layers": cfg.num_layers})
                trace.step_ended(global_step)
            if (trained_batches == 0 and skipped_nonfinite == 0
                    and skip == 0):
                # an epoch that formed no batches at all must not report
                # a vanity accuracy of 1.0: every example was filtered out
                # before batching, a configuration error (a resume that
                # skips the whole start epoch is the one legitimate case).
                # An epoch whose batches were all skipped as non-finite
                # is what --nonfinite-action skip asked to survive.
                log.error("epoch %d produced zero training batches "
                          "(all examples filtered before batching)", epoch)
                raise RuntimeError(
                    f"epoch {epoch} produced zero training batches")
            if trained_batches == 0 and skipped_nonfinite > 0:
                log.warning("epoch %d: every batch (%d) was skipped as "
                            "non-finite — no parameters were updated",
                            epoch, skipped_nonfinite)
            # per-epoch accuracy line (parseable contract), global counts
            with span("train.log"):
                g_err, g_ref = global_counts(tot_err, tot_ref)
                if g_ref > 0:
                    metrics_log.log_accuracy(1.0 - g_err / max(g_ref, 1),
                                             epoch=epoch, step=global_step)
            tot_err = tot_ref = 0
            if is_primary():
                checkpoint({"epoch": epoch + 1, "num_layers": cfg.num_layers})
            with span("train.log"):
                last = write_timing(epoch, last)

    if not is_primary():
        log.info("done (secondary process): %d steps", global_step)
        return
    with span("train.checkpoint"):
        save_checkpoint(ckpt_dir, global_step, state,
                        extra={"epoch": args.epochs,
                               "num_layers": cfg.num_layers, "final": True})
    log.info("done: %d steps", global_step)


if __name__ == "__main__":
    main()
