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

One process trains on one device (``parallel`` is a stand-in until
ROADMAP.md item 14); ``--minibatch-size`` is the global batch and the
final short batch of an epoch is dropped, as in the JAX package.  These
raise ``NotImplementedError`` before any file is written:
``--realign-epochs`` and ``--affine-type natural`` (ROADMAP item 13),
``--dropout > 0``, splicing, the FT front and the DS2 conv front (item
12).  ``init_model``'s caveat holds here too: the same ``--seed`` draws
other initial numbers than JAX's (``torch.Generator``), so runs are
compared from one shared checkpoint with ``--resume``.

Example (tiny sanity run on the CPU):
  python -m kaldi_ctc_tpu_torch.cli.train_ctc \\
      --feats scp:data/train/feats.scp --ali ark:exp/ali.ark \\
      --num-targets 72 --dir exp/ctc --epochs 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_AM_EXTRAS = "{} is not ported yet: ROADMAP.md item 12 (am_forward extras)"


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
                   help="input splice left context (not ported yet: "
                        "raises)")
    p.add_argument("--splice-right", type=int, default=0)
    p.add_argument("--front-nonlin", default="relu",
                   choices=["relu", "tanh", "sigmoid", "pnorm", "maxout"],
                   help="front-layer nonlinearity of the FT front")
    p.add_argument("--front-group", type=int, default=1,
                   help="group size for pnorm/maxout front layers")
    p.add_argument("--front-affine-dim", type=int, default=0,
                   help="FT model type front layer width (0 = google "
                        "type; not ported yet: raises)")
    p.add_argument("--conv-layers", type=int, default=0,
                   help="DS2 model type conv layers (not ported yet: "
                        "raises)")
    p.add_argument("--conv-channels", type=int, default=32)
    p.add_argument("--conv-time-stride", type=int, default=2)
    p.add_argument("--conv-norm", default="seq", choices=["seq", "none"])
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout after the RNN stack (not ported yet: "
                        "> 0 raises)")
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
                   help="natural: online NG-SGD (not ported yet: raises)")
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
                   help="epochs at whose start the model realigns the "
                        "training set (not ported yet: raises)")
    p.add_argument("--cv-period", type=int, default=10,
                   help="diagnostic eval every N steps x 10")
    p.add_argument("--checkpoint-period", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dir", required=True, help="experiment directory")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=int, default=0,
                   help="1: per-section host timing summary at exit "
                        "(AccuProfile analogue)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace here")
    p.add_argument("--device", default="cuda",
                   help="torch device the model trains on; 'cuda' with no "
                        "card raises")
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Raise for the options the port does not run yet, before anything
    is read or written."""
    if args.realign_epochs:
        raise NotImplementedError(
            "--realign-epochs is not ported yet: ROADMAP.md item 13 "
            "(ctc_viterbi_align, training/realign.py)")
    if args.affine_type == "natural":
        raise NotImplementedError(
            "--affine-type natural (online natural-gradient SGD) is not "
            "ported yet: ROADMAP.md item 13")
    if args.dropout > 0.0:
        raise NotImplementedError(_AM_EXTRAS.format("--dropout > 0"))
    if args.splice_left or args.splice_right:
        raise NotImplementedError(_AM_EXTRAS.format("input splicing"))
    if args.front_affine_dim:
        raise NotImplementedError(_AM_EXTRAS.format(
            "the FT front (--front-affine-dim)"))
    if args.conv_layers:
        raise NotImplementedError(_AM_EXTRAS.format(
            "the DS2 conv front (--conv-layers)"))


def initial_params(cfg, seed: int, device):
    """The parameters a fresh run starts from: ``init_am_params`` drawn
    from ``torch.Generator().manual_seed(seed)``."""
    import torch

    from kaldi_ctc_tpu_torch.models import init_am_params
    return init_am_params(cfg, torch.Generator().manual_seed(seed), device)


def main(argv=None):
    import torch

    from kaldi_ctc_tpu_torch.cli.common import resolve_device
    from kaldi_ctc_tpu_torch.data import EgsPipeline, Prefetcher, load_examples
    from kaldi_ctc_tpu_torch.models import AmConfig, grow_rnn_layer
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    from kaldi_ctc_tpu_torch.parallel import make_mesh, shard_batch
    from kaldi_ctc_tpu_torch.parallel.distributed import (init_distributed,
                                                          is_primary)
    from kaldi_ctc_tpu_torch.training import (
        TrainOptions, accuracy_from_outputs, init_train_state,
        make_eval_step, make_train_step)
    from kaldi_ctc_tpu_torch.training.checkpoint import (
        apply_retention, latest_step, read_meta, restore_checkpoint,
        save_checkpoint)
    from kaldi_ctc_tpu_torch.utils import get_logger, profiling
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader
    from kaldi_ctc_tpu_torch.utils.logging import MetricsLogger, Timer

    args = parse_args(argv)
    check_ported(args)
    init_distributed()
    device = resolve_device(args.device)
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
    if args.egs:
        from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
        examples = list(SequentialEgsReader(args.egs))
    elif args.feats and args.ali:
        examples = list(load_examples(args.feats, args.ali,
                                      cmvn_rspecifier=args.cmvn,
                                      utt2spk=utt2spk))
    else:
        log.error("need --egs or both --feats and --ali"); sys.exit(1)
    if not examples:
        log.error("no examples loaded"); sys.exit(1)
    input_dim = examples[0].feats.shape[1]
    log.info("loaded %d utterances, input dim %d", len(examples), input_dim)

    # --minibatch-size is the global batch (reference semantics: lr*sum
    # over that many utterances); one process assembles all of it
    if len(examples) < args.minibatch_size:
        # the final short batch is dropped, so fewer examples than one
        # batch would train zero steps silently
        log.error("only %d utterances for a per-host batch of %d: every "
                  "epoch would yield zero batches — reduce "
                  "--minibatch-size", len(examples), args.minibatch_size)
        sys.exit(1)

    pipe = EgsPipeline(
        examples, minibatch_size=args.minibatch_size,
        max_allow_frames=args.max_allow_frames,
        frame_subsampling_factor=args.frame_subsampling_factor,
        seed=args.seed)

    valid_pipe = None
    if args.valid_feats and args.valid_ali:
        valid_examples = list(load_examples(args.valid_feats, args.valid_ali,
                                            cmvn_rspecifier=args.cmvn,
                                            utt2spk=utt2spk))
        valid_pipe = EgsPipeline(
            valid_examples, minibatch_size=args.minibatch_size,
            max_allow_frames=args.max_allow_frames,
            frame_subsampling_factor=args.frame_subsampling_factor,
            seed=args.seed + 1000)

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

    # rough decay horizon: one step consumes minibatch_size utterances
    steps_per_epoch = max(len(examples) // args.minibatch_size, 1)
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

    mesh = make_mesh(device)
    state = init_train_state(initial_params(cfg, args.seed, device), opts)
    start_epoch = 0
    start_epoch_step = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        state, meta = restore_checkpoint(ckpt_dir, state)
        start_epoch = meta["extra"].get("epoch", 0)
        # resume mid-epoch: skip the batches already trained (the epoch
        # order is deterministic given the epoch seed), otherwise they
        # are double-trained and the lr decay horizon is overrun
        start_epoch_step = meta["extra"].get("epoch_step", 0)
        log.info("resumed from step %d (epoch %d, batch %d)",
                 meta["step"], start_epoch, start_epoch_step)

    train_step = make_train_step(cfg, opts)
    eval_step = make_eval_step(cfg)
    timer = Timer()
    tot_err = tot_ref = 0
    global_step = int(state.step)

    # the trace closes on the way out of the with, a failed step included,
    # or the profile directory is left unusable
    with profiling.trace(args.profile_dir):
        for epoch in range(start_epoch, args.epochs):
            log.info("epoch %d", epoch)
            epoch_step = 0
            trained_batches = skipped_nonfinite = 0
            skip = start_epoch_step if epoch == start_epoch else 0
            for batch_np in Prefetcher(pipe.epoch(epoch)):
                if epoch_step < skip:
                    epoch_step += 1
                    continue
                epoch_step += 1
                keys = batch_np.pop("keys")
                batch = shard_batch(batch_np, mesh)
                with profiling.profiler.track("train_step"):
                    state, m = train_step(state, batch)
                global_step += 1
                if not bool(m["finite"]):
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
                    metrics_log.log("skipped_nonfinite", step=global_step)
                    skipped_nonfinite += 1
                    continue
                trained_batches += 1
                if (grow and cfg.num_layers < args.num_layers
                        and global_step % args.add_layers_period == 0):
                    new_params, cfg = grow_rnn_layer(
                        state.params, cfg, torch.Generator().manual_seed(
                            args.seed + 100 + cfg.num_layers))
                    # the tree changed: fresh velocity, rebuilt steps
                    state = init_train_state(new_params,
                                             opts)._replace(step=state.step)
                    train_step = make_train_step(cfg, opts)
                    eval_step = make_eval_step(cfg)
                    write_cfg(cfg)
                    log.info("grew RNN stack to %d layers at step %d",
                             cfg.num_layers, global_step)
                acc, err, ref = accuracy_from_outputs(
                    m, batch_np["labels"], batch_np["label_lens"])
                tot_err += err; tot_ref += ref
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
                    v_err = v_ref = 0; v_loss = 0.0; v_frames = 0
                    for vb in valid_pipe.epoch(0):
                        vb.pop("keys")
                        out = eval_step(state.params, shard_batch(vb, mesh))
                        _, e, r = accuracy_from_outputs(
                            out, vb["labels"], vb["label_lens"])
                        v_err += e; v_ref += r
                        v_loss += float(out["loss_total"])
                        v_frames += int(out["num_frames"])
                    v_acc = 1.0 - v_err / max(v_ref, 1)
                    metrics_log.log("valid", step=global_step, accuracy=v_acc,
                                    loss_per_frame=v_loss / max(v_frames, 1))
                    log.info("valid @%d: acc %.4f", global_step, v_acc)
                if global_step % args.checkpoint_period == 0 and is_primary():
                    save_checkpoint(ckpt_dir, global_step, state,
                                    extra={"epoch": epoch,
                                           "epoch_step": epoch_step,
                                           "num_layers": cfg.num_layers})
                    apply_retention(ckpt_dir)
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
            # per-epoch accuracy line (parseable contract)
            if tot_ref > 0:
                metrics_log.log_accuracy(1.0 - tot_err / max(tot_ref, 1),
                                         epoch=epoch, step=global_step)
            tot_err = tot_ref = 0
            if is_primary():
                save_checkpoint(ckpt_dir, global_step, state,
                                extra={"epoch": epoch + 1,
                                       "num_layers": cfg.num_layers})
                apply_retention(ckpt_dir)

    save_checkpoint(ckpt_dir, global_step, state,
                    extra={"epoch": args.epochs, "num_layers": cfg.num_layers,
                           "final": True})
    log.info("done: %d steps", global_step)


if __name__ == "__main__":
    main()
