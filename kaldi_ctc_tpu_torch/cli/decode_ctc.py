"""CTC decoding CLI (the LM-free part of nnet2-ctc-latgen-faster).

Counterpart of ``kaldi_ctc_tpu/cli/decode_ctc.py`` with the same flags,
defaults and output, plus ``--device`` (default ``cuda``; with no card it
raises, it never runs on the CPU unasked).  Runs the acoustic model over
utterances on the device (on the card the kernels of the model's layers,
K2 for a BLSTM), applies the decodable-layer semantics (prior division,
blank-threshold, acoustic scale — ctc/ctc-decodable-am-nnet.cc:29-87),
decodes greedy or prefix-beam on the device or best-path through the
native WFST decoder on the host, writes hypothesis label sequences (word
sequences with a words table), reports RTF like the reference
(ctcbin/nnet2-ctc-latgen-faster.cc:238-245), and scores the label error
rate when reference text is given.  With ``--method wfst --lattice``
each utterance's lattice is generated on the host from the device's
scores (blank-threshold frames dropped), pruned at ``--lattice-beam``,
optionally determinized (``--determinize 1``), and written as a text
archive.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats", required=True)
    p.add_argument("--cmvn", default=None)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--dir", default=None,
                   help="experiment dir (checkpoints)")
    p.add_argument("--model", default=None,
                   help="inference artifact (.npz from copy_model); "
                        "replaces --dir")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--method", choices=["greedy", "beam", "wfst"],
                   default="beam")
    p.add_argument("--graph", default=None,
                   help="CTC decoding graph (VectorFst) for --method wfst")
    p.add_argument("--trans-model", default=None,
                   help="Kaldi TransitionModel (.mdl) — maps the graph's "
                        "tid+1 labels to score columns; default assumes "
                        "graph ilabels are already pdf+1")
    p.add_argument("--words", default=None,
                   help="words.txt symbol table (id word) for wfst output")
    p.add_argument("--lattice", default=None,
                   help="write lattices (text archive) to this path; "
                        "wfst method only")
    p.add_argument("--determinize", type=int, default=0,
                   help="1: determinize lattices before writing")
    p.add_argument("--lattice-beam", type=float, default=10.0,
                   help="forward-backward lattice pruning margin "
                        "(run_ctc_phone.sh lattice_beam default 10)")
    p.add_argument("--wfst-beam", type=float, default=16.0,
                   help="decoding beam (run_ctc_phone.sh uses 20)")
    p.add_argument("--max-active", type=int, default=7000)
    p.add_argument("--decode-threads", type=int, default=0,
                   help="native decoder threads for wfst batch decode "
                        "(0 = hardware concurrency)")
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--prune-k", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--blank-threshold", type=float, default=0.98)
    p.add_argument("--use-priors", type=int, default=1)
    p.add_argument("--blank-prior", type=float, default=9.0)
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--minibatch-size", type=int, default=16)
    p.add_argument("--text", default=None,
                   help="reference label seqs (text table of ints) for error rate")
    p.add_argument("--output", default=None, help="hypotheses output file")
    p.add_argument("--profile", type=int, default=0,
                   help="1: print the table of spans and counters at "
                        "exit")
    p.add_argument("--device", default="cuda",
                   help="torch device the model and the greedy and beam "
                        "decoders run on; 'cuda' with no card raises")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from kaldi_ctc_tpu_torch.cli.common import (batches,
                                                read_feature_examples,
                                                resolve_device)
    from kaldi_ctc_tpu_torch.decoding import (acoustic_scores,
                                              greedy_decode,
                                              prefix_beam_search)
    from kaldi_ctc_tpu_torch.models import am_forward, default_priors
    from kaldi_ctc_tpu_torch.models.artifact import (load_acoustic_model,
                                                     load_norm_stats)
    from kaldi_ctc_tpu_torch.utils import get_logger, profiling
    from kaldi_ctc_tpu_torch.utils.edit_distance import edit_distance
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader

    args = parse_args(argv)
    log = get_logger("decode_ctc")
    device = resolve_device(args.device)
    if args.profile:
        profiling.enable()
    priors = None
    try:
        model_params, cfg, loaded_priors, _ = load_acoustic_model(
            args.model, args.dir, args.step, device=device)
        norm_stats = load_norm_stats(cfg, args.model, args.dir, args.step,
                                     device)
    except ValueError as e:
        log.error("%s", e); sys.exit(1)
    if args.use_priors:
        priors = (loaded_priors if loaded_priors is not None
                  else default_priors(cfg.num_targets, args.blank_prior))

    graph = None
    word_syms = None
    ilabel_map = None
    lat_writer = None
    if args.method == "wfst":
        from kaldi_ctc_tpu_torch.decoding.wfst import (NativeFst,
                                                       decode_best_path_batch)
        if not args.graph:
            log.error("--method wfst requires --graph"); sys.exit(1)
        graph = NativeFst.load(args.graph)
        if args.lattice:
            from kaldi_ctc_tpu_torch.decoding.lattice import LatticeWriter
            lat_writer = LatticeWriter(args.lattice)
        if args.trans_model:
            from kaldi_ctc_tpu_torch.utils.transition_model import (
                ctc_ilabel_map, read_transition_model)
            ilabel_map = ctc_ilabel_map(read_transition_model(args.trans_model))
        if args.words:
            from kaldi_ctc_tpu_torch.utils.kaldi_io import read_symbol_table
            word_syms = read_symbol_table(args.words)

    egs = read_feature_examples(args.feats, args.cmvn, args.utt2spk,
                                args.frame_subsampling_factor)

    def emit(key, words):
        if word_syms is not None:
            hyps[key] = [word_syms.get(w, str(w)) for w in words]
        else:
            hyps[key] = list(map(int, words))

    hyps = {}
    total_frames = 0
    t0 = time.perf_counter()
    for group, batch in batches(egs, args.minibatch_size):
        with profiling.profiler.span("decode.am_forward"), \
                torch.inference_mode():
            logits = am_forward(
                model_params, torch.as_tensor(batch["feats"], device=device),
                cfg, torch.as_tensor(batch["input_lens"], device=device),
                stats=norm_stats)
            scores, skip = acoustic_scores(
                logits, priors=priors, acoustic_scale=args.acoustic_scale,
                blank_threshold=args.blank_threshold)
            # the span ends once the host holds the scores (or the device
            # has made them): it times the work, not the enqueue
            if args.method == "wfst":
                scores_np = scores.cpu().numpy()
                skip_np = skip.cpu().numpy()
            elif scores.is_cuda:
                torch.cuda.synchronize(scores.device)
        # conv time stride: score rows per utterance (identity without)
        score_lens = np.asarray(cfg.output_lens(batch["input_lens"]))
        if args.method == "wfst":
            todo = []     # (key, rows) with blank-threshold frames dropped
            for j, e in enumerate(group):
                t = int(score_lens[j])
                # drop blank-threshold frames exactly like the reference
                # (ctc-decodable-am-nnet.cc:54-69)
                rows = scores_np[j, :t][~skip_np[j, :t]]
                if rows.shape[0] == 0:
                    hyps[e.key] = []
                    continue
                todo.append((e.key, rows))
            if lat_writer is not None:
                from kaldi_ctc_tpu_torch.decoding.lattice import decode_lattice
                for key, rows in todo:
                    lat = decode_lattice(
                        graph, rows, ilabel_map=ilabel_map,
                        beam=args.wfst_beam, max_active=args.max_active,
                        lattice_beam=args.lattice_beam)
                    if args.determinize:
                        from kaldi_ctc_tpu_torch.decoding.det_lattice import (
                            determinize_lattice_pruned,
                            write_compact_lattice_text)
                        clat = determinize_lattice_pruned(
                            lat, det_beam=args.lattice_beam)
                        write_compact_lattice_text(
                            lat_writer._f, key, clat)
                        words, _, _ = clat.best_path()
                    else:
                        lat_writer[key] = lat
                        words, _, _ = lat.best_path()
                    emit(key, words)
            elif todo:
                # threaded native batch decode (nj-parallel analogue)
                results = decode_best_path_batch(
                    graph, [rows for _, rows in todo],
                    ilabel_map=ilabel_map, beam=args.wfst_beam,
                    max_active=args.max_active,
                    num_threads=args.decode_threads)
                for (key, _), (words, _, _, ok) in zip(todo, results):
                    emit(key, words if ok else [])
        else:
            slens = torch.as_tensor(score_lens, device=device)
            if args.method == "greedy":
                labels, out_lens = greedy_decode(scores, slens)
            else:
                labels, out_lens, _ = prefix_beam_search(
                    scores, slens, beam=args.beam, prune_k=args.prune_k)
            labels = labels.cpu().numpy()
            out_lens = out_lens.cpu().numpy()
            for j, e in enumerate(group):
                hyps[e.key] = list(map(int, labels[j][: out_lens[j]]))
        total_frames += int(np.asarray(batch["input_lens"]).sum())
    if lat_writer is not None:
        lat_writer.close()
    elapsed = time.perf_counter() - t0
    # frames are frame_shift*fs_factor seconds of audio each
    audio_s = total_frames * 0.01 * args.frame_subsampling_factor
    rtf = elapsed / max(audio_s, 1e-9)
    log.info("decoded %d utts, %.1f audio-s in %.2f s (RTF %.4f)",
             len(hyps), audio_s, elapsed, rtf)

    out_f = open(args.output, "w") if args.output else sys.stdout
    for k in sorted(hyps):
        print(k, " ".join(map(str, hyps[k])), file=out_f)
    if args.output:
        out_f.close()

    if args.text:
        refs = {k: v.split() for k, v in SequentialTextReader(args.text)}
        err = tot = 0
        for k, hyp in hyps.items():
            if k in refs:
                err += edit_distance(refs[k], [str(x) for x in hyp])
                tot += len(refs[k])
        ler = err / max(tot, 1)
        print(json.dumps({"label_error_rate": ler, "errors": err,
                          "ref_tokens": tot, "rtf": rtf}))


if __name__ == "__main__":
    main()
