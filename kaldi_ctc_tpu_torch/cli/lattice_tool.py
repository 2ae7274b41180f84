"""Lattice toolbox — copy/scale/prune/best-path/determinize/info.

Counterpart of ``kaldi_ctc_tpu/cli/lattice_tool.py``: the same host code over the
port's modules.

One CLI covering the latbin tools the CTC recipe touches
(``steps/ctc/decode.sh``, local/score.sh): lattice-copy, lattice-scale
(independent graph/acoustic scaling), lattice-prune (beam pruning around
the best path), lattice-best-path (words + alignment), and the CTC
pruned determinization (``ctc/ctc-graph.cc:245-269``) producing
CompactLattice text archives.

Inputs are text lattice archives as written by ``decode_ctc --lattice``
(raw Lattice) or this tool's ``determinize`` output (CompactLattice).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("copy", help="read + rewrite a lattice archive "
                       "(text or Kaldi binary in; --binary selects the "
                       "output format, so this is the lattice-copy "
                       "format converter)")
    c.add_argument("--lattices", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--binary", type=int, default=0,
                   help="1: write a Kaldi binary archive")

    s = sub.add_parser("scale", help="scale graph/acoustic costs")
    s.add_argument("--lattices", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--acoustic-scale", type=float, default=1.0)
    s.add_argument("--lm-scale", type=float, default=1.0)

    pr = sub.add_parser("prune", help="beam-prune around the best path")
    pr.add_argument("--lattices", required=True)
    pr.add_argument("--output", required=True)
    pr.add_argument("--beam", type=float, default=4.0)

    bp = sub.add_parser("best-path", help="words + alignment per utterance")
    bp.add_argument("--lattices", required=True)
    bp.add_argument("--acoustic-scale", type=float, default=1.0)
    bp.add_argument("--lm-scale", type=float, default=1.0)
    bp.add_argument("--words", default=None, help="words.txt symbol table")
    bp.add_argument("--compact", type=int, default=0,
                    help="1: input is a CompactLattice archive")
    bp.add_argument("--output", default=None)

    d = sub.add_parser("determinize",
                       help="pruned determinization -> CompactLattice")
    d.add_argument("--lattices", required=True)
    d.add_argument("--output", required=True)
    d.add_argument("--det-beam", type=float, default=10.0)

    i = sub.add_parser("info", help="archive stats")
    i.add_argument("--lattices", required=True)
    i.add_argument("--compact", type=int, default=0)

    m = sub.add_parser(
        "mbr", help="Minimum-Bayes-Risk decode + confusion network "
                    "(lattice-mbr-decode / sausages)")
    m.add_argument("--lattices", required=True,
                   help="CompactLattice archive (lattice_tool determinize "
                        "output) unless --compact 0 (raw; determinized "
                        "on the fly)")
    m.add_argument("--compact", type=int, default=1)
    m.add_argument("--acoustic-scale", type=float, default=1.0)
    m.add_argument("--lm-scale", type=float, default=1.0)
    m.add_argument("--no-mbr", action="store_true",
                   help="MAP hypothesis + sausage stats only (do_mbr "
                        "false)")
    m.add_argument("--words", default=None, help="words.txt symbol table")
    m.add_argument("--output", default=None, help="transcripts out")
    m.add_argument("--sausage", default=None,
                   help="write confusion-network bins (JSON lines)")
    m.add_argument("--ctm", default=None,
                   help="write NIST CTM with times + confidences "
                        "(lattice-to-ctm-conf analogue)")
    m.add_argument("--frame-shift", type=float, default=0.01,
                   help="seconds per lattice frame for CTM times "
                        "(multiply by the frame-subsampling factor when "
                        "the model ran subsampled)")

    nb = sub.add_parser("nbest", help="N best word sequences per lattice")
    nb.add_argument("--lattices", required=True)
    nb.add_argument("--n", type=int, default=10)
    nb.add_argument("--acoustic-scale", type=float, default=1.0)
    nb.add_argument("--lm-scale", type=float, default=1.0)
    nb.add_argument("--words", default=None)
    nb.add_argument("--output", default=None)

    po = sub.add_parser("post", help="arc posteriors (lattice-arc-post)")
    po.add_argument("--lattices", required=True)
    po.add_argument("--acoustic-scale", type=float, default=1.0)
    po.add_argument("--lm-scale", type=float, default=1.0)
    po.add_argument("--output", default=None,
                    help="per-arc 'key from to ilabel olabel post' lines")
    po.add_argument("--min-post", type=float, default=0.0001)

    aw = sub.add_parser(
        "align-words", help="re-partition CompactLattice arcs onto word "
                            "boundaries (lattice-align-words-lexicon)")
    aw.add_argument("--lattices", required=True,
                    help="CompactLattice archive")
    aw.add_argument("--output", required=True)
    aw.add_argument("--lexicon", required=True,
                    help="'word phone...' pronunciation lexicon")
    aw.add_argument("--words", required=True, help="words.txt symbol table")
    aw.add_argument("--phones", required=True,
                    help="phones.txt symbol table")
    aw.add_argument("--trans-model", default=None,
                    help="Kaldi TransitionModel (.mdl); omit for native "
                         "unit graphs (graph label = phone+1)")
    aw.add_argument("--silence-label", type=int, default=0,
                    help="word id for inter-word blank stretches")
    aw.add_argument("--partial-word-label", type=int, default=0,
                    help="word id for forced-out partial words")
    aw.add_argument("--output-error-lats", type=int, default=1,
                    help="1: pass unalignable lattices through unchanged")

    pu = sub.add_parser(
        "push", help="push CompactLattice strings/weights toward the "
                     "start (lattice-push)")
    pu.add_argument("--lattices", required=True,
                    help="CompactLattice archive")
    pu.add_argument("--output", required=True)
    pu.add_argument("--push-strings", type=int, default=1)
    pu.add_argument("--push-weights", type=int, default=1)

    mi = sub.add_parser(
        "minimize", help="merge suffix-equivalent CompactLattice states "
                         "(lattice-minimize; pushes first by default)")
    mi.add_argument("--lattices", required=True,
                    help="CompactLattice archive (determinized)")
    mi.add_argument("--output", required=True)
    mi.add_argument("--delta", type=float, default=1.0 / 1024.0)
    mi.add_argument("--no-push", action="store_true",
                    help="skip the string/weight pushing prepass")

    lr = sub.add_parser(
        "lmrescore", help="add/subtract scaled ARPA LM scores "
                          "(lattice-lmrescore; use --lm-scale -1 with the "
                          "old LM to subtract, +1 with the new to add)")
    lr.add_argument("--lattices", required=True,
                    help="CompactLattice archive")
    lr.add_argument("--arpa", default=None)
    lr.add_argument("--const-arpa", default=None,
                    help="compiled const-ARPA .npz (lm_tool "
                         "compile-const) instead of --arpa "
                         "(lattice-lmrescore-const-arpa)")
    lr.add_argument("--words", required=True, help="words.txt symbol table")
    lr.add_argument("--lm-scale", type=float, default=1.0)
    lr.add_argument("--output", required=True)

    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.decoding.det_lattice import (
        determinize_lattice_pruned, write_compact_lattice_text)
    from kaldi_ctc_tpu_torch.decoding.lattice import LatticeWriter
    from kaldi_ctc_tpu_torch.decoding.lattice_binary import (
        BinaryLatticeWriter, read_compact_lattice_ark, read_lattice_ark)
    # auto-detecting readers: Kaldi binary archives (lattice-copy's
    # default output) and text archives both work everywhere
    read_lattice_text_ark = read_lattice_ark
    read_compact_lattice_text_ark = read_compact_lattice_ark
    from kaldi_ctc_tpu_torch.utils import get_logger

    args = parse_args(argv)
    log = get_logger("lattice_tool")

    from kaldi_ctc_tpu_torch.utils.kaldi_io import read_symbol_table

    def _read_word_syms(path):
        return read_symbol_table(path) if path else None

    def _sym(w, syms):
        return syms.get(int(w), str(int(w))) if syms else str(int(w))

    if args.cmd == "copy":
        n = 0
        writer_cls = BinaryLatticeWriter if args.binary else LatticeWriter
        with writer_cls(args.output) as w:
            for key, lat in read_lattice_text_ark(args.lattices):
                w[key] = lat; n += 1
        log.info("copied %d lattices", n)

    elif args.cmd == "scale":
        n = 0
        with LatticeWriter(args.output) as w:
            for key, lat in read_lattice_text_ark(args.lattices):
                w[key] = lat.scale(acoustic_scale=args.acoustic_scale,
                                   lm_scale=args.lm_scale)
                n += 1
        log.info("scaled %d lattices", n)

    elif args.cmd == "prune":
        n = 0
        states_in = states_out = 0
        with LatticeWriter(args.output) as w:
            for key, lat in read_lattice_text_ark(args.lattices):
                pruned = lat.prune(args.beam)
                states_in += lat.num_states
                states_out += pruned.num_states
                w[key] = pruned; n += 1
        log.info("pruned %d lattices (%d -> %d states)", n, states_in,
                 states_out)

    elif args.cmd == "best-path":
        word_syms = _read_word_syms(args.words)
        reader = (read_compact_lattice_text_ark if args.compact
                  else read_lattice_text_ark)
        out_f = open(args.output, "w") if args.output else sys.stdout
        for key, lat in reader(args.lattices):
            words, align, cost = lat.best_path(
                acoustic_scale=args.acoustic_scale, lm_scale=args.lm_scale)
            if word_syms is not None:
                toks = [word_syms.get(int(x), str(int(x))) for x in words]
            else:
                toks = [str(int(x)) for x in words]
            print(key, " ".join(toks), file=out_f)
        if args.output:
            out_f.close()

    elif args.cmd == "determinize":
        n = 0
        with open(args.output, "w") as f:
            for key, lat in read_lattice_text_ark(args.lattices):
                clat = determinize_lattice_pruned(lat,
                                                  det_beam=args.det_beam)
                write_compact_lattice_text(f, key, clat)
                n += 1
        log.info("determinized %d lattices", n)

    elif args.cmd == "mbr":
        from kaldi_ctc_tpu_torch.decoding.mbr import MinimumBayesRisk
        word_syms = _read_word_syms(args.words)
        out_f = open(args.output, "w") if args.output else sys.stdout
        saus_f = open(args.sausage, "w") if args.sausage else None
        ctm_f = open(args.ctm, "w") if args.ctm else None
        n = 0
        tot_risk = 0.0
        if args.compact:
            source = read_compact_lattice_text_ark(args.lattices)
        else:
            source = ((k, determinize_lattice_pruned(lat))
                      for k, lat in read_lattice_text_ark(args.lattices))
        for key, clat in source:
            try:
                mbr = MinimumBayesRisk(clat, do_mbr=not args.no_mbr,
                                       acoustic_scale=args.acoustic_scale,
                                       lm_scale=args.lm_scale)
            except ValueError as e:
                # e.g. no successful path: warn and skip, keep the batch
                # going (lattice-mbr-decode behavior)
                log.warning("skipping %s: %s", key, e)
                continue
            toks = [_sym(w, word_syms) for w in mbr.one_best]
            print(key, " ".join(toks), file=out_f)
            tot_risk += mbr.bayes_risk
            n += 1
            if saus_f is not None:
                bins = [{"words": [[_sym(w, word_syms), round(p, 6)]
                                   for w, p in b],
                         "time": [round(t, 2) for t in tm]}
                        for b, tm in zip(mbr.sausage, mbr.times)]
                print(json.dumps({
                    "key": key, "bayes_risk": round(mbr.bayes_risk, 4),
                    "confidences": [round(c, 4)
                                    for c in mbr.one_best_confidences],
                    "bins": bins}), file=saus_f)
            if ctm_f is not None:
                # NIST CTM: utt channel start duration word [confidence]
                for w, (tb, te), conf in zip(mbr.one_best,
                                             mbr.one_best_times,
                                             mbr.one_best_confidences):
                    start = tb * args.frame_shift
                    dur = max(te - tb, 0.0) * args.frame_shift
                    print(f"{key} 1 {start:.2f} {dur:.2f} "
                          f"{_sym(w, word_syms)} {conf:.2f}", file=ctm_f)
        if args.output:
            out_f.close()
        if saus_f is not None:
            saus_f.close()
        if ctm_f is not None:
            ctm_f.close()
        log.info("MBR-decoded %d lattices, mean Bayes risk %.3f",
                 n, tot_risk / max(n, 1))

    elif args.cmd == "nbest":
        word_syms = _read_word_syms(args.words)
        out_f = open(args.output, "w") if args.output else sys.stdout
        n = 0
        for key, lat in read_lattice_text_ark(args.lattices):
            for rank, (words, align, cost) in enumerate(
                    lat.nbest(args.n, acoustic_scale=args.acoustic_scale,
                              lm_scale=args.lm_scale)):
                toks = [_sym(int(w), word_syms) for w in words]
                print(f"{key}-{rank + 1} {cost:.4f} {' '.join(toks)}",
                      file=out_f)
            n += 1
        if args.output:
            out_f.close()
        log.info("wrote %d-best for %d lattices", args.n, n)

    elif args.cmd == "post":
        out_f = open(args.output, "w") if args.output else sys.stdout
        n = 0
        for key, lat in read_lattice_text_ark(args.lattices):
            post = lat.arc_posteriors(acoustic_scale=args.acoustic_scale,
                                      lm_scale=args.lm_scale)
            for i in range(lat.num_arcs):
                if post[i] < args.min_post:
                    continue
                print(f"{key} {lat.arc_from[i]} {lat.arc_to[i]} "
                      f"{lat.arc_ilabel[i]} {lat.arc_olabel[i]} "
                      f"{post[i]:.6f}", file=out_f)
            n += 1
        if args.output:
            out_f.close()
        log.info("wrote arc posteriors for %d lattices", n)

    elif args.cmd == "align-words":
        from kaldi_ctc_tpu_torch.decoding.word_align import (
            AlignError, word_align_lattice_lexicon)
        from kaldi_ctc_tpu_torch.lm.lexicon import parse_lexicon

        word_ids = read_symbol_table(args.words, invert=True)
        phone_ids = read_symbol_table(args.phones, invert=True)
        prons = {}
        for word, phones in parse_lexicon(args.lexicon):
            if word not in word_ids:
                continue
            try:
                pron = tuple(phone_ids[p] for p in phones)
            except KeyError as e:
                log.warning("lexicon phone %s not in phones.txt; "
                            "skipping a pron of %s", e, word)
                continue
            prons.setdefault(word_ids[word], []).append(pron)
        tid_phone = tid_selfloop = None
        if args.trans_model:
            from kaldi_ctc_tpu_torch.utils.transition_model import \
                read_transition_model
            tm = read_transition_model(args.trans_model)
            tid_phone = tm.tid_to_phone()
            tid_selfloop = tm.tid_is_self_loop()
        n = n_err = 0
        with open(args.output, "w") as f:
            for key, clat in read_compact_lattice_text_ark(args.lattices):
                try:
                    out = word_align_lattice_lexicon(
                        clat, prons, tid_phone, tid_selfloop,
                        silence_label=args.silence_label,
                        partial_word_label=args.partial_word_label)
                    n += 1
                except AlignError as e:
                    log.warning("could not align %s: %s", key, e)
                    n_err += 1
                    if not args.output_error_lats:
                        continue
                    out = clat
                write_compact_lattice_text(f, key, out)
        log.info("word-aligned %d lattices, errors on %d", n, n_err)

    elif args.cmd == "push":
        from kaldi_ctc_tpu_torch.decoding.lattice_ops import (
            push_compact_lattice_strings, push_compact_lattice_weights)
        n = 0
        with open(args.output, "w") as f:
            for key, clat in read_compact_lattice_text_ark(args.lattices):
                if args.push_strings:
                    clat = push_compact_lattice_strings(clat)
                if args.push_weights:
                    clat = push_compact_lattice_weights(clat)
                write_compact_lattice_text(f, key, clat)
                n += 1
        log.info("pushed %d lattices", n)

    elif args.cmd == "minimize":
        from kaldi_ctc_tpu_torch.decoding.lattice_ops import \
            minimize_compact_lattice
        n = 0
        states_in = states_out = 0
        with open(args.output, "w") as f:
            for key, clat in read_compact_lattice_text_ark(args.lattices):
                out = minimize_compact_lattice(clat, delta=args.delta,
                                               push=not args.no_push)
                states_in += clat.num_states
                states_out += out.num_states
                write_compact_lattice_text(f, key, out)
                n += 1
        log.info("minimized %d lattices (%d -> %d states)", n, states_in,
                 states_out)

    elif args.cmd == "lmrescore":
        from kaldi_ctc_tpu_torch.decoding.rescore import lmrescore_compact
        if args.const_arpa:
            from kaldi_ctc_tpu_torch.lm.const_arpa import ConstArpaLm
            lm = ConstArpaLm.load(args.const_arpa)
        elif args.arpa:
            from kaldi_ctc_tpu_torch.lm import parse_arpa
            lm = parse_arpa(args.arpa)
        else:
            log.error("lmrescore needs --arpa or --const-arpa")
            sys.exit(1)
        syms = _read_word_syms(args.words) or {}
        n = 0
        with open(args.output, "w") as f:
            for key, clat in read_compact_lattice_text_ark(args.lattices):
                out = lmrescore_compact(clat, lm, syms,
                                        lm_scale=args.lm_scale)
                write_compact_lattice_text(f, key, out)
                n += 1
        log.info("LM-rescored %d lattices (scale %.2f)", n, args.lm_scale)

    elif args.cmd == "info":
        reader = (read_compact_lattice_text_ark if args.compact
                  else read_lattice_text_ark)
        n = 0
        states = arcs = 0
        for key, lat in reader(args.lattices):
            n += 1
            states += lat.num_states
            arcs += lat.num_arcs
        print(json.dumps({"num_lattices": n, "total_states": states,
                          "total_arcs": arcs}))


if __name__ == "__main__":
    main()
