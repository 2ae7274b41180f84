"""Egs archive toolbox — get/copy/sort/shuffle/subset/perturb/relabel/info.

Counterpart of ``kaldi_ctc_tpu/cli/prepare_egs.py`` with the same
subcommands, flags, defaults, archives and printed lines; host-only
numpy, as there.

One CLI covering the ctcbin egs tool family
(``ctcbin/Makefile:10-14``):

  get      feats+ali → egs archives, with the length filters of
           nnet-ctc-get-egs (2L+1 <= T, L <= 639;
           ``ctcbin/nnet-ctc-get-egs.cc:31-82,150-166``), split across
           --num-archives outputs (nnet-ctc-copy-egs)
  copy     re-split existing archives across N outputs
  sort     sort by NumFrames, optionally windowed (nnet-ctc-sort-egs)
  shuffle  buffered shuffle + frame subsample/shift (nnet-ctc-shuffle-egs)
  subset   take N examples (nnet-ctc-subset-egs; diagnostics subsets)
  perturb  covariance-shaped Gaussian noise (nnet-ctc-perturb-egs.cc:30-45)
  relabel  swap labels from new alignments (nnet-ctc-relabel-egs)
  info     count/length stats of an archive

Archive outputs take a template containing ``JOB`` when splitting, e.g.
``--output "ark,scp:egs.JOB.ark,egs.JOB.scp" --num-archives 8``.
"""

from __future__ import annotations

import argparse

import numpy as np


def _expand(template: str, idx: int) -> str:
    return template.replace("JOB", str(idx + 1))


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("get", help="feats+ali (or feats+text+lexicon "
                       "for flat-start) -> egs archives")
    g.add_argument("--feats", required=True)
    g.add_argument("--ali", default=None,
                   help="pdf-id alignments (GMM-bootstrap route)")
    g.add_argument("--trans-model", default=None,
                   help="Kaldi .mdl: --ali holds transition-ids "
                        "(gmm-align output) to be mapped to pdf-ids "
                        "first (ali-to-pdf)")
    g.add_argument("--text", default=None,
                   help="transcripts (flat-start route, with --lexicon)")
    g.add_argument("--lexicon", default=None,
                   help="'word phone...' lexicon for flat-start labels")
    g.add_argument("--phones", default=None,
                   help="phones.txt fixing phone ids (default: enumerate "
                        "lexicon phones from 1)")
    g.add_argument("--tree", default=None,
                   help="ContextDependency tree: flat-start labels become "
                        "tree pdfs+1 (context-dependent targets) instead "
                        "of phone ids (not ported yet: raises)")
    g.add_argument("--online-ivectors", default=None,
                   help="per-utterance online-ivector matrix table (one "
                        "row per --ivector-period frames): rows are "
                        "repeated to frame rate and pasted onto the "
                        "features, and --const-feat-dim is set to the "
                        "ivector dim (get_egs2.sh:200-211)")
    g.add_argument("--ivector-period", type=int, default=10,
                   help="frames per online-ivector row (the paste "
                        "length tolerance, get_egs2.sh:205-207)")
    g.add_argument("--const-feat-dim", type=int, default=0,
                   help="treat the last N feature dims as constant "
                        "speaker info (appended ivectors): replace them "
                        "by their utterance mean (nnet-ctc-get-egs "
                        "spk_info, ctcbin/nnet-ctc-get-egs.cc:150-166 — "
                        "equivalent layout: the mean is broadcast back "
                        "onto every frame instead of stored separately)")
    g.add_argument("--cmvn", default=None)
    g.add_argument("--utt2spk", default=None)
    g.add_argument("--add-deltas", type=int, default=0,
                   help="append delta features of this order (the "
                        "get_egs2.sh raw-feature route's add-deltas)")
    g.add_argument("--delta-window", type=int, default=2)
    g.add_argument("--splice-left", type=int, default=0,
                   help="splice this many left context frames before "
                        "--transform (the LDA route's splice-feats)")
    g.add_argument("--splice-right", type=int, default=0)
    g.add_argument("--transform", default=None,
                   help="global LDA/MLLT matrix file (Kaldi matrix, "
                        "linear [R,D] or affine [R,D+1]; transform-feats)")
    g.add_argument("--transforms", default=None,
                   help="per-speaker fMLLR transform rspecifier "
                        "(speaker keys via --utt2spk; transform-feats "
                        "--utt2spk)")
    g.add_argument("--output", required=True,
                   help="wspecifier template (JOB expands when splitting)")
    g.add_argument("--num-archives", type=int, default=1)
    g.add_argument("--random", type=int, default=0,
                   help="1: random archive assignment instead of round-robin")
    g.add_argument("--max-allow-frames", type=int, default=2000)
    g.add_argument("--max-label-length", type=int, default=639)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--compress", type=int, default=1)

    c = sub.add_parser("copy", help="re-split archives")
    c.add_argument("--egs", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--num-archives", type=int, default=1)
    c.add_argument("--random", type=int, default=0)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--compress", type=int, default=1)

    s = sub.add_parser("sort", help="sort by length")
    s.add_argument("--egs", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--window", type=int, default=0,
                   help="0 = global sort; N = sort within windows of N")
    s.add_argument("--compress", type=int, default=1)

    sh = sub.add_parser("shuffle", help="buffered shuffle + subsample/shift")
    sh.add_argument("--egs", required=True)
    sh.add_argument("--output", required=True)
    sh.add_argument("--buffer-size", type=int, default=5000)
    sh.add_argument("--frame-subsampling-factor", type=int, default=1)
    sh.add_argument("--frame-shift", type=int, default=0)
    sh.add_argument("--seed", type=int, default=0)
    sh.add_argument("--compress", type=int, default=1)

    su = sub.add_parser("subset", help="take first N examples")
    su.add_argument("--egs", required=True)
    su.add_argument("--output", required=True)
    su.add_argument("--n", type=int, required=True)
    su.add_argument("--compress", type=int, default=1)

    pe = sub.add_parser("perturb", help="covariance-shaped noise")
    pe.add_argument("--egs", required=True)
    pe.add_argument("--output", required=True)
    pe.add_argument("--noise-scale", type=float, default=0.1)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--compress", type=int, default=1)

    re_ = sub.add_parser("relabel", help="swap labels from new alignments")
    re_.add_argument("--egs", required=True)
    re_.add_argument("--ali", required=True)
    re_.add_argument("--frame-labels", type=int, default=0,
                     help="--ali holds align_ctc per-frame symbol ids "
                          "(already shifted, blank=0): collapse runs and "
                          "drop blanks instead of the GMM collapse+shift")
    re_.add_argument("--output", required=True)
    re_.add_argument("--compress", type=int, default=1)

    inf = sub.add_parser("info", help="archive stats")
    inf.add_argument("--egs", required=True)

    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.data.egs import example_ok, perturb_examples
    from kaldi_ctc_tpu_torch.data.egs_io import (
        EgsWriter, SequentialEgsReader, copy_egs, relabel_egs, shuffle_egs,
        sort_egs, subset_egs)
    from kaldi_ctc_tpu_torch.data.pipeline import load_examples
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (
        SequentialIntVectorReader, SequentialTextReader)

    args = parse_args(argv)
    log = get_logger("prepare_egs")

    def _split_write(egs_iter, template, num, random, seed, compress):
        writers = [EgsWriter(_expand(template, i) if num > 1 else template,
                             compress=bool(compress))
                   for i in range(num)]
        counts = [0] * num
        try:
            for idx, eg in copy_egs(egs_iter, num, random=bool(random),
                                    seed=seed):
                writers[idx][eg.key] = eg
                counts[idx] += 1
        finally:
            for w in writers:
                w.close()
        return counts

    if args.cmd == "get":
        utt2spk = (dict(SequentialTextReader(args.utt2spk))
                   if args.utt2spk else None)
        n_skip = 0
        n_oov = 0

        import dataclasses as _dc
        import numpy as _np2

        lda_mat = None
        if args.transform:
            from kaldi_ctc_tpu_torch.utils.kaldi_io import read_matrix
            lda_mat = read_matrix(args.transform)
        spk_trans = None
        if args.transforms:
            from kaldi_ctc_tpu_torch.utils.kaldi_io import \
                open_random_access_matrices
            spk_trans = open_random_access_matrices(args.transforms)
        ivectors = None
        if args.online_ivectors:
            from kaldi_ctc_tpu_torch.utils.kaldi_io import \
                open_random_access_matrices
            ivectors = open_random_access_matrices(args.online_ivectors)
            if args.const_feat_dim:
                raise SystemExit("--const-feat-dim is set automatically "
                                 "from --online-ivectors; don't pass both")

        def paste_ivectors(key, feats):
            """subsample-feats --n=-P | paste-feats --length-tolerance=P
            (get_egs2.sh:206): repeat each ivector row P times, trim
            both streams to the shorter if within tolerance.
            → (pasted feats, ivector dim) or (None, 0) to skip."""
            if key not in ivectors:
                log.warning("no online ivectors for %s: skipped", key)
                return None, 0
            raw = _np2.asarray(ivectors[key], _np2.float32)
            iv = _np2.repeat(raw, args.ivector_period, axis=0)
            t = min(len(feats), len(iv))
            if max(len(feats), len(iv)) - t > args.ivector_period:
                log.warning("ivector/feature length mismatch for %s "
                            "(%d vs %d frames, tolerance %d): skipped",
                            key, len(feats), len(iv), args.ivector_period)
                return None, 0
            return (_np2.concatenate([feats[:t], iv[:t]], axis=1),
                    raw.shape[1])

        def apply_spk_info(eg):
            # feature pipeline after CMVN, in get_egs2.sh order:
            # deltas | splice | LDA | per-speaker fMLLR | ivectors |
            # spk_info; returns None when the utterance must be skipped
            feats = eg.feats
            if args.add_deltas > 0:
                from kaldi_ctc_tpu_torch.features.functions import add_deltas
                feats = _np2.asarray(add_deltas(
                    feats, order=args.add_deltas,
                    window=args.delta_window))
            if args.splice_left or args.splice_right:
                from kaldi_ctc_tpu_torch.features.functions import splice_frames
                feats = _np2.asarray(splice_frames(
                    feats, args.splice_left, args.splice_right))
            if lda_mat is not None:
                from kaldi_ctc_tpu_torch.features.transform import apply_transform
                feats = apply_transform(feats, lda_mat)
            if spk_trans is not None:
                from kaldi_ctc_tpu_torch.features.transform import apply_transform
                spk = utt2spk.get(eg.key, eg.key) if utt2spk else eg.key
                if spk in spk_trans:
                    feats = apply_transform(feats, spk_trans[spk])
                else:
                    # mixing transformed and raw features silently would
                    # corrupt training — make every miss visible
                    log.warning("no fMLLR transform for speaker %s "
                                "(utterance %s): left untransformed",
                                spk, eg.key)
            n = args.const_feat_dim
            if ivectors is not None:
                feats, n = paste_ivectors(eg.key, feats)
                if feats is None:
                    return None
            # spk_info: utterance-mean of the trailing const dims,
            # broadcast back onto every frame
            if n > 0:
                feats = feats.copy() if feats is eg.feats else feats
                feats[:, -n:] = feats[:, -n:].mean(axis=0, keepdims=True)
            if feats is eg.feats:
                return eg
            return _dc.replace(eg,
                               feats=_np2.asarray(feats, _np2.float32))

        if args.ali:
            tid_map = None
            if args.trans_model:
                from kaldi_ctc_tpu_torch.utils.transition_model import (
                    read_transition_model)
                tid_map = \
                    read_transition_model(args.trans_model).tid_to_pdf()

            def gen():
                nonlocal n_skip
                for eg in load_examples(args.feats, args.ali,
                                        cmvn_rspecifier=args.cmvn,
                                        utt2spk=utt2spk,
                                        tid_to_pdf=tid_map):
                    # pipeline first, filters second (get_egs2.sh order:
                    # the feats string — incl. ivector paste trimming —
                    # runs before nnet-ctc-get-egs's 2L+1/639 checks)
                    eg = apply_spk_info(eg)
                    if eg is None or not example_ok(
                            eg, args.max_allow_frames,
                            max_label_length=args.max_label_length):
                        n_skip += 1
                        continue
                    yield eg
        elif args.text and args.lexicon:
            # flat-start: labels from transcripts via the lexicon (no
            # GMM bootstrap; CTC only needs label order)
            from kaldi_ctc_tpu_torch.data.egs import CtcExample
            from kaldi_ctc_tpu_torch.features.cmvn import apply_cmvn
            from kaldi_ctc_tpu_torch.lm.lexicon import (
                labels_from_text, parse_lexicon)
            from kaldi_ctc_tpu_torch.utils import kaldi_io
            import numpy as _np
            import torch

            prons = {}
            for w, ps in parse_lexicon(args.lexicon):
                prons.setdefault(w, []).append(ps)
            if args.phones:
                phone_to_id = {}
                with open(args.phones) as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) >= 2:
                            phone_to_id[parts[0]] = int(parts[1])
            else:
                phone_to_id = {}
                for ps_list in prons.values():
                    for ps in ps_list:
                        for p in ps:
                            if p not in phone_to_id:
                                phone_to_id[p] = len(phone_to_id) + 1
            texts = {k: v.split()
                     for k, v in SequentialTextReader(args.text)}
            cmvn = (kaldi_io.open_random_access_matrices(args.cmvn)
                    if args.cmvn else None)
            tree = None
            if args.tree:
                from kaldi_ctc_tpu_torch.decoding.context import \
                    labels_to_pdfs
                from kaldi_ctc_tpu_torch.utils.tree import read_tree
                tree = read_tree(args.tree)

            def gen():
                nonlocal n_skip, n_oov
                for key, feats in kaldi_io.SequentialMatrixReader(
                        args.feats):
                    if key not in texts:
                        continue
                    labels = labels_from_text(texts[key], prons,
                                              phone_to_id)
                    if labels is None:
                        n_oov += 1
                        continue
                    if tree is not None:
                        try:
                            labels = labels_to_pdfs(labels, tree)
                        except ValueError:
                            # unseen phone context in the tree: skip the
                            # utterance (like the OOV path), don't abort
                            n_oov += 1
                            continue
                    if cmvn is not None:
                        spk = utt2spk.get(key, key) if utt2spk else key
                        if spk in cmvn:
                            feats = apply_cmvn(torch.from_numpy(
                                _np.asarray(feats, _np.float32)),
                                cmvn[spk]).numpy()
                    eg = apply_spk_info(CtcExample(
                        key, _np.asarray(feats, _np.float32), labels))
                    if eg is None or not example_ok(
                            eg, args.max_allow_frames,
                            max_label_length=args.max_label_length):
                        n_skip += 1
                        continue
                    yield eg
        else:
            log.error("get needs --ali or both --text and --lexicon")
            import sys
            sys.exit(1)

        counts = _split_write(gen(), args.output, args.num_archives,
                              args.random, args.seed, args.compress)
        log.info("wrote %s examples (%d skipped by filters, %d with OOV)",
                 "+".join(map(str, counts)), n_skip, n_oov)

    elif args.cmd == "copy":
        counts = _split_write(SequentialEgsReader(args.egs), args.output,
                              args.num_archives, args.random, args.seed,
                              args.compress)
        log.info("wrote %s examples", "+".join(map(str, counts)))

    elif args.cmd == "sort":
        n = 0
        with EgsWriter(args.output, compress=bool(args.compress)) as w:
            for eg in sort_egs(SequentialEgsReader(args.egs),
                               window=args.window):
                w[eg.key] = eg; n += 1
        log.info("wrote %d examples (sorted by length)", n)

    elif args.cmd == "shuffle":
        n = 0
        with EgsWriter(args.output, compress=bool(args.compress)) as w:
            for eg in shuffle_egs(
                    SequentialEgsReader(args.egs),
                    buffer_size=args.buffer_size, seed=args.seed,
                    frame_subsampling_factor=args.frame_subsampling_factor,
                    frame_shift=args.frame_shift):
                w[eg.key] = eg; n += 1
        log.info("wrote %d examples (shuffled)", n)

    elif args.cmd == "subset":
        n = 0
        with EgsWriter(args.output, compress=bool(args.compress)) as w:
            for eg in subset_egs(SequentialEgsReader(args.egs), args.n):
                w[eg.key] = eg; n += 1
        log.info("wrote %d examples", n)

    elif args.cmd == "perturb":
        egs = perturb_examples(SequentialEgsReader(args.egs),
                               noise_scale=args.noise_scale, seed=args.seed)
        with EgsWriter(args.output, compress=bool(args.compress)) as w:
            for eg in egs:
                w[eg.key] = eg
        log.info("wrote %d examples (perturbed)", len(egs))

    elif args.cmd == "relabel":
        if args.frame_labels:
            # align_ctc output: runs of a symbol are one label instance
            # (valid CTC paths always separate repeated labels with a
            # blank), so collapse runs then drop blanks; no +1 shift
            from kaldi_ctc_tpu_torch.data.egs import collapse_alignment
            ali = {}
            for k, v in SequentialIntVectorReader(args.ali):
                seq = collapse_alignment(np.asarray(v, np.int32), shift=0)
                ali[k] = seq[seq != 0]
            collapse = False
        else:
            ali = {k: v for k, v in SequentialIntVectorReader(args.ali)}
            collapse = True
        n_in = n_out = 0

        def counted():
            nonlocal n_in
            for eg in SequentialEgsReader(args.egs):
                n_in += 1
                yield eg

        with EgsWriter(args.output, compress=bool(args.compress)) as w:
            for eg in relabel_egs(counted(), ali, collapse=collapse):
                w[eg.key] = eg; n_out += 1
        log.info("relabeled %d examples (%d dropped: no alignment)",
                 n_out, n_in - n_out)

    elif args.cmd == "info":
        n = 0
        frames = []
        labels = []
        dim = None
        for eg in SequentialEgsReader(args.egs):
            n += 1
            frames.append(eg.num_frames)
            labels.append(eg.num_labels)
            dim = eg.feats.shape[1]
        if n == 0:
            print('{"num_examples": 0}')
            return
        import json
        print(json.dumps({
            "num_examples": n,
            "total_frames": int(np.sum(frames)),
            "frames_min": int(np.min(frames)),
            "frames_max": int(np.max(frames)),
            "frames_mean": float(np.mean(frames)),
            "labels_mean": float(np.mean(labels)),
            "dim": dim,
        }))


if __name__ == "__main__":
    main()
