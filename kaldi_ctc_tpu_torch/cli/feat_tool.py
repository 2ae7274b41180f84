"""Feature-archive toolbox — the featbin utility surface.

Counterpart of ``kaldi_ctc_tpu/cli/feat_tool.py`` with the same
subcommands, flags, defaults and archives; host-only, as there.

One CLI covering the feature-manipulation binaries the reference
recipes chain between extraction and egs (``steps/ctc/get_egs2.sh``,
``build_tree.sh``): copy-feats, feat-to-dim, paste-feats,
subsample-feats, splice-feats, add-deltas, transform-feats, apply-cmvn,
select-feats.  All subcommands stream Kaldi matrix archives
(text/binary/compressed auto-detected; ``ark``/``scp``/pipes).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def io_args(sp, multi_in=False):
        if multi_in:
            sp.add_argument("--feats", required=True, action="append",
                            help="repeatable: one rspecifier per stream")
        else:
            sp.add_argument("--feats", required=True)
        sp.add_argument("--output", required=True, help="wspecifier")
        sp.add_argument("--compress", type=int, default=0)

    c = sub.add_parser("copy", help="copy-feats (format conversion)")
    io_args(c)

    d = sub.add_parser("to-dim", help="feat-to-dim: print the dim")
    d.add_argument("--feats", required=True)

    tl = sub.add_parser("to-len", help="feat-to-len: 'key num-frames' "
                                       "per utterance")
    tl.add_argument("--feats", required=True)

    ci = sub.add_parser("copy-ints", help="copy-int-vector (format "
                                          "conversion, e.g. ark -> ark,t)")
    ci.add_argument("--feats", required=True,
                    help="int-vector rspecifier (alignments)")
    ci.add_argument("--output", required=True, help="wspecifier")

    pa = sub.add_parser("paste", help="paste-feats: append dims of "
                                      "several streams per utterance")
    io_args(pa, multi_in=True)
    pa.add_argument("--length-tolerance", type=int, default=0,
                    help="allow this many frames of length mismatch "
                         "(truncate to the shortest)")

    ss = sub.add_parser("subsample", help="subsample-feats --n")
    io_args(ss)
    ss.add_argument("--n", type=int, required=True,
                    help="keep every n-th frame; negative repeats each "
                         "frame |n| times (featbin/subsample-feats.cc:37-55,"
                         " the online-ivector expansion direction)")
    ss.add_argument("--offset", type=int, default=0)

    sp_ = sub.add_parser("splice", help="splice-feats")
    io_args(sp_)
    sp_.add_argument("--left-context", type=int, default=4)
    sp_.add_argument("--right-context", type=int, default=4)

    de = sub.add_parser("deltas", help="add-deltas")
    io_args(de)
    de.add_argument("--delta-order", type=int, default=2)
    de.add_argument("--delta-window", type=int, default=2)

    tr = sub.add_parser("transform", help="transform-feats")
    io_args(tr)
    tr.add_argument("--matrix", default=None,
                    help="global transform matrix file (LDA/MLLT)")
    tr.add_argument("--transforms", default=None,
                    help="per-speaker transform rspecifier (fMLLR)")
    tr.add_argument("--utt2spk", default=None)

    cm = sub.add_parser("apply-cmvn", help="apply-cmvn")
    io_args(cm)
    cm.add_argument("--cmvn", required=True,
                    help="stats rspecifier (compute_cmvn output)")
    cm.add_argument("--utt2spk", default=None)
    cm.add_argument("--norm-vars", type=int, default=0)

    se = sub.add_parser("select", help="select-feats: keep a column "
                                       "range")
    io_args(se)
    se.add_argument("--range", required=True,
                    help="e.g. 0-39 (inclusive) or 13-25")
    return p.parse_args(argv)


def _read_utt2spk(path):
    if not path:
        return None
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def main(argv=None):
    import numpy as np

    from kaldi_ctc_tpu_torch.utils import get_logger, kaldi_io

    args = parse_args(argv)
    log = get_logger("feat_tool")

    _rand_access = kaldi_io.open_random_access_matrices

    if args.cmd == "to-dim":
        for _key, mat in kaldi_io.SequentialMatrixReader(args.feats):
            print(mat.shape[1])
            return
        log.error("empty archive")
        sys.exit(1)

    if args.cmd == "to-len":
        for key, mat in kaldi_io.SequentialMatrixReader(args.feats):
            print(key, mat.shape[0])
        return

    if args.cmd == "copy-ints":
        n = 0
        with kaldi_io.IntVectorWriter(args.output) as w:
            for key, vec in kaldi_io.SequentialIntVectorReader(args.feats):
                w[key] = vec
                n += 1
        log.info("copied %d int vectors", n)
        return

    n = 0
    if args.cmd == "paste":
        import itertools
        readers = [kaldi_io.SequentialMatrixReader(r) for r in args.feats]
        with kaldi_io.MatrixWriter(args.output,
                                   compress=bool(args.compress)) as w:
            for rows in itertools.zip_longest(*readers):
                if any(r is None for r in rows):
                    # a stream ran out early: that is data loss, not a
                    # normal end (paste-feats errors on missing keys)
                    log.error("input streams have different lengths "
                              "(first short stream at utterance %s)",
                              next(r[0] for r in rows if r is not None))
                    sys.exit(1)
                keys = [k for k, _m in rows]
                if len(set(keys)) != 1:
                    log.error("key mismatch across streams: %s", keys)
                    sys.exit(1)
                mats = [m for _k, m in rows]
                lens = [m.shape[0] for m in mats]
                if max(lens) - min(lens) > args.length_tolerance:
                    log.warning("length mismatch %s for %s: skipped",
                                lens, keys[0])
                    continue
                t = min(lens)
                w[keys[0]] = np.concatenate([m[:t] for m in mats], axis=1)
                n += 1
        log.info("pasted %d utterances from %d streams", n,
                 len(args.feats))
        return

    # single-input streaming subcommands
    def transform_one(key, mat):
        if args.cmd == "copy":
            return mat
        if args.cmd == "subsample":
            if args.n < 0:
                if args.offset != 0:
                    log.error("--offset cannot be used with negative n")
                    sys.exit(1)
                return np.repeat(mat, -args.n, axis=0)
            return mat[args.offset::args.n]
        if args.cmd == "splice":
            from kaldi_ctc_tpu_torch.features.functions import splice_frames
            return np.asarray(splice_frames(mat, args.left_context,
                                            args.right_context))
        if args.cmd == "deltas":
            from kaldi_ctc_tpu_torch.features.functions import add_deltas
            return np.asarray(add_deltas(mat, order=args.delta_order,
                                         window=args.delta_window))
        if args.cmd == "transform":
            from kaldi_ctc_tpu_torch.features.transform import apply_transform
            out = mat
            if lda is not None:
                out = apply_transform(out, lda)
            if trans is not None:
                spk = (u2s.get(key, key) if u2s else key)
                if spk in trans:
                    out = apply_transform(out, trans[spk])
                else:
                    log.warning("no transform for %s", spk)
            return out
        if args.cmd == "apply-cmvn":
            import torch

            from kaldi_ctc_tpu_torch.features.cmvn import apply_cmvn
            spk = (u2s.get(key, key) if u2s else key)
            if spk not in cmvn:
                log.warning("no CMVN stats for %s", spk)
                return mat
            return apply_cmvn(torch.from_numpy(np.asarray(mat, np.float32)),
                              cmvn[spk],
                              norm_vars=bool(args.norm_vars)).numpy()
        if args.cmd == "select":
            lo, hi = args.range.split("-")
            return mat[:, int(lo):int(hi) + 1]
        raise AssertionError(args.cmd)

    lda = trans = cmvn = u2s = None
    if args.cmd == "transform":
        if args.matrix:
            lda = kaldi_io.read_matrix(args.matrix)
        if args.transforms:
            trans = _rand_access(args.transforms)
        u2s = _read_utt2spk(args.utt2spk)
        if lda is None and trans is None:
            log.error("transform needs --matrix and/or --transforms")
            sys.exit(1)
    elif args.cmd == "apply-cmvn":
        cmvn = _rand_access(args.cmvn)
        u2s = _read_utt2spk(args.utt2spk)

    with kaldi_io.MatrixWriter(args.output,
                               compress=bool(args.compress)) as w:
        for key, mat in kaldi_io.SequentialMatrixReader(args.feats):
            w[key] = np.asarray(transform_one(key, mat), np.float32)
            n += 1
    log.info("%s: wrote %d utterances", args.cmd, n)


if __name__ == "__main__":
    main()
