"""Decision-tree building toolbox (acc-tree-stats / sum-tree-stats /
cluster-phones / build-tree).

Counterpart of ``kaldi_ctc_tpu/cli/tree_tool.py``: the same host code over
the port's modules.

The native replacement for the tree-building calls of
``steps/ctc/build_tree.sh:139-193``: accumulate diagonal-Gaussian
context stats from features + alignments, cluster phones into question
sets, and grow a triphone (or any-context) tree that ``graph_tool
make-tlg --tree`` and ``prepare_egs get --tree`` consume directly.
Stats archives are .npz files (the native .treeacc analogue).
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("acc-stats",
                       help="features + alignments -> context stats")
    a.add_argument("--feats", required=True)
    a.add_argument("--ali", required=True,
                   help="per-frame alignments: phone ids, or "
                        "transition-ids with --trans-model")
    a.add_argument("--trans-model", default=None,
                   help="Kaldi .mdl to map transition-id alignments "
                        "to phones first")
    a.add_argument("--context-width", type=int, default=3)
    a.add_argument("--central-position", type=int, default=1)
    a.add_argument("--ci-phones", default="",
                   help="colon-separated context-independent phones "
                        "(e.g. silence)")
    a.add_argument("--subsample", type=int, default=1,
                   help="frame-subsampling factor applied to the "
                        "alignments (convert-ali analogue)")
    a.add_argument("--output", required=True, help="stats .npz")

    s = sub.add_parser("sum-stats", help="merge stats archives")
    s.add_argument("stats", nargs="+")
    s.add_argument("--output", required=True)

    q = sub.add_parser("questions",
                       help="cluster phones into question sets")
    q.add_argument("--stats", required=True)
    q.add_argument("--sets", default=None,
                   help="sets.int: initial phone groups (default: one "
                        "set per phone seen in the stats)")
    q.add_argument("--extra-questions", default=None,
                   help="file of extra question lines to append")
    q.add_argument("--central-position", type=int, default=1)
    q.add_argument("--output", required=True, help="questions.int")

    b = sub.add_parser("build", help="grow the decision tree")
    b.add_argument("--stats", required=True)
    b.add_argument("--questions", required=True)
    b.add_argument("--roots", default=None,
                   help="roots.int: 'shared|not-shared split|not-split "
                        "phones...' per line (default: every phone its "
                        "own shared split root)")
    b.add_argument("--context-width", type=int, default=3)
    b.add_argument("--central-position", type=int, default=1)
    b.add_argument("--max-leaves", type=int, default=0)
    b.add_argument("--cluster-thresh", type=float, default=0.0)
    b.add_argument("--thresh", type=float, default=0.0,
                   help="stop splitting below this likelihood gain")
    b.add_argument("--num-phones", type=int, default=None)
    b.add_argument("--output", required=True, help="tree file (Kaldi "
                                                   "binary format)")

    i = sub.add_parser("info", help="tree summary as JSON")
    i.add_argument("--tree", required=True)

    return p.parse_args(argv)


def main(argv=None):
    import numpy as np

    from kaldi_ctc_tpu_torch.utils import get_logger, kaldi_io
    from kaldi_ctc_tpu_torch.utils.tree_build import (
        acc_tree_stats, build_tree, cluster_phones, load_tree_stats,
        parse_roots, save_tree_stats, sum_tree_stats)

    args = parse_args(argv)
    log = get_logger("tree_tool")

    if args.cmd == "acc-stats":
        tid_phone = tid_selfloop = None
        if args.trans_model:
            from kaldi_ctc_tpu_torch.utils.transition_model import \
                read_transition_model
            tm = read_transition_model(args.trans_model)
            tid_phone = tm.tid_to_phone()
            tid_selfloop = tm.tid_is_self_loop()
        ci = [int(x) for x in args.ci_phones.split(":") if x]
        ali = dict(kaldi_io.SequentialIntVectorReader(args.ali))

        def gen():
            n_miss = 0
            for key, feats in kaldi_io.SequentialMatrixReader(args.feats):
                if key not in ali:
                    n_miss += 1
                    continue
                phones = np.asarray(ali[key])
                starts = None
                if tid_phone is not None:
                    # a non-self-loop tid re-enters its phone: adjacent
                    # instances of the same phone stay distinct segments
                    starts = ~tid_selfloop[phones]
                    phones = tid_phone[phones]
                if args.subsample > 1:
                    phones = phones[::args.subsample]
                    if starts is not None:
                        starts = starts[::args.subsample]
                if len(phones) != feats.shape[0]:
                    log.warning("length mismatch for %s (%d frames, %d "
                                "alignment): skipped", key,
                                feats.shape[0], len(phones))
                    continue
                yield (feats, phones) if starts is None \
                    else (feats, phones, starts)
            if n_miss:
                log.warning("%d utterances had no alignment", n_miss)

        stats = acc_tree_stats(gen(), N=args.context_width,
                               P=args.central_position, ci_phones=ci)
        save_tree_stats(args.output, stats)
        log.info("accumulated stats for %d context events "
                 "(%.0f frames)", len(stats),
                 sum(s.count for s in stats.values()))

    elif args.cmd == "sum-stats":
        stats = sum_tree_stats(load_tree_stats(p) for p in args.stats)
        save_tree_stats(args.output, stats)
        log.info("summed %d archives -> %d events", len(args.stats),
                 len(stats))

    elif args.cmd == "questions":
        stats = load_tree_stats(args.stats)
        if args.sets:
            sets = []
            with open(args.sets) as f:
                for line in f:
                    ps = [int(x) for x in line.split()]
                    if ps:
                        sets.append(ps)
        else:
            phones = sorted({dict(e)[args.central_position]
                             for e in stats})
            sets = [[p] for p in phones]
        qs = cluster_phones(stats, sets, P=args.central_position)
        with open(args.output, "w") as f:
            for q in qs:
                print(" ".join(str(p) for p in sorted(q)), file=f)
            if args.extra_questions:
                with open(args.extra_questions) as ef:
                    for line in ef:
                        if line.split():
                            f.write(line if line.endswith("\n")
                                    else line + "\n")
        log.info("wrote %d questions", len(qs))

    elif args.cmd == "build":
        from kaldi_ctc_tpu_torch.utils.tree import write_tree
        stats = load_tree_stats(args.stats)
        questions = []
        with open(args.questions) as f:
            for line in f:
                ps = frozenset(int(x) for x in line.split())
                if ps:
                    questions.append(ps)
        if args.roots:
            roots = parse_roots(args.roots)
        else:
            phones = sorted({dict(e)[args.central_position]
                             for e in stats})
            roots = [(True, True, [p]) for p in phones]
        tree = build_tree(stats, questions, roots,
                          N=args.context_width,
                          P=args.central_position,
                          max_leaves=args.max_leaves,
                          cluster_thresh=args.cluster_thresh,
                          thresh=args.thresh,
                          num_phones=args.num_phones)
        write_tree(args.output, tree)
        log.info("built tree: %d pdfs (N=%d P=%d, %d questions, "
                 "max-leaves %d)", tree.num_pdfs, tree.N, tree.P,
                 len(questions), args.max_leaves)

    elif args.cmd == "info":
        from kaldi_ctc_tpu_torch.utils.tree import read_tree
        tree = read_tree(args.tree)
        print(json.dumps({"N": tree.N, "P": tree.P,
                          "num_pdfs": tree.num_pdfs}))


if __name__ == "__main__":
    main()
