"""Decoding-graph toolbox — make-ctc / info.

Counterpart of ``kaldi_ctc_tpu/cli/graph_tool.py``: the same host code over
the port's modules.

The ctc-make-decoding-graph + ctc-graph-info CLI surface
(``ctcbin/ctc-make-decoding-graph.cc:33-56``,
``ctcbin/ctc-graph-info.cpp:1-63``): applies the CTC transform (shift
every non-epsilon ilabel +1, insert per-state blank states with blank
self-loops — ``ctc/ctc-graph.cc:30-76``) to an HCLG-style OpenFst
binary, and prints graph statistics.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("make-ctc",
                       help="HCLG.fst -> CTC.fst (shift + blank states)")
    m.add_argument("--graph", required=True, help="input VectorFst")
    m.add_argument("--output", required=True)

    i = sub.add_parser("info", help="print graph statistics")
    i.add_argument("--graph", required=True)
    i.add_argument("--check-stochastic", type=int, default=0,
                   help="also report per-state outgoing-probability-mass "
                        "bounds (the fstisstochastic diagnostic of "
                        "mkgraph.sh:98,110,130)")

    t = sub.add_parser(
        "make-tlg",
        help="lexicon + ARPA LM -> CTC decoding graph (mono): "
             "L compose G, CTC transform; the native mkgraph.sh --ctc "
             "for monophone models")
    t.add_argument("--lexicon", required=True,
                   help="'word phone1 phone2 ...' lines")
    t.add_argument("--arpa", required=True)
    t.add_argument("--output", required=True, help="TLG.fst path")
    t.add_argument("--phones", default=None,
                   help="phones.txt (symbol id) fixing phone ids to the "
                        "model's training labels; default: enumerate "
                        "from the lexicon starting at 1")
    t.add_argument("--sil-phone", default=None,
                   help="optional inter-word silence phone")
    t.add_argument("--sil-prob", type=float, default=0.5)
    t.add_argument("--write-words", default=None,
                   help="words.txt output (default <output>.words.txt)")
    t.add_argument("--write-phones", default=None,
                   help="phones.txt output (default <output>.phones.txt)")
    t.add_argument("--tree", default=None,
                   help="ContextDependency tree file: build a "
                        "context-dependent (e.g. triphone) graph — phone "
                        "arcs become tree pdfs+1 (fstcomposecontext + "
                        "make-h-transducer collapsed); default: mono, "
                        "phone id == pdf+1")
    t.add_argument("--determinize", type=int, default=1,
                   help="determinize-star + minimize LG with lexicon "
                        "disambig symbols (mkgraph.sh:92-98); 0 = plain "
                        "compose (the decoder tolerates nondeterminism)")
    t.add_argument("--push", type=int, default=1,
                   help="push-special LG weights (needs --determinize 1)")

    for name, hlp in (("determinize", "fstdeterminizestar"),
                      ("minimize", "fstminimizeencoded"),
                      ("push", "fstpushspecial"),
                      ("connect", "fstconnect")):
        s = sub.add_parser(name, help=f"{hlp} on a VectorFst file")
        s.add_argument("--graph", required=True)
        s.add_argument("--output", required=True)

    c = sub.add_parser("compose", help="fsttablecompose a ∘ b (+connect)")
    c.add_argument("--a", required=True)
    c.add_argument("--b", required=True)
    c.add_argument("--output", required=True)

    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
    from kaldi_ctc_tpu_torch.utils import get_logger

    args = parse_args(argv)
    log = get_logger("graph_tool")

    if args.cmd == "make-tlg":
        from kaldi_ctc_tpu_torch.decoding.graph import build_tlg
        from kaldi_ctc_tpu_torch.lm import parse_arpa
        from kaldi_ctc_tpu_torch.lm.lexicon import parse_lexicon

        lexicon = parse_lexicon(args.lexicon)
        phone_to_id = None
        if args.phones:
            phone_to_id = {}
            with open(args.phones) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        phone_to_id[parts[0]] = int(parts[1])
        tree = None
        if args.tree:
            from kaldi_ctc_tpu_torch.utils.tree import read_tree
            tree = read_tree(args.tree)
        timings = {}
        tlg, word_to_id, phone_to_id = build_tlg(
            lexicon, parse_arpa(args.arpa), phone_to_id=phone_to_id,
            sil_phone=args.sil_phone, sil_prob=args.sil_prob,
            determinize=bool(args.determinize), push=bool(args.push),
            tree=tree, timings=timings)
        tlg.write(args.output)
        words_out = args.write_words or args.output + ".words.txt"
        with open(words_out, "w") as f:
            for w, i in sorted(word_to_id.items(), key=lambda kv: kv[1]):
                print(w, i, file=f)
        phones_out = args.write_phones or args.output + ".phones.txt"
        with open(phones_out, "w") as f:
            for ph, i in sorted(phone_to_id.items(), key=lambda kv: kv[1]):
                if not (ph.startswith("#") and ph[1:].isdigit()):
                    print(ph, i, file=f)
        log.info("TLG: %d states / %d arcs (det=%d)  stage seconds: %s",
                 tlg.num_states, tlg.num_arcs, args.determinize,
                 {k: round(v, 2) for k, v in timings.items()})
        return

    if args.cmd == "compose":
        a = NativeFst.load(args.a)
        b = NativeFst.load(args.b)
        out = a.compose(b)
        out.write(args.output)
        log.info("composed %d/%d ∘ %d/%d -> %d states / %d arcs",
                 a.num_states, a.num_arcs, b.num_states, b.num_arcs,
                 out.num_states, out.num_arcs)
        return

    if args.cmd in ("determinize", "minimize", "push", "connect"):
        fst = NativeFst.load(args.graph)
        op = {"determinize": fst.determinize_star, "minimize": fst.minimize,
              "push": fst.push_special, "connect": fst.connect}[args.cmd]
        out = op()
        out.write(args.output)
        log.info("%s: %d states / %d arcs -> %d states / %d arcs",
                 args.cmd, fst.num_states, fst.num_arcs,
                 out.num_states, out.num_arcs)
        return

    fst = NativeFst.load(args.graph)
    if args.cmd == "make-ctc":
        ctc = fst.make_ctc_graph()
        ctc.write(args.output)
        log.info("%s: %d states / %d arcs -> %s: %d states / %d arcs",
                 args.graph, fst.num_states, fst.num_arcs,
                 args.output, ctc.num_states, ctc.num_arcs)
    elif args.cmd == "info":
        out = {
            "num_states": fst.num_states,
            "num_arcs": fst.num_arcs,
            "start": fst.start,
        }
        if args.check_stochastic:
            # fstisstochastic: per state, -log sum of outgoing arc
            # probabilities (+ final) in the log semiring; 0 everywhere
            # means stochastic.  A state with no mass at all (dead end —
            # the pathology a skipped fstconnect leaves behind) has
            # residual +inf and fails the check, exactly like the
            # OpenFst tool.  Vectorized segmented logsumexp (finals join
            # the arcs as pseudo-arcs) — a per-state Python loop took
            # ~10 s at real-TLG scale.
            import numpy as np
            start, arcs, weights, finals = fst.to_arrays()
            n = fst.num_states
            fin_states = np.flatnonzero(np.isfinite(finals))
            src_all = np.concatenate(
                [arcs[:, 0], fin_states]) if len(arcs) else fin_states
            w_all = np.concatenate(
                [-weights.astype(np.float64),
                 -finals[fin_states].astype(np.float64)]
            ) if len(arcs) else -finals[fin_states].astype(np.float64)
            neg = np.full(n, np.inf)
            if src_all.size:
                order = np.argsort(src_all, kind="stable")
                src = src_all[order]
                w = w_all[order]
                bounds = np.searchsorted(src, np.arange(n + 1))
                has = bounds[1:] > bounds[:-1]
                starts = bounds[:-1][has]
                mx = np.maximum.reduceat(w, starts)     # per nonempty seg
                mx_per_arc = np.repeat(mx, np.diff(bounds)[has])
                sums = np.add.reduceat(np.exp(w - mx_per_arc), starts)
                neg[has] = -(mx + np.log(sums))
            out["is_stochastic"] = bool(
                n > 0 and np.isfinite(neg).all()
                and float(np.abs(neg).max()) < 1e-3)
            if n:
                finite = np.isfinite(neg)
                out["stochastic_min"] = float(
                    neg[finite].min()) if finite.any() else float("inf")
                out["stochastic_max"] = (float(neg.max()) if finite.all()
                                         else float("inf"))
        print(json.dumps(out))


if __name__ == "__main__":
    main()
