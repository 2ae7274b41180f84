"""LM toolbox — arpa-to-fst / perplexity.

Counterpart of ``kaldi_ctc_tpu/cli/lm_tool.py``: the same host code over
the port's modules.

The arpa2fst + LM-query surface of src/lm (``lm/arpa-lm-compiler.h``,
``lm/const-arpa-lm.h``): compile an ARPA n-gram LM into a G word
acceptor (OpenFst binary, ready for Kaldi composition or inspection
with graph_tool), write its words.txt, and score text for perplexity.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("arpa-to-fst", help="compile ARPA -> G.fst")
    a.add_argument("--arpa", required=True)
    a.add_argument("--output", required=True, help="G.fst path")
    a.add_argument("--words", default=None,
                   help="existing words.txt to map symbols (else written "
                        "next to the fst)")
    a.add_argument("--write-words", default=None,
                   help="where to write the symbol table (default: "
                        "<output>.words.txt when --words not given)")

    pp = sub.add_parser("perplexity", help="score text with the LM")
    pp.add_argument("--arpa", default=None)
    pp.add_argument("--const-arpa", default=None,
                    help="compiled const-ARPA .npz instead of --arpa")
    pp.add_argument("--text", required=True,
                    help="utt-keyed transcript table")

    cc = sub.add_parser("compile-const",
                        help="ARPA -> const-ARPA flat-trie .npz "
                             "(arpa-to-const-arpa)")
    cc.add_argument("--arpa", required=True)
    cc.add_argument("--output", required=True, help=".npz path")
    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.lm import (
        arpa_to_fst_arrays, parse_arpa, sentence_logprob)
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader

    args = parse_args(argv)
    log = get_logger("lm_tool")
    if getattr(args, "const_arpa", None):
        from kaldi_ctc_tpu_torch.lm.const_arpa import ConstArpaLm
        lm = ConstArpaLm.load(args.const_arpa)
        log.info("const-ARPA order %d, %d words", lm.order, len(lm.vocab))
    elif args.arpa:
        lm = parse_arpa(args.arpa)
        log.info("ARPA order %d, counts %s", lm.order, lm.counts)
    else:
        import sys
        log.error("%s needs --arpa or --const-arpa", args.cmd)
        sys.exit(1)

    if args.cmd == "arpa-to-fst":
        from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
        word_to_id = None
        if args.words:
            word_to_id = {}
            with open(args.words) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        word_to_id[parts[0]] = int(parts[1])
        start, n_states, arcs, weights, finals, word_to_id = \
            arpa_to_fst_arrays(lm, word_to_id)
        fst = NativeFst.from_arrays(start, n_states, arcs, weights, finals)
        fst.write(args.output)
        words_out = args.write_words
        if words_out is None and not args.words:
            words_out = args.output + ".words.txt"
        if words_out:
            with open(words_out, "w") as f:
                for w, i in sorted(word_to_id.items(), key=lambda kv: kv[1]):
                    print(w, i, file=f)
        log.info("wrote %s: %d states / %d arcs (%d words)",
                 args.output, fst.num_states, fst.num_arcs, len(word_to_id))

    elif args.cmd == "perplexity":
        tot_logp = 0.0
        tot_words = 0
        n_utts = 0
        for key, line in SequentialTextReader(args.text):
            words = line.split()
            tot_logp += sentence_logprob(lm, words)
            tot_words += len(words) + 1  # + </s>
            n_utts += 1
        ppl = 10.0 ** (-tot_logp / max(tot_words, 1))
        print(json.dumps({"num_utts": n_utts, "num_words": tot_words,
                          "log10prob": tot_logp, "perplexity": ppl}))

    elif args.cmd == "compile-const":
        from kaldi_ctc_tpu_torch.lm.const_arpa import compile_const_arpa
        const = compile_const_arpa(lm)
        const.save(args.output)
        log.info("compiled const-ARPA: order %d, %d words -> %s",
                 const.order, len(const.vocab), args.output)


if __name__ == "__main__":
    main()
