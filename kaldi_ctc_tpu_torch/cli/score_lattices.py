"""Score lattices: best path per LM weight → WER sweep.

Counterpart of ``kaldi_ctc_tpu/cli/score_lattices.py``: the same host code over the
port's modules.

The local/score.sh + steps/ctc/decode.sh:169-176 analogue: lattices are
rescaled (``lattice-scale --acoustic-scale`` — the recipe uses
lattice_acoustic_scale=10, run_ctc_phone.sh:40), then for each LM weight
in [min-lmwt, max-lmwt] the best path is extracted
(``lattice-best-path --lm-scale=LMWT``) and WER computed against the
reference transcripts.  Prints one JSON line per LM weight plus a final
summary line with the best WER.
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
    p.add_argument("--lattices", required=True,
                   help="text lattice archive (decode_ctc --lattice output)")
    p.add_argument("--text", required=True, help="reference transcripts")
    p.add_argument("--words", default=None,
                   help="words.txt (id word); hyps reported as words when "
                        "given, else as integer ids")
    p.add_argument("--acoustic-scale", type=float, default=1.0,
                   help="pre-scale on acoustic costs (recipe uses 10)")
    p.add_argument("--min-lmwt", type=int, default=1)
    p.add_argument("--max-lmwt", type=int, default=20)
    p.add_argument("--compact", type=int, default=0,
                   help="1: input is a CompactLattice archive "
                        "(decode --determinize output)")
    p.add_argument("--output", default=None,
                   help="write best-LMWT hypotheses here")
    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.decoding.det_lattice import (
        read_compact_lattice_text_ark)
    from kaldi_ctc_tpu_torch.decoding.lattice import read_lattice_text_ark
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.edit_distance import edit_distance
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader

    args = parse_args(argv)
    log = get_logger("score_lattices")

    word_syms = None
    if args.words:
        from kaldi_ctc_tpu_torch.utils.kaldi_io import read_symbol_table
        word_syms = read_symbol_table(args.words)

    reader = (read_compact_lattice_text_ark if args.compact
              else read_lattice_text_ark)
    lats = dict(reader(args.lattices))
    if not lats:
        log.error("no lattices in %s", args.lattices); sys.exit(1)
    refs = {k: v.split() for k, v in SequentialTextReader(args.text)}

    def to_words(ids):
        if word_syms is not None:
            return [word_syms.get(int(w), str(int(w))) for w in ids]
        return [str(int(w)) for w in ids]

    best = None
    best_hyps = None
    for lmwt in range(args.min_lmwt, args.max_lmwt + 1):
        err = tot = 0
        hyps = {}
        for key, lat in lats.items():
            words, _, _ = lat.best_path(
                acoustic_scale=args.acoustic_scale, lm_scale=float(lmwt))
            hyps[key] = to_words(words)
            if key in refs:
                err += edit_distance(refs[key], hyps[key])
                tot += len(refs[key])
        wer = err / max(tot, 1)
        print(json.dumps({"lmwt": lmwt, "wer": wer, "errors": err,
                          "ref_tokens": tot}))
        if best is None or wer < best[1]:
            best = (lmwt, wer)
            best_hyps = hyps
    print(json.dumps({"best_lmwt": best[0], "best_wer": best[1]}))

    if args.output and best_hyps is not None:
        with open(args.output, "w") as f:
            for k in sorted(best_hyps):
                print(k, " ".join(best_hyps[k]), file=f)


if __name__ == "__main__":
    main()
