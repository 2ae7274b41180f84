#!/usr/bin/env python
"""WER with a bootstrap confidence interval over test utterances.

Counterpart of ``recipes/hard/wer_ci.py`` over the port's
modules: the same output.

usage: python wer_ci.py ref_text hyp_text [n_boot]

Resamples utterances with replacement (the standard WER bootstrap,
Bisani & Ney 2004 style) and reports the 2.5/97.5 percentile interval —
the error bars the ablation table in
kaldi_ctc_tpu_torch/recipes/hard/run.sh cites.
Prints one JSON line.
"""

import json
import sys

import numpy as np


def main(argv):
    ref_path, hyp_path = argv[0], argv[1]
    n_boot = int(argv[2]) if len(argv) > 2 else 2000

    from kaldi_ctc_tpu_torch.utils.edit_distance import edit_distance

    refs = {l.split()[0]: l.split()[1:] for l in open(ref_path)
            if l.strip()}
    errs, lens = [], []
    missing = 0
    hyp_keys = set()
    for l in open(hyp_path):
        parts = l.split()
        if not parts:
            continue
        key = parts[0]
        hyp_keys.add(key)
        if key not in refs:
            continue
        errs.append(edit_distance(refs[key], parts[1:]))
        lens.append(len(refs[key]))
    # utterances with no hypothesis line count as fully deleted
    for key, ref in refs.items():
        if key not in hyp_keys:
            errs.append(len(ref))
            lens.append(len(ref))
            missing += 1
    errs = np.asarray(errs, np.float64)
    lens = np.asarray(lens, np.float64)
    wer = 100.0 * errs.sum() / max(lens.sum(), 1.0)

    rng = np.random.default_rng(0)
    n = len(errs)
    idx = rng.integers(0, n, size=(n_boot, n))
    boot = 100.0 * errs[idx].sum(axis=1) / np.maximum(
        lens[idx].sum(axis=1), 1.0)
    lo, hi = np.percentile(boot, [2.5, 97.5])
    print(json.dumps({
        "wer": round(float(wer), 2),
        "ci95": [round(float(lo), 2), round(float(hi), 2)],
        "n_utts": n, "n_ref_tokens": int(lens.sum()),
        "missing_hyps": missing, "n_boot": n_boot,
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
