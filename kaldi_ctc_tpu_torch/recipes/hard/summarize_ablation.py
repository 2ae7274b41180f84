#!/usr/bin/env python
"""Summarize the hard-recipe ablation matrix into a markdown table.

Counterpart of ``recipes/hard/summarize_ablation.py`` over the port's
modules: the same output.

usage: python summarize_ablation.py /tmp/kctpu_hard

Reads every  <work>/<arm>.s<seed>/wer_ci.json  plus the final train
accuracy from metrics.jsonl and prints:

1. per-run WER with its utterance-bootstrap CI;
2. per-arm mean + training-seed spread;
3. **paired comparisons** vs baseline: for each shared seed the arm and
   the baseline share the init stream and data order, and all runs
   decode the same test set — so the per-utterance error-count
   differences are paired samples, and a bootstrap over utterances of
   the *difference* cancels test-set sampling noise (the matched-pairs
   idea of Gillick & Cox 1989 / Bisani & Ney 2004, done by resampling).
   An arm "separates" when every shared-seed pair moves the same
   direction and the pooled paired CI excludes zero.
"""

import glob
import json
import os
import re
import sys

import numpy as np


def final_train_acc(exp):
    path = os.path.join(exp, "metrics.jsonl")
    acc = None
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("event") == "accuracy":
                    acc = rec.get("accuracy", acc)
    except OSError:
        pass
    return acc


def per_utt_errors(ref_path, hyp_path):
    """{key: (errors, ref_len)} with missing hyps = full deletion."""
    from kaldi_ctc_tpu_torch.utils.edit_distance import edit_distance
    refs = {l.split()[0]: l.split()[1:] for l in open(ref_path)
            if l.strip()}
    out = {}
    for l in open(hyp_path):
        parts = l.split()
        if parts and parts[0] in refs:
            out[parts[0]] = (edit_distance(refs[parts[0]], parts[1:]),
                             len(refs[parts[0]]))
    for key, ref in refs.items():
        out.setdefault(key, (len(ref), len(ref)))
    return out


def paired_delta(base_errs, arm_errs, n_boot=2000):
    """Paired bootstrap over utterances of WER(arm) - WER(base)."""
    keys = sorted(set(base_errs) & set(arm_errs))
    be = np.asarray([base_errs[k][0] for k in keys], np.float64)
    ae = np.asarray([arm_errs[k][0] for k in keys], np.float64)
    ln = np.asarray([base_errs[k][1] for k in keys], np.float64)
    delta = 100.0 * (ae.sum() - be.sum()) / max(ln.sum(), 1.0)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(keys), size=(n_boot, len(keys)))
    boot = 100.0 * ((ae[idx].sum(1) - be[idx].sum(1))
                    / np.maximum(ln[idx].sum(1), 1.0))
    lo, hi = np.percentile(boot, [2.5, 97.5])
    return delta, float(lo), float(hi)


def main(work):
    rows = []
    for path in sorted(glob.glob(os.path.join(work, "*", "wer_ci.json"))):
        exp = os.path.dirname(path)
        m = re.match(r"(.+)\.s(\d+)$", os.path.basename(exp))
        if not m:
            continue
        arm, seed = m.group(1), int(m.group(2))
        with open(path) as f:
            ci = json.load(f)
        rows.append({"arm": arm, "seed": seed, "wer": ci["wer"],
                     "ci": ci["ci95"], "n_utts": ci["n_utts"],
                     "acc": final_train_acc(exp), "exp": exp})
    if not rows:
        print("no results under", work)
        return 1

    with open(os.path.join(work, "data.json")) as f:
        data = json.load(f)
    ref_path = os.path.join(work, "data", "test", "text")

    print("# Hard-recipe ablation results\n")
    print(f"Corpus: vocab {data['vocab']}, {data['train_utts']} train / "
          f"{data['test_utts']} test utts ({data['train_hours']} h / "
          f"{data['test_hours']} h), frame_acc_nearest "
          f"{data['frame_acc_nearest']}, knobs {data['knobs']}\n")
    print("| Arm | Seed | WER % | 95% CI (utterance bootstrap) | "
          "final train acc |")
    print("|---|---|---|---|---|")
    arms = {}
    by_key = {}
    for r in sorted(rows, key=lambda r: (r["arm"] != "baseline",
                                         r["arm"], r["seed"])):
        acc = f"{r['acc']:.3f}" if r["acc"] is not None else "—"
        print(f"| {r['arm']} | {r['seed']} | {r['wer']:.2f} | "
              f"[{r['ci'][0]:.2f}, {r['ci'][1]:.2f}] | {acc} |")
        arms.setdefault(r["arm"], []).append(r["wer"])
        by_key[(r["arm"], r["seed"])] = r

    print("\n| Arm | mean WER % | seed spread (min–max) | n seeds |")
    print("|---|---|---|---|")
    for arm, wers in sorted(arms.items(),
                            key=lambda kv: (kv[0] != "baseline", kv[0])):
        print(f"| {arm} | {sum(wers) / len(wers):.2f} | "
              f"{min(wers):.2f}–{max(wers):.2f} | {len(wers)} |")

    base = arms.get("baseline", [])
    if not base:
        return 0
    print("\n## Paired comparisons vs baseline\n")
    print("Same seed = same init stream and data order; same test set →"
          " per-utterance paired bootstrap of ΔWER (arm − baseline)."
          " Negative Δ = arm better.\n")
    print("| Arm | Seed | ΔWER % | paired 95% CI | CI excludes 0 |")
    print("|---|---|---|---|---|")
    verdicts = {}
    for arm in sorted(arms):
        if arm == "baseline":
            continue
        deltas = []
        for seed in sorted(s for (a, s) in by_key if a == arm):
            if ("baseline", seed) not in by_key:
                continue
            b = by_key[("baseline", seed)]
            a = by_key[(arm, seed)]
            b_hyp = os.path.join(b["exp"], "best_hyps.test.txt")
            a_hyp = os.path.join(a["exp"], "best_hyps.test.txt")
            if not (os.path.exists(b_hyp) and os.path.exists(a_hyp)):
                # an arm that failed to train has no hypotheses
                print(f"| {arm} | {seed} | n/a | arm produced no "
                      f"hypotheses | — |")
                verdicts[arm] = "FAILED to train (see wer_ci.json note)"
                continue
            be = per_utt_errors(ref_path, b_hyp)
            ae = per_utt_errors(ref_path, a_hyp)
            d, lo, hi = paired_delta(be, ae)
            sig = "yes" if (lo > 0 or hi < 0) else "no"
            deltas.append((d, lo, hi))
            print(f"| {arm} | {seed} | {d:+.2f} | [{lo:+.2f}, "
                  f"{hi:+.2f}] | {sig} |")
        if deltas:
            same_dir = (all(d > 0 for d, _, _ in deltas)
                        or all(d < 0 for d, _, _ in deltas))
            all_sig = all(lo > 0 or hi < 0 for _, lo, hi in deltas)
            mean_d = sum(d for d, _, _ in deltas) / len(deltas)
            if same_dir and all_sig:
                verdicts[arm] = (f"SEPARATES ({mean_d:+.2f} WER mean; "
                                 f"consistent direction, every paired "
                                 f"CI excludes 0)")
            elif same_dir:
                verdicts[arm] = (f"trend {mean_d:+.2f} WER (consistent "
                                 f"direction, not all CIs exclude 0)")
            else:
                verdicts[arm] = ("within training noise (seed pairs "
                                 "disagree in direction)")
    print()
    for arm, v in sorted(verdicts.items()):
        print(f"- **{arm}**: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/kctpu_hard"))
