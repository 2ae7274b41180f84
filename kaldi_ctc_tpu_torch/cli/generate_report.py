"""Training report from metrics.jsonl (generate_plots.py equivalent).

Counterpart of ``kaldi_ctc_tpu/cli/generate_report.py``: the same host code over
the port's modules.

Parses the JSONL metrics stream written by train_ctc (instead of scraping
C++ logs like steps/ctc/report/nnet2_log_parse_lib.py:17-67) and emits the
accuracy.log-style table plus optional matplotlib plots.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="experiment dir")
    p.add_argument("--plot", action="store_true",
                   help="write accuracy.png/loss.png (needs matplotlib)")
    p.add_argument("--latex", action="store_true",
                   help="also write report.tex embedding the plots (the "
                        "reference's LatexReport, generate_plots.py:78-108;"
                        " compile manually — no pdflatex dependency)")
    args = p.parse_args(argv)

    path = os.path.join(args.dir, "metrics.jsonl")
    steps, losses, accs, lrs = [], [], [], []
    valid_steps, valid_accs = [], []
    n_bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a hard-killed trainer can leave one truncated record;
                # losing the whole report over it helps nobody
                n_bad += 1
                continue
            if rec.get("event") == "train_step":
                steps.append(rec["step"])
                losses.append(rec["loss_per_frame"])
                accs.append(rec["accuracy"])
                lrs.append(rec["lr"])
            elif rec.get("event") == "valid":
                valid_steps.append(rec["step"])
                valid_accs.append(rec["accuracy"])
    if n_bad:
        print(f"generate_report: skipped {n_bad} unparseable metrics "
              "lines", file=sys.stderr)

    # accuracy.log-style table (reports/ctc-google/accuracy.log format)
    out = os.path.join(args.dir, "accuracy.log")
    with open(out, "w") as f:
        print(f"{'step':>8} {'loss/frame':>12} {'train_acc':>10} "
              f"{'lr':>10}", file=f)
        for i in range(0, len(steps), max(len(steps) // 100, 1)):
            print(f"{steps[i]:>8} {losses[i]:>12.4f} {accs[i]:>10.4f} "
                  f"{lrs[i]:>10.3g}", file=f)
    print(f"wrote {out} ({len(steps)} steps"
          f", {len(valid_steps)} valid points)")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(12, 4))
        axes[0].plot(steps, accs, label="train")
        if valid_steps:
            axes[0].plot(valid_steps, valid_accs, label="valid")
        axes[0].set_xlabel("step"); axes[0].set_ylabel("label accuracy")
        axes[0].legend(); axes[0].grid(True)
        axes[1].plot(steps, losses)
        axes[1].set_xlabel("step"); axes[1].set_ylabel("CTC loss / frame")
        axes[1].set_yscale("log"); axes[1].grid(True)
        fig.tight_layout()
        png = os.path.join(args.dir, "training.png")
        fig.savefig(png, dpi=120)
        print(f"wrote {png}")

    if args.latex:
        final_acc = accs[-1] if accs else float("nan")
        final_vacc = valid_accs[-1] if valid_accs else None
        lines = [
            r"\documentclass{article}",
            r"\usepackage{graphicx}",
            r"\title{CTC training report}",
            r"\begin{document}", r"\maketitle",
            r"\section{Summary}",
            r"\begin{tabular}{lr}",
            rf"steps & {steps[-1] if steps else 0} \\",
            rf"final train accuracy & {final_acc:.4f} \\",
        ]
        if final_vacc is not None:
            lines.append(rf"final valid accuracy & {final_vacc:.4f} \\")
        lines.append(r"\end{tabular}")
        if args.plot:
            lines += [r"\section{Curves}",
                      r"\includegraphics[width=\textwidth]{training.png}"]
        lines.append(r"\end{document}")
        tex = os.path.join(args.dir, "report.tex")
        with open(tex, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {tex}")


if __name__ == "__main__":
    main()
