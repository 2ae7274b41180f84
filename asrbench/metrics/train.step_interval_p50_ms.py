"""Median gap between consecutive train_step records in the traced window:
the training driver's cadence (data wait, step, accuracy, logging)."""

import statistics


def read(ctx):
    s = ctx.get("stamps_trace") if ctx["kind"] == "train" else None
    if not s or len(s) < 2:
        return None
    return 1000.0 * statistics.median(b - a for a, b in zip(s, s[1:]))
