"""Helpers the per-layer readers share (not a metric: no entry in
BENCHMARK.json names it)."""

from __future__ import annotations

from asrbench import flops


def peaks(ctx):
    """The card's published peaks, None for a device with none (a CPU
    run reports no share of a peak)."""
    try:
        return flops.peaks_for(ctx["device_name"],
                               ctx["config"]["compute_dtype"])
    except KeyError:
        return None


def idle_pct(ctx, kind: str):
    tr = ctx.get("trace")
    if ctx["kind"] != kind or not tr or tr["window_s"] <= 0 \
            or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(ctx, kind: str, layer: str, backward: bool):
    """The layer's least time for the traced window's work over the
    device time charged to it (per chip)."""
    tr = ctx.get("trace")
    if ctx["kind"] != kind or not tr or not ctx["frames_trace"]:
        return None
    dev = tr["layer_s"].get(layer, 0.0)
    if dev <= 0:
        return None
    frames = [sum(ctx["frames_trace"]) / ctx["chips"]]
    work = flops.recurrent_work(ctx["config"], frames, backward)
    p = peaks(ctx)
    if p is None:
        return None
    return 100.0 * flops.least_seconds(work, p["flops"], p["bytes"]) / dev
