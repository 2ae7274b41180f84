"""A layer's roofline share from its family's ``layer_work`` (not a
metric: no entry in BENCHMARK.json names it).  ``_common.roofline_pct``
reads the recurrent stack's work alone; the layers that only some
families have (the conv front, the batch norms) come here."""

from __future__ import annotations

from asrbench import families, flops
from asrbench.metrics import _common


def roofline_pct(ctx, kind: str, layer: str, backward: bool):
    """The layer's least time for the traced window's work over the
    device time charged to it (per chip); None where the trace charges
    it nothing or the family has no such layer."""
    tr = ctx.get("trace")
    if ctx["kind"] != kind or not tr or not ctx["frames_trace"]:
        return None
    dev = tr["layer_s"].get(layer, 0.0)
    p = _common.peaks(ctx)
    if dev <= 0 or p is None:
        return None
    frames = [sum(ctx["frames_trace"]) / ctx["chips"]]
    try:
        work = families.of(ctx["config"]).layer_work(ctx["config"], layer,
                                                     frames, backward)
    except KeyError:
        return None
    return 100.0 * flops.least_seconds(work, p["flops"], p["bytes"]) / dev
