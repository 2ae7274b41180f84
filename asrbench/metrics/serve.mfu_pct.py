"""Forward FLOPs of the window's requests over the traced window's
device-busy seconds x the peak of the configuration's precision."""

from asrbench import flops
from asrbench.metrics import _common


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "recognize" or not tr or tr["busy_s"] <= 0:
        return None
    p = _common.peaks(ctx)
    if p is None:
        return None
    work = sum(ctx["frames_trace"]) * flops.forward_flops_per_frame(
        ctx["config"])
    return 100.0 * work / (tr["busy_s"] * p["flops"])
