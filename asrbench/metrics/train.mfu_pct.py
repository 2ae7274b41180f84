"""Model FLOPs of the window's steps (valid frames x forward and backward
operations a frame, from the configuration's widths) over the window's
seconds x chips x the peak of the configuration's precision."""

from asrbench import flops
from asrbench.metrics import _common


def read(ctx):
    if ctx["kind"] != "train" or not ctx["frames_window"]:
        return None
    p = _common.peaks(ctx)
    if p is None:
        return None
    work = sum(ctx["frames_window"]) * flops.train_flops_per_frame(
        ctx["config"])
    return 100.0 * work / (ctx["seconds"] * ctx["chips"]
                           * p["flops"])
