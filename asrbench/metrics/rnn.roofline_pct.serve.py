"""The recurrent stack's least time for the window's forward recurrent
products at B=1 over the device time of the kernels charged to it."""

from asrbench.metrics import _common


def read(ctx):
    return _common.roofline_pct(ctx, "recognize", "recurrent stack", False)
