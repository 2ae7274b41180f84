"""The recurrent stack's least time for the traced steps' recurrent
products (forward and backward, asrbench.flops.recurrent_work) over the
device time of the kernels charged to it."""

from asrbench.metrics import _common


def read(ctx):
    return _common.roofline_pct(ctx, "train", "recurrent stack", True)
