"""The batch norms' least time for the traced steps (forward and backward,
the family's ``layer_work``: every normalised position's bytes at 3.35
TB/s) over the device time of the kernels charged to them."""

from asrbench.metrics import _layer_roofline


def read(ctx):
    return _layer_roofline.roofline_pct(ctx, "train", "batch norm", True)
