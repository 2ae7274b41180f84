"""The conv front's least time for the traced steps' convolutions (forward
and backward, the family's ``layer_work``: operations at the f32 peak,
activations and weights at the HBM rate) over the device time of the
kernels charged to it."""

from asrbench.metrics import _layer_roofline


def read(ctx):
    return _layer_roofline.roofline_pct(ctx, "train", "conv front", True)
