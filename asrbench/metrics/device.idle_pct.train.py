"""Share of the traced training window with no device activity."""

from asrbench.metrics import _common


def read(ctx):
    return _common.idle_pct(ctx, "train")
