"""Median engine time of the window's requests: the response's rtf x the
request's audio (the engine's own clock, lock wait included; rtf is
rounded to 1e-4, so steps of ~0.7 ms at 7.4 s)."""

import statistics


def read(ctx):
    if ctx["kind"] != "recognize" or not ctx["engine_s"]:
        return None
    return 1000.0 * statistics.median(ctx["engine_s"])
