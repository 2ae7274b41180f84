"""Reduce a ``torch.profiler`` trace of the measured window to numbers.

- ``busy_s``: the union of the intervals in which any device activity
  (kernel, copy, set) ran, inside the traced window;
- ``device_ops``: device seconds by operation name, the largest first;
- ``idle_gaps``: the longest gaps between device activity as [name,
  seconds, start_ns, end_ns], each named by what the host was doing: the
  innermost benchmark span (``asrbench.*``, a ``record_function`` around
  a call into one of the program's layers) over the gap's middle, else
  "host, outside the spans";
- ``layer_s``: device seconds charged to each layer by the kernel-name
  patterns of ``kernels/*.json``.

Timestamps are the profiler's, in ``time.time_ns()``'s clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

__all__ = ["summarize", "merge_intervals", "charge_layers"]


def _ns(e, what: str) -> int:
    if hasattr(e, what + "_ns"):
        return int(getattr(e, what + "_ns")())
    return int(getattr(e, what + "_us")() * 1000)


def merge_intervals(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def charge_layers(op_seconds: Dict[str, float],
                  layers: Dict[str, Sequence[str]]) -> Dict[str, float]:
    """Device seconds of each layer: the operations whose name contains
    one of the layer's patterns."""
    out = {}
    for layer, pats in layers.items():
        out[layer] = sum(s for name, s in op_seconds.items()
                         if any(p in name for p in pats))
    return out


def summarize(prof, t0_ns: int, t1_ns: int,
              layers: Dict[str, Sequence[str]], top: int = 10) -> dict:
    """The numbers of one traced window [t0_ns, t1_ns]."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[int, int]] = []
    op_s: Dict[str, float] = defaultdict(float)
    spans: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        a = _ns(e, "start")
        b = a + _ns(e, "duration")
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.name().startswith("asrbench."):
                continue    # a span's shadow on the device's timeline
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b > a:
                dev.append((a, b))
                op_s[e.name()] += (b - a) / 1e9
        elif e.is_user_annotation() and e.name().startswith("asrbench."):
            spans.append((a, b, e.name()))
    busy = merge_intervals(dev)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = []
    edge = t0_ns
    for a, b in busy + [(t1_ns, t1_ns)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    spans.sort()
    named = [[_what(spans, (a + b) // 2), (b - a) / 1e9, a, b]
             for a, b in gaps[:top]]
    ops = sorted(op_s.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy_s,
        "device_ops": [[n, s] for n, s in ops[:top]],
        "idle_gaps": named,
        "op_seconds": dict(op_s),
        "layer_s": charge_layers(op_s, layers),
        "device_events": len(dev),
    }


def _what(spans, t: int) -> str:
    best = None
    for a, b, name in spans[:bisect.bisect_right(spans, (t, t, "~"))]:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best is not None else "host, outside the spans"
