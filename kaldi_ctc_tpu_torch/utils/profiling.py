"""Per-op wall-time accumulation + device trace capture.

The CuDevice::AccuProfile / PrintProfile analogue
(``cudamatrix/cu-device.h:103-109,172``): named sections accumulate wall
time in a process-global map and a summary is printed at exit or on
demand (the reference dumps it at the end of every GPU binary, e.g.
``ctcbin/nnet2-ctc-latgen-faster.cc:235``).  A copy of
``kaldi_ctc_tpu/utils/profiling.py`` whose ``trace(log_dir)`` records a
``torch.profiler`` trace (host and CUDA activity) where the JAX package's
records a ``jax.profiler`` one; the section timer remains useful for
host-side phases (data, decode, IO) the device trace can't see.
"""

from __future__ import annotations

import atexit
import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

__all__ = ["Profiler", "profiler", "trace"]


class Profiler:
    """Accumulates wall time per named section."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self.enabled = False

    def reset(self) -> None:
        self._acc.clear()
        self._count.clear()

    @contextlib.contextmanager
    def track(self, key: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[key] += time.perf_counter() - t0
            self._count[key] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"seconds": self._acc[k], "calls": self._count[k]}
                for k in sorted(self._acc, key=self._acc.get, reverse=True)}

    def print_profile(self, log=None) -> None:
        """PrintProfile analogue: sections sorted by accumulated time."""
        if not self._acc:
            return
        import functools
        import sys
        # stderr by default: CLIs write machine-readable output
        # (hypotheses, JSON) to stdout, like every other log line here
        emit = (log.info if log is not None
                else functools.partial(print, file=sys.stderr))
        total = sum(self._acc.values())
        emit("-----[Profile], total accounted %.3fs" % total)
        for k, v in self.report().items():
            emit("  %-40s %8.3fs  (%d calls)"
                 % (k, v["seconds"], v["calls"]))


profiler = Profiler()


def enable(print_at_exit: bool = True) -> Profiler:
    """Turn on section timing (and register the exit dump)."""
    profiler.enabled = True
    if print_at_exit:
        atexit.register(profiler.print_profile)
    return profiler


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into log_dir as a Chrome trace
    (TensorBoard's trace format; no-op when None).  CUDA activity is
    recorded where a card is present."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
