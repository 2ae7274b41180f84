"""Spans and counters: the port's one timing registry, and its traces.

The CuDevice::AccuProfile / PrintProfile analogue
(``cudamatrix/cu-device.h:103-109,172``) grown into a registry of spans
and counters that is always on:

- ``profiler.span(name)`` is a context manager.  Each thread keeps its
  chain of open spans, so a span knows its parent and its *self* time
  (its duration less its children's).  Each name keeps a count, the
  total and self seconds, the longest, and a histogram of durations (4
  buckets an octave from 1 us to ~113 s: the memory is fixed, and the
  quantiles of any interval come from the difference of two snapshots).
  Durations are ``time.perf_counter_ns`` stamps.  Each thread adds to
  totals of its own, so a span ends without a lock; a snapshot sums the
  threads' (an ended thread's are folded into the registry's).
- ``profiler.count(name, n)`` adds to a counter.
- ``profiler.snapshot()`` returns ``{"t_s", "hist", "main_top_s",
  "spans", "counters"}``; the kernel wrappers' launch counters (the
  ``launches`` attributes that ``ops/*_cuda.py`` and
  ``features/stft_cuda.py`` register with
  :func:`register_launch_counters`) are read where they are kept, as
  ``kernels.launches.<wrapper>[.<route>]``.  :func:`diff` subtracts two
  snapshots, :func:`quantile` reads a quantile from a difference.
- :class:`Trace` records a ``torch.profiler`` trace of a window the
  program opens itself.  While it is open, the spans of the thread that
  opened it also enter ``record_function`` (the profiler sees no other
  thread's), and every thread's span events are kept and written beside
  the trace as a Chrome-trace file on the trace's own clock
  (``time.time_ns()``).  Outside a window no ``record_function`` runs.

``enable()`` prints the table at exit (``--profile 1``): each span's self
and total seconds, count, p50 and p95, then the counters.
"""

from __future__ import annotations

import atexit
import functools
import json
import math
import os
import re
import socket
import sys
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = ["Profiler", "profiler", "enable", "diff", "quantile", "Trace",
           "HIST_LO_S", "HIST_PER_OCTAVE", "HIST_BUCKETS"]

HIST_LO_S = 1e-6            # the lower edge of bucket 1; shorter → bucket 0
HIST_PER_OCTAVE = 4
HIST_BUCKETS = 108          # bucket i: [lo 2^((i-1)/4), lo 2^(i/4)); the last
                            # one is open above (~113 s)
_LO_NS = 1000

# the kernel wrappers that keep launch counters as function attributes,
# registered by their modules on import
_launch_wrappers: list = []


# the clock of every span (tests replace it)
_now = time.perf_counter_ns


def _bucket(ns: int) -> int:
    """The histogram bucket of a duration."""
    if ns < _LO_NS:
        return 0
    return min(1 + int(HIST_PER_OCTAVE * math.log2(ns / _LO_NS)),
               HIST_BUCKETS - 1)


def bucket_edges(i: int) -> Tuple[float, float]:
    """Bucket ``i``'s [lower, upper) edges in seconds."""
    if i == 0:
        return 0.0, HIST_LO_S
    lo = HIST_LO_S * 2.0 ** ((i - 1) / HIST_PER_OCTAVE)
    hi = (math.inf if i == HIST_BUCKETS - 1
          else HIST_LO_S * 2.0 ** (i / HIST_PER_OCTAVE))
    return lo, hi


class _Stat:
    __slots__ = ("count", "total", "self", "max", "hist")

    def __init__(self):
        self.count = self.total = self.self = self.max = 0
        self.hist: Dict[int, int] = {}

    def add(self, other: "_Stat") -> None:
        self.count += other.count
        self.total += other.total
        self.self += other.self
        self.max = max(self.max, other.max)
        for b, n in list(other.hist.items()):
            self.hist[b] = self.hist.get(b, 0) + n


class _Thread:
    """One thread's innermost open span and the totals of its spans,
    written by that thread alone: a span ends without a lock."""

    __slots__ = ("thread", "span", "stats", "main", "main_top")

    def __init__(self, main: bool):
        self.thread = threading.current_thread()
        self.span = None
        self.stats: Dict[str, _Stat] = {}
        self.main = main
        self.main_top = 0


class _Local(threading.local):
    state = None


class _Window:
    """What the registry keeps while a program-opened trace runs."""

    def __init__(self):
        self.tid = threading.get_ident()
        # perf_counter_ns → time_ns, the profiler's clock
        self.offset_ns = time.time_ns() - _now()
        self.events: list = []
        self.threads: Dict[int, str] = {}


class _Span:
    __slots__ = ("reg", "name", "t0", "child", "parent", "rf", "ts")

    def __init__(self, reg, name):
        self.reg = reg
        self.name = name
        self.child = 0
        self.rf = None

    def __enter__(self):
        reg = self.reg
        ts = reg._local.state or reg._new_thread()
        self.ts = ts
        self.parent = ts.span
        ts.span = self
        # read once: the thread that owns the window may close it
        # meanwhile
        win = reg._window
        if win is not None and win.tid == threading.get_ident():
            from torch.autograd.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, et, ev, tb):
        t1 = _now()
        self.ts.span = self.parent
        if self.rf is not None:
            self.rf.__exit__(et, ev, tb)
        self.close(t1)
        return False

    def close(self, t1: int) -> None:
        """Account the span, ended at ``t1``, to its parent and to its
        thread's totals of its name."""
        dur = t1 - self.t0
        ts = self.ts
        parent = self.parent
        if parent is not None:
            parent.child += dur
        elif ts.main:
            ts.main_top += dur
        st = ts.stats.get(self.name)
        if st is None:
            st = ts.stats[self.name] = _Stat()
        # the bucket before the count: a snapshot taken meanwhile never
        # holds a count without its bucket
        b = _bucket(dur)
        st.hist[b] = st.hist.get(b, 0) + 1
        st.count += 1
        st.total += dur
        st.self += dur - self.child
        if dur > st.max:
            st.max = dur
        win = self.reg._window
        if win is not None:
            ident = threading.get_ident()
            if ident not in win.threads:
                win.threads[ident] = threading.current_thread().name
            win.events.append((self.name, self.t0, t1, ident,
                               parent.name if parent is not None else None))


class Profiler:
    """The registry of spans and counters (one a process: ``profiler``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = _Local()
        self._threads: list = []            # each live thread's _Thread
        self._retired: Dict[str, _Stat] = {}  # the ended threads' totals
        self._retired_main_top = 0
        self._counters: Dict[str, float] = {}
        self._main_ident = threading.main_thread().ident
        self._window: Optional[_Window] = None
        self._started_ns: Optional[int] = None
        # span(name): a span of ``name``; a partial, not a method: one
        # Python call less on every span
        self.span = functools.partial(_Span, self)

    def _new_thread(self) -> _Thread:
        ts = self._local.state = _Thread(
            threading.get_ident() == self._main_ident)
        with self._lock:
            self._retire()
            self._threads.append(ts)
        return ts

    def _retire(self) -> None:
        """Fold the totals of threads that have ended into the retired
        totals (under the lock; no thread writes an ended thread's)."""
        live = []
        for ts in self._threads:
            if ts.thread.is_alive():
                live.append(ts)
                continue
            for name, st in ts.stats.items():
                self._retired.setdefault(name, _Stat()).add(st)
            self._retired_main_top += ts.main_top
        self._threads = live

    def count(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def record(self, name: str, t0_ns: int, t1_ns: int) -> None:
        """A span with given ``perf_counter_ns`` stamps, under no parent
        (a time that passed before the registry could open it)."""
        sp = _Span(self, name)
        sp.ts = self._local.state or self._new_thread()
        sp.t0, sp.parent = t0_ns, None
        sp.close(t1_ns)

    def main_started(self) -> dict:
        """Called at an entry point's ``main``: the first time in a
        process, records ``setup.imports`` (process start, read from
        ``/proc/self/stat``, to now).  → the baseline snapshot of the
        run's first interval, stamped at the process's start (or now on
        a later call, or where ``/proc`` cannot be read)."""
        base = self.snapshot()
        now = _now()
        if self._started_ns is None:
            age = _process_age_ns()
            self._started_ns = now - age if age is not None else now
            if age is not None:
                self.record("setup.imports", self._started_ns, now)
                base["t_s"] = self._started_ns / 1e9
        return base

    def snapshot(self) -> dict:
        """The totals so far (histograms as ``{bucket: count}``)."""
        t = _now()
        with self._lock:
            self._retire()
            totals: Dict[str, _Stat] = {}
            for name, st in self._retired.items():
                totals.setdefault(name, _Stat()).add(st)
            main_top = self._retired_main_top
            for ts in self._threads:
                # a live thread may add a name meanwhile: copy first
                for name, st in list(ts.stats.items()):
                    totals.setdefault(name, _Stat()).add(st)
                main_top += ts.main_top
            counters = dict(self._counters)
        spans = {name: {"count": st.count, "total_s": st.total / 1e9,
                        "self_s": st.self / 1e9, "max_s": st.max / 1e9,
                        "hist": st.hist}
                 for name, st in totals.items()}
        main_top /= 1e9
        counters.update(launch_counters())
        return {"t_s": t / 1e9,
                "hist": {"lo_s": HIST_LO_S, "per_octave": HIST_PER_OCTAVE,
                         "buckets": HIST_BUCKETS},
                "main_top_s": main_top, "spans": spans, "counters": counters}

    def print_profile(self, log=None) -> None:
        """PrintProfile analogue: spans by self time, then counters."""
        snap = self.snapshot()
        if not snap["spans"] and not self._counters:
            return
        # stderr by default: CLIs write machine-readable output
        # (hypotheses, JSON) to stdout, like every other log line here
        emit = (log.info if log is not None
                else (lambda s: print(s, file=sys.stderr)))
        spans = sorted(snap["spans"].items(), key=lambda kv: -kv[1]["self_s"])
        emit("-----[Profile], %d spans, %.3fs self in all"
             % (len(spans), sum(v["self_s"] for _, v in spans)))
        emit("  %-28s %10s %10s %8s %10s %10s"
             % ("span", "self s", "total s", "count", "p50 ms", "p95 ms"))
        for name, v in spans:
            emit("  %-28s %10.3f %10.3f %8d %10.3f %10.3f"
                 % (name, v["self_s"], v["total_s"], v["count"],
                    1e3 * quantile(v, 0.5), 1e3 * quantile(v, 0.95)))
        for name, n in sorted(snap["counters"].items()):
            if n:
                emit("  %-28s %g" % (name, n))

    # ---- the program-opened window ----

    def open_window(self) -> None:
        self._window = _Window()

    def close_window(self) -> Optional[_Window]:
        win, self._window = self._window, None
        return win


profiler = Profiler()


def _process_age_ns() -> Optional[int]:
    """Nanoseconds since this process started (10 ms resolution)."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # the command name may hold spaces: the fields after it
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        boot_s = time.clock_gettime(time.CLOCK_BOOTTIME)
        age = boot_s - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    return max(int(age * 1e9), 0)


def register_launch_counters(*wrappers) -> None:
    """Called by a kernel wrapper module on import: each of ``wrappers``
    keeps its launches in its attribute ``launches``, and by route in
    ``<route>_launches``.  Every snapshot reads them where they are."""
    _launch_wrappers.extend(wrappers)


def launch_counters() -> Dict[str, int]:
    """The registered wrappers' launch counters, read in place
    (``kernels.launches.<wrapper>`` and ``.<route>`` for the routes)."""
    out = {}
    for fn in _launch_wrappers:
        for attr, v in vars(fn).items():
            if attr == "launches":
                out[f"kernels.launches.{fn.__name__}"] = int(v)
            elif attr.endswith("_launches"):
                out[f"kernels.launches.{fn.__name__}.{attr[:-9]}"] = int(v)
    return out


def diff(new: dict, old: dict) -> dict:
    """``new`` less ``old`` (two snapshots): the interval's spans (those
    that ran in it), counters (those that moved), ``wall_s`` and
    ``main_top_s``.  An interval's longest span is not kept; ``max_s``
    is the upper edge of its highest bucket, capped by the longest so
    far.  A snapshot may catch a thread between a span's bucket and its
    count, so the two may disagree by the spans that were ending then:
    where no bucket moved, ``max_s`` is the longest so far."""
    spans = {}
    for name, v in new["spans"].items():
        # bucket keys are ints here and strings after a JSON round trip
        vh = {int(b): n for b, n in v["hist"].items()}
        o = old["spans"].get(name)
        if o is None:
            spans[name] = dict(v, hist=vh)
            continue
        if v["count"] == o["count"]:
            continue
        oh = {int(b): n for b, n in o["hist"].items()}
        hist = {b: n - oh.get(b, 0) for b, n in vh.items()
                if n != oh.get(b, 0)}
        top = bucket_edges(max(hist))[1] if hist else math.inf
        spans[name] = {"count": v["count"] - o["count"],
                       "total_s": v["total_s"] - o["total_s"],
                       "self_s": v["self_s"] - o["self_s"],
                       "max_s": min(top, v["max_s"]), "hist": hist}
    counters = {name: n - old["counters"].get(name, 0)
                for name, n in new["counters"].items()
                if n != old["counters"].get(name, 0)}
    return {"wall_s": new["t_s"] - old["t_s"],
            "main_top_s": new["main_top_s"] - old["main_top_s"],
            "spans": spans, "counters": counters}


def quantile(stats: dict, q: float) -> float:
    """The ``q`` quantile (0..1) of a span's durations in seconds, from
    its histogram: the geometric middle of the bucket that holds it."""
    hist = {int(b): n for b, n in stats["hist"].items()}
    total = sum(hist.values())
    if total == 0:
        return 0.0
    rank = q * (total - 1)
    seen = 0
    for b in sorted(hist):
        seen += hist[b]
        if seen > rank:
            lo, hi = bucket_edges(b)
            if b == 0:
                return hi / 2
            if math.isinf(hi):
                return lo
            return math.sqrt(lo * hi)
    return bucket_edges(max(hist))[0]


def enable(print_at_exit: bool = True) -> Profiler:
    """Print the registry's table at exit (``--profile 1``)."""
    if print_at_exit:
        atexit.register(profiler.print_profile)
    return profiler


_BASE_RE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


class Trace:
    """A ``torch.profiler`` trace (host and CUDA activity where a card is
    present) of a window the program opens, written into ``log_dir`` as
    ``<host>_<pid>.<time_ns>.pt.trace.json`` (TensorBoard's layout) when
    the window closes, with the registry's span events of every thread
    beside it in ``….host_spans.json``, stamped on the trace's clock.

    ``steps=None``: the window is the ``with`` block.  ``steps=(a, b)``:
    it opens at :meth:`step_begins` of step ``a`` and closes at
    :meth:`step_ended` of step ``b`` (or on the way out of the block).
    With no ``log_dir`` nothing is traced.  The profiler's start and
    the files' writing are spans of their own (``profile.start``,
    ``profile.write``), outside the window."""

    def __init__(self, log_dir: Optional[str],
                 steps: Optional[Tuple[int, int]] = None,
                 registry: Profiler = profiler):
        self.log_dir = log_dir
        self.steps = steps
        self.registry = registry
        self._prof = None
        self._done = False
        self.paths: list = []

    def __enter__(self):
        if self.log_dir and self.steps is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def step_begins(self, step: int) -> None:
        if (self.log_dir and self.steps and not self._done
                and self._prof is None
                and self.steps[0] <= step <= self.steps[1]):
            self.start()

    def step_ended(self, step: int) -> None:
        if self.steps and self._prof is not None and step >= self.steps[1]:
            self.stop()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with self.registry.span("profile.start"):
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self._prof = profile(activities=activities)
            self._prof.start()
        self.registry.open_window()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._done = True
        win = self.registry.close_window()
        with self.registry.span("profile.write"):
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            stem = os.path.join(self.log_dir, "%s_%d.%d" % (
                socket.gethostname(), os.getpid(), time.time_ns()))
            prof.export_chrome_trace(stem + ".pt.trace.json")
            with open(stem + ".pt.trace.json", "rb") as f:
                m = _BASE_RE.search(f.read(4096))
            base_ns = int(m.group(1)) if m else 0
            write_host_spans(stem + ".host_spans.json", win, base_ns)
        self.paths += [stem + ".pt.trace.json", stem + ".host_spans.json"]


def write_host_spans(path: str, win: _Window, base_ns: int) -> None:
    """A window's span events as a Chrome trace: ``ts`` and ``dur`` in
    microseconds, ``ts`` from ``baseTimeNanoseconds`` (the profiler
    trace's, so the two files share one timeline); ``args`` hold the
    stamps in ``time.time_ns()`` nanoseconds and the parent."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": "host spans (registry)"}}]
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in win.threads.items()]
    for name, t0, t1, tid, parent in win.events:
        a_ns = t0 + win.offset_ns
        b_ns = t1 + win.offset_ns
        events.append({"ph": "X", "cat": "host_span", "name": name,
                       "pid": pid, "tid": tid,
                       "ts": (a_ns - base_ns) / 1e3,
                       "dur": (b_ns - a_ns) / 1e3,
                       "args": {"start_ns": a_ns, "end_ns": b_ns,
                                "parent": parent}})
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns,
                   "traceEvents": events}, f)
