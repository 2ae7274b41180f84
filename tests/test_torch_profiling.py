"""The port's span and counter registry (``utils/profiling.py``): nesting
and self time, the histogram's quantiles, snapshot differences, updates
from several threads, the kernel wrappers' launch counters read in
place, ``record_function`` only inside a window the program opens, and
the host-span file written beside a trace on the trace's own clock."""

import json
import math
import os
import sys
import threading
import time

import numpy as np
import pytest

from kaldi_ctc_tpu_torch.utils import profiling
from kaldi_ctc_tpu_torch.utils.profiling import Profiler


class _Clock:
    """A stand-in for the registry's clock that the test moves."""

    def __init__(self):
        self.now = 10 ** 12

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += int(seconds * 1e9)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(profiling, "_now", c)
    return c


def test_nesting_and_self_time(clock):
    p = Profiler()
    with p.span("a"):
        clock.advance(0.001)
        with p.span("b"):
            clock.advance(0.003)
            with p.span("c"):
                clock.advance(0.002)
        with p.span("b"):
            clock.advance(0.004)
        clock.advance(0.005)
    s = p.snapshot()["spans"]
    assert s["a"]["count"] == 1 and s["b"]["count"] == 2
    assert s["a"]["total_s"] == pytest.approx(0.015)
    assert s["a"]["self_s"] == pytest.approx(0.006)
    assert s["b"]["total_s"] == pytest.approx(0.009)
    assert s["b"]["self_s"] == pytest.approx(0.007)
    assert s["b"]["max_s"] == pytest.approx(0.005)
    assert s["c"]["self_s"] == s["c"]["total_s"] == pytest.approx(0.002)
    # only "a" ran at the top of the main thread
    assert p.snapshot()["main_top_s"] == pytest.approx(0.015)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_quantiles_within_one_bucket(seed):
    rng = np.random.default_rng(seed)
    durs = np.exp(rng.uniform(math.log(2e-6), math.log(20.0), 5000))
    p = Profiler()
    for d in durs:
        p.record("x", 0, int(d * 1e9))
    stats = p.snapshot()["spans"]["x"]
    assert sum(stats["hist"].values()) == stats["count"] == len(durs)
    for q in (0.05, 0.5, 0.9, 0.95, 0.99):
        got = profiling.quantile(stats, q)
        want = float(np.percentile(durs, 100 * q))
        assert abs(profiling._bucket(int(got * 1e9))
                   - profiling._bucket(int(want * 1e9))) <= 1, (q, got, want)


def test_snapshot_difference(clock):
    p = Profiler()
    for _ in range(3):
        with p.span("x"):
            clock.advance(0.5)
    p.count("n", 2)
    old = p.snapshot()
    clock.advance(1.0)
    for _ in range(4):
        with p.span("x"):
            clock.advance(0.002)
    with p.span("y"):
        clock.advance(0.001)
    p.count("n", 5)
    p.count("m")
    d = profiling.diff(p.snapshot(), old)
    assert d["wall_s"] == pytest.approx(1.009)
    assert d["main_top_s"] == pytest.approx(0.009)
    x = d["spans"]["x"]
    assert x["count"] == 4 and x["total_s"] == pytest.approx(0.008)
    assert sum(x["hist"].values()) == 4
    # the interval's quantiles come from its own buckets, not the 0.5 s
    # spans before it
    assert 0.0015 < profiling.quantile(x, 0.5) < 0.0025
    assert 0.002 <= x["max_s"] < 0.0025
    assert d["spans"]["y"]["count"] == 1
    assert d["counters"] == {"n": 5, "m": 1}


def test_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span and
    count of every thread is kept, and each thread's stack is its own."""
    p = Profiler()
    n_threads, n = 2 * (os.cpu_count() or 2) + 2, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with p.span("outer"):
                    with p.span("inner"):
                        p.count("c")
                    p.count("c", 2)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = p.snapshot()
    assert snap["counters"]["c"] == 3 * n * n_threads
    assert snap["spans"]["outer"]["count"] == n * n_threads
    assert snap["spans"]["inner"]["count"] == n * n_threads
    assert snap["spans"]["outer"]["self_s"] == pytest.approx(
        snap["spans"]["outer"]["total_s"]
        - snap["spans"]["inner"]["total_s"])
    # no thread was the main one: nothing at the main thread's top
    assert snap["main_top_s"] == 0


def test_diff_when_no_bucket_moved():
    """A snapshot that caught a span between its bucket and its count,
    subtracted from a later one: the count moved and no bucket did."""
    def snap(t, count, total):
        return {"t_s": t, "main_top_s": 0.0, "counters": {},
                "spans": {"x": {"count": count, "total_s": total,
                                "self_s": total, "max_s": 0.1,
                                "hist": {"40": 5}}}}
    d = profiling.diff(snap(2.0, 5, 0.5), snap(1.0, 4, 0.4))
    x = d["spans"]["x"]
    assert x["count"] == 1 and x["hist"] == {}
    assert x["total_s"] == pytest.approx(0.1) and x["max_s"] == 0.1
    assert profiling.quantile(x, 0.5) == 0.0


def _spin(p, n_threads, n):
    """``n_threads`` threads that each run ``n`` nested span pairs, with
    a short switch interval; → (threads, errors, restore)."""
    errors = []

    def work():
        try:
            for _ in range(n):
                with p.span("outer"):
                    with p.span("inner"):
                        pass
        except Exception as e:  # noqa: BLE001 — the test reports it
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    return threads, errors, lambda: sys.setswitchinterval(old)


def test_snapshots_taken_while_spans_end_diff():
    """Snapshots taken while other threads end spans: each holds at least
    as many buckets as counts, and every difference of two of them reads
    (no bucket lost, no name without its bucket)."""
    p = Profiler()
    threads, errors, restore = _spin(p, 4, 4000)
    snaps = []
    try:
        while any(t.is_alive() for t in threads):
            snaps.append(p.snapshot())
        for t in threads:
            t.join(timeout=120)
    finally:
        restore()
    snaps.append(p.snapshot())
    assert errors == [] and len(snaps) > 2
    for s in snaps:
        for v in s["spans"].values():
            assert sum(v["hist"].values()) >= v["count"]
    for old, new in zip(snaps, snaps[1:]):
        for v in profiling.diff(new, old)["spans"].values():
            assert v["count"] > 0 and v["max_s"] >= 0
            profiling.quantile(v, 0.95)
    for s in snaps[:-1]:
        profiling.diff(snaps[-1], s)
    assert snaps[-1]["spans"]["outer"]["count"] == 4 * 4000


def test_window_closed_while_a_thread_ends_a_span(monkeypatch):
    """The main thread closes the window just as another thread's span,
    which began inside it, records its end: the span ends whole, its
    event goes to the window it began in, and the next span sees no
    window."""
    p = Profiler()
    real_get_ident = threading.get_ident

    class Threading:
        """``threading`` whose ``get_ident``, asked by the worker's span
        as it records its end, lets the main thread close the window
        first."""

        def __getattr__(self, name):
            return getattr(threading, name)

        @staticmethod
        def get_ident():
            if (threading.current_thread().name == "worker"
                    and sys._getframe(1).f_code.co_name == "close"
                    and p._window is not None):
                closed.append(p.close_window())
            return real_get_ident()

    closed = []
    errors = []

    def work():
        try:
            with p.span("x"):
                pass
            with p.span("y"):
                pass
        except Exception as e:  # noqa: BLE001 — the test reports it
            errors.append(e)

    monkeypatch.setattr(profiling, "threading", Threading())
    p.open_window()
    t = threading.Thread(target=work, name="worker")
    t.start()
    t.join(timeout=30)
    assert errors == [] and len(closed) == 1
    assert [e[0] for e in closed[0].events] == ["x"]
    spans = p.snapshot()["spans"]
    assert spans["x"]["count"] == spans["y"]["count"] == 1
    assert p._window is None


def test_launch_counters_are_read_in_place(monkeypatch):
    from kaldi_ctc_tpu_torch.ops import ctc_cuda, rnn_cuda

    monkeypatch.setattr(rnn_cuda.bilstm_seq_fwd, "launches", 7)
    monkeypatch.setattr(ctc_cuda.alpha_beta, "warp_launches", 3)
    c = Profiler().snapshot()["counters"]
    assert c["kernels.launches.bilstm_seq_fwd"] == 7
    assert c["kernels.launches.alpha_beta.warp"] == 3
    assert (c["kernels.launches.alpha_beta"]
            == ctc_cuda.alpha_beta.launches)
    # the wrappers keep them: nothing was copied or moved
    assert rnn_cuda.bilstm_seq_fwd.launches == 7
    assert "kernels.launches.log_mel" in c or \
        "kaldi_ctc_tpu_torch.features.stft_cuda" not in sys.modules

    # a wrapper module added later registers its wrappers on import
    def new_wrapper():
        pass
    new_wrapper.launches = 2
    new_wrapper.fast_launches = 1
    monkeypatch.setattr(profiling, "_launch_wrappers",
                        profiling._launch_wrappers[:])
    profiling.register_launch_counters(new_wrapper)
    c = Profiler().snapshot()["counters"]
    assert c["kernels.launches.new_wrapper"] == 2
    assert c["kernels.launches.new_wrapper.fast"] == 1


def test_record_function_only_inside_the_programs_window(monkeypatch):
    import torch.autograd.profiler as tprof

    calls = []

    class FakeRecordFunction:
        def __init__(self, name):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tprof, "record_function", FakeRecordFunction)
    p = Profiler()
    for _ in range(5):
        with p.span("outside"):
            pass
    assert calls == []
    p.open_window()
    try:
        with p.span("a"):
            with p.span("b"):
                pass
        # another thread's spans never reach the profiler
        t = threading.Thread(target=lambda: p.span("other").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
    finally:
        win = p.close_window()
    assert calls == ["a", "b"]
    with p.span("after"):
        pass
    assert calls == ["a", "b"]
    assert sorted(e[0] for e in win.events) == ["a", "b", "other"]


def test_trace_window_shares_the_profilers_clock(tmp_path):
    """A main-thread span in a CPU profiler window, against its stamps in
    the host-span file; a producer thread's span is in that file only."""
    import torch

    p = Profiler()
    with profiling.Trace(str(tmp_path), registry=p) as tr:
        def producer():
            with p.span("pipeline.batch"):
                time.sleep(0.002)
        t = threading.Thread(target=producer, name="producer")
        t.start()
        # the process's first record_function loads the profiler's ops
        with p.span("warm"):
            pass
        with p.span("train.step"):
            torch.ones(64, 64).sum()
            time.sleep(0.003)
        t.join(timeout=30)
    trace_path, spans_path = tr.paths
    with open(trace_path) as f:
        trace = json.load(f)
    with open(spans_path) as f:
        host = json.load(f)
    assert host["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    base = trace["baseTimeNanoseconds"]
    ann = [e for e in trace["traceEvents"] if e.get("name") == "train.step"
           and e.get("cat") == "user_annotation"]
    assert len(ann) == 1
    mine = {e["name"]: e for e in host["traceEvents"] if e["ph"] == "X"}
    step = mine["train.step"]
    a_prof = base + ann[0]["ts"] * 1e3
    b_prof = a_prof + ann[0]["dur"] * 1e3
    assert abs(a_prof - step["args"]["start_ns"]) < 1e6
    assert abs(b_prof - step["args"]["end_ns"]) < 1e6
    # the same rule reads both files' stamps
    assert abs(base + step["ts"] * 1e3 - step["args"]["start_ns"]) < 1e3
    prod = mine["pipeline.batch"]
    assert prod["args"]["parent"] is None and prod["tid"] != step["tid"]
    assert not [e for e in trace["traceEvents"]
                if e.get("name") == "pipeline.batch"]
    names = {e["args"]["name"] for e in host["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "producer" in names
    assert trace_path.endswith(".pt.trace.json")
    assert spans_path == trace_path[:-len(".pt.trace.json")] + \
        ".host_spans.json"


def test_trace_step_window(tmp_path):
    """``steps=(2, 3)``: opens at step 2's start and closes at step 3's
    end, once; the trace and the span file hold steps 2 and 3 only."""
    p = Profiler()
    with profiling.Trace(str(tmp_path), steps=(2, 3), registry=p) as tr:
        for step in range(1, 7):
            tr.step_begins(step)
            with p.span(f"step{step}"):
                pass
            tr.step_ended(step)
    assert len(tr.paths) == 2
    with open(tr.paths[0]) as f:
        ann = {e["name"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    with open(tr.paths[1]) as f:
        host = {e["name"] for e in json.load(f)["traceEvents"]
                if e["ph"] == "X"}
    assert ann == host == {"step2", "step3"}
    # no directory: nothing opens
    with profiling.Trace(None, steps=(1, 1), registry=p) as tr:
        tr.step_begins(1)
        tr.step_ended(1)
    assert tr.paths == [] and p._window is None


def test_print_profile_table(capsys, clock):
    p = Profiler()
    for _ in range(3):
        with p.span("x"):
            clock.advance(0.01)
    p.count("k", 4)
    p.print_profile()
    err = capsys.readouterr().err
    assert "self s" in err and "p95 ms" in err
    line = [ln for ln in err.splitlines() if ln.split()[:1] == ["x"]][0]
    assert line.split()[3] == "3"
    assert any(ln.split() == ["k", "4"] for ln in err.splitlines())
