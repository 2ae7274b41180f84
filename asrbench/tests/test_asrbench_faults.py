"""A whole run at a test size on the CPU, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath (a
step that returns its state unchanged, half the batch left out with the
update scaled to the whole, a served token altered where it is
produced), ``correct`` comes out false under the cells' own limits."""

import json
import os
import sys
import time

import pytest

from asrbench import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "asrbench", "tests", "data")
sys.path.insert(0, os.path.join(ROOT, "asrbench"))
import run  # noqa: E402

sys.path.remove(os.path.join(ROOT, "asrbench"))


# the recognize cell's end-to-end metrics (its traffic, driver, readers
# and limits are in asrbench/; BENCHMARK.json does not run it yet)
RECOGNIZE_METRICS = [{"name": n, "unit": u} for n, u in (
    ("request_p95_ms", "ms"), ("request_p50_ms", "ms"), ("setup_s", "s"))]


def _cell(config, traffic, limits_of):
    """A test-size cell held to the limits of the cell ``limits_of``."""
    with open(os.path.join(DATA, config + ".json")) as f:
        cfg = json.load(f)
    path = os.path.join(DATA, traffic + ".json")
    with open(path) as f:
        tr = json.load(f)
    with open(os.path.join(cells.HERE, "limits", limits_of + ".json")) as f:
        limits = json.load(f)
    bench = cells.load_benchmark(ROOT)
    if limits_of.endswith(".recognize"):
        ends, layers = RECOGNIZE_METRICS, []
    else:
        real = cells.find_cell(bench, ROOT, limits_of)
        ends, layers = real.end_to_end, real.per_layer
    return cells.Cell("test." + traffic, 1, config, cfg, traffic, tr, path,
                      ends, layers, limits, cells.HERE)


def _line(cell, fault, trace=False):
    out = cells.driver_for(cell).run(cell, 20260 + len(fault or ""), 2.0,
                                     trace, time.monotonic(), device="cpu",
                                     fault=fault)
    return run.result_line(cell, out, trace, 1)


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.mark.parametrize("config,limits_of", [
    ("tiny_lstm", "blstm5x320.train"), ("tiny_gru", "bigru5x320.train")])
def test_train_sound_run_is_correct(config, limits_of):
    line = _line(_cell(config, "tiny_train", limits_of), None)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_are_not_correct(fault):
    line = _line(_cell("tiny_lstm", "tiny_train", "blstm5x320.train"), fault)
    assert not line["correct"], line["checks"]


def test_recognize_sound_run_is_correct():
    line = _line(_cell("tiny_lstm", "tiny_recognize",
                       "blstm5x320.recognize"), None)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert set(line["metrics"]) == {"request_p95_ms", "request_p50_ms",
                                    "setup_s"}


def test_recognize_altered_token_is_not_correct():
    line = _line(_cell("tiny_lstm", "tiny_recognize",
                       "blstm5x320.recognize"), "alter_token")
    assert not line["correct"], line["checks"]
    assert line["checks"]["label_gap"]["value"] > 0.1


def test_traced_run_reports_its_layers():
    """A traced run on the CPU: the host-clock readers report, the
    device ones find no device time and stay silent."""
    line = _line(_cell("tiny_lstm", "tiny_train", "blstm5x320.train"), None,
                 trace=True)
    assert "train.step_interval_p50_ms" in line["metrics"]
    assert "rnn.roofline_pct.train" not in line["metrics"]
    assert line["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_processes_on_gloo(fault):
    """The four-process path (``launch``, gloo on the CPU): the global
    batches worked out again match the first process's; with the
    all-reduce left out the run is not correct."""
    line = _line(_cell("tiny_lstm", "tiny_train_dp4", "blstm5x320.train"),
                 fault)
    assert line["checks"]["batches_differ"]["value"] == 0
    assert line["correct"] == (fault is None), line["checks"]
