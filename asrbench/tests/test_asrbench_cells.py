"""The loader: BENCHMARK.json keeps its rules, and a throwaway cell
made only by adding files is found and validated with no existing file
edited."""

import copy
import json
import os
import shutil

import pytest

from asrbench import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _bench():
    return cells.load_benchmark(ROOT)


def test_benchmark_keeps_its_rules():
    assert cells.validate(_bench(), ROOT) == []
    for w in _bench()["workloads"]:
        cell = cells.find_cell(_bench(), ROOT, w["name"])
        assert [m["name"] for m in cell.end_to_end][-1] == "setup_s" or \
            "setup_s" in [m["name"] for m in cell.end_to_end]
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
        assert cells.driver_for(cell).run


def test_a_cell_added_as_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a metric
    reader, a kernel attribution and a limits file, and entries in
    BENCHMARK.json: the loader finds and validates the new cell, and no
    file that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "asrbench"), root / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(root / "asrbench") for p in fs}
    bench = copy.deepcopy(_bench())
    b = root / "asrbench"
    cfg = json.loads((b / "configs" / "blstm5x320.json").read_text())
    cfg.update(name="blstm3x128", hidden_dim=128, num_layers=3)
    (b / "configs" / "blstm3x128.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "train960.json").read_text())
    tr["utterances"] = 960
    (b / "traffic" / "train100.json").write_text(json.dumps(tr))
    (b / "metrics" / "train.steps_per_s.py").write_text(
        "def read(ctx):\n    return None\n")
    (b / "kernels" / "k13.json").write_text(json.dumps(
        {"layer": "recurrent stack", "patterns": ["k13_"]}))
    (b / "limits" / "blstm3x128.train100.json").write_text(json.dumps(
        {"batches_differ": 0, "loss_rel": 1e-5}))
    bench["configs"].append({"name": "blstm3x128", "source": "a recipe",
                             "file": "asrbench/configs/blstm3x128.json",
                             "reduced": [], "why": "the medium recipe"})
    bench["workloads"].append({"name": "blstm3x128.train100",
                               "config": "blstm3x128", "traffic": "train100",
                               "chips": 1, "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("blstm3x128.train100")
    bench["per_layer"].append({"name": "train.steps_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "training driver",
                               "moves": "audio_s_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = cells.load_benchmark(str(root))
    assert cells.validate(loaded, str(root), str(b)) == []
    cell = cells.find_cell(loaded, str(root), "blstm3x128.train100", str(b))
    assert cell.config["hidden_dim"] == 128
    assert cell.traffic["utterances"] == 960
    assert "train.steps_per_s" in [m["name"] for m in cell.per_layer]
    assert "k13_" in cells.kernel_layers(str(b))["recurrent stack"]
    assert cells.metric_reader("train.steps_per_s", str(b))({}) is None
    for p, data in before.items():
        matches = [os.path.join(dp, p) for dp, _, fs in os.walk(b)
                   if p in fs]
        assert any(open(m, "rb").read() == data for m in matches)


@pytest.mark.parametrize("break_it", [
    lambda b: b.pop("run_seconds"),
    lambda b: b["end_to_end"][0].update(bound=0.3),
    lambda b: b["end_to_end"].pop(),                     # setup_s
    lambda b: b["workloads"][0].update(chips=2),
    lambda b: b["workloads"][0].update(traffic="nope"),
    lambda b: b["per_layer"][0].update(moves="nope"),
    lambda b: b["per_layer"][0].update(unit="per second"),
    lambda b: b["configs"][0].update(name="bad name"),
    lambda b: b["workloads"].append(dict(b["workloads"][0], name="twin")),
])
def test_a_broken_benchmark_is_refused(break_it):
    bench = copy.deepcopy(_bench())
    break_it(bench)
    assert cells.validate(bench, ROOT)
    with pytest.raises(ValueError):
        cells.find_cell(bench, ROOT, "blstm5x320.train")
