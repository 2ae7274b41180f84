"""Find a cell's pieces by name and check BENCHMARK.json's rules.

Everything that belongs to one configuration, traffic mix, per-layer
metric, layer or cell is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the path is the config entry's ``file``),
  whose ``family`` names ``families/<family>.py``, the model's code
  (``google`` where it names none);
- ``traffic/<traffic>.json``, whose ``kind`` names the driver
  ``drivers/<kind>.py`` that runs it;
- ``metrics/<metric>.py``, a reader with ``read(ctx)`` that returns the
  metric's value, or None where it finds nothing to read;
- ``kernels/*.json``, each ``{"layer": ..., "patterns": [...]}``: the
  device operations whose names hold a pattern are charged to the layer;
- ``limits/<cell>.json``, the limits that decide ``correct``.

A later cell, configuration, metric or layer is added by adding files
and entries; no file here needs an edit.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List

from asrbench import families

__all__ = ["Cell", "load_benchmark", "validate", "find_cell",
           "kernel_layers", "metric_reader", "driver_for", "HERE"]

HERE = os.path.dirname(os.path.abspath(__file__))

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
_PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
_TOP = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
_SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    traffic_path: str
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    bench_dir: str


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s, what, errors):
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s \
            or "\t" in s:
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def validate(bench: dict, root: str, bench_dir: str = HERE) -> List[str]:
    """The rules of BENCHMARK.json that a file can break → the list of faults
    (empty when the benchmark holds)."""
    e: List[str] = []
    if set(bench) != _TOP:
        e.append(f"top-level keys {sorted(bench)} != {sorted(_TOP)}")
        return e
    paths = bench["paths"]
    if not 1 <= len(paths) <= 16 or any(
            not _PATH.match(p) or p.startswith("/") or ".." in p.split("/")
            for p in paths):
        e.append("paths: 1 to 16 relative directories")
    cmd = bench["command"]
    if not 1 <= len(cmd) <= 32:
        e.append("command: 1 to 32 words")
    for w in cmd:
        _line(w, "command word", e)
    if not (isinstance(bench["run_seconds"], int)
            and 1 <= bench["run_seconds"] <= 51):
        e.append("run_seconds: a whole number from 1 to 51")
    names = set()

    def named(entry, what, allowed):
        n = entry.get("name")
        if not isinstance(n, str) or not _NAME.match(n):
            e.append(f"{what} name {n!r}")
        if n in names:
            e.append(f"name {n!r} used twice")
        names.add(n)
        extra = set(entry) - allowed
        if extra:
            e.append(f"{what} {n}: keys {sorted(extra)} not allowed")

    configs = {}
    for c in bench["configs"]:
        named(c, "config", {"name", "source", "file", "reduced", "why"})
        _line(c.get("source"), f"config {c.get('name')} source", e)
        _line(c.get("why"), f"config {c.get('name')} why", e)
        f = c.get("file", "")
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            e.append(f"config {c.get('name')}: file {f} not under paths")
        elif not os.path.exists(os.path.join(root, f)):
            e.append(f"config {c.get('name')}: {f} missing")
        else:
            with open(os.path.join(root, f)) as fh:
                family = json.load(fh).get("family", families.DEFAULT)
            if not families.NAME.match(str(family)) or not os.path.exists(
                    os.path.join(bench_dir, "families", f"{family}.py")):
                e.append(f"config {c.get('name')}: no family {family!r}")
        if len(c.get("reduced", [])) > 16 or any(
                not _NAME.match(k) for k in c.get("reduced", [])):
            e.append(f"config {c.get('name')}: reduced")
        configs[c.get("name")] = c
    if len({c.get("file") for c in bench["configs"]}) != len(bench["configs"]):
        e.append("two configs share a file")
    if not 1 <= len(bench["configs"]) <= 24:
        e.append("configs: 1 to 24")
    cells = {}
    pairs = set()
    for w in bench["workloads"]:
        named(w, "workload", {"name", "config", "traffic", "chips", "why"})
        _line(w.get("why"), f"workload {w.get('name')} why", e)
        if w.get("config") not in configs:
            e.append(f"workload {w.get('name')}: unknown config")
        if not _NAME.match(str(w.get("traffic"))) or not os.path.exists(
                os.path.join(bench_dir, "traffic", f"{w.get('traffic')}.json")):
            e.append(f"workload {w.get('name')}: no traffic file")
        if w.get("chips") not in (1, 4):
            e.append(f"workload {w.get('name')}: chips 1 or 4")
        if not os.path.exists(os.path.join(bench_dir, "limits",
                                           f"{w.get('name')}.json")):
            e.append(f"workload {w.get('name')}: no limits file")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            e.append(f"config and traffic {pair} twice")
        pairs.add(pair)
        cells[w.get("name")] = w
    if not 1 <= len(bench["workloads"]) <= 24:
        e.append("workloads: 1 to 24")
    if sum(w.get("chips") == 4 for w in bench["workloads"]) > max(
            1, len(bench["workloads"]) // 4):
        e.append("too many four-chip cells")
    used = {w.get("config") for w in bench["workloads"]}
    for c in configs:
        if c not in used:
            e.append(f"config {c} used by no cell")
    e2e = {}
    for m in bench["end_to_end"]:
        named(m, "metric", {"name", "unit", "better", "bound", "source",
                            "workloads"})
        if m.get("source") not in ("host_clock", "device_trace"):
            e.append(f"metric {m.get('name')}: end-to-end source")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            e.append(f"metric {m.get('name')}: bound in [0.01, 0.25]")
        e2e[m.get("name")] = m
    if "setup_s" not in e2e:
        e.append("no setup_s")
    for m in bench["per_layer"]:
        named(m, "metric", {"name", "unit", "better", "source", "layer",
                            "moves", "workloads"})
        if m.get("source") not in _SOURCES:
            e.append(f"metric {m.get('name')}: source")
        _line(m.get("layer"), f"metric {m.get('name')} layer", e)
        if m.get("moves") not in e2e:
            e.append(f"metric {m.get('name')}: moves an unknown metric")
        if not os.path.exists(os.path.join(bench_dir, "metrics",
                                           f"{m.get('name')}.py")):
            e.append(f"metric {m.get('name')}: no reader file")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not _UNIT.match(str(m.get("unit"))):
            e.append(f"metric {m.get('name')}: unit")
        if m.get("better") not in ("lower", "higher"):
            e.append(f"metric {m.get('name')}: better")
        for c in m.get("workloads", []):
            if c not in cells:
                e.append(f"metric {m.get('name')}: unknown cell {c}")
    for c in cells:
        ends = [m["name"] for m in bench["end_to_end"] if _reports(m, c)]
        if "setup_s" not in ends or len(ends) < 2:
            e.append(f"cell {c}: needs setup_s and another end-to-end metric")
        layers = [m for m in bench["per_layer"]
                  if _reports(m, c) and m.get("moves") in ends]
        if not layers:
            e.append(f"cell {c}: no per-layer metric")
        for m in bench["per_layer"]:
            if c in m.get("workloads", []) and m.get("moves") not in ends:
                e.append(f"metric {m['name']}: cell {c} does not report "
                         f"{m.get('moves')}")
    if len(json.dumps(bench)) > 64 * 1024:
        e.append("BENCHMARK.json over 64 KiB")
    return e


def find_cell(bench: dict, root: str, name: str,
              bench_dir: str = HERE) -> Cell:
    """The cell ``name`` with its files read; ValueError where the
    benchmark breaks its rules or names no such cell."""
    faults = validate(bench, root, bench_dir)
    if faults:
        raise ValueError("BENCHMARK.json: " + "; ".join(faults))
    w = {x["name"]: x for x in bench["workloads"]}.get(name)
    if w is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    tpath = os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")
    with open(tpath) as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    ends = [m for m in bench["end_to_end"] if _reports(m, name)]
    end_names = {m["name"] for m in ends}
    layers = [m for m in bench["per_layer"]
              if _reports(m, name) and m["moves"] in end_names]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, tpath, ends, layers, limits, bench_dir)


def kernel_layers(bench_dir: str = HERE) -> Dict[str, List[str]]:
    """layer → kernel-name patterns, the union over ``kernels/*.json``."""
    out: Dict[str, List[str]] = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels",
                                              "*.json"))):
        with open(path) as f:
            d = json.load(f)
        out.setdefault(d["layer"], []).extend(d["patterns"])
    return out


def metric_reader(name: str, bench_dir: str = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "asrbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_for(cell: Cell):
    """``drivers/<kind>.py`` of the cell's traffic."""
    kind = cell.traffic["kind"]
    if not _NAME.match(kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"asrbench.drivers.{kind}")
