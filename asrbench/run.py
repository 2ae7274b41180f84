"""Run one cell of the benchmark once and print its result line.

  python3 asrbench/run.py --workload blstm5x320.train --seed 7 \\
      --seconds 30 --trace 0

Reads ``BENCHMARK.json`` at the checkout's root, finds the cell's files
by name (``asrbench/cells.py``), checks for the cards the cell needs,
runs the cell's driver, and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit (also the last lines of
standard error).  Exits non-zero with no result line where it finds no
card, or too few, where the program or a file of the benchmark is
missing, or where the process holds JAX or the JAX package at the end.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "kaldi_ctc_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``kaldi_ctc_tpu_torch`` is not
    ``kaldi_ctc_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def result_line(cell, out: dict, trace: bool, chips_used: int) -> dict:
    """The result object from a driver's output."""
    from asrbench import cells, checks

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], cell.bench_dir)(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    res = out["results"]
    device = {"platform": "gpu", "kind": res.get("device_name", ""),
              "count": chips_used,
              "memory_peak_bytes": int(res.get("memory_peak_bytes", 0))}
    line = {"attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": device}
    tr = res.get("trace")
    if trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": [g[:2] for g in tr["idle_gaps"]]}
    judged = checks.judge(out["readings"], cell.limits)
    line = {"correct": checks.passed(judged), **line, "checks": judged}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    from asrbench import cells

    bench = cells.load_benchmark(ROOT)
    cell = cells.find_cell(bench, ROOT, args.workload)
    import importlib.util
    if importlib.util.find_spec("kaldi_ctc_tpu_torch") is None:
        sys.stderr.write("the program under test, kaldi_ctc_tpu_torch, is "
                         "not in this checkout\n")
        return 5
    from asrbench import proc

    def check_cards():
        # after the program has started, so that torch's import here
        # overlaps the program's own
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            raise proc.NoCards(f"{cell.name} needs {cell.chips} CUDA "
                               f"card(s); found {n}")

    driver = cells.driver_for(cell)
    try:
        out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START, device="cuda", check_cards=check_cards)
    except proc.NoCards as e:
        sys.stderr.write(f"{e}\n")
        return 3
    line = result_line(cell, out, bool(args.trace), cell.chips)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"JAX or the JAX package is loaded: {bad}\n")
        return 4
    from asrbench import checks
    sys.stderr.write("\n".join(checks.report_lines(line["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
