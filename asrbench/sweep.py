"""Find the highest /recognize rate a server sustains: one server, open
loop windows at rising rates.

  python3 asrbench/sweep.py --workload blstm5x320.recognize --seed 5 \\
      --seconds 15 --rates 30,45,60,75,90

A rate is sustained when every request of its window is answered, and
the median latency of the window's last quarter of requests stays under
twice that of its first quarter (no backlog that grows through the
window).  Prints one JSON line a rate.  The cell's traffic file keeps a
fixed rate below the highest sustained one; this script is run when a
benchmark PR sets it, not by the benchmark's runs.
"""

import argparse
import json
import os
import shutil
import signal
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from asrbench import cells, proc, traffic as tr
    from asrbench.drivers import recognize as rc

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    cell = cells.find_cell(cells.load_benchmark(ROOT), ROOT, args.workload)
    run_dir = tempfile.mkdtemp(prefix="asrbench-sweep-")
    settings = {"role": "recognize", "entry": "kaldi_ctc_tpu_torch.cli.serve",
                "config": cell.config, "seed": args.seed, "run_dir": run_dir,
                "model_path": os.path.join(run_dir, "model.npz"),
                "trace": False, "device": "cuda"}
    spath = os.path.join(run_dir, "settings.json")
    with open(spath, "w") as f:
        json.dump(settings, f)
    log = os.path.join(run_dir, "program.log")
    srv = proc.start([sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.serve",
                      "--model", settings["model_path"], "--device", "cuda",
                      "--port", "0", "--host", "127.0.0.1"], spath, log)
    try:
        port = rc._wait_port(srv, log, 1100.0)
        pcm = tr.pcm_pool(cell.traffic, args.seed)
        for rate in [float(x) for x in args.rates.split(",")]:
            t = dict(cell.traffic, rate_per_s=rate)
            reqs = tr.request_schedule(t, args.seed, args.seconds)
            warm = max(reqs, key=lambda r: r.samples)
            rc.post(port, tr.request_pcm(pcm, warm).tobytes(), 1100.0)
            client = rc.Client(port, pcm, int(t.get("client_threads", 64)))
            t0 = time.monotonic() + 0.05
            out = client.run(reqs, t0, args.seconds + 60.0)
            done = [out[r.index] for r in reqs
                    if out.get(r.index, {}).get("resp") is not None]
            lat = [o["latency_s"] * 1e3 for o in
                   sorted(done, key=lambda o: o["due"])]
            q = max(len(lat) // 4, 1)
            first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
            ok = len(done) == len(reqs) and last < 2.0 * first
            end = max(o["due"] + o["latency_s"] for o in done) - t0
            print(json.dumps({
                "rate_per_s": rate, "requests": len(reqs),
                "answered": len(done), "sustained": ok,
                "p50_ms": statistics.median(lat),
                "p95_ms": sorted(lat)[int(0.95 * (len(lat) - 1))],
                "first_quarter_p50_ms": first, "last_quarter_p50_ms": last,
                "drain_s": end - args.seconds}), flush=True)
    finally:
        os.kill(srv.pid, signal.SIGTERM)
        proc.end(srv)
        shutil.rmtree(run_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
