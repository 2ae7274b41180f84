"""Serving cells: ``serve`` in its own process, driven over HTTP by an
open-loop client with POST /recognize.

Set-up: the hook writes the seed's model file before ``serve`` loads it;
the harness waits for ``/healthz``, then warms the server with the
window's longest utterance and a few of median length.  The window:
``round(rate * seconds)`` requests due at the schedule's offsets, sent
whether or not earlier ones have finished, each timed from its due time
to the end of its response.  After the window the harness waits for
every request (a minute at most), closes the hook's window, ends the
server and judges every response against the reference.
"""

from __future__ import annotations

import concurrent.futures as cf
import http.client
import json
import math
import os
import re
import shutil
import signal
import statistics
import sys
import tempfile
import threading
import time

import numpy as np

from asrbench import cells, families, proc, traffic as tr

__all__ = ["run", "post", "Client"]

_PORT = re.compile(rb"serving on [^:\s]+:(\d+)")
BLOCK = 64


def post(port: int, body: bytes, timeout_s: float = 120.0) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
    try:
        conn.request("POST", "/recognize", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        return json.loads(data)
    finally:
        conn.close()


def _wait_port(p, log: str, timeout_s: float) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(log, "rb") as f:
            m = _PORT.search(f.read())
        if m:
            return int(m.group(1))
        if p.poll() is not None:
            break
        time.sleep(0.05)
    sys.stderr.write(proc.tail(log))
    raise RuntimeError("serve did not come up")


class Client:
    """Open loop: a dispatcher sends each request at its due time to a
    pool of sender threads; latency runs from the due time to the end of
    the response."""

    def __init__(self, port: int, pcm: np.ndarray, threads: int):
        self.port = port
        self.pcm = pcm
        self.pool = cf.ThreadPoolExecutor(max_workers=threads)
        self.out: dict = {}
        self.lock = threading.Lock()

    def _send(self, r: tr.Request, due: float) -> None:
        body = tr.request_pcm(self.pcm, r).tobytes()
        t_send, ns_send = time.monotonic(), time.time_ns()
        try:
            resp, err = post(self.port, body), None
        except (OSError, RuntimeError, http.client.HTTPException,
                ValueError) as e:
            resp, err = None, repr(e)
        t_done, ns_done = time.monotonic(), time.time_ns()
        with self.lock:
            self.out[r.index] = {"due": due, "late_s": t_send - due,
                                 "latency_s": t_done - due, "resp": resp,
                                 "error": err, "ns": (ns_send, ns_done)}

    def run(self, requests, t0: float, wait_s: float) -> dict:
        futures = []
        for r in requests:
            due = t0 + r.offset_s
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            futures.append(self.pool.submit(self._send, r, due))
        done, pending = cf.wait(futures, timeout=wait_s)
        for f in done:
            f.result()
        self.pool.shutdown(wait=not pending, cancel_futures=True)
        return dict(self.out)


def _reference_check(cell, seed: int, pcm: np.ndarray, sample, out: dict,
                     device: str, tf32: bool = False) -> dict:
    """The widest label gap over every request of the window, and how
    many served frame counts differ from the reference's."""
    from asrbench import reference as ref
    from asrbench import weights

    cfg = cell.config
    tree = weights.unflatten(cfg, weights.make_params(cfg, seed, device))
    front = families.of(cfg).features
    feats = [front(cfg, tr.request_pcm(pcm, r)) for r in sample]
    gap, frames_differ, missing = 0.0, 0, 0
    # in blocks of utterances of like lengths: the reference's loop over
    # frames is batched, its memory small
    order = sorted(range(len(sample)), key=lambda i: sample[i].samples)
    sample = [sample[i] for i in order]
    feats = [feats[i] for i in order]
    for i in range(0, len(sample), BLOCK):
        sc = ref.scores(tree, feats[i:i + BLOCK], cfg, device, tf32=tf32)
        for r, s in zip(sample[i:i + BLOCK], sc):
            resp = out.get(r.index, {}).get("resp")
            if resp is None:
                missing += 1
                continue
            if int(resp["num_frames"]) != s.shape[0]:
                frames_differ += 1
                continue
            gap = max(gap, ref.label_gap(s, resp["labels"]))
    return {"label_gap": gap, "frames_differ": float(frames_differ),
            "missing": float(missing)}


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", fault=None,
        check_cards=None) -> dict:
    """One run → the end-to-end metrics, the readings of ``correct`` and
    the per-layer readers' context.  ``check_cards``, called once the
    server has started, raises ``proc.NoCards`` to end the run."""
    t = cell.traffic
    requests = tr.request_schedule(t, seed, seconds)
    pcm = tr.pcm_pool(t, seed)
    run_dir = tempfile.mkdtemp(prefix="asrbench-serve-")
    try:
        settings = {"role": "recognize",
                    "entry": "kaldi_ctc_tpu_torch.cli.serve", "config": cell.config,
                    "seed": int(seed), "run_dir": run_dir,
                    "model_path": os.path.join(run_dir, "model.npz"),
                    "trace": bool(trace), "trace_host": False,
                    "device": device, "fault": fault,
                    "kernel_layers": cells.kernel_layers(cell.bench_dir)}
        spath = os.path.join(run_dir, "settings.json")
        with open(spath, "w") as fh:
            json.dump(settings, fh)
        log = os.path.join(run_dir, "program.log")
        cmd = [sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.serve",
               "--model", settings["model_path"], "--device", device,
               "--port", "0", "--host", "127.0.0.1"]
        t_spawn = time.monotonic()
        p = proc.start(cmd, spath, log)
        try:
            if check_cards is not None:
                check_cards()
            port = _wait_port(p, log, 1100.0)
            by_len = sorted(requests, key=lambda r: r.samples)
            warm = [by_len[-1]] + [by_len[len(by_len) // 2]] * (
                int(t.get("warmup_requests", 4)) - 1)
            for r in warm:
                post(port, tr.request_pcm(pcm, r).tobytes(), 1100.0)
            os.kill(p.pid, signal.SIGUSR1)
            if proc.wait_for(os.path.join(run_dir, "opened"), p, 60.0) is None:
                raise RuntimeError("serve's hook did not open the window")
            t0 = time.monotonic() + 0.05
            client = Client(port, pcm, int(t.get("client_threads", 64)))
            out = client.run(requests, t0, seconds + 60.0)
            os.kill(p.pid, signal.SIGUSR2)
            res = proc.wait_for(os.path.join(run_dir, "results.json"), p,
                                600.0)
            if res is None:
                raise RuntimeError("serve's hook wrote no results")
        except proc.NoCards:
            raise
        except BaseException:
            sys.stderr.write(proc.tail(log))
            raise
        finally:
            proc.end(p)
        failed = [r.index for r in requests
                  if out.get(r.index, {}).get("resp") is None]
        # a failed request counts as waited for to the end of the wait
        lat = sorted(out[r.index]["latency_s"] if r.index not in failed
                     else seconds + 60.0 for r in requests)
        late = [out[r.index]["late_s"] for r in requests if r.index in out]
        sys.stderr.write(
            f"generator lateness: median {statistics.median(late) * 1e3:.3f} "
            f"ms, max {max(late) * 1e3:.3f} ms over {len(late)} requests\n")
        ok = [out[r.index] for r in requests if r.index not in failed]
        if res.get("trace"):
            _name_gaps(res["trace"], [o["ns"] for o in out.values()])
        sys.stderr.write(
            f"setup: harness {t_spawn - t_start:.2f} s, server start to "
            f"hook {res['t_install'] - t_spawn:.2f} s, weights "
            f"{res['t_weights'] - res['t_install']:.2f} s, to the window "
            f"{t0 - res['t_weights']:.2f} s (server up, {len(warm)} "
            f"warm-up requests)\n")
        ctx = {"kind": "recognize", "config": cell.config, "chips": cell.chips,
               "seconds": float(seconds), "trace": res.get("trace"),
               "device_name": res.get("device_name", ""),
               "frames_trace": [int(o["resp"]["num_frames"]) for o in ok],
               "engine_s": [float(o["resp"]["rtf"]) * int(
                   o["resp"]["num_frames"]) * 0.01 for o in ok]}
        if res.get("trace"):
            sys.stderr.write(
                f"trace: {res['trace']['device_events']} device events, "
                f"reduced in {res['trace']['reduce_s']:.2f} s\n")
        t_ref = time.monotonic()
        readings = _reference_check(cell, seed, pcm, requests, out, device)
        sys.stderr.write(f"reference: {time.monotonic() - t_ref:.2f} s\n")
        readings["failed"] = float(len(failed))
        return {
            "attempted": len(requests), "failed": len(failed),
            "end_to_end": {
                "request_p95_ms": 1000.0 * _quantile(lat, 0.95),
                "request_p50_ms": 1000.0 * _quantile(lat, 0.50),
                "setup_s": t0 - t_start},
            "readings": readings, "ctx": ctx, "results": res,
        }
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _name_gaps(trace: dict, in_flight) -> None:
    """Name each idle gap of a server's trace by the client's side: a
    gap with no request in flight waits for arrivals; one with a request
    in flight is the engine's host work (or its queue)."""
    for gap in trace["idle_gaps"]:
        a, b = gap[2], gap[3]
        busy = any(s < b and e > a for s, e in in_flight)
        gap[0] = ("a request in flight: host work" if busy
                  else "no request in flight")


def _quantile(sorted_values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted_values
    x = q * (len(v) - 1)
    lo, hi = int(math.floor(x)), int(math.ceil(x))
    return v[lo] + (v[hi] - v[lo]) * (x - lo)
