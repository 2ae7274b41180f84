"""Local multi-process launcher — the run.pl analogue.

Counterpart of ``kaldi_ctc_tpu/cli/launch.py``.  Spawns N copies of a
command with the environment ``parallel.distributed.init_distributed``
reads (COORDINATOR_ADDRESS / PROCESS_ID / NUM_PROCESSES), so the
multi-process training path (per-process data shards, the gradient
summed across processes over NCCL on the cards or gloo on the CPU) runs
on one machine:

  python -m kaldi_ctc_tpu_torch.cli.launch --num-processes 2 -- \\
      python -m kaldi_ctc_tpu_torch.cli.train_ctc --feats ... --dir exp

Each process takes ``cuda:(rank % device_count)``; more processes than
cards raise in every process (NCCL puts no two ranks on one card), and
``--device cpu`` on the command trains on gloo.  When one process exits
with an error the launcher terminates the rest and exits with its code
(the stand-in for the reference's run.pl/queue.pl job spawning,
utils/run.pl:7-29, steps/ctc/train.sh:408-419).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--port", type=int, default=0,
                   help="coordinator port (0 = pick a free one, so "
                        "concurrent launches on one machine don't "
                        "cross-connect)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to run (prefix with --)")
    return p.parse_args(argv)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    import time

    args = parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("no command given", file=sys.stderr)
        sys.exit(2)
    port = args.port or _free_port()
    procs = []
    for pid in range(args.num_processes):
        env = dict(os.environ)
        env["COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["PROCESS_ID"] = str(pid)
        env["NUM_PROCESSES"] = str(args.num_processes)
        procs.append(subprocess.Popen(cmd, env=env))
    # poll instead of sequential wait: a process that dies before the
    # process-group rendezvous would leave the others blocked in the
    # barrier forever — kill the survivors and fail fast instead
    rc = 0
    live = list(procs)
    try:
        while live:
            for p in list(live):
                r = p.poll()
                if r is None:
                    continue
                live.remove(p)
                if r != 0:
                    rc = rc or r
                    print(f"launch: a process exited with {r}; "
                          f"terminating the remaining "
                          f"{len(live)}", file=sys.stderr)
                    for q in live:
                        q.terminate()
                    for q in live:
                        try:
                            q.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            q.kill()
                            q.wait()
                    live = []
                    break
            time.sleep(0.1)
    finally:
        for q in live:
            q.terminate()
    sys.exit(rc)


if __name__ == "__main__":
    main()
