"""Starting, watching and ending the program's processes.

Each program process gets its own session, so ending it ends everything
it started (``launch``'s ranks, a piped rspecifier's writer).  Build and
kernel caches stay at fixed paths inside the checkout: the program's
``build/kernels`` and ``build/native``, and ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` under ``build/``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from typing import List, Optional

__all__ = ["ROOT", "HOOKPATH", "NoCards", "program_env", "start",
           "wait_for", "end", "tail"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOOKPATH = os.path.join(ROOT, "asrbench", "hookpath")


class NoCards(RuntimeError):
    """The machine has no CUDA card, or fewer than the cell needs."""


def program_env(settings_path: str) -> dict:
    env = dict(os.environ)
    rest = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join(
        [HOOKPATH, ROOT] + ([rest] if rest else []))
    env["ASRBENCH_HOOK"] = settings_path
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                               "torch_extensions")
    env["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    env["USE_FLAX"] = "0"
    env["PYTHONUNBUFFERED"] = "1"
    return env


def start(cmd: List[str], settings_path: str, log_path: str
          ) -> subprocess.Popen:
    log = open(log_path, "wb")
    try:
        return subprocess.Popen(cmd, cwd=ROOT, env=program_env(settings_path),
                                stdin=subprocess.DEVNULL, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    finally:
        log.close()


def wait_for(path: str, proc: subprocess.Popen, timeout_s: float,
             poll_s: float = 0.05) -> Optional[dict]:
    """The JSON at ``path`` once it exists; None if ``proc`` ended first
    without writing it, or ``timeout_s`` passed."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        if proc.poll() is not None:
            if os.path.exists(path):
                continue
            return None
        time.sleep(poll_s)
    return None


def end(proc: subprocess.Popen, grace_s: float = 10.0) -> None:
    """End the process's whole session and wait until every member of
    it (a launcher's ranks too) is gone."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=grace_s)
            break
        except subprocess.TimeoutExpired:
            continue
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            return
        time.sleep(0.05)


def tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(max(os.path.getsize(path) - n, 0))
            return f.read().decode(errors="replace")
    except OSError:
        return ""

