"""Structured logging and metrics.

Replaces the reference's KALDI_LOG/KALDI_VLOG (``base/kaldi-error.h:60-136``)
and the machine-parseable accuracy line contract
(``ctc/ctc-nnet-train.cc:278-279``) consumed by
``steps/ctc/report/nnet2_log_parse_lib.py``.  Metrics go to a JSONL stream
(one object per step/event) plus human-readable stderr lines; the parseable
``Accuracy = <float>`` line is kept so reference plotting tools keep working.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO, Optional

__all__ = ["get_logger", "MetricsLogger", "Timer"]

_FMT = "%(levelname)s (%(name)s) %(message)s"


def get_logger(name: str = "kaldi_ctc_tpu_torch", verbose: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if verbose > 0 else logging.INFO)
    return logger


class MetricsLogger:
    """JSONL metrics writer with the reference-compatible accuracy line."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 append: bool = True):
        """append=False truncates: a fresh (non-resume) run must not
        interleave its records with a previous run's in the same dir."""
        self._f: Optional[IO] = stream
        if path is not None:
            self._f = open(path, "a" if append else "w")
        self._t0 = time.time()

    def log(self, event: str, **kv) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **kv}
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def log_accuracy(self, accuracy: float, **kv) -> None:
        """Emit the parseable accuracy line (ctc/ctc-nnet-train.cc:278-279)."""
        print(
            "LOG [this line is to be parsed by a script:] "
            f"Accuracy = {accuracy:.4f}",
            file=sys.stderr,
        )
        self.log("accuracy", accuracy=accuracy, **kv)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class Timer:
    """Wall-clock timer (base/timer.h equivalent)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0
