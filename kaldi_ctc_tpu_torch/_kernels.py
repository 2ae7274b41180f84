"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is a kernel with a plain C interface.  At its
first use in a process it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` (beside the package; the
directory is git-ignored) and loaded with ``ctypes``.  The library's
file name carries a hash of the source, of the headers (``*.cuh``) in
``csrc/`` and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  Only sources in this
repository are built.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.  Nothing here falls back to a
plain version: a missing compiler, a failed build or a failed launch
raises.

Spans ``kernels.load.<name>`` (a process's first use: the source hash,
the build if any, ``dlopen``) and ``kernels.build.<name>`` (``nvcc``
alone), counters ``kernels.built`` and ``kernels.reused`` (a library of
the same hash was there).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from kaldi_ctc_tpu_torch.utils.profiling import profiler

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "check",
           "stream_ptr"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from kaldi_ctc_tpu_torch/csrc at first use")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    and header hash exists → path of the shared library."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        profiler.count("kernels.reused")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    with profiler.span("kernels.build." + name):
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    profiler.count("kernels.built")
    return out


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare each entry
    point's argument types (``c_void_p`` for pointers and the stream, so
    ctypes does not cut them to 32 bits) and its ``int`` return."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with profiler.span("kernels.load." + name):
                lib = ctypes.CDLL(build(name))
                for fn, argtypes in signatures.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                lib.kctpu_error_string.argtypes = [ctypes.c_int]
                lib.kctpu_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kctpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    """The current PyTorch stream on ``device`` as a raw handle."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
