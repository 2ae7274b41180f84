"""Python interface to the native WFST decoder (ctypes): the port's own
loader of ``native/``.

Counterpart of ``kaldi_ctc_tpu/decoding/wfst.py``: ``NativeFst``,
``decode_best_path`` and ``decode_best_path_batch`` are that module's,
unchanged, over the same C API of ``native/{fst,decoder,api}.cc``
(OpenFst-compatible graph loading, the CTC graph transform, token-passing
best-path beam decoding over the acoustic scores).  Only the build
differs.  The JAX package runs ``make -C native``, whose Makefile writes
``kaldi_ctc_tpu/decoding/libctc_native.so``; the port never builds inside
that package.  It calls ``g++`` itself with the Makefile's flags and
sources and writes ``build/native/libctc_native-<key>.so`` beside the
package (git-ignored), where the key hashes every source and header of
``native/``, the flags and the host CPU (the flags say
``-march=native``).  A build compiles the sources in parallel and links
under a temporary name, then renames; it takes a file lock, so
concurrent processes build once.  A failed build
raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import glob
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["NativeFst", "decode_best_path", "decode_best_path_batch",
           "ensure_built"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
# native/Makefile's CXXFLAGS and SRCS
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra", "-Wno-unused-parameter")
SRCS = ("fst.cc", "determinize.cc", "decoder.cc", "lattice.cc",
        "det_lattice.cc", "api.cc")
_lib = None
_lib_lock = threading.Lock()


def _host_arch_stamp() -> str:
    """Identifies the CPU the library is built for (``-march=native``: a
    library built on another host could SIGILL)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine() + ":" + hashlib.sha256(
        flags.encode()).hexdigest()[:16]


def library_path() -> str:
    """Where the library of the current sources, flags and host lives."""
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(NATIVE_DIR, "*.h")))
    for path in [os.path.join(NATIVE_DIR, s) for s in SRCS] + headers:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(CXXFLAGS).encode())
    digest.update(_host_arch_stamp().encode())
    return os.path.join(BUILD_DIR,
                        f"libctc_native-{digest.hexdigest()[:16]}.so")


def _run(cmd, what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {what}:\n{proc.stderr}")


def _compile(out: str) -> None:
    """One g++ per source, all at once, then the link; the library is
    written under a temporary name and renamed."""
    stem = f"{out}.{os.getpid()}"
    objs = [f"{stem}.{s}.o" for s in SRCS]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(SRCS)) as pool:
            for job in [pool.submit(
                    _run, ["g++", *CXXFLAGS, "-c", "-o", obj,
                           os.path.join(NATIVE_DIR, s)],
                    os.path.join(NATIVE_DIR, s))
                    for s, obj in zip(SRCS, objs)]:
                job.result()
        _run(["g++", *CXXFLAGS, "-shared", "-o", f"{stem}.tmp", *objs],
             "the link")
        os.replace(f"{stem}.tmp", out)  # a loader sees all of it or nothing
    finally:
        for path in objs + [f"{stem}.tmp"]:
            if os.path.exists(path):
                os.unlink(path)


def ensure_built() -> str:
    """Build the shared library unless one of the same key exists →
    its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        # released when the file closes, and by the kernel if the
        # process dies, so a killed build leaves no stale lock
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            _compile(out)
    return out


def _load():
    """The loaded library, built at first use, with every entry point's
    argument and return types declared."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(ensure_built()))
    return _lib


def _declare(lib):
    lib.ctcn_fst_load.restype = ctypes.c_void_p
    lib.ctcn_fst_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.ctcn_fst_from_arrays.restype = ctypes.c_void_p
    lib.ctcn_fst_from_arrays.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_fst_free.argtypes = [ctypes.c_void_p]
    for name in ("ctcn_fst_num_states", "ctcn_fst_num_arcs",
                 "ctcn_fst_start"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_write.restype = ctypes.c_int
    lib.ctcn_fst_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctcn_make_ctc_graph.restype = ctypes.c_void_p
    lib.ctcn_make_ctc_graph.argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_compose.restype = ctypes.c_void_p
    lib.ctcn_fst_compose.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ctcn_add_self_loops.restype = ctypes.c_void_p
    lib.ctcn_add_self_loops.argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_determinize_star.restype = ctypes.c_void_p
    lib.ctcn_fst_determinize_star.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int]
    for name in ("ctcn_fst_minimize", "ctcn_fst_push_special",
                 "ctcn_fst_connect", "ctcn_fst_renumber_bfs"):
        getattr(lib, name).restype = ctypes.c_void_p
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_remove_disambig.restype = ctypes.c_void_p
    lib.ctcn_fst_remove_disambig.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int32]
    lib.ctcn_fst_get_arrays.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_det_lattice.restype = ctypes.c_void_p
    lib.ctcn_det_lattice.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_int64]
    lib.ctcn_clat_free.argtypes = [ctypes.c_void_p]
    for name in ("ctcn_clat_num_states", "ctcn_clat_num_arcs",
                 "ctcn_clat_start", "ctcn_clat_arc_ilabels_size",
                 "ctcn_clat_final_ilabels_size"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ctcn_clat_get_arcs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_clat_get_finals.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_decode_best_path.restype = ctypes.c_int
    lib.ctcn_decode_best_path.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_decode_best_path_batch.restype = ctypes.c_int
    lib.ctcn_decode_best_path_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_decode_lattice.restype = ctypes.c_void_p
    lib.ctcn_decode_lattice.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_float]
    lib.ctcn_lat_free.argtypes = [ctypes.c_void_p]
    for name in ("ctcn_lat_num_states", "ctcn_lat_num_arcs",
                 "ctcn_lat_start"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ctcn_lat_reached_final.restype = ctypes.c_int
    lib.ctcn_lat_reached_final.argtypes = [ctypes.c_void_p]
    lib.ctcn_lat_best_cost.restype = ctypes.c_float
    lib.ctcn_lat_best_cost.argtypes = [ctypes.c_void_p]
    lib.ctcn_lat_get_arcs.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_lat_get_finals.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_lat_get_frames.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
    return lib


class NativeFst:
    """Owns a native Fst handle."""

    def __init__(self, handle: int):
        self._lib = _load()
        self._h = handle
        if not self._h:
            raise ValueError("null FST handle")

    @staticmethod
    def load(path: str) -> "NativeFst":
        lib = _load()
        err = ctypes.create_string_buffer(512)
        h = lib.ctcn_fst_load(path.encode(), err, len(err))
        if not h:
            raise IOError(err.value.decode() or f"failed to load {path}")
        return NativeFst(h)

    @staticmethod
    def from_arrays(start: int, num_states: int, arcs: np.ndarray,
                    weights: np.ndarray, finals: np.ndarray) -> "NativeFst":
        """arcs [N,4] int32 (state, ilabel, olabel, nextstate)."""
        lib = _load()
        arcs = np.ascontiguousarray(arcs, np.int32)
        weights = np.ascontiguousarray(weights, np.float32)
        finals = np.ascontiguousarray(finals, np.float32)
        h = lib.ctcn_fst_from_arrays(
            start, num_states, arcs.shape[0],
            arcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            finals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return NativeFst(h)

    @property
    def num_states(self) -> int:
        return self._lib.ctcn_fst_num_states(self._h)

    @property
    def num_arcs(self) -> int:
        return self._lib.ctcn_fst_num_arcs(self._h)

    @property
    def start(self) -> int:
        return self._lib.ctcn_fst_start(self._h)

    def write(self, path: str) -> None:
        if self._lib.ctcn_fst_write(self._h, path.encode()) != 0:
            raise IOError(f"failed to write {path}")

    def make_ctc_graph(self) -> "NativeFst":
        """ShiftTransitionIdAndAddBlanks (ctc-graph.cc:30-76)."""
        return NativeFst(self._lib.ctcn_make_ctc_graph(self._h))

    def compose(self, other: "NativeFst") -> "NativeFst":
        """self ∘ other (tropical), connected (fsttablecompose +
        fstconnect analogue for graph building)."""
        return NativeFst(self._lib.ctcn_fst_compose(self._h, other._h))

    def add_self_loops(self) -> "NativeFst":
        """add-self-loops --ctc=true (hmm-utils.cc:504-509): per emitting
        arc, a self-loop state so sustained frames stay on the arc's
        label; run before make_ctc_graph when building from L ∘ G."""
        return NativeFst(self._lib.ctcn_add_self_loops(self._h))

    def determinize_star(self, max_states: int = 0,
                         allow_nonfunctional: bool = False) -> "NativeFst":
        """Subset determinization with input-epsilon removal
        (fstdeterminizestar, fstext/determinize-star.h semantics).
        Raises RuntimeError if the input is not determinizable or not
        functional (use lexicon disambiguation symbols; or pass
        allow_nonfunctional to resolve same-input-same-weight output
        conflicts toward the lexicographically smaller output).
        max_states 0 = default cap."""
        err = ctypes.create_string_buffer(1024)
        h = self._lib.ctcn_fst_determinize_star(self._h, err, len(err),
                                                max_states,
                                                int(allow_nonfunctional))
        if not h:
            raise RuntimeError(err.value.decode()
                               or "determinize-star failed")
        return NativeFst(h)

    def minimize(self) -> "NativeFst":
        """Encoded minimization (fstminimizeencoded): bisimulation
        partition refinement over (ilabel, olabel, weight) atoms."""
        return NativeFst(self._lib.ctcn_fst_minimize(self._h))

    def push_special(self) -> "NativeFst":
        """fstpushspecial: reweight so every state's outgoing probability
        mass is the same constant (path weights exactly preserved) —
        improves pruned-search behavior."""
        return NativeFst(self._lib.ctcn_fst_push_special(self._h))

    def remove_disambig(self, first_disambig: int) -> "NativeFst":
        """Map ilabels >= first_disambig to epsilon (fstrmsymbols on the
        lexicon disambiguation range, mkgraph.sh's post-determinize
        cleanup)."""
        return NativeFst(self._lib.ctcn_fst_remove_disambig(
            self._h, first_disambig))

    def renumber_bfs(self) -> "NativeFst":
        """BFS state renumbering from the start state (isomorphism).

        Decode-critical on multi-GB graphs: beam-search active sets are
        graph-local, so BFS-adjacent ids make the per-frame offset/arc
        walks near-sequential; in particular each CTC blank twin moves
        from id n0+s to the slot right after its original state."""
        return NativeFst(self._lib.ctcn_fst_renumber_bfs(self._h))

    def connect(self) -> "NativeFst":
        """fstconnect: drop non-accessible/non-coaccessible states."""
        return NativeFst(self._lib.ctcn_fst_connect(self._h))

    def to_arrays(self):
        """→ (start, arcs [N,4] int32 (state, ilabel, olabel, nextstate),
        weights [N] f32, finals [S] f32) — inverse of from_arrays."""
        n_arcs, n_states = self.num_arcs, self.num_states
        arcs = np.zeros((n_arcs, 4), np.int32)
        weights = np.zeros(n_arcs, np.float32)
        finals = np.zeros(max(n_states, 1), np.float32)
        self._lib.ctcn_fst_get_arrays(
            self._h, arcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            finals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return self.start, arcs, weights, finals[:n_states]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ctcn_fst_free(self._h)
            self._h = None


def decode_best_path(
    fst: NativeFst,
    scores: np.ndarray,                 # [T, A] higher-better log scores
    ilabel_map: Optional[np.ndarray] = None,  # ilabel -> column
    beam: float = 16.0,
    max_active: int = 7000,
    acoustic_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, float, bool]:
    """→ (words, alignment_ilabels, total_cost, reached_final).

    Default ilabel_map is the CTC-graph convention: ilabel i → score
    column i-1 (graph labels are shifted +1; blank ilabel 1 → column 0).
    """
    lib = _load()
    scores = np.ascontiguousarray(scores, np.float32)
    t, a = scores.shape
    if ilabel_map is None:
        ilabel_map = np.concatenate(
            [[-1], np.arange(a, dtype=np.int32)]).astype(np.int32)
    ilabel_map = np.ascontiguousarray(ilabel_map, np.int32)
    max_out = t + 8
    words = np.zeros(max_out, np.int32)
    align = np.zeros(max_out, np.int32)
    n_words = ctypes.c_int64()
    n_align = ctypes.c_int64()
    cost = ctypes.c_float()
    final = ctypes.c_int32()
    rc = lib.ctcn_decode_best_path(
        fst._h, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, a, ilabel_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ilabel_map.shape[0], beam, max_active, acoustic_scale,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out,
        ctypes.byref(n_words),
        align.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out,
        ctypes.byref(n_align), ctypes.byref(cost), ctypes.byref(final))
    if rc != 0:
        raise RuntimeError("decode failed (all tokens pruned?)")
    return (words[: n_words.value].copy(), align[: n_align.value].copy(),
            float(cost.value), bool(final.value))


def decode_best_path_batch(
    fst: NativeFst,
    scores_list,                        # sequence of [T_u, A] arrays
    ilabel_map: Optional[np.ndarray] = None,
    beam: float = 16.0,
    max_active: int = 7000,
    acoustic_scale: float = 1.0,
    num_threads: int = 0,
):
    """Decode many utterances across native worker threads (the
    in-process analogue of decode.sh's nj-way parallel jobs).

    -> list of (words, alignment, total_cost, ok) per utterance."""
    lib = _load()
    scores_list = [np.ascontiguousarray(s, np.float32) for s in scores_list]
    if not scores_list:
        return []
    a = scores_list[0].shape[1]
    offsets = np.zeros(len(scores_list) + 1, np.int64)
    for i, s in enumerate(scores_list):
        if s.shape[1] != a:
            raise ValueError("inconsistent score widths")
        offsets[i + 1] = offsets[i] + s.shape[0]
    packed = (np.concatenate(scores_list, axis=0)
              if len(scores_list) > 1 else scores_list[0])
    packed = np.ascontiguousarray(packed, np.float32)
    if ilabel_map is None:
        ilabel_map = np.concatenate(
            [[-1], np.arange(a, dtype=np.int32)]).astype(np.int32)
    ilabel_map = np.ascontiguousarray(ilabel_map, np.int32)
    n = len(scores_list)
    max_out = int(max(s.shape[0] for s in scores_list)) + 8
    words = np.zeros((n, max_out), np.int32)
    align = np.zeros((n, max_out), np.int32)
    n_words = np.zeros(n, np.int64)
    n_align = np.zeros(n, np.int64)
    costs = np.zeros(n, np.float32)
    ok = np.zeros(n, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.ctcn_decode_best_path_batch(
        fst._h, packed.ctypes.data_as(f32), offsets.ctypes.data_as(i64),
        n, a, ilabel_map.ctypes.data_as(i32), ilabel_map.shape[0],
        beam, max_active, acoustic_scale, num_threads,
        words.ctypes.data_as(i32), max_out, n_words.ctypes.data_as(i64),
        align.ctypes.data_as(i32), max_out, n_align.ctypes.data_as(i64),
        costs.ctypes.data_as(f32), ok.ctypes.data_as(i32))
    out = []
    for u in range(n):
        out.append((words[u, : n_words[u]].copy(),
                    align[u, : n_align[u]].copy(),
                    float(costs[u]), bool(ok[u])))
    return out
