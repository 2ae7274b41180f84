"""Kaldi BINARY lattice archive I/O (+ auto-detecting readers).

Counterpart of ``kaldi_ctc_tpu/decoding/lattice_binary.py``: the same host code over the
port's modules.

The on-disk format of ``lattice-copy`` without ``--write-ark=t``
(``lat/kaldi-lattice.cc:394-496``): each archive record is
``key<space>`` followed directly by an OpenFst ``VectorFst`` binary —
arc type ``lattice4`` (LatticeWeight: graph,acoustic float pair) for raw
lattices, ``compactlattice44`` (weight pair + int32 alignment string)
for CompactLattices.  Unlike matrices there is no Kaldi ``\\0B`` marker;
text records are recognized by the newline after the key
(``LatticeHolder::Read``, kaldi-lattice.cc:497-515).

``read_lattice_ark`` / ``read_compact_lattice_ark`` sniff each record
and handle text and binary archives interchangeably, so Kaldi-produced
binary lattices feed lattice_tool directly.
"""

from __future__ import annotations

import math
import struct
from typing import Iterator, List, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.decoding.det_lattice import (
    CompactLattice, read_compact_lattice_text_ark)
from kaldi_ctc_tpu_torch.decoding.lattice import Lattice, read_lattice_text_ark

__all__ = ["read_lattice_ark", "read_compact_lattice_ark",
           "write_lattice_binary", "write_compact_lattice_binary",
           "BinaryLatticeWriter", "BinaryCompactLatticeWriter"]

_FST_MAGIC = 2125659606
_INF = float("inf")
# OpenFst encodes Zero (non-final) as +inf in both weight components
_F32_INF = struct.unpack("<f", struct.pack("<f", float("inf")))[0]


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated lattice record")
    return b


def _read_string(f) -> str:
    (n,) = struct.unpack("<i", _read_exact(f, 4))
    return _read_exact(f, n).decode()


def _write_string(f, s: str) -> None:
    f.write(struct.pack("<i", len(s)))
    f.write(s.encode())


def _read_header(f) -> Tuple[str, int, int]:
    (magic,) = struct.unpack("<i", _read_exact(f, 4))
    if magic != _FST_MAGIC:
        raise ValueError(f"bad FST magic {magic}")
    fsttype = _read_string(f)
    arctype = _read_string(f)
    if fsttype != "vector":
        raise ValueError(f"unsupported fst type {fsttype!r}")
    struct.unpack("<i", _read_exact(f, 4))    # version
    struct.unpack("<i", _read_exact(f, 4))    # flags
    struct.unpack("<Q", _read_exact(f, 8))    # properties
    (start,) = struct.unpack("<q", _read_exact(f, 8))
    (nstates,) = struct.unpack("<q", _read_exact(f, 8))
    struct.unpack("<q", _read_exact(f, 8))    # numarcs
    return arctype, start, nstates


def _write_header(f, arctype: str, start: int, nstates: int,
                  narcs: int) -> None:
    f.write(struct.pack("<i", _FST_MAGIC))
    _write_string(f, "vector")
    _write_string(f, arctype)
    f.write(struct.pack("<i", 2))      # version
    f.write(struct.pack("<i", 0))      # flags
    f.write(struct.pack("<Q", 0))      # properties
    f.write(struct.pack("<q", start))
    f.write(struct.pack("<q", nstates))
    f.write(struct.pack("<q", narcs))


def _read_binary_lattice(f) -> Lattice:
    arctype, start, nstates = _read_header(f)
    if arctype not in ("lattice4",):
        raise ValueError(f"expected lattice4 arcs, got {arctype!r} "
                         "(use read_compact_lattice_ark for "
                         "CompactLattice archives)")
    fr: List[int] = []
    to: List[int] = []
    il: List[int] = []
    ol: List[int] = []
    gc: List[float] = []
    ac: List[float] = []
    fc = np.full(max(nstates, 1), np.inf, np.float32)
    for s in range(nstates):
        g, a = struct.unpack("<ff", _read_exact(f, 8))
        if math.isfinite(g) or math.isfinite(a):
            fc[s] = g + a   # our final_cost is the summed pair
        (narcs,) = struct.unpack("<q", _read_exact(f, 8))
        raw = _read_exact(f, 20 * narcs)
        for i in range(narcs):
            a_il, a_ol, w1, w2, ns = struct.unpack_from("<iiffi", raw,
                                                        20 * i)
            fr.append(s)
            to.append(ns)
            il.append(a_il)
            ol.append(a_ol)
            gc.append(w1)
            ac.append(w2)
    return Lattice(
        start=int(start), num_states=max(int(nstates), 1),
        arc_from=np.asarray(fr, np.int32), arc_to=np.asarray(to, np.int32),
        arc_ilabel=np.asarray(il, np.int32),
        arc_olabel=np.asarray(ol, np.int32),
        arc_graph_cost=np.asarray(gc, np.float32),
        arc_acoustic_cost=np.asarray(ac, np.float32), final_cost=fc)


def _read_binary_compact(f) -> CompactLattice:
    arctype, start, nstates = _read_header(f)
    if arctype not in ("compactlattice44",):
        raise ValueError(f"expected compactlattice44 arcs, got "
                         f"{arctype!r}")
    lat = CompactLattice(
        start=int(start), num_states=max(int(nstates), 1),
        arc_from=[], arc_to=[], arc_word=[], arc_graph_cost=[],
        arc_acoustic_cost=[], arc_ilabels=[],
        final_graph_cost=[_INF] * max(int(nstates), 1),
        final_acoustic_cost=[_INF] * max(int(nstates), 1),
        final_ilabels=[()] * max(int(nstates), 1))

    def read_weight():
        g, a = struct.unpack("<ff", _read_exact(f, 8))
        (sz,) = struct.unpack("<i", _read_exact(f, 4))
        string = struct.unpack(f"<{sz}i", _read_exact(f, 4 * sz)) \
            if sz else ()
        return g, a, tuple(string)

    for s in range(nstates):
        g, a, string = read_weight()
        if math.isfinite(g) or math.isfinite(a):
            lat.final_graph_cost[s] = g
            lat.final_acoustic_cost[s] = a
            lat.final_ilabels[s] = string
        (narcs,) = struct.unpack("<q", _read_exact(f, 8))
        for _ in range(narcs):
            a_il, a_ol = struct.unpack("<ii", _read_exact(f, 8))
            g, ac_, string = read_weight()
            (ns,) = struct.unpack("<i", _read_exact(f, 4))
            lat.arc_from.append(s)
            lat.arc_to.append(ns)
            lat.arc_word.append(a_il)   # acceptor: ilabel == olabel
            lat.arc_graph_cost.append(g)
            lat.arc_acoustic_cost.append(ac_)
            lat.arc_ilabels.append(string)
    return lat


def write_lattice_binary(f, key: str, lat: Lattice) -> None:
    """One binary archive record (lattice-copy's default output)."""
    f.write(key.encode() + b" ")
    by_state: List[List[int]] = [[] for _ in range(lat.num_states)]
    for i in range(lat.num_arcs):
        by_state[int(lat.arc_from[i])].append(i)
    _write_header(f, "lattice4", lat.start, lat.num_states, lat.num_arcs)
    for s in range(lat.num_states):
        fc = float(lat.final_cost[s])
        if math.isinf(fc):
            f.write(struct.pack("<ff", _F32_INF, _F32_INF))
        else:
            f.write(struct.pack("<ff", fc, 0.0))
        f.write(struct.pack("<q", len(by_state[s])))
        for i in by_state[s]:
            f.write(struct.pack(
                "<iiffi", int(lat.arc_ilabel[i]), int(lat.arc_olabel[i]),
                float(lat.arc_graph_cost[i]),
                float(lat.arc_acoustic_cost[i]), int(lat.arc_to[i])))


def write_compact_lattice_binary(f, key: str, lat: CompactLattice) -> None:
    f.write(key.encode() + b" ")
    by_state: List[List[int]] = [[] for _ in range(lat.num_states)]
    for i in range(lat.num_arcs):
        by_state[int(lat.arc_from[i])].append(i)

    def write_weight(g, a, string):
        f.write(struct.pack("<ff", g, a))
        f.write(struct.pack("<i", len(string)))
        if string:
            f.write(struct.pack(f"<{len(string)}i", *string))

    _write_header(f, "compactlattice44", lat.start, lat.num_states,
                  lat.num_arcs)
    for s in range(lat.num_states):
        g = float(lat.final_graph_cost[s])
        if math.isinf(g):
            write_weight(_F32_INF, _F32_INF, ())
        else:
            write_weight(g, float(lat.final_acoustic_cost[s]),
                         tuple(lat.final_ilabels[s]))
        f.write(struct.pack("<q", len(by_state[s])))
        for i in by_state[s]:
            w = int(lat.arc_word[i])
            f.write(struct.pack("<ii", w, w))
            write_weight(float(lat.arc_graph_cost[i]),
                         float(lat.arc_acoustic_cost[i]),
                         tuple(lat.arc_ilabels[i]))
            f.write(struct.pack("<i", int(lat.arc_to[i])))


class BinaryLatticeWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, key: str, lat: Lattice) -> None:
        write_lattice_binary(self._f, key, lat)

    __setitem__ = write

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class BinaryCompactLatticeWriter(BinaryLatticeWriter):
    def write(self, key: str, lat: CompactLattice) -> None:
        write_compact_lattice_binary(self._f, key, lat)

    __setitem__ = write


def _sniff_binary(path: str) -> bool:
    """True when the first record's payload is a binary FST."""
    with open(path, "rb") as f:
        head = f.read(4096)
    sp = head.find(b" ")
    if sp < 0:
        return False
    return head[sp + 1:sp + 5] == struct.pack("<i", _FST_MAGIC)


def _iter_binary(path: str, reader) -> Iterator[Tuple[str, object]]:
    with open(path, "rb") as f:
        while True:
            key = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            yield key.decode().strip(), reader(f)


def read_lattice_ark(path: str) -> Iterator[Tuple[str, Lattice]]:
    """Auto-detecting lattice archive reader (text or Kaldi binary)."""
    if _sniff_binary(path):
        return _iter_binary(path, _read_binary_lattice)
    return read_lattice_text_ark(path)


def read_compact_lattice_ark(path: str
                             ) -> Iterator[Tuple[str, CompactLattice]]:
    """Auto-detecting CompactLattice archive reader."""
    if _sniff_binary(path):
        return _iter_binary(path, _read_binary_compact)
    return read_compact_lattice_text_ark(path)
