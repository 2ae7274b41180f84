"""Kaldi TransitionModel parser → tid↔pdf maps for CTC graph decoding.

A copy of ``kaldi_ctc_tpu/utils/transition_model.py`` (host-only numpy).

Parses the binary serialization written by TransitionModel::Write
(``hmm/transition-model.cc``) and HmmTopology::Write
(``hmm/hmm-topology.cc``), which is also the on-disk format of the
reference's CtcTransitionModel (``ctc/ctc-transition-model.h:85-91`` —
a plain wrapper).  This lets Kaldi-built ``.mdl`` files and TLG/CTC graphs
be used directly: graph label g maps to an acoustic score column via
``ctc_ilabel_map`` (graph-label 1 = blank → column 0; g>1 → pdf+1,
ctc-transition-model.h:56-62).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

import numpy as np

from kaldi_ctc_tpu_torch.utils.kaldi_io import (
    _BINARY_MARKER,
    _read_basic_int32,
    _read_token,
)

__all__ = ["TransitionModel", "read_transition_model", "ctc_ilabel_map"]


def _read_basic_float(f) -> float:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"Expected float32 size marker, got {size!r}")
    return struct.unpack("<f", f.read(4))[0]


def _read_int_vector_body(f) -> np.ndarray:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"Expected int32 element size, got {size!r}")
    n = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(4 * n), dtype=np.int32).copy()


@dataclasses.dataclass
class TransitionModel:
    phones: np.ndarray                    # [P]
    phone2idx: np.ndarray                 # phone -> topology entry index
    # per entry: list of (pdf_class, [(dest_state, prob), ...])
    entries: List[List[Tuple[int, List[Tuple[int, float]]]]]
    triples: np.ndarray                   # [N, 3] (phone, hmm_state, pdf)
    log_probs: np.ndarray                 # [num_tids + 1]

    @property
    def num_pdfs(self) -> int:
        return int(self.triples[:, 2].max()) + 1 if len(self.triples) else 0

    @property
    def num_transition_ids(self) -> int:
        return int(self._tid_bounds()[-1])

    def _tid_bounds(self) -> np.ndarray:
        """state2id analogue: cumulative tid counts per triple.
        tids of triple i are (bounds[i], bounds[i+1]]."""
        counts = []
        for phone, hmm_state, _pdf in self.triples:
            entry = self.entries[self.phone2idx[phone]]
            counts.append(len(entry[hmm_state][1]))
        return np.concatenate([[0], np.cumsum(counts)])

    def tid_to_pdf(self) -> np.ndarray:
        """Array m with m[tid] = pdf for tid in 1..num_transition_ids."""
        bounds = self._tid_bounds()
        n = int(bounds[-1])
        out = np.zeros(n + 1, dtype=np.int32)
        for i, (_phone, _state, pdf) in enumerate(self.triples):
            out[int(bounds[i]) + 1: int(bounds[i + 1]) + 1] = pdf
        return out

    def tid_to_phone(self) -> np.ndarray:
        bounds = self._tid_bounds()
        n = int(bounds[-1])
        out = np.zeros(n + 1, dtype=np.int32)
        for i, (phone, _state, _pdf) in enumerate(self.triples):
            out[int(bounds[i]) + 1: int(bounds[i + 1]) + 1] = phone
        return out

    def tid_is_self_loop(self) -> np.ndarray:
        """Bool array m with m[tid] true iff the tid's topology transition
        returns to its own HMM state (TransitionModel::IsSelfLoop)."""
        bounds = self._tid_bounds()
        n = int(bounds[-1])
        out = np.zeros(n + 1, dtype=bool)
        for i, (phone, hmm_state, _pdf) in enumerate(self.triples):
            trans = self.entries[self.phone2idx[phone]][hmm_state][1]
            for j, (dest, _prob) in enumerate(trans):
                out[int(bounds[i]) + 1 + j] = (dest == hmm_state)
        return out


def _read_topology(f) -> Tuple[np.ndarray, np.ndarray, List[List[Tuple[int, int]]]]:
    tok = _read_token(f)
    if tok != "<Topology>":
        raise ValueError(f"Expected <Topology>, got {tok}")
    phones = _read_int_vector_body(f)
    phone2idx = _read_int_vector_body(f)
    num_entries = _read_basic_int32(f)
    entries = []
    for _ in range(num_entries):
        entry_len = _read_basic_int32(f)
        states = []
        for _ in range(entry_len):
            pdf_class = _read_basic_int32(f)
            num_trans = _read_basic_int32(f)
            trans = []
            for _ in range(num_trans):
                dest = _read_basic_int32(f)
                prob = _read_basic_float(f)
                trans.append((dest, prob))
            states.append((pdf_class, trans))
        entries.append(states)
    tok = _read_token(f)
    if tok != "</Topology>":
        raise ValueError(f"Expected </Topology>, got {tok}")
    return phones, phone2idx, entries


def read_transition_model(f_or_path) -> TransitionModel:
    """Read a binary TransitionModel (e.g. from a Kaldi .mdl file).

    Accepts a path or a positioned stream; skips the \\0B marker if present.
    """
    close = False
    if isinstance(f_or_path, str):
        f = open(f_or_path, "rb")
        close = True
    else:
        f = f_or_path
    try:
        pos = f.tell()
        if f.read(2) != _BINARY_MARKER:
            f.seek(pos)
        tok = _read_token(f)
        if tok != "<TransitionModel>":
            raise ValueError(f"Expected <TransitionModel>, got {tok}")
        phones, phone2idx, entries = _read_topology(f)
        tok = _read_token(f)
        if tok != "<Triples>":
            raise ValueError(f"Expected <Triples>, got {tok}")
        n = _read_basic_int32(f)
        triples = np.zeros((n, 3), dtype=np.int32)
        for i in range(n):
            triples[i, 0] = _read_basic_int32(f)
            triples[i, 1] = _read_basic_int32(f)
            triples[i, 2] = _read_basic_int32(f)
        for expect in ("</Triples>", "<LogProbs>"):
            tok = _read_token(f)
            if tok != expect:
                raise ValueError(f"Expected {expect}, got {tok}")
        vec_tok = _read_token(f)
        if vec_tok not in ("FV", "DV"):
            raise ValueError(f"Expected FV/DV, got {vec_tok}")
        dim = _read_basic_int32(f)
        dtype = np.float32 if vec_tok == "FV" else np.float64
        log_probs = np.frombuffer(f.read(dim * dtype().itemsize),
                                  dtype=dtype).copy()
        for expect in ("</LogProbs>", "</TransitionModel>"):
            tok = _read_token(f)
            if tok != expect:
                raise ValueError(f"Expected {expect}, got {tok}")
        return TransitionModel(phones=phones, phone2idx=phone2idx,
                               entries=entries, triples=triples,
                               log_probs=log_probs.astype(np.float32))
    finally:
        if close:
            f.close()


def ctc_ilabel_map(trans: TransitionModel) -> np.ndarray:
    """Graph-label → acoustic score column for CTC graphs.

    Graph labels are transition-ids + 1 with 1 = blank
    (ctc-transition-model.h:56-75); score columns are pdf+1 with blank at 0.
    Entry 0 (epsilon) is -1.
    """
    tid2pdf = trans.tid_to_pdf()
    n_tids = trans.num_transition_ids
    out = np.full(n_tids + 2, -1, dtype=np.int32)
    out[1] = 0  # blank
    for g in range(2, n_tids + 2):
        out[g] = tid2pdf[g - 1] + 1
    return out
