"""HTK feature-file I/O, a numpy copy of ``kaldi_ctc_tpu/features/htk.py``
(reference: src/feat/feature-functions.cc ReadHtk/
WriteHtk and the HtkHeader struct in feat/feature-functions.h).

HTK files are big-endian: a 12-byte header (int32 num_samples, int32
sample_period in 100ns units, int16 sample_size in bytes, int16 parm_kind)
followed by num_samples rows of sample_size/4 float32 values.  Used by the
golden feature-parity tests against the reference HCopy outputs.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import numpy as np

__all__ = ["HtkHeader", "read_htk", "write_htk"]


class HtkHeader(NamedTuple):
    num_samples: int
    sample_period: int  # in 100ns units (100000 = 10ms)
    sample_size: int    # bytes per sample (4 * num_cols)
    parm_kind: int      # e.g. 0o06406 MFCC_D_A_0, 0o7 FBANK


def read_htk(path: str) -> Tuple[np.ndarray, HtkHeader]:
    """Read an HTK feature file → (features [T, D] float32, header)."""
    with open(path, "rb") as f:
        hdr_bytes = f.read(12)
        if len(hdr_bytes) != 12:
            raise ValueError(f"{path}: truncated HTK header")
        n, period, size, kind = struct.unpack(">iihh", hdr_bytes)
        if size <= 0 or size % 4:
            raise ValueError(f"{path}: bad HTK sample size {size} "
                             "(only float features supported)")
        cols = size // 4
        data = np.frombuffer(f.read(n * size), dtype=">f4")
        if data.size != n * cols:
            raise ValueError(f"{path}: truncated HTK data "
                             f"({data.size} of {n * cols} values)")
    return (data.reshape(n, cols).astype(np.float32),
            HtkHeader(n, period, size, kind))


def write_htk(path: str, feats: np.ndarray,
              sample_period: int = 100000, parm_kind: int = 9) -> None:
    """Write features [T, D] as an HTK file (WriteHtk analogue)."""
    feats = np.asarray(feats, dtype=np.float32)
    if feats.ndim != 2:
        raise ValueError("expected a [T, D] feature matrix")
    with open(path, "wb") as f:
        f.write(struct.pack(">iihh", feats.shape[0], sample_period,
                            4 * feats.shape[1], parm_kind))
        f.write(feats.astype(">f4").tobytes())
