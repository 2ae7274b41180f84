"""Pure-Python readers/writers for Kaldi table I/O (ark/scp).

A copy of ``kaldi_ctc_tpu/utils/kaldi_io.py`` (host-only numpy): archives
written by either package read back identically in the other.

This is the TPU framework's replacement for the reference's table-I/O layer
(``src/util/kaldi-table.h:44-124`` — SequentialTableReader / TableWriter over
``ark:``/``scp:`` rspecifier strings, including command pipes) and the matrix
serialization code (``src/matrix/kaldi-matrix.cc:1221-1360``,
``src/matrix/compressed-matrix.cc:28-470``).  We keep the on-disk formats
bit-compatible so Kaldi-prepared data (features, alignments, CMVN stats)
can be consumed directly as fixtures, but the implementation is new,
vectorized numpy, and streams into host-side pipelines feeding the model.

Supported object types:
  - float/double matrices ("FM"/"DM") and vectors ("FV"/"DV")
  - CompressedMatrix ("CM" format 1, "CM2" format 2)
  - int32 vectors (alignments / label sequences)
  - text tables (transcripts etc.)

Specifier strings: ``ark:file``, ``scp:file``, ``ark:-``,
``ark:cmd ... |`` (read pipe), ``ark,t:``, ``ark,scp:data.ark,data.scp``.
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import Iterator, Tuple

import numpy as np

__all__ = [
    "read_matrix",
    "write_matrix",
    "read_vector",
    "write_vector",
    "read_int_vector",
    "write_int_vector",
    "SequentialReader",
    "SequentialMatrixReader",
    "SequentialIntVectorReader",
    "SequentialTextReader",
    "RandomAccessMatrixReader",
    "RandomAccessIntVectorReader",
    "MatrixWriter",
    "IntVectorWriter",
    "compress_matrix",
]

_BINARY_MARKER = b"\0B"


# ---------------------------------------------------------------------------
# Low-level binary primitives (mirror base/io-funcs semantics)
# ---------------------------------------------------------------------------

def _read_token(f) -> str:
    """Read a space-terminated token.

    A newline terminator is pushed back when the stream supports it
    (archive iteration wraps streams in _PushbackStream): a key line
    with no value ('utt1\\n') must leave the newline for the record
    parser, or the probe for the next record's binary marker would
    swallow the start of the following line."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            if chars:
                break
            raise EOFError("EOF while reading token")
        if c in b" \t\n\r":
            if chars:
                if c in b"\n\r" and hasattr(f, "unread"):
                    f.unread(c)
                break
            continue  # skip leading whitespace (text records end with \n)
        chars.append(c)
    return b"".join(chars).decode("utf-8")


def _write_token(f, tok: str) -> None:
    f.write(tok.encode("utf-8") + b" ")


def _read_basic_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"Expected int32 size marker, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _write_basic_int32(f, value: int) -> None:
    f.write(b"\x04" + struct.pack("<i", value))


# ---------------------------------------------------------------------------
# Matrix / vector objects
# ---------------------------------------------------------------------------

def _read_binary_object(f) -> np.ndarray:
    """Read one Kaldi object after the \\0B marker (matrix/vector/compressed)."""
    tok = _read_token(f)
    if tok in ("FM", "DM"):
        dtype = np.float32 if tok == "FM" else np.float64
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype=dtype)
        return data.reshape(rows, cols).copy()
    if tok in ("FV", "DV"):
        dtype = np.float32 if tok == "FV" else np.float64
        dim = _read_basic_int32(f)
        return np.frombuffer(f.read(dim * dtype().itemsize), dtype=dtype).copy()
    if tok in ("CM", "CM2"):
        return _read_compressed_body(f, fmt=1 if tok == "CM" else 2)
    raise ValueError(f"Unknown Kaldi object token {tok!r}")


def _read_compressed_body(f, fmt: int) -> np.ndarray:
    # GlobalHeader minus the int32 format field: min_value, range, rows, cols
    # (compressed-matrix.cc Read: `is.read(...&h + 4, sizeof(h) - 4)`).
    min_value, rng = struct.unpack("<ff", f.read(8))
    num_rows, num_cols = struct.unpack("<ii", f.read(8))
    if num_cols == 0:
        return np.zeros((0, 0), dtype=np.float32)
    if fmt == 2:
        raw = np.frombuffer(f.read(2 * num_rows * num_cols), dtype=np.uint16)
        data = raw.reshape(num_rows, num_cols).astype(np.float32)
        return (min_value + rng * (1.0 / 65535.0) * data).astype(np.float32)
    # format 1: per-column headers of 4 uint16, then uint8 data column-major.
    headers = np.frombuffer(f.read(8 * num_cols), dtype=np.uint16)
    headers = headers.reshape(num_cols, 4).astype(np.float32)
    p = min_value + rng * (1.0 / 65535.0) * headers  # [num_cols, 4]
    bytes_ = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8)
    v = bytes_.reshape(num_cols, num_rows).astype(np.float32)  # column-major
    p0, p25, p75, p100 = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
    # Piecewise-linear dequantization (compressed-matrix.cc CharToFloat).
    low = p0 + (p25 - p0) * v * (1.0 / 64.0)
    mid = p25 + (p75 - p25) * (v - 64.0) * (1.0 / 128.0)
    high = p75 + (p100 - p75) * (v - 192.0) * (1.0 / 63.0)
    out = np.where(v <= 64, low, np.where(v <= 192, mid, high))
    return np.ascontiguousarray(out.T.astype(np.float32))


def _float_to_uint16(min_value: float, rng: float, x: np.ndarray) -> np.ndarray:
    f = np.clip((x - min_value) / max(rng, 1e-20), 0.0, 1.0)
    return (f * 65535.0 + 0.499).astype(np.uint16)


def compress_matrix(mat: np.ndarray) -> bytes:
    """Serialize a float matrix as a Kaldi CompressedMatrix (format 1 or 2).

    Mirrors compressed-matrix.cc CompressedMatrix::CopyFromMat/Write: matrices
    with < 8 rows use format 2 (plain uint16 quantization); otherwise format 1
    with per-column percentile headers and uint8 payload.
    """
    mat = np.asarray(mat, dtype=np.float32)
    num_rows, num_cols = mat.shape
    if num_rows == 0 or num_cols == 0:
        return b"CM " + struct.pack("<ffii", 0.0, 0.0, 0, 0)
    min_value = float(mat.min())
    max_value = float(mat.max())
    rng = max_value - min_value
    if rng <= 0:
        rng = 1.984e-3  # mirror of kaldi's guard against zero range
    out = io.BytesIO()
    if num_rows < 8:
        out.write(b"CM2 ")
        out.write(struct.pack("<ffii", min_value, rng, num_rows, num_cols))
        out.write(_float_to_uint16(min_value, rng, mat).tobytes())
        return out.getvalue()
    out.write(b"CM ")
    out.write(struct.pack("<ffii", min_value, rng, num_rows, num_cols))
    cols = mat.T  # [num_cols, num_rows]
    q = num_rows // 4
    s = np.sort(cols, axis=1)
    u = _float_to_uint16(min_value, rng, np.stack(
        [s[:, 0], s[:, q], s[:, 3 * q], s[:, -1]], axis=1)).astype(np.int64)
    p0 = np.minimum(u[:, 0], 65532)
    p25 = np.minimum(np.maximum(u[:, 1], p0 + 1), 65533)
    p75 = np.minimum(np.maximum(u[:, 2], p25 + 1), 65534)
    p100 = np.maximum(u[:, 3], p75 + 1)
    headers = np.stack([p0, p25, p75, p100], axis=1).astype(np.uint16)
    out.write(headers.tobytes())
    # quantize each column to uint8 through the piecewise map
    fp = min_value + rng * (1.0 / 65535.0) * headers.astype(np.float32)
    f0, f25, f75, f100 = (fp[:, i:i + 1] for i in range(4))
    x = cols
    low = (x - f0) / np.maximum(f25 - f0, 1e-20) * 64.0 + 0.5
    mid = 64.0 + (x - f25) / np.maximum(f75 - f25, 1e-20) * 128.0 + 0.5
    high = 192.0 + (x - f75) / np.maximum(f100 - f75, 1e-20) * 63.0 + 0.5
    v = np.where(x < f25, np.clip(low, 0, 64),
                 np.where(x < f75, np.clip(mid, 64, 192),
                          np.clip(high, 192, 255)))
    out.write(v.astype(np.uint8).tobytes())
    return out.getvalue()


def _write_binary_matrix(f, mat: np.ndarray, compress: bool = False) -> None:
    mat = np.asarray(mat)
    if compress:
        f.write(compress_matrix(mat))
        return
    if mat.dtype == np.float64:
        tok, dtype = "DM", np.float64
    else:
        tok, dtype = "FM", np.float32
    _write_token(f, tok)
    _write_basic_int32(f, mat.shape[0])
    _write_basic_int32(f, mat.shape[1])
    f.write(np.ascontiguousarray(mat, dtype=dtype).tobytes())


def _write_binary_vector(f, vec: np.ndarray) -> None:
    vec = np.asarray(vec)
    if vec.dtype == np.float64:
        tok, dtype = "DV", np.float64
    else:
        tok, dtype = "FV", np.float32
    _write_token(f, tok)
    _write_basic_int32(f, vec.shape[0])
    f.write(np.ascontiguousarray(vec, dtype=dtype).tobytes())


def _read_binary_int_vector(f) -> np.ndarray:
    # WriteIntegerVector: char sizeof(T), int32 size, raw data
    # (base/io-funcs-inl.h:198-230).
    size_marker = f.read(1)
    if size_marker != b"\x04":
        raise ValueError(f"Expected int32 element size, got {size_marker!r}")
    n = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(4 * n), dtype=np.int32).copy()


def _write_binary_int_vector(f, vec: np.ndarray) -> None:
    vec = np.ascontiguousarray(vec, dtype=np.int32)
    f.write(b"\x04" + struct.pack("<i", vec.shape[0]) + vec.tobytes())


def _read_text_matrix(f) -> np.ndarray:
    """Read a text-form matrix ``[\\n r c ...\\n ... ]``."""
    rows, cur = [], []
    tok = b""
    started = False
    while True:
        c = f.read(1)
        if not c:
            raise EOFError("EOF in text matrix")
        if c in b" \t\n[]":
            if tok:
                cur.append(float(tok))
                tok = b""
            if c == b"[":
                started = True
            elif c == b"\n" and started:
                if cur:
                    rows.append(cur)
                    cur = []
            elif c == b"]":
                if cur:
                    rows.append(cur)
                break
        else:
            tok += c
    return np.asarray(rows, dtype=np.float32)


# ---------------------------------------------------------------------------
# Public one-object helpers
# ---------------------------------------------------------------------------

def read_matrix(f_or_path) -> np.ndarray:
    """Read one Kaldi matrix (binary or text) from a file/stream."""
    f, close = _as_stream(f_or_path, "rb")
    try:
        head = f.read(2)
        if head == _BINARY_MARKER:
            return _read_binary_object(f)
        f2 = io.BytesIO(head + f.read())
        return _read_text_matrix(f2)
    finally:
        if close:
            f.close()


def write_matrix(f_or_path, mat: np.ndarray, compress: bool = False) -> None:
    f, close = _as_stream(f_or_path, "wb")
    try:
        f.write(_BINARY_MARKER)
        _write_binary_matrix(f, mat, compress=compress)
    finally:
        if close:
            f.close()


def read_vector(f_or_path) -> np.ndarray:
    f, close = _as_stream(f_or_path, "rb")
    try:
        head = f.read(2)
        if head != _BINARY_MARKER:
            raise ValueError("Only binary vectors supported")
        return _read_binary_object(f)
    finally:
        if close:
            f.close()


def write_vector(f_or_path, vec: np.ndarray) -> None:
    f, close = _as_stream(f_or_path, "wb")
    try:
        f.write(_BINARY_MARKER)
        _write_binary_vector(f, vec)
    finally:
        if close:
            f.close()


def read_int_vector(f_or_path) -> np.ndarray:
    f, close = _as_stream(f_or_path, "rb")
    try:
        head = f.read(2)
        if head != _BINARY_MARKER:
            raise ValueError("Only binary int vectors supported")
        return _read_binary_int_vector(f)
    finally:
        if close:
            f.close()


def write_int_vector(f_or_path, vec: np.ndarray) -> None:
    f, close = _as_stream(f_or_path, "wb")
    try:
        f.write(_BINARY_MARKER)
        _write_binary_int_vector(f, vec)
    finally:
        if close:
            f.close()


def _as_stream(f_or_path, mode: str):
    if isinstance(f_or_path, (str, os.PathLike)):
        return open(f_or_path, mode), True
    return f_or_path, False


# ---------------------------------------------------------------------------
# Specifier parsing (mirror of rspecifier/wspecifier strings)
# ---------------------------------------------------------------------------

class _Specifier:
    def __init__(self, spec: str):
        if ":" not in spec:
            raise ValueError(f"Bad specifier {spec!r} (no colon)")
        prefix, rest = spec.split(":", 1)
        opts = prefix.split(",")
        self.kinds = [o for o in opts if o in ("ark", "scp")]
        if not self.kinds:
            raise ValueError(f"Bad specifier {spec!r}: need ark: or scp:")
        self.kind = self.kinds[0]
        self.text = "t" in opts
        # 'ark,bg:' — decode records on a background thread so the
        # consumer overlaps compute with table reading
        # (util/kaldi-table.h:44-124 background-prefetch option)
        self.background = "bg" in opts
        self.target = rest
        # ark,scp:ark_path,scp_path writer form
        self.scp_target: Optional[str] = None
        if self.kinds == ["ark", "scp"]:
            parts = rest.split(",")
            if len(parts) == 2:
                self.target, self.scp_target = parts

    def open_read(self):
        t = self.target
        if t == "-":
            return os.fdopen(os.dup(0), "rb"), None
        if t.rstrip().endswith("|"):
            proc = subprocess.Popen(
                t.rstrip().rstrip("|"), shell=True, stdout=subprocess.PIPE)
            return proc.stdout, proc
        return open(t, "rb"), None


class _PushbackStream:
    """Byte stream with unread support (text records need the 2-byte
    binary-marker probe pushed back before parsing, and pipes are not
    seekable)."""

    def __init__(self, f):
        self._f = f
        self._buf = b""

    def unread(self, data: bytes) -> None:
        self._buf = data + self._buf

    def read(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            if len(out) < n:
                out += self._f.read(n - len(out))
            return out
        return self._f.read(n)

    def readline(self) -> bytes:
        if self._buf:
            i = self._buf.find(b"\n")
            if i >= 0:
                out, self._buf = self._buf[:i + 1], self._buf[i + 1:]
                return out
            out, self._buf = self._buf, b""
            return out + self._f.readline()
        return self._f.readline()


def _read_text_int_vector(f) -> np.ndarray:
    """Text int-vector record: the rest of the line."""
    line = f.readline().decode("utf-8")
    return np.asarray([int(x) for x in line.split()], dtype=np.int32)


def _iter_ark(f, reader, text_reader=None) -> Iterator[Tuple[str, object]]:
    f = _PushbackStream(f)
    if text_reader is None:
        text_reader = _read_text_matrix
    while True:
        try:
            key = _read_token(f)
        except EOFError:
            return
        marker = f.read(2)
        if marker == _BINARY_MARKER:
            yield key, reader(f)
        else:
            # text record ('ark,t:' archives): parse with the type's
            # text form (matrices span lines up to ']', int vectors end
            # at the newline)
            f.unread(marker)
            yield key, text_reader(f)


def _iter_scp(path) -> Iterator[Tuple[str, str]]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rx = line.split(None, 1)
            yield key, rx


def _read_at(rxfilename: str, reader, text_reader=None):
    """Read one object from an extended filename ``path[:offset]``."""
    if ":" in rxfilename:
        path, _, off = rxfilename.rpartition(":")
        try:
            offset = int(off)
        except ValueError:
            path, offset = rxfilename, 0
    else:
        path, offset = rxfilename, 0
    with open(path, "rb") as f:
        f.seek(offset)
        marker = f.read(2)
        if marker != _BINARY_MARKER:
            # text record: parse with the value type's text form
            f.seek(offset)
            data = f.read()
            return (text_reader or _read_text_matrix)(io.BytesIO(data))
        return reader(f)


def _iter_background(make_iter, buffer_records: int = 8):
    """Run an iterator on a daemon thread, yielding through a bounded
    queue ('ark,bg:' semantics: the table is read and decoded while the
    consumer computes). Exceptions re-raise in the consumer; abandoning
    the generator stops the producer at its next put."""
    import queue as _queue
    import threading as _threading

    q = _queue.Queue(maxsize=buffer_records)
    stop = _threading.Event()
    _END, _ERR = object(), object()

    def put_or_stop(item):
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def produce():
        try:
            for item in make_iter():
                if not put_or_stop(item):
                    return
            put_or_stop((_END, None))
        except BaseException as e:  # propagate to consumer
            put_or_stop((_ERR, e))

    t = _threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and \
                    item[0] in (_END, _ERR):
                if item[0] is _ERR:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()


class SequentialReader:
    """Iterate (key, object) over an rspecifier. Object reader pluggable."""

    def __init__(self, rspecifier: str, value_reader, text_reader=None):
        self.spec = _Specifier(rspecifier)
        self._value_reader = value_reader
        self._text_reader = text_reader
        self._proc = None

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        if self.spec.background:
            yield from _iter_background(self._iter_foreground)
        else:
            yield from self._iter_foreground()

    def _iter_foreground(self) -> Iterator[Tuple[str, object]]:
        if self.spec.kind == "scp":
            for key, rx in _iter_scp(self.spec.target):
                yield key, _read_at(rx, self._value_reader,
                                    self._text_reader)
        else:
            f, self._proc = self.spec.open_read()
            try:
                yield from _iter_ark(f, self._value_reader,
                                     self._text_reader)
            finally:
                f.close()
                if self._proc is not None:
                    self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def SequentialMatrixReader(rspecifier: str) -> SequentialReader:
    return SequentialReader(rspecifier, _read_binary_object,
                            _read_text_matrix)


def SequentialIntVectorReader(rspecifier: str) -> SequentialReader:
    return SequentialReader(rspecifier, _read_binary_int_vector,
                            _read_text_int_vector)


class SequentialTextReader:
    """Text table: ``key v1 v2 ...`` per line (transcripts, utt2spk, ...)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(None, 1)
                yield parts[0], (parts[1] if len(parts) > 1 else "")


class _RandomAccessReader:
    def __init__(self, scp_rspecifier: str, value_reader, text_reader=None):
        spec = _Specifier(scp_rspecifier)
        if spec.kind != "scp":
            raise ValueError("Random access requires an scp: specifier")
        self._index = dict(_iter_scp(spec.target))
        self._value_reader = value_reader
        self._text_reader = text_reader

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __getitem__(self, key: str):
        return _read_at(self._index[key], self._value_reader,
                        self._text_reader)

    def keys(self):
        return self._index.keys()


def RandomAccessMatrixReader(rspecifier: str) -> _RandomAccessReader:
    return _RandomAccessReader(rspecifier, _read_binary_object,
                               _read_text_matrix)


def open_random_access_matrices(rspecifier: str):
    """Random-access matrices from either specifier form: ``scp:`` is
    lazy (seek per key); ``ark:`` archives are loaded eagerly into a
    dict (the common small-table case: CMVN stats, fMLLR transforms)."""
    if rspecifier.startswith("scp"):
        return RandomAccessMatrixReader(rspecifier)
    return dict(SequentialMatrixReader(rspecifier))


def read_symbol_table(path: str, invert: bool = False):
    """OpenFst symbol table ('symbol id' per line) → {id: symbol}
    (or {symbol: id} with invert=True)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                if invert:
                    out[parts[0]] = int(parts[1])
                else:
                    out[int(parts[1])] = parts[0]
    return out


def RandomAccessIntVectorReader(rspecifier: str) -> _RandomAccessReader:
    return _RandomAccessReader(rspecifier, _read_binary_int_vector,
                               _read_text_int_vector)


class _Writer:
    """Table writer for a wspecifier (``ark:``, ``ark,t:``,
    ``ark,scp:ark,scp``)."""

    def __init__(self, wspecifier: str, write_fn, text_write_fn=None):
        self.spec = _Specifier(wspecifier)
        if self.spec.kind != "ark":
            raise ValueError("Writers require an ark: target")
        if self.spec.text and text_write_fn is None:
            raise ValueError("this writer has no text form (',t')")
        self._write_fn = write_fn
        self._text_write_fn = text_write_fn
        if self.spec.target == "-":
            self._f = os.fdopen(os.dup(1), "wb")
        else:
            self._f = open(self.spec.target, "wb")
        self._scp = open(self.spec.scp_target, "w") if self.spec.scp_target else None
        self._abs_path = (os.path.abspath(self.spec.target)
                          if self.spec.target != "-" else "-")

    def write(self, key: str, value) -> None:
        self._f.write(key.encode("utf-8") + b" ")
        # only scp generation needs the offset — tell() raises on
        # unseekable targets (ark:- into a pipe)
        offset = self._f.tell() if self._scp is not None else 0
        if self.spec.text:
            self._text_write_fn(self._f, value)
        else:
            self._f.write(_BINARY_MARKER)
            self._write_fn(self._f, value)
        if self._scp is not None:
            self._scp.write(f"{key} {self._abs_path}:{offset}\n")

    def __setitem__(self, key, value):
        self.write(key, value)

    def close(self) -> None:
        self._f.close()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _write_text_matrix(f, mat) -> None:
    mat = np.asarray(mat)
    f.write(b" [\n")
    for row in mat:
        f.write(("  " + " ".join(f"{x:.6g}" for x in row) + "\n")
                .encode("utf-8"))
    f.write(b"]\n")


def _write_text_int_vector(f, vec) -> None:
    f.write((" ".join(str(int(x)) for x in np.asarray(vec)) + "\n")
            .encode("utf-8"))


def MatrixWriter(wspecifier: str, compress: bool = False) -> _Writer:
    def _w(f, mat):
        _write_binary_matrix(f, mat, compress=compress)
    return _Writer(wspecifier, _w, _write_text_matrix)


def IntVectorWriter(wspecifier: str) -> _Writer:
    return _Writer(wspecifier, _write_binary_int_vector,
                   _write_text_int_vector)
