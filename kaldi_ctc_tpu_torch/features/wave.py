"""RIFF wave reading (reference: src/feat/wave-reader.{h,cc}).

Minimal PCM reader sufficient for the recipes: 8/16/32-bit integer PCM and
float PCM, mono or multi-channel.  Returns float32 samples in the Kaldi
convention (16-bit range, NOT normalized to [-1, 1]).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["read_wave"]


def read_wave(path: str) -> Tuple[np.ndarray, float]:
    """Read a wav file → (samples [channels, n] float32, sample_rate).

    Accepts Kaldi extended filenames: a trailing ``|`` runs the entry as
    a shell pipeline and reads the wav from its stdout (the wav.scp
    ``flac -c -d ... |`` idiom of the librispeech recipes,
    util/kaldi-io pipe inputs)."""
    if path.rstrip().endswith("|"):
        import io
        import subprocess
        proc = subprocess.run(path.rstrip().rstrip("|"), shell=True,
                              stdout=subprocess.PIPE, check=True)
        f = io.BytesIO(proc.stdout)
        return _read_wave_stream(f, path)
    with open(path, "rb") as f:
        return _read_wave_stream(f, path)


def _read_wave_stream(f, path: str) -> Tuple[np.ndarray, float]:
    if True:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if chunk_id == b"data" and size in (0, 0xFFFFFFFF):
                # streamed writers can't seek back to fix the size;
                # read to EOF like Kaldi's wave reader does
                payload = f.read()
                size = len(payload)
            else:
                payload = f.read(size)
            if size % 2:
                f.read(1)
            if chunk_id == b"fmt ":
                fmt = payload
            elif chunk_id == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_format, channels, rate, _, _, bits = struct.unpack(
            "<HHIIHH", fmt[:16])
        if audio_format == 3:  # IEEE float
            samples = np.frombuffer(data, dtype=np.float32).astype(np.float32)
            samples = samples * 32768.0
        elif bits == 16:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
        elif bits == 8:
            samples = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                       - 128.0) * 256.0
        elif bits == 32:
            samples = np.frombuffer(data, dtype="<i4").astype(np.float32) / 65536.0
        else:
            raise ValueError(f"{path}: unsupported bit depth {bits}")
        n = samples.shape[0] // channels
        return samples[: n * channels].reshape(n, channels).T.copy(), float(rate)
