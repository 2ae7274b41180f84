"""Fused STFT → log-mel: the CUDA kernel K4 and its plain version.

Counterpart of ``kaldi_ctc_tpu/features/stft_pallas.py``.  One launch
(``csrc/log_mel.cu``) does DC removal, the raw frame energy,
preemphasis, the window, the power spectrum, the mel projection and the
log, with no round trip to device memory between stages.  Two routes,
chosen from the shapes by :func:`k4_plan`: ``fft`` (a padded size that
is a power of two up to ``K4_FFT_MAX_POINTS``: an FFT in shared memory,
one warp per frame, twiddles from :func:`fft_twiddles`) and ``dft``
(every other size: the direct DFT against the tables of
:func:`dft_tables`).

:func:`log_mel` is the wrapper: a CPU tensor goes to
:func:`log_mel_reference` (the XLA path the JAX package treats as the
reference: rFFT power spectrum and a mel matmul); a CUDA tensor launches
the plan's route or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import weakref
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.utils import profiling

__all__ = ["K4Plan", "dft_tables", "fft_twiddles", "k4_plan", "log_mel",
           "log_mel_reference", "mel_rows"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "log_mel_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                    _I, _P],
    "log_mel_fft_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _F, _I, _I, _I, _P],
    "log_mel_fft_smem": [_I, _I, _I, _I, _I],
    "log_mel_dft_smem": [_I, _I],
    "kctpu_null_launch": [_P],
}

# the fft route: padded sizes that are powers of two up to this, and at
# most this many frames (one warp each) a block (csrc/log_mel.cu
# kFftMaxPoints, kFftFrames)
K4_FFT_MAX_POINTS = 4096
K4_FFT_FRAMES = 4
# the dft route's frames a block (kFrames) and the H100's shared memory a
# block may opt in to (bytes)
_DFT_FRAMES = 4
_SMEM_OPTIN = 232448


class K4Plan(NamedTuple):
    """K4's route ("fft" or "dft"), the frames a block takes and its
    dynamic shared memory (bytes; on the fft route the most a launch
    takes, with every mel entry nonzero)."""
    route: str
    frames_per_block: int
    smem_bytes: int


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _fft_smem_bytes(length: int, padded_size: int, m_bins: int, nnz: int,
                    frames_per_block: int) -> int:
    """The fft route's shared memory, the twin of ``FftLayout`` in
    ``csrc/log_mel.cu``: the N/2 + 1 twiddles, the window, the mel rows'
    spans [M, 3] and their ``nnz`` packed floats, and per frame its raw
    samples and two complex rows of N/2 (one complex of padding every
    16), each part a multiple of 4 floats."""
    nh = padded_size // 2
    shared = (_round4(2 * (nh + 1)) + _round4(length) + _round4(3 * m_bins)
              + _round4(nnz))
    row = _round4(2 * (nh + ((nh - 1) >> 4)))
    return 4 * (shared + frames_per_block * (_round4(length) + 2 * row))


def _dft_smem_bytes(length: int, k_bins: int) -> int:
    """The dft route's dynamic shared memory (``dft_smem_bytes``):
    kFrames raw and windowed frames and their power spectra."""
    return 4 * (2 * _DFT_FRAMES * length + _DFT_FRAMES * k_bins)


def k4_plan(length: int, padded_size: int, k_bins: int, m_bins: int,
            smem_optin: int = _SMEM_OPTIN) -> K4Plan:
    """K4's route for frames of ``length`` samples padded to
    ``padded_size``, ``k_bins`` spectrum bins and ``m_bins`` mel bins: the
    fft route where the padded size is a power of two up to
    ``K4_FFT_MAX_POINTS`` and ``K4_FFT_FRAMES`` frames a block (or fewer)
    fit ``smem_optin`` with every mel entry nonzero; else the dft route.
    A pure function of shapes."""
    pow2 = padded_size >= 2 and padded_size & (padded_size - 1) == 0
    if pow2 and padded_size <= K4_FFT_MAX_POINTS:
        fpb = K4_FFT_FRAMES
        while fpb >= 1:
            b = _fft_smem_bytes(length, padded_size, m_bins, m_bins * k_bins,
                                fpb)
            if b <= smem_optin:
                return K4Plan("fft", fpb, b)
            fpb //= 2
    b = _dft_smem_bytes(length, k_bins)
    if b > smem_optin:
        raise ValueError(f"log_mel: no route fits {length} samples and "
                         f"{k_bins} bins in {smem_optin} bytes of shared "
                         f"memory")
    return K4Plan("dft", _DFT_FRAMES, b)


def dft_tables(window_size: int, padded_size: int,
               num_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin matrices [window_size, num_bins] for bins
    0..num_bins-1 of a padded_size-point transform (zero padding beyond
    window_size contributes nothing, so rows stop at window_size)."""
    n = np.arange(window_size, dtype=np.float64)[:, None]
    k = np.arange(num_bins, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / padded_size
    return (np.cos(ang).astype(np.float32),
            -np.sin(ang).astype(np.float32))


def fft_twiddles(padded_size: int) -> np.ndarray:
    """The fft route's twiddles e^{-2 pi i t / N}, t = 0..N/2, as
    [N/2 + 1, 2] (real, imaginary) f32, computed in float64 and rounded
    once, as :func:`dft_tables` rounds its tables."""
    t = np.arange(padded_size // 2 + 1, dtype=np.float64)
    ang = 2.0 * math.pi * t / padded_size
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_twiddles(padded_size: int, device: torch.device):
    return torch.as_tensor(fft_twiddles(padded_size), device=device)


def mel_rows(mel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The fft route's form of a mel matrix [M, K]: each row's span from
    its first to its last nonzero bin, as rows [M, 3] int32 (first bin,
    one past the last, offset in ``packed``), and the spans packed one
    after another, f32.  A row of zeros has an empty span."""
    nz = mel != 0
    live = nz.any(axis=1)
    lo = np.where(live, nz.argmax(axis=1), 0)
    hi = np.where(live, mel.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    packed = [mel[m, lo[m]:hi[m]] for m in range(mel.shape[0])]
    return (np.stack([lo, hi, off], axis=1).astype(np.int32),
            np.concatenate(packed + [np.zeros(0)]).astype(np.float32))


# mel_rows of each mel tensor on the card, by id: (a weak reference that
# tells the same tensor from a later one at the same id, its version at
# the time, rows, packed, nnz)
_MEL_ROWS = {}


def _device_mel_rows(mel: torch.Tensor):
    """:func:`mel_rows` of ``mel`` on its device, found once per tensor
    and version (one copy to the host; a server keeps one mel tensor for
    its life) → (rows, packed, nnz)."""
    key = id(mel)
    hit = _MEL_ROWS.get(key)
    if hit is None or hit[0]() is not mel or hit[1] != mel._version:
        rows, packed = mel_rows(mel.cpu().numpy())
        ref = weakref.ref(mel, lambda _, k=key: _MEL_ROWS.pop(k, None))
        hit = (ref, mel._version,
               torch.as_tensor(rows, device=mel.device),
               torch.as_tensor(np.append(packed, np.float32(0)),
                               device=mel.device), len(packed))
        _MEL_ROWS[key] = hit
    return hit[2:]


@functools.lru_cache(maxsize=8)
def _device_tables(window_size: int, padded_size: int, num_bins: int,
                   device: torch.device):
    cos_t, sin_t = dft_tables(window_size, padded_size, num_bins)
    return (torch.as_tensor(cos_t, device=device),
            torch.as_tensor(sin_t, device=device))


def log_mel_reference(frames: torch.Tensor, window: torch.Tensor,
                      mel: torch.Tensor, padded_size: int,
                      remove_dc: bool = True, preemph: float = 0.97,
                      use_power: bool = True, use_log: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`log_mel` on any device: frame
    processing, zero-padded rFFT power spectrum, mel matmul, log."""
    eps = torch.finfo(torch.float32).eps
    x = frames
    if remove_dc:
        x = x - x.mean(dim=1, keepdim=True)
    energy = torch.log(torch.clamp_min((x * x).sum(1), eps))
    if preemph != 0.0:
        x = x - preemph * torch.cat([x[:, :1], x[:, :-1]], dim=1)
    x = torch.nn.functional.pad(x * window[None, :],
                                (0, padded_size - x.shape[1]))
    spec = torch.fft.rfft(x, dim=1)
    p = spec.real * spec.real + spec.imag * spec.imag
    if not use_power:
        p = torch.sqrt(p)
    m = torch.matmul(p[:, :mel.shape[1]], mel.T)
    if use_log:
        m = torch.log(torch.clamp_min(m, eps))
    return m, energy


def log_mel(frames: torch.Tensor, window: torch.Tensor, mel: torch.Tensor,
            padded_size: int, remove_dc: bool = True, preemph: float = 0.97,
            use_power: bool = True, use_log: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames [F, L] (raw, post-dither) → (mel features [F, M] f32,
    raw log energies [F] f32), the contract of ``log_mel_pallas``.

    mel: [M, K] filterbank over DFT bins 0..K-1 (Nyquist excluded, the
    feature-fbank.cc convention)."""
    if frames.device.type == "cpu":
        return log_mel_reference(frames, window, mel, padded_size,
                                 remove_dc, preemph, use_power, use_log)
    if frames.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {frames.device}")
    if frames.dim() != 2 or frames.dtype != torch.float32:
        raise ValueError("log_mel: frames must be a 2-D float32 tensor, "
                         f"got {tuple(frames.shape)} {frames.dtype}")
    f, length = frames.shape
    m_bins, k_bins = mel.shape
    if k_bins > padded_size // 2 + 1 or padded_size < length:
        raise ValueError(f"log_mel: {k_bins} bins do not fit a "
                         f"{padded_size}-point DFT of {length} samples")
    for name, t, shape in (("window", window, (length,)),
                           ("mel", mel, (m_bins, k_bins))):
        if (t.device != frames.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"log_mel: {name} must be float32 {shape} on "
                             f"{frames.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    for name, t in (("frames", frames), ("window", window), ("mel", mel)):
        if not t.is_contiguous():
            raise ValueError(f"log_mel: {name} is not contiguous")
    plan = k4_plan(length, padded_size, k_bins, m_bins)
    if plan.route == "fft":
        out = _log_mel_fft(frames, window, mel, padded_size, remove_dc,
                           preemph, use_power, use_log, plan)
    else:
        out = _log_mel_dft(frames, window, mel, padded_size, remove_dc,
                           preemph, use_power, use_log)
    if f:
        log_mel.launches += 1
        if plan.route == "fft":
            log_mel.fft_launches += 1
        else:
            log_mel.dft_launches += 1
        log_mel.frame_counts[f] += 1
    return out


def _log_mel_fft(frames, window, mel, padded_size, remove_dc, preemph,
                 use_power, use_log, plan=None):
    """K4's fft route (``log_mel_fft_f32``) on checked operands →
    (mel [F, M], energy [F])."""
    f, length = frames.shape
    m_bins, k_bins = mel.shape
    plan = plan or k4_plan(length, padded_size, k_bins, m_bins)
    out = torch.empty((f, m_bins), dtype=torch.float32, device=frames.device)
    energy = torch.empty((f,), dtype=torch.float32, device=frames.device)
    if f == 0:
        return out, energy
    tw = _device_twiddles(padded_size, frames.device)
    rows, packed, nnz = _device_mel_rows(mel)
    lib = _kernels.load("log_mel", _SIGNATURES)
    err = lib.log_mel_fft_f32(
        frames.data_ptr(), window.data_ptr(), tw.data_ptr(), rows.data_ptr(),
        packed.data_ptr(), out.data_ptr(), energy.data_ptr(), f, length,
        padded_size, k_bins, m_bins, nnz, int(remove_dc), float(preemph),
        int(use_power), int(use_log), plan.frames_per_block,
        _kernels.stream_ptr(frames.device))
    _kernels.check(lib, err, f"log_mel at F={f}, {plan}")
    return out, energy


def _log_mel_dft(frames, window, mel, padded_size, remove_dc, preemph,
                 use_power, use_log):
    """K4's dft route (``log_mel_f32``) on checked operands → (mel
    [F, M], energy [F])."""
    f, length = frames.shape
    m_bins, k_bins = mel.shape
    out = torch.empty((f, m_bins), dtype=torch.float32, device=frames.device)
    energy = torch.empty((f,), dtype=torch.float32, device=frames.device)
    if f == 0:
        return out, energy
    cos_t, sin_t = _device_tables(length, padded_size, k_bins,
                                  frames.device)
    lib = _kernels.load("log_mel", _SIGNATURES)
    err = lib.log_mel_f32(
        frames.data_ptr(), window.data_ptr(), cos_t.data_ptr(),
        sin_t.data_ptr(), mel.data_ptr(), out.data_ptr(), energy.data_ptr(),
        f, length, k_bins, m_bins, int(remove_dc), float(preemph),
        int(use_power), int(use_log), _kernels.stream_ptr(frames.device))
    _kernels.check(lib, err, "log_mel")
    return out, energy


# kernel launches made by this wrapper, in all and by route, and by the
# frames of the launch
log_mel.launches = 0
log_mel.fft_launches = 0
log_mel.dft_launches = 0
log_mel.frame_counts = collections.Counter()

# every snapshot of the span registry reads these counters where they are
profiling.register_launch_counters(log_mel)
