"""Fused STFT → log-mel: the CUDA kernel K4 and its plain version.

Counterpart of ``kaldi_ctc_tpu/features/stft_pallas.py``.  One kernel
(``csrc/log_mel.cu``) does DC removal, the raw frame energy,
preemphasis, the window, the real DFT against cos/sin tables, power,
the mel projection and the log, with no round trip to device memory
between stages.

:func:`log_mel` is the wrapper: a CPU tensor goes to
:func:`log_mel_reference` (the XLA path the JAX package treats as the
reference: rFFT power spectrum and a mel matmul); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from kaldi_ctc_tpu_torch import _kernels

__all__ = ["dft_tables", "log_mel", "log_mel_reference"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"log_mel_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, ctypes.c_float, _I, _I, _P]}


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
    cos_t, sin_t = _device_tables(length, padded_size, k_bins,
                                  frames.device)
    out = torch.empty((f, m_bins), dtype=torch.float32, device=frames.device)
    energy = torch.empty((f,), dtype=torch.float32, device=frames.device)
    if f == 0:
        return out, energy
    lib = _kernels.load("log_mel", _SIGNATURES)
    err = lib.log_mel_f32(
        frames.data_ptr(), window.data_ptr(), cos_t.data_ptr(),
        sin_t.data_ptr(), mel.data_ptr(), out.data_ptr(), energy.data_ptr(),
        f, length, k_bins, m_bins, int(remove_dc), float(preemph),
        int(use_power), int(use_log), _kernels.stream_ptr(frames.device))
    _kernels.check(lib, err, "log_mel")
    log_mel.launches += 1
    return out, energy


log_mel.launches = 0  # kernel launches made by this wrapper
