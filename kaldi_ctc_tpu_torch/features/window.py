"""Frame extraction and windowing (reference: src/feat/feature-window.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/window.py``: frames are
one gather indexed by ``frame*shift + arange(len)`` (reflection by index
arithmetic for snip_edges=False), and the per-frame processing (dither,
DC removal, preemphasis, window) is vectorized over the utterance.  The
tensors stay on the device of the waveform.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["FrameOptions", "feature_window", "num_frames", "frame_signal",
           "process_frames", "padded_power_spectrum"]


def _round_up_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class FrameOptions:
    """Mirror of FrameExtractionOptions (feature-window.h:35-90)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        return (_round_up_pow2(self.window_size)
                if self.round_to_power_of_two else self.window_size)


def feature_window(opts: FrameOptions) -> np.ndarray:
    """Window function table (FeatureWindowFunction, feature-window.cc:106-129)."""
    n = opts.window_size
    i = np.arange(n, dtype=np.float64)
    a = 2.0 * math.pi / (n - 1)
    t = opts.window_type
    if t == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif t == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif t == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif t == "rectangular":
        w = np.ones_like(i)
    elif t == "blackman":
        w = (opts.blackman_coeff - 0.5 * np.cos(a * i)
             + (0.5 - opts.blackman_coeff) * np.cos(2 * a * i))
    else:
        raise ValueError(f"Invalid window type {t!r}")
    return w.astype(np.float32)


def num_frames(num_samples: int, opts: FrameOptions) -> int:
    """NumFrames (feature-window.cc:42-88), flush=True semantics."""
    shift, length = opts.window_shift, opts.window_size
    if opts.snip_edges:
        if num_samples < length:
            return 0
        return 1 + (num_samples - length) // shift
    return (num_samples + shift // 2) // shift


def frame_signal(wave: torch.Tensor, opts: FrameOptions) -> torch.Tensor:
    """Slice the waveform into frames [num_frames, window_size].

    snip_edges=True: frame f covers samples [f*shift, f*shift+len).
    snip_edges=False: frames are centred on f*shift + shift/2 and edges are
    reflected (feature-window.cc:30-40,190-205).
    """
    n = wave.shape[0]
    nf = num_frames(n, opts)
    shift, length = opts.window_shift, opts.window_size
    frame_idx = torch.arange(nf, device=wave.device)[:, None] * shift
    offs = torch.arange(length, device=wave.device)[None, :]
    sample_idx = frame_idx + offs
    if not opts.snip_edges:
        sample_idx = frame_idx + shift // 2 - length // 2 + offs
        # reflect: -1 -> 0, -2 -> 1; n -> n-1, n+1 -> n-2
        sample_idx = torch.where(sample_idx < 0, -sample_idx - 1, sample_idx)
        sample_idx = torch.where(sample_idx >= n, 2 * n - 1 - sample_idx,
                                 sample_idx)
    return wave[sample_idx]


def process_frames(
    frames: torch.Tensor,
    opts: FrameOptions,
    window: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    need_raw_energy: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dither + DC removal + (raw energy) + preemphasis + window multiply.

    Mirrors ProcessWindow (feature-window.cc:131-153), vectorized over
    frames.  Dither is added only when a ``torch.Generator`` (on the
    frames' device) is passed, as the JAX package dithers only with a key.
    Returns (processed [F, L], raw log energy [F] or None).
    """
    if opts.dither != 0.0 and generator is not None:
        frames = frames + opts.dither * torch.randn(
            frames.shape, generator=generator, dtype=frames.dtype,
            device=frames.device)
    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=1, keepdim=True)
    raw_energy = None
    if need_raw_energy:
        eps = torch.finfo(torch.float32).eps
        raw_energy = torch.log(torch.clamp_min((frames * frames).sum(1), eps))
    c = opts.preemph_coeff
    if c != 0.0:
        shifted = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - c * shifted
    return frames * window[None, :], raw_energy


def padded_power_spectrum(frames: torch.Tensor,
                          opts: FrameOptions) -> torch.Tensor:
    """Zero-pad each frame to the power-of-two size, rFFT, |.|^2.

    Returns [F, padded/2 + 1] power spectrum (ComputePowerSpectrum analogue).
    """
    if frames.shape[0] == 0:   # the CPU FFT refuses an empty batch
        return frames.new_zeros((0, opts.padded_window_size // 2 + 1))
    pad = opts.padded_window_size - frames.shape[1]
    if pad > 0:
        frames = torch.nn.functional.pad(frames, (0, pad))
    spec = torch.fft.rfft(frames, dim=1)
    return (spec.real * spec.real + spec.imag * spec.imag).to(torch.float32)
