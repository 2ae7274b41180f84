"""Log power-spectrogram features (reference:
src/feat/feature-spectrogram.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/spectrogram.py``, on the
waveform's device.  Dim = padded_window_size/2 + 1; each row is the log
power spectrum floored at float epsilon, with column 0 overwritten by the
frame's log energy (raw by default, post-window when raw_energy=False) —
SpectrogramComputer::Compute (feature-spectrogram.cc:52-82).  No kernel:
the JAX package computes it in XLA ops, not through its Pallas log-mel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kaldi_ctc_tpu_torch.features.window import (
    FrameOptions,
    feature_window,
    frame_signal,
    padded_power_spectrum,
    process_frames,
)

__all__ = ["SpectrogramOptions", "compute_spectrogram"]


@dataclasses.dataclass(frozen=True)
class SpectrogramOptions:
    """Mirror of SpectrogramOptions (feature-spectrogram.h:37-54)."""

    frame_opts: FrameOptions = FrameOptions()
    energy_floor: float = 0.0
    raw_energy: bool = True

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1


def compute_spectrogram(
    wave: torch.Tensor,
    opts: SpectrogramOptions = SpectrogramOptions(),
    generator: Optional[torch.Generator] = None,
    vtln_warp: float = 1.0,   # ignored; interface parity with the
    # other computers (feature-spectrogram.h:84 ignores it too)
) -> torch.Tensor:
    """[num_samples] → [num_frames, padded/2+1] log power spectrogram."""
    fo = opts.frame_opts
    eps = torch.finfo(torch.float32).eps
    window = torch.as_tensor(feature_window(fo), device=wave.device)
    frames = frame_signal(wave, fo)
    frames, raw_energy = process_frames(
        frames, fo, window, generator=generator,
        need_raw_energy=opts.raw_energy)
    if not opts.raw_energy:
        raw_energy = torch.log(torch.clamp_min((frames * frames).sum(1), eps))
    power = padded_power_spectrum(frames, fo)
    feats = torch.log(torch.clamp_min(power, eps))
    energy = raw_energy
    if opts.energy_floor > 0.0:
        energy = torch.clamp_min(energy, float(np.log(opts.energy_floor)))
    feats[:, 0] = energy
    return feats
