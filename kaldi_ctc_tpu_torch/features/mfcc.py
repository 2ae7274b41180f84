"""MFCC features (reference: src/feat/feature-mfcc.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/mfcc.py``.  DCT and
liftering fold into one precomputed [num_ceps, num_bins] matrix applied
after the log-mel stage.  The log-mel stage is :func:`stft_cuda.log_mel`:
kernel K4 for a CUDA waveform, its plain version for a CPU one.  The DCT
stays a ``torch.matmul`` in IEEE f32 (the package pins TF32 off), as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from kaldi_ctc_tpu_torch.features import stft_cuda
from kaldi_ctc_tpu_torch.features.mel import MelOptions, mel_banks
from kaldi_ctc_tpu_torch.features.window import (
    FrameOptions,
    feature_window,
    frame_signal,
    padded_power_spectrum,
    process_frames,
)

__all__ = ["MfccOptions", "compute_mfcc", "dct_matrix", "lifter_coeffs"]


@dataclasses.dataclass(frozen=True)
class MfccOptions:
    """Mirror of MfccOptions (feature-mfcc.h:38-84)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    # HTK output order: [c1..c{n-1}, c0_or_energy]; C0 scaled by sqrt(2)
    # when use_energy=False (feature-mfcc.h:47-49, .cc:70-79).
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps

    @staticmethod
    def hires() -> "MfccOptions":
        """The librispeech hires config (conf/mfcc_hires.conf)."""
        return MfccOptions(
            mel_opts=MelOptions(num_bins=40, low_freq=20.0, high_freq=-400.0),
            num_ceps=40,
            use_energy=False,
        )


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Normalized type-II DCT matrix (matrix-functions.cc ComputeDctMatrix)."""
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_bins)
    n = np.arange(num_bins, dtype=np.float64)
    for k in range(1, num_ceps):
        m[k, :] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (n + 0.5) * k)
    return m.astype(np.float32)


def lifter_coeffs(q: float, num_ceps: int) -> np.ndarray:
    """Cepstral liftering coefficients (mel-computations.cc ComputeLifterCoeffs)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _tables(opts: MfccOptions, vtln_warp: float, device: torch.device):
    """(window [L], mel [M, K], dct [C, M]) on ``device``, built once per
    option set: a server extracts features with one set for its life."""
    fo = opts.frame_opts
    dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
    if opts.cepstral_lifter != 0.0:
        dct = dct * lifter_coeffs(opts.cepstral_lifter, opts.num_ceps)[:, None]
    return (torch.as_tensor(feature_window(fo), device=device),
            torch.as_tensor(mel_banks(opts.mel_opts, fo, vtln_warp=vtln_warp),
                            device=device),
            torch.as_tensor(dct, device=device))


def compute_mfcc(
    wave: torch.Tensor,
    opts: MfccOptions = MfccOptions(),
    generator: Optional[torch.Generator] = None,
    vtln_warp: float = 1.0,
) -> torch.Tensor:
    """MFCCs for one waveform [num_samples] → [num_frames, num_ceps], on
    the waveform's device.

    Matches MfccComputer::Compute (feature-mfcc.cc:32-85).  Dither only
    with a ``torch.Generator``.  The fused log-mel path (K4 on CUDA) is
    taken where the JAX package takes its Pallas kernel; htk_mode and
    non-raw energy go through the plain frame pipeline, as in JAX.
    """
    fo = opts.frame_opts
    window, mel, dct = _tables(opts, float(vtln_warp), wave.device)
    frames = frame_signal(wave, fo)
    fused_ok = ((opts.raw_energy or not opts.use_energy)
                and not opts.mel_opts.htk_mode)
    if fused_ok and frames.shape[0] > 0:
        if fo.dither != 0.0 and generator is not None:
            frames = frames + fo.dither * torch.randn(
                frames.shape, generator=generator, dtype=frames.dtype,
                device=frames.device)
        log_mel, raw_energy = stft_cuda.log_mel(
            frames, window, mel, fo.padded_window_size,
            remove_dc=fo.remove_dc_offset, preemph=fo.preemph_coeff,
            use_power=True, use_log=True)
        feats = torch.matmul(log_mel, dct.T)
        if opts.use_energy:
            feats[:, 0] = _floor_energy(raw_energy, opts.energy_floor)
        return _htk_reorder(feats, opts)
    need_raw = opts.use_energy and opts.raw_energy
    frames, raw_energy = process_frames(
        frames, fo, window, generator=generator, need_raw_energy=need_raw)
    power = padded_power_spectrum(frames, fo)
    eps = torch.finfo(torch.float32).eps
    if opts.use_energy and not opts.raw_energy:
        # Kaldi floors energy at float epsilon, not denormal-min
        raw_energy = torch.log(torch.clamp_min((frames * frames).sum(1), eps))
    mel_energies = torch.matmul(power[:, :-1], mel.T)
    if opts.mel_opts.htk_mode:
        # HTK-like flooring (mel-computations.cc:238)
        mel_energies = torch.clamp_min(mel_energies, 1.0)
    feats = torch.matmul(torch.log(torch.clamp_min(mel_energies, eps)), dct.T)
    if opts.use_energy:
        feats[:, 0] = _floor_energy(raw_energy, opts.energy_floor)
    return _htk_reorder(feats, opts)


def _floor_energy(energy: torch.Tensor, energy_floor: float) -> torch.Tensor:
    if energy_floor > 0.0:
        return torch.clamp_min(energy, float(np.log(energy_floor)))
    return energy


def _htk_reorder(feats: torch.Tensor, opts: MfccOptions) -> torch.Tensor:
    """htk_compat output order (feature-mfcc.cc:70-79): rotate c0/energy to
    the last column; scale C0 by sqrt(2) when it is a cepstrum (removes the
    1/sqrt(2) the normalized DCT put on row 0)."""
    if not opts.htk_compat:
        return feats
    first = feats[:, :1]
    if not opts.use_energy:
        first = first * math.sqrt(2.0)
    return torch.cat([feats[:, 1:], first], dim=1)
