"""Mel filterbank construction (reference: src/feat/mel-computations.cc:33-140).

The reference stores each triangular bin as a sparse (offset, coeffs) pair
and does per-bin dot products; on TPU we build one dense
[num_bins, num_fft_bins] matrix on the host once and apply it as a single
matmul over the whole utterance — that is the MXU-friendly formulation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_ctc_tpu_torch.features.window import FrameOptions

__all__ = ["MelOptions", "mel_scale", "inverse_mel_scale", "mel_banks",
           "mel_center_freqs"]


@dataclasses.dataclass(frozen=True)
class MelOptions:
    """Mirror of MelBanksOptions (feat/mel-computations.h:43-78)."""

    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from Nyquist
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    # HTK bug replication for golden tests (mel-computations.h:52-55):
    # zeroes bin 0's first coefficient when low_freq != 0 and floors mel
    # energies at 1.0 before the log (consumed by compute_fbank/mfcc).
    htk_mode: bool = False


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def _vtln_warp_freq(vtln_low, vtln_high, low_freq, high_freq, warp, freq):
    """VtlnWarpFreq (mel-computations.cc): piecewise-linear frequency warp.

    The central segment maps freq -> freq/warp; the breakpoints l and h
    are chosen in the UNWARPED domain (l = vtln_low*max(1,warp),
    h = vtln_high*min(1,warp)) so that both the input knees [l, h] and
    their images [l/warp, h/warp] stay inside [low_freq, high_freq],
    keeping the warp continuous and monotonic for any warp factor.
    """
    if freq < low_freq or freq > high_freq:
        return freq
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    Fl = scale * l
    Fh = scale * h
    scale_left = (Fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - Fh) / (high_freq - h)
    if freq < l:
        return low_freq + scale_left * (freq - low_freq)
    if freq < h:
        return scale * freq
    return high_freq + scale_right * (freq - high_freq)


def _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq, warp, mel):
    return mel_scale(_vtln_warp_freq(
        vtln_low, vtln_high, low_freq, high_freq, warp,
        inverse_mel_scale(mel)))


def mel_banks(
    opts: MelOptions,
    frame_opts: FrameOptions,
    vtln_warp: float = 1.0,
) -> np.ndarray:
    """Dense mel filterbank matrix [num_bins, num_fft_bins].

    num_fft_bins = padded_window_size/2 (the Nyquist bin is excluded, as in
    the reference where bins are defined over i in [0, padded/2)).
    """
    num_bins = opts.num_bins
    if num_bins < 3:
        raise ValueError("Must have at least 3 mel bins")
    sample_freq = frame_opts.samp_freq
    window_length_padded = frame_opts.padded_window_size
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    low_freq = opts.low_freq
    high_freq = opts.high_freq if opts.high_freq > 0.0 else nyquist + opts.high_freq
    if not (0.0 <= low_freq < nyquist and 0.0 < high_freq <= nyquist
            and low_freq < high_freq):
        raise ValueError(
            f"Bad frequency range: low {low_freq} high {high_freq} "
            f"nyquist {nyquist}")

    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    vtln_high = opts.vtln_high
    if vtln_high < 0.0:
        vtln_high += nyquist

    fft_mels = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))
    out = np.zeros((num_bins, num_fft_bins), dtype=np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        if vtln_warp != 1.0:
            left = _vtln_warp_mel(opts.vtln_low, vtln_high, low_freq,
                                  high_freq, vtln_warp, left)
            center = _vtln_warp_mel(opts.vtln_low, vtln_high, low_freq,
                                    high_freq, vtln_warp, center)
            right = _vtln_warp_mel(opts.vtln_low, vtln_high, low_freq,
                                   high_freq, vtln_warp, right)
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        weight = np.where(fft_mels <= center, up, down)
        weight = np.where((fft_mels > left) & (fft_mels < right), weight, 0.0)
        if not weight.any():
            raise ValueError("Empty mel bin: --num-mel-bins too large?")
        if opts.htk_mode and b == 0 and mel_low > 0.0:
            # "Replicate a bug in HTK" (mel-computations.cc:133-135): the
            # first nonzero coefficient of bin 0 is zeroed.
            nz = np.flatnonzero(weight)
            weight[nz[0]] = 0.0
        out[b] = weight.astype(np.float32)
    return out


def mel_center_freqs(
    opts: MelOptions,
    frame_opts: FrameOptions,
    vtln_warp: float = 1.0,
) -> np.ndarray:
    """Center frequency (Hz) of each mel bin — MelBanks::GetCenterFreqs
    (mel-computations.cc:148-150), consumed by the PLP equal-loudness
    curve (GetEqualLoudnessVector, mel-computations.cc:313-325)."""
    nyquist = 0.5 * frame_opts.samp_freq
    low_freq = opts.low_freq
    high_freq = (opts.high_freq if opts.high_freq > 0.0
                 else nyquist + opts.high_freq)
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (opts.num_bins + 1)
    vtln_high = opts.vtln_high
    if vtln_high < 0.0:
        vtln_high += nyquist
    centers = np.empty(opts.num_bins, np.float64)
    for b in range(opts.num_bins):
        center = mel_low + (b + 1) * mel_delta
        if vtln_warp != 1.0:
            center = _vtln_warp_mel(opts.vtln_low, vtln_high, low_freq,
                                    high_freq, vtln_warp, center)
        centers[b] = inverse_mel_scale(center)
    return centers.astype(np.float32)
