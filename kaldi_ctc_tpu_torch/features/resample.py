"""Waveform resampling and speed perturbation.

Replaces src/feat/resample.{h,cc} (LinearResample) for the recipe's 3-way
speed perturbation (run_ctc_phone.sh stage 0 uses sox/utils
perturb_data_dir_speed.sh; here the same effect is computed in-process).
Implemented as a windowed-sinc filter bank applied with one matmul per
output phase — the MXU-friendly formulation of polyphase resampling.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["resample", "speed_perturb"]


@lru_cache(maxsize=32)
def _polyphase_filters(up: int, down: int, zeros: int = 16,
                       rolloff: float = 0.945) -> np.ndarray:
    """Hann-windowed sinc filters [up, taps] for rate up/down.

    The filter taps sit on the INPUT sample grid (direct-form gather in
    resample(), not zero-stuffing), so the anti-alias cutoff is
    expressed in input-sample units — rolloff × half the narrower of
    the two bandwidths — and the DC gain is 1 (no `up` compensation,
    which only applies to zero-stuffed formulations).
    """
    cutoff = rolloff * 0.5 * min(1.0, up / down)
    half_width = int(math.ceil(zeros / (2 * cutoff)))
    taps = 2 * half_width + 1
    out = np.zeros((up, taps), dtype=np.float64)
    for phase in range(up):
        # output sample k*up+phase sits at input position
        # (k*down + phase*down/up) — offset within input grid:
        frac = phase * down / up
        n = np.arange(-half_width, half_width + 1) - (frac - np.floor(frac))
        x = 2 * cutoff * n
        sinc = np.sinc(x)
        window = 0.5 * (1 + np.cos(np.pi * n / half_width))
        window[np.abs(n) > half_width] = 0.0
        out[phase] = 2 * cutoff * sinc * window
    return out.astype(np.float32)


def resample(wave: np.ndarray, src_rate: float, dst_rate: float) -> np.ndarray:
    """Resample [n] float waveform from src_rate to dst_rate."""
    if src_rate == dst_rate:
        return np.asarray(wave, np.float32)
    g = math.gcd(int(round(src_rate)), int(round(dst_rate)))
    up = int(round(dst_rate)) // g
    down = int(round(src_rate)) // g
    filters = _polyphase_filters(up, down)
    taps = filters.shape[1]
    half = taps // 2
    n_in = wave.shape[0]
    n_out = int(n_in * up // down)
    padded = np.concatenate([np.zeros(half, np.float32),
                             np.asarray(wave, np.float32),
                             np.zeros(half + down, np.float32)])
    out = np.zeros(n_out, dtype=np.float32)
    k = np.arange(n_out)
    phase = k % up
    in_pos = (k * down) // up  # integer part of input index
    # gather windows [n_out, taps] — vectorized indexing
    idx = in_pos[:, None] + np.arange(taps)[None, :]
    windows = padded[idx]
    out = np.einsum("nt,nt->n", windows, filters[phase])
    return out.astype(np.float32)


def speed_perturb(wave: np.ndarray, rate: float,
                  factor: float) -> np.ndarray:
    """Speed-perturb by `factor` (0.9 / 1.1 in the recipe): resample so the
    audio plays `factor`× faster at the same nominal rate."""
    if factor == 1.0:
        return np.asarray(wave, np.float32)
    return resample(wave, rate * factor, rate)
