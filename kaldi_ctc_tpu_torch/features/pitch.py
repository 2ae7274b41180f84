"""Kaldi pitch extraction (compute-kaldi-pitch-feats + process-kaldi-pitch).

A numpy copy of ``kaldi_ctc_tpu/features/pitch.py``: pitch runs on the
host in both packages.

The ``src/feat/pitch-functions.{h,cc}`` algorithm of Ghahremani et al.,
"A Pitch Extraction Algorithm Tuned for Automatic Speech Recognition"
(ICASSP 2014), implemented offline (whole-utterance; equivalent to the
reference's single-chunk ComputeKaldiPitch with the ballast term from
whole-file statistics):

  1. low-pass + downsample to ``resample_freq`` (windowed-sinc
     LinearResample, ``feat/resample.h`` semantics);
  2. per frame, NCCF over integer lags 1/max_f0..1/min_f0 with a ballast
     term ``(mean_sq_energy * frame_len)^2 * nccf_ballast`` for the pitch
     version and no ballast for the POV version
     (pitch-functions.cc:102-155, 1139-1151);
  3. windowed-sinc resampling of the NCCF onto geometrically spaced lags
     (ratio 1 + delta_pitch, SelectLags, pitch-functions.cc:157-167);
  4. Viterbi over lag states: local cost 1 - Φ(1 - soft_min_f0·lag)
     (eq. 5 / :178-191), quadratic log-lag transition cost
     ``(i-j)^2 (log(1+delta_pitch))^2 penalty_factor`` (:316-319) — here
     solved per frame in O(N) with the lower-envelope distance transform
     rather than the reference's bound-tightening search;
  5. output [T, 2] = (NCCF-for-POV at chosen lag, pitch Hz).

``process_pitch`` mirrors OnlineProcessPitch (:1397-1540): the final
(pov-feature, normalized-log-pitch, delta-pitch[, raw-log-pitch])
features with POV-weighted sliding-window pitch normalization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = ["PitchOptions", "ProcessPitchOptions", "compute_kaldi_pitch",
           "process_pitch", "compute_and_process_pitch"]


@dataclasses.dataclass
class PitchOptions:
    """PitchExtractionOptions (pitch-functions.h:42-135 defaults)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5


@dataclasses.dataclass
class ProcessPitchOptions:
    """ProcessPitchOptions (pitch-functions.h:212-248 defaults)."""

    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_pitch_noise_stddev: float = 0.005
    normalization_left_context: int = 75
    normalization_right_context: int = 75
    delta_window: int = 2
    add_pov_feature: bool = True
    add_normalized_log_pitch: bool = True
    add_delta_pitch: bool = True
    add_raw_log_pitch: bool = False


# ---------------------------------------------------------------------------
# windowed-sinc resampling (feat/resample.cc FilterFunc semantics)
# ---------------------------------------------------------------------------

def _filter_func(dt: np.ndarray, cutoff: float, num_zeros: int) -> np.ndarray:
    """Hanning-windowed sinc low-pass, Kaldi's FilterFunc: support
    |t| < num_zeros/(2 cutoff)."""
    width = num_zeros / (2.0 * cutoff)
    win = np.where(np.abs(dt) < width,
                   0.5 * (1.0 + np.cos(2 * np.pi * cutoff / num_zeros * dt)),
                   0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(dt == 0.0, 2.0 * cutoff,
                     np.sin(2 * np.pi * cutoff * dt) / (np.pi * dt))
    return win * f


def _linear_resample(x: np.ndarray, in_rate: float, out_rate: float,
                     cutoff: float, num_zeros: int) -> np.ndarray:
    """LinearResample: phase-decomposed windowed-sinc rate conversion."""
    g = math.gcd(int(round(in_rate)), int(round(out_rate)))
    in_p, out_p = int(round(in_rate)) // g, int(round(out_rate)) // g
    n_in = len(x)
    n_out = int(np.floor(n_in * out_rate / in_rate))
    width = num_zeros / (2.0 * cutoff)
    out = np.zeros(n_out, np.float64)
    xpad = x.astype(np.float64)
    for p in range(out_p):
        # output samples m = p, p + out_p, ... ; input-center for phase p
        center = p * in_p / out_p
        lo = int(np.ceil(center - width * in_rate))
        hi = int(np.floor(center + width * in_rate))
        taps = np.arange(lo, hi + 1)
        wt = _filter_func(taps / in_rate - p / out_rate, cutoff,
                          num_zeros) / in_rate
        m = np.arange(p, n_out, out_p)
        base = (m - p) // out_p * in_p
        idx = base[:, None] + taps[None, :]
        valid = (idx >= 0) & (idx < n_in)
        vals = np.where(valid, xpad[np.clip(idx, 0, n_in - 1)], 0.0)
        out[m] = vals @ wt
    return out


def _resample_lags(nccf: np.ndarray, first_lag: int, resample_freq: float,
                   lags: np.ndarray, num_zeros: int) -> np.ndarray:
    """ArbitraryResample of the NCCF (sampled at integer lags of the
    downsampled signal) onto the geometric lag grid.  nccf: [T, L]."""
    cutoff = resample_freq * 0.5
    width = num_zeros / (2.0 * cutoff)
    n = nccf.shape[1]
    weights = np.zeros((len(lags), n))
    for i, lag in enumerate(lags):
        taps = np.arange(n)
        dt = (taps + first_lag) / resample_freq - lag
        weights[i] = np.where(np.abs(dt) <= width,
                              _filter_func(dt, cutoff, num_zeros), 0.0)
    weights /= resample_freq
    return nccf @ weights.T


# ---------------------------------------------------------------------------
# Viterbi with quadratic transition cost — O(N) lower envelope per frame
# ---------------------------------------------------------------------------

def _quadratic_min_conv(prev: np.ndarray, factor: float):
    """For each i: min_j prev[j] + factor*(i-j)^2, plus the argmin —
    Felzenszwalb-Huttenlocher distance transform (exact, O(N))."""
    n = len(prev)
    v = np.zeros(n, np.int64)      # parabola centers
    z = np.zeros(n + 1)            # envelope boundaries
    k = 0
    v[0] = 0
    z[0], z[1] = -np.inf, np.inf
    inv = 1.0 / factor
    for q in range(1, n):
        while True:
            s = ((prev[q] - prev[v[k]]) * inv + q * q - v[k] * v[k]) / \
                (2.0 * (q - v[k]))
            if s <= z[k]:
                k -= 1
            else:
                break
        k += 1
        v[k] = q
        z[k], z[k + 1] = s, np.inf
    out = np.empty(n)
    arg = np.empty(n, np.int64)
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        arg[q] = v[k]
        out[q] = factor * (q - v[k]) ** 2 + prev[v[k]]
    return out, arg


def compute_kaldi_pitch(wave: np.ndarray,
                        opts: Optional[PitchOptions] = None) -> np.ndarray:
    """→ [T, 2] float32: column 0 = NCCF (POV version, no ballast) at the
    Viterbi lag, column 1 = pitch in Hz (compute-kaldi-pitch-feats)."""
    if opts is None:
        opts = PitchOptions()
    wave = np.asarray(wave, np.float64).reshape(-1)
    fs = opts.resample_freq
    down = _linear_resample(wave, opts.samp_freq, fs, opts.lowpass_cutoff,
                            opts.lowpass_filter_width)
    shift = int(round(fs * opts.frame_shift_ms / 1000.0))
    basic = int(round(fs * opts.frame_length_ms / 1000.0))
    first_lag = int(math.ceil(fs / opts.max_f0))
    last_lag = int(math.floor(fs / opts.min_f0))
    full = basic + last_lag
    n = len(down)
    if n < basic:
        return np.zeros((0, 2), np.float32)
    num_frames = 1 + (n - basic) // shift

    # frame matrix [T, full], zero-padded at the tail (the reference
    # zero-pads windows that extend past the end once input is finished)
    padded = np.concatenate([down, np.zeros(full, np.float64)])
    idx = (np.arange(num_frames)[:, None] * shift +
           np.arange(full)[None, :])
    frames = padded[idx]
    # mean of the BASIC window subtracted from the whole outer window
    # (pitch-functions.cc:107-111)
    frames = frames - frames[:, :basic].mean(axis=1, keepdims=True)

    w1 = frames[:, :basic]
    e1 = np.einsum("ij,ij->i", w1, w1)
    n_lags = last_lag - first_lag + 1
    inner = np.empty((num_frames, n_lags))
    norm = np.empty((num_frames, n_lags))
    for li, lag in enumerate(range(first_lag, last_lag + 1)):
        w2 = frames[:, lag:lag + basic]
        inner[:, li] = np.einsum("ij,ij->i", w1, w2)
        norm[:, li] = e1 * np.einsum("ij,ij->i", w2, w2)

    mean_square = float(np.mean(down ** 2) - np.mean(down) ** 2)
    ballast_pitch = (mean_square * basic) ** 2 * opts.nccf_ballast
    with np.errstate(invalid="ignore"):
        nccf_pitch = np.where(norm + ballast_pitch > 0,
                              inner / np.sqrt(norm + ballast_pitch), 0.0)
        nccf_pov = np.where(norm > 0, inner / np.sqrt(norm), 0.0)

    # geometric lag grid (SelectLags)
    lag_list = []
    lag = 1.0 / opts.max_f0
    while lag <= 1.0 / opts.min_f0:
        lag_list.append(lag)
        lag *= 1.0 + opts.delta_pitch
    lags = np.asarray(lag_list)
    nccf_pitch_r = _resample_lags(nccf_pitch, first_lag, fs, lags,
                                  opts.upsample_filter_width)
    nccf_pov_r = _resample_lags(nccf_pov, first_lag, fs, lags,
                                opts.upsample_filter_width)

    # Viterbi
    factor = (math.log(1.0 + opts.delta_pitch) ** 2) * opts.penalty_factor
    local = 1.0 - nccf_pitch_r * (1.0 - opts.soft_min_f0 * lags[None, :])
    fwd = local[0].copy()
    back = np.zeros((num_frames, len(lags)), np.int64)
    for t in range(1, num_frames):
        best, arg = _quadratic_min_conv(fwd, factor)
        fwd = best + local[t]
        fwd -= fwd.min()          # renormalize (reference does the same)
        back[t] = arg
    state = int(np.argmin(fwd))
    out = np.zeros((num_frames, 2), np.float32)
    for t in range(num_frames - 1, -1, -1):
        out[t, 0] = nccf_pov_r[t, state]
        out[t, 1] = 1.0 / lags[state]
        state = int(back[t, state])
    return out


# ---------------------------------------------------------------------------
# post-processing (OnlineProcessPitch, offline application)
# ---------------------------------------------------------------------------

def _nccf_to_pov_feature(n: np.ndarray) -> np.ndarray:
    n = np.clip(n, -1.0, 1.0)
    return np.power(1.0001 - n, 0.15) - 1.0


def _nccf_to_pov(n: np.ndarray) -> np.ndarray:
    """NCCF → probability of voicing (pitch-functions.cc:78-88)."""
    nd = np.clip(np.abs(n), 0.0, 1.0)
    r = (-5.2 + 5.4 * np.exp(7.5 * (nd - 1.0)) + 4.8 * nd
         - 2.0 * np.exp(-10.0 * nd) + 4.2 * np.exp(20.0 * (nd - 1.0)))
    return 1.0 / (1.0 + np.exp(-r))


def process_pitch(raw: np.ndarray,
                  opts: Optional[ProcessPitchOptions] = None,
                  seed: int = 0) -> np.ndarray:
    """[T,2] (nccf, pitch Hz) → processed features, column order
    (pov-feature, normalized-log-pitch, delta-pitch, raw-log-pitch) for
    the enabled outputs — process-kaldi-pitch-feats."""
    if opts is None:
        opts = ProcessPitchOptions()
    raw = np.asarray(raw, np.float64)
    t = raw.shape[0]
    if t == 0:
        dim = sum([opts.add_pov_feature, opts.add_normalized_log_pitch,
                   opts.add_delta_pitch, opts.add_raw_log_pitch])
        return np.zeros((0, dim), np.float32)
    nccf, pitch = raw[:, 0], raw[:, 1]
    log_pitch = np.log(np.maximum(pitch, 1e-10))
    cols = []
    if opts.add_pov_feature:
        cols.append(opts.pov_scale * _nccf_to_pov_feature(nccf)
                    + opts.pov_offset)
    if opts.add_normalized_log_pitch:
        pov = _nccf_to_pov(nccf)
        wpl = pov * log_pitch
        cp = np.concatenate([[0.0], np.cumsum(pov)])
        cwl = np.concatenate([[0.0], np.cumsum(wpl)])
        lo = np.maximum(0, np.arange(t) - opts.normalization_left_context)
        hi = np.minimum(t, np.arange(t) + opts.normalization_right_context
                        + 1)
        avg = (cwl[hi] - cwl[lo]) / np.maximum(cp[hi] - cp[lo], 1e-20)
        cols.append((log_pitch - avg) * opts.pitch_scale)
    if opts.add_delta_pitch:
        w = opts.delta_window
        scale = 1.0 / sum(2 * k * k for k in range(1, w + 1))
        delta = np.zeros(t)
        for k in range(1, w + 1):
            plus = log_pitch[np.minimum(np.arange(t) + k, t - 1)]
            minus = log_pitch[np.maximum(np.arange(t) - k, 0)]
            delta += k * (plus - minus)
        delta *= scale
        rng = np.random.default_rng(seed)
        noise = rng.standard_normal(t) * opts.delta_pitch_noise_stddev
        cols.append((delta + noise) * opts.delta_pitch_scale)
    if opts.add_raw_log_pitch:
        cols.append(log_pitch)
    return np.stack(cols, axis=1).astype(np.float32)


def compute_and_process_pitch(
        wave: np.ndarray, opts: Optional[PitchOptions] = None,
        popts: Optional[ProcessPitchOptions] = None,
        seed: int = 0) -> np.ndarray:
    """wave → final pitch features (the compute | process pipeline)."""
    return process_pitch(compute_kaldi_pitch(wave, opts), popts, seed=seed)
