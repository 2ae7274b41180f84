"""The one traffic generator: utterance pools and request schedules from a
traffic file and a seed.

Every seed gets the same multiset of sizes and gaps: lengths are the
quantiles (i + 0.5) / n of the traffic file's length histogram, phone
rates and inter-arrival gaps likewise, and the seed only permutes them
and draws the contents (features, alignments, waveforms).  So two seeds
do the same work in another order, and a run's work is fixed by the
traffic file.  Numpy only: nothing here imports torch or the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

__all__ = ["Utterance", "rng_for", "histogram_quantiles", "train_pool",
           "utterance_alignment", "utterance_features", "Request",
           "request_schedule", "pcm_pool", "request_pcm",
           "subsampled_frames"]

PART_IDS = {"train": 1, "valid": 2, "pcm": 3, "requests": 4}


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one stream of one seed (any integer
    seed; negative ones are folded into 64 bits)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def histogram_quantiles(bins: Sequence[Sequence[float]], n: int
                        ) -> np.ndarray:
    """The values at quantiles (i + 0.5) / n, i < n, of a piecewise-uniform
    density given as [lo, hi, weight] bins (weights need not sum to 1)."""
    lo = np.array([b[0] for b in bins], np.float64)
    hi = np.array([b[1] for b in bins], np.float64)
    w = np.array([b[2] for b in bins], np.float64)
    if n <= 0:
        return np.zeros(0)
    if np.any(hi <= lo) or np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"bad length bins {bins}")
    cdf = np.concatenate([[0.0], np.cumsum(w / w.sum())])
    q = (np.arange(n) + 0.5) / n
    k = np.clip(np.searchsorted(cdf, q, side="right") - 1, 0, len(w) - 1)
    frac = (q - cdf[k]) / np.maximum(cdf[k + 1] - cdf[k], 1e-300)
    return lo[k] + frac * (hi[k] - lo[k])


@dataclasses.dataclass(frozen=True)
class Utterance:
    """One training utterance: its key, index in its part, raw frame
    count and phone count (the collapsed label length)."""

    key: str
    part: str
    index: int
    frames: int
    phones: int

    @property
    def seconds(self) -> float:
        return self.frames / 100.0


def train_pool(traffic: dict, seed: int, part: str = "train"
               ) -> List[Utterance]:
    """The training (or valid) utterances, in the order their archives
    hold them.  Lengths: the histogram's quantiles for each speed factor
    (a factor f plays the utterance 1/f as long), so every seed has the
    same lengths; the seed permutes them and the phone rates."""
    n = int(traffic["utterances" if part == "train" else "valid_utterances"])
    factors = list(traffic.get("speed_factors", [1.0]))
    fps = float(traffic.get("frames_per_s", 100))
    per = [n // len(factors) + (1 if i < n % len(factors) else 0)
           for i in range(len(factors))]
    secs = np.concatenate([
        histogram_quantiles(traffic["length_bins_s"], m) / f
        for m, f in zip(per, factors)])
    lo, hi = traffic["phones_per_s"]
    rates = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    rng = rng_for(seed, PART_IDS[part], 0)
    secs = secs[rng.permutation(n)]
    rates = rates[rng.permutation(n)]
    out = []
    for i in range(n):
        frames = max(int(round(secs[i] * fps)), 1)
        phones = max(int(round(secs[i] * rates[i])), 1)
        out.append(Utterance(f"{part}{i:06d}", part, i, frames, phones))
    return out


def utterance_alignment(u: Utterance, traffic: dict, seed: int
                        ) -> np.ndarray:
    """Per-frame pdf ids [frames] int32: ``phones`` segments of random
    lengths, no two neighbours the same pdf (so the collapsed label
    sequence has exactly ``phones`` labels)."""
    rng = rng_for(seed, PART_IDS[u.part], 1, u.index)
    num_pdfs = int(traffic["num_pdfs"])
    phones = min(u.phones, u.frames)
    cuts = np.sort(rng.choice(np.arange(1, u.frames), phones - 1,
                              replace=False)) if phones > 1 else np.zeros(0)
    bounds = np.concatenate([[0], cuts, [u.frames]]).astype(np.int64)
    ids = np.empty(phones, np.int32)
    ids[0] = rng.integers(num_pdfs)
    # a step of 1..num_pdfs-1 modulo num_pdfs never repeats a neighbour
    steps = rng.integers(1, num_pdfs, size=phones - 1)
    ids[1:] = (ids[0] + np.cumsum(steps)) % num_pdfs
    return np.repeat(ids, np.diff(bounds)).astype(np.int32)


def utterance_features(u: Utterance, seed: int, dim: int) -> np.ndarray:
    """Features [frames, dim] f32: unit Gaussian, as CMVN'd MFCCs are to
    first and second order."""
    rng = rng_for(seed, PART_IDS[u.part], 2, u.index)
    return rng.standard_normal((u.frames, dim), dtype=np.float32)


def subsampled_frames(frames: int, factor: int, shift: int) -> int:
    """Frames left by frame subsampling at ``shift`` (frames shift,
    shift + factor, ...; all of them when none would be left)."""
    if factor <= 1:
        return frames
    n = len(range(shift, frames, factor))
    return n if n else frames


@dataclasses.dataclass(frozen=True)
class Request:
    """One /recognize request: due ``offset_s`` after the window opens,
    ``samples`` long, cut from the seed's PCM pool at ``start``."""

    index: int
    offset_s: float
    samples: int
    start: int


def request_schedule(traffic: dict, seed: int, seconds: float
                     ) -> List[Request]:
    """round(rate * seconds) requests due in [0, seconds): lengths are the
    histogram's quantiles and gaps the exponential's (Poisson arrivals),
    each permuted by the seed, the gaps scaled to fill the window."""
    rate = float(traffic["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    sr = int(traffic["sample_rate"])
    rng = rng_for(seed, PART_IDS["requests"], 0)
    secs = histogram_quantiles(traffic["length_bins_s"], n)[rng.permutation(n)]
    q = (np.arange(n) + 0.5) / n
    gaps = (-np.log1p(-q) / rate)[rng.permutation(n)]
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    offsets *= seconds / gaps.sum()
    pool = int(float(traffic["pcm_pool_s"]) * sr)
    out = []
    for i in range(n):
        samples = min(int(round(secs[i] * sr)), pool)
        start = int(rng.integers(0, pool - samples + 1))
        out.append(Request(i, float(offsets[i]), samples, start))
    return out


def pcm_pool(traffic: dict, seed: int) -> np.ndarray:
    """The seed's PCM pool, int16 [pcm_pool_s * sample_rate]: Gaussian
    noise under a syllable-rate envelope (4 Hz), at ``pcm_rms``."""
    sr = int(traffic["sample_rate"])
    n = int(float(traffic["pcm_pool_s"]) * sr)
    rng = rng_for(seed, PART_IDS["pcm"], 0)
    noise = rng.standard_normal(n)
    t = np.arange(n) / sr
    phase = rng.uniform(0, 2 * math.pi)
    env = 0.35 + 0.65 * np.abs(np.sin(2 * math.pi * 2.0 * t + phase))
    pcm = noise * env * (float(traffic["pcm_rms"]) / np.sqrt(np.mean(env ** 2)))
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int16)


def request_pcm(pool: np.ndarray, r: Request) -> np.ndarray:
    return pool[r.start:r.start + r.samples]
