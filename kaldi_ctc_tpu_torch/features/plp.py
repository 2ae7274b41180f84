"""PLP features (reference: src/feat/feature-plp.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/plp.py``, on the
waveform's device.  The per-frame chain (PlpComputer::Compute,
feature-plp.cc:112-187): power spectrum → mel filterbank →
equal-loudness weighting → power-law compression (^compress_factor) →
duplicate edge bins → inverse DFT to autocorrelation → Levinson-Durbin
LPC → LPC-to-cepstrum → liftering → scaling → energy/C0 handling.

Everything up to the autocorrelation is f32 matmuls over the whole
utterance (TF32 is off); the Durbin and cepstrum recursions are short
loops over the LPC order (12 steps), each step vectorized over frames in
the JAX package's order of operations.  No kernel: the JAX package
computes PLP in XLA ops, not through its Pallas log-mel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from kaldi_ctc_tpu_torch.features.mel import (MelOptions, mel_banks,
                                              mel_center_freqs)
from kaldi_ctc_tpu_torch.features.mfcc import lifter_coeffs
from kaldi_ctc_tpu_torch.features.window import (
    FrameOptions,
    feature_window,
    frame_signal,
    padded_power_spectrum,
    process_frames,
)

__all__ = ["PlpOptions", "compute_plp", "equal_loudness_vector",
           "idft_bases", "durbin_lpc", "lpc_to_cepstrum"]


@dataclasses.dataclass(frozen=True)
class PlpOptions:
    """Mirror of PlpOptions (feature-plp.h:43-96); defaults match the
    reference's (23 mel bins, LPC order 12, 13 cepstra)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions(num_bins=23)
    lpc_order: int = 12
    num_ceps: int = 13              # including C0
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False

    @property
    def dim(self) -> int:
        return self.num_ceps


def equal_loudness_vector(opts: MelOptions, frame_opts: FrameOptions,
                          vtln_warp: float = 1.0) -> np.ndarray:
    """Equal-loudness preemphasis curve over the mel bin center
    frequencies (GetEqualLoudnessVector, mel-computations.cc:313-325)."""
    f0 = mel_center_freqs(opts, frame_opts, vtln_warp).astype(np.float64)
    fsq = f0 * f0
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(
        np.float32)


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """[n_bases, dimension] inverse-DFT basis matrix (InitIdftBases,
    feature-functions.cc:188-203): row i maps the duplicated compressed
    mel spectrum to autocorrelation coefficient i."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def durbin_lpc(autocorr, order: int):
    """Levinson-Durbin over a batch of frames.

    autocorr: [N, order+1] → (lpc [N, order], residual energy E [N]), on
    autocorr's device (numpy in → torch on the CPU).  Mirror of Durbin
    (mel-computations.cc:269-300) incl. its 1e-5 floor on (1-k^2); the
    loop is over the LPC order only, each step vectorized over frames.
    """
    autocorr = torch.as_tensor(autocorr)
    dev = autocorr.device
    n_frames = autocorr.shape[0]
    lp = torch.zeros((n_frames, order), dtype=autocorr.dtype, device=dev)
    e = autocorr[:, 0]
    j = torch.arange(order, device=dev)
    zero = torch.zeros((), dtype=autocorr.dtype, device=dev)
    for i in range(order):
        # k_i = (r[i+1] + sum_{j<i} lp[j] * r[i-j]) / E
        idx = i - j                          # r index i-j for j=0..order-1
        r_rev = torch.where((idx >= 1) & (j < i),
                            autocorr[:, torch.clamp(idx, 0, order)], zero)
        ki = (autocorr[:, i + 1] + torch.sum(lp * r_rev, dim=1)) / e
        c = torch.clamp_min(1.0 - ki * ki, 1.0e-5)
        e = e * c
        # lp'[j] = lp[j] - k*lp[i-j-1] for j<i;  lp'[i] = -k
        rev_idx = i - j - 1
        lp_rev = torch.where((rev_idx >= 0) & (j < i),
                             lp[:, torch.clamp(rev_idx, 0, order - 1)], zero)
        new = lp - ki[:, None] * lp_rev
        new[:, i] = -ki
        lp = torch.where(j[None, :] <= i, new, lp)
    return lp, e


def lpc_to_cepstrum(lpc):
    """[N, order] LPC → [N, order] cepstra (Lpc2Cepstrum,
    mel-computations.cc:302-311): c[i] = -a[i] - 1/(i+1) *
    sum_{j<i} (i-j) a[j] c[i-j-1]; sequential in i, vectorized over
    frames."""
    lpc = torch.as_tensor(lpc)
    dev = lpc.device
    n_frames, order = lpc.shape
    cep = torch.zeros((n_frames, order), dtype=lpc.dtype, device=dev)
    j = torch.arange(order, device=dev)
    zero = torch.zeros((), dtype=lpc.dtype, device=dev)
    for i in range(order):
        back = i - j - 1                     # c index i-j-1 for j<i
        c_rev = torch.where((back >= 0) & (j < i),
                            cep[:, torch.clamp(back, 0, order - 1)], zero)
        w = torch.where(j < i, (i - j).to(lpc.dtype), zero)
        s = torch.sum(w[None, :] * lpc * c_rev, dim=1)
        cep[:, i] = -lpc[:, i] - s / (i + 1.0)
    return cep


def compute_plp(
    wave: torch.Tensor,
    opts: PlpOptions = PlpOptions(),
    generator: Optional[torch.Generator] = None,
    vtln_warp: float = 1.0,
) -> torch.Tensor:
    """PLPs for one waveform [num_samples] → [num_frames, num_ceps], on
    the waveform's device.  Dither only with a ``torch.Generator``.

    Matches PlpComputer::Compute (feature-plp.cc:112-187)."""
    if opts.num_ceps > opts.lpc_order + 1:
        raise ValueError("num_ceps must be <= lpc_order+1")
    fo = opts.frame_opts
    dev = wave.device
    eps = torch.finfo(torch.float32).eps
    tiny = torch.finfo(torch.float32).tiny
    window = torch.as_tensor(feature_window(fo), device=dev)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, fo, vtln_warp=vtln_warp),
                          device=dev)
    eql = torch.as_tensor(
        equal_loudness_vector(opts.mel_opts, fo, vtln_warp), device=dev)
    nb = opts.mel_opts.num_bins
    idft = torch.as_tensor(idft_bases(opts.lpc_order + 1, nb + 2),
                           device=dev)

    frames = frame_signal(wave, fo)
    need_raw = opts.use_energy and opts.raw_energy
    frames, raw_energy = process_frames(
        frames, fo, window, generator=generator, need_raw_energy=need_raw)
    if opts.use_energy and not opts.raw_energy:
        raw_energy = torch.log(torch.clamp_min((frames * frames).sum(1), eps))
    power = padded_power_spectrum(frames, fo)

    mel_energies = torch.matmul(power[:, :-1], mel.T)
    mel_energies = mel_energies * eql[None, :]
    mel_energies = torch.pow(torch.clamp_min(mel_energies, tiny),
                             opts.compress_factor)
    # duplicate first and last bins (feature-plp.cc:152-155)
    dup = torch.cat([mel_energies[:, :1], mel_energies,
                     mel_energies[:, -1:]], dim=1)
    autocorr = torch.matmul(dup, idft.T)

    lpc, resid_e = durbin_lpc(autocorr, opts.lpc_order)
    # C0 = -log(1/E) = log(E), floored (feature-plp.cc:166-170)
    resid = torch.log(torch.clamp_min(resid_e, tiny))
    cep = lpc_to_cepstrum(lpc)

    feats = torch.cat([resid[:, None], cep[:, :opts.num_ceps - 1]], dim=1)
    if opts.cepstral_lifter != 0.0:
        feats = feats * torch.as_tensor(
            lifter_coeffs(opts.cepstral_lifter, opts.num_ceps),
            device=dev)[None, :]
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale
    if opts.use_energy:
        energy = raw_energy
        if opts.energy_floor > 0.0:
            energy = torch.clamp_min(energy, float(np.log(opts.energy_floor)))
        feats[:, 0] = energy
    if opts.htk_compat:
        # energy/C0 last (feature-plp.cc:179-187); unlike MFCC there is
        # no sqrt(2) factor
        feats = torch.cat([feats[:, 1:], feats[:, :1]], dim=1)
    return feats
