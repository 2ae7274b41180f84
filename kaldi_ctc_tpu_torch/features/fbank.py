"""Log mel filterbank features (reference: src/feat/feature-fbank.{h,cc}).

PyTorch counterpart of ``kaldi_ctc_tpu/features/fbank.py``: gather-frame
→ :func:`stft_cuda.log_mel` (kernel K4 for a CUDA waveform, its plain
version for a CPU one).  htk_mode and non-raw energy take the plain
frame pipeline, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from kaldi_ctc_tpu_torch.features import stft_cuda
from kaldi_ctc_tpu_torch.features.mel import MelOptions, mel_banks
from kaldi_ctc_tpu_torch.features.mfcc import _floor_energy
from kaldi_ctc_tpu_torch.features.window import (
    FrameOptions,
    feature_window,
    frame_signal,
    padded_power_spectrum,
    process_frames,
)

__all__ = ["FbankOptions", "compute_fbank"]


@dataclasses.dataclass(frozen=True)
class FbankOptions:
    """Mirror of FbankOptions (feature-fbank.h:39-91)."""

    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True
    htk_compat: bool = False  # energy last, not first (feature-fbank.h:47)

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.use_energy else 0)


@functools.lru_cache(maxsize=16)
def _tables(opts: FbankOptions, vtln_warp: float, device: torch.device):
    fo = opts.frame_opts
    return (torch.as_tensor(feature_window(fo), device=device),
            torch.as_tensor(mel_banks(opts.mel_opts, fo, vtln_warp=vtln_warp),
                            device=device))


def compute_fbank(
    wave: torch.Tensor,
    opts: FbankOptions = FbankOptions(),
    generator: Optional[torch.Generator] = None,
    vtln_warp: float = 1.0,
) -> torch.Tensor:
    """Fbank features for one waveform [num_samples] → [num_frames, dim],
    on the waveform's device.

    Matches FbankComputer::Compute (feature-fbank.cc:72-126) with dither
    disabled unless a ``torch.Generator`` is supplied.
    """
    fo = opts.frame_opts
    window, mel = _tables(opts, float(vtln_warp), wave.device)
    frames = frame_signal(wave, fo)
    # the fused kernel computes the RAW (pre-window) energy only
    fused_ok = ((opts.raw_energy or not opts.use_energy)
                and not opts.mel_opts.htk_mode)
    if fused_ok and frames.shape[0] > 0:
        if fo.dither != 0.0 and generator is not None:
            frames = frames + fo.dither * torch.randn(
                frames.shape, generator=generator, dtype=frames.dtype,
                device=frames.device)
        mel_energies, raw_energy = stft_cuda.log_mel(
            frames, window, mel, fo.padded_window_size,
            remove_dc=fo.remove_dc_offset, preemph=fo.preemph_coeff,
            use_power=opts.use_power, use_log=opts.use_log_fbank)
        if opts.use_energy:
            return _with_energy(mel_energies,
                                _floor_energy(raw_energy, opts.energy_floor),
                                opts)
        return mel_energies
    need_raw = opts.use_energy and opts.raw_energy
    frames, raw_energy = process_frames(
        frames, fo, window, generator=generator, need_raw_energy=need_raw)
    power = padded_power_spectrum(frames, fo)
    eps = torch.finfo(torch.float32).eps
    if opts.use_energy and not opts.raw_energy:
        # Kaldi floors energy at float epsilon, not denormal-min
        raw_energy = torch.log(torch.clamp_min((frames * frames).sum(1), eps))
    if not opts.use_power:
        power = torch.sqrt(power)
    # bins are defined over fft bins [0, padded/2); drop the Nyquist bin
    mel_energies = torch.matmul(power[:, :-1], mel.T)
    if opts.mel_opts.htk_mode:
        # HTK-like flooring (mel-computations.cc:238)
        mel_energies = torch.clamp_min(mel_energies, 1.0)
    if opts.use_log_fbank:
        mel_energies = torch.log(torch.clamp_min(mel_energies, eps))
    if opts.use_energy:
        return _with_energy(mel_energies,
                            _floor_energy(raw_energy, opts.energy_floor),
                            opts)
    return mel_energies


def _with_energy(mel_energies: torch.Tensor, energy: torch.Tensor,
                 opts: FbankOptions) -> torch.Tensor:
    """Energy column first (Kaldi) or last (htk_compat),
    feature-fbank.cc:102-121."""
    if opts.htk_compat:
        return torch.cat([mel_energies, energy[:, None]], dim=1)
    return torch.cat([energy[:, None], mel_energies], dim=1)
