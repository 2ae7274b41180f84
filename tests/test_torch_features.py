"""The port's feature front end held to the JAX package's, per module:
window/framing, the fused log-mel stage (K4's plain version against
``log_mel_pallas`` in interpret mode), MFCC and fbank against both JAX
implementations, CMVN, and the host-only copies (wave, resample).
Inputs are made with numpy from a seed and fed to both packages."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.features import (FbankOptions as JFbankOptions,
                                    MfccOptions as JMfccOptions,
                                    compute_fbank as j_fbank,
                                    compute_mfcc as j_mfcc)
from kaldi_ctc_tpu_torch.features import (FbankOptions, FrameOptions,
                                          MelOptions, MfccOptions,
                                          compute_fbank, compute_mfcc,
                                          frame_signal, mel_banks)
from kaldi_ctc_tpu_torch.features import stft_cuda
from kaldi_ctc_tpu_torch.features.window import feature_window

# The port's CPU path is rFFT + f32 matmuls, like JAX's "xla" path; the
# Pallas kernel (interpret mode) sums the DFT as a matmul.  2e-4 is the
# tolerance the JAX package holds its own two implementations to
# (tests/test_features.py TestPallasStft).
FEAT_TOL = 2e-4


def _wave(seconds, seed, scale=1000.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * scale).astype(
        np.float32)


def _jax_opts(opts):
    """The JAX package's option dataclass with the same field values."""
    import dataclasses

    from kaldi_ctc_tpu.features import FrameOptions as JF, MelOptions as JM
    kind = JMfccOptions if isinstance(opts, MfccOptions) else JFbankOptions
    fields = dataclasses.asdict(opts)
    fields["frame_opts"] = JF(**fields["frame_opts"])
    fields["mel_opts"] = JM(**fields["mel_opts"])
    return kind(**fields)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name", ["hires", "default"])
def test_mfcc_matches_jax(name, impl):
    wave = _wave(1.0, seed=1, scale=500.0)
    opts = MfccOptions.hires() if name == "hires" else MfccOptions()
    got = compute_mfcc(torch.as_tensor(wave), opts).numpy()
    ref = np.asarray(j_mfcc(jnp.asarray(wave), _jax_opts(opts),
                            implementation=impl))
    assert got.shape == ref.shape == (98, opts.num_ceps)
    np.testing.assert_allclose(got, ref, rtol=FEAT_TOL, atol=FEAT_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("use_energy,use_log", [(False, True), (True, True),
                                                (True, False)])
def test_fbank_matches_jax(use_energy, use_log, impl):
    wave = _wave(0.6, seed=2)
    opts = FbankOptions(use_energy=use_energy, use_log_fbank=use_log)
    got = compute_fbank(torch.as_tensor(wave), opts).numpy()
    ref = np.asarray(j_fbank(jnp.asarray(wave), _jax_opts(opts),
                             implementation=impl))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=FEAT_TOL, atol=FEAT_TOL)


@pytest.mark.parametrize("opts", [
    MfccOptions(mel_opts=MelOptions(htk_mode=True), htk_compat=True),
    MfccOptions(raw_energy=False, energy_floor=1.0),
    MfccOptions(frame_opts=FrameOptions(snip_edges=False,
                                        window_type="hamming")),
], ids=["htk", "windowed_energy", "reflect_edges"])
def test_mfcc_plain_path_options_match_jax(opts):
    """Options the fused path does not take (htk_mode, windowed energy)
    and the reflected framing, against JAX's XLA path."""
    wave = _wave(0.5, seed=3)
    got = compute_mfcc(torch.as_tensor(wave), opts).numpy()
    ref = np.asarray(j_mfcc(jnp.asarray(wave), _jax_opts(opts),
                            implementation="xla"))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=FEAT_TOL, atol=FEAT_TOL)


@pytest.mark.parametrize("num_frames", [23, 130])
def test_log_mel_reference_matches_pallas_interpret(num_frames):
    """K4's plain version against the TPU kernel it replaces, with F not
    a multiple of the kernel's 128-frame block."""
    from kaldi_ctc_tpu.features.stft_pallas import log_mel_pallas

    fo = FrameOptions()
    rng = np.random.default_rng(num_frames)
    frames = (rng.standard_normal((num_frames, fo.window_size)) * 300
              ).astype(np.float32)
    window = feature_window(fo)
    mel = mel_banks(MelOptions(num_bins=40, low_freq=20.0,
                               high_freq=-400.0), fo)
    got, got_e = stft_cuda.log_mel_reference(
        torch.as_tensor(frames), torch.as_tensor(window),
        torch.as_tensor(mel), fo.padded_window_size)
    ref, ref_e = log_mel_pallas(jnp.asarray(frames), jnp.asarray(window),
                                jnp.asarray(mel), fo.padded_window_size,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=FEAT_TOL, atol=FEAT_TOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e),
                               rtol=FEAT_TOL, atol=FEAT_TOL)


def test_log_mel_wrapper_takes_plain_version_on_cpu():
    fo = FrameOptions()
    frames = torch.as_tensor(_wave(0.1, 4)[:fo.window_size * 3].reshape(
        3, fo.window_size))
    window = torch.as_tensor(feature_window(fo))
    mel = torch.as_tensor(mel_banks(MelOptions(), fo))
    before = stft_cuda.log_mel.launches
    got = stft_cuda.log_mel(frames, window, mel, fo.padded_window_size)
    ref = stft_cuda.log_mel_reference(frames, window, mel,
                                      fo.padded_window_size)
    assert stft_cuda.log_mel.launches == before   # no kernel on the CPU
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_dft_tables_equal_jax():
    from kaldi_ctc_tpu.features.stft_pallas import dft_tables as j_tables
    for a, b in zip(stft_cuda.dft_tables(400, 512, 256),
                    j_tables(400, 512, 256)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("snip", [True, False])
def test_frame_signal_matches_jax(snip):
    from kaldi_ctc_tpu.features.window import (FrameOptions as JF,
                                               frame_signal as j_frame)
    wave = _wave(0.2, seed=5)
    got = frame_signal(torch.as_tensor(wave), FrameOptions(snip_edges=snip))
    ref = j_frame(jnp.asarray(wave), JF(snip_edges=snip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dither_only_with_generator():
    wave = torch.as_tensor(_wave(0.3, seed=6))
    opts = MfccOptions()
    a, b = compute_mfcc(wave, opts), compute_mfcc(wave, opts)
    assert torch.equal(a, b)
    d1 = compute_mfcc(wave, opts, generator=torch.Generator().manual_seed(1))
    d2 = compute_mfcc(wave, opts, generator=torch.Generator().manual_seed(1))
    assert torch.equal(d1, d2) and not torch.equal(a, d1)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_cmvn_matches_jax(norm_vars):
    from kaldi_ctc_tpu.features.cmvn import (acc_cmvn_stats as j_acc,
                                             apply_cmvn as j_apply)
    from kaldi_ctc_tpu_torch.features import acc_cmvn_stats, apply_cmvn
    rng = np.random.default_rng(7)
    feats = (rng.standard_normal((20, 6)) * 3 + 1).astype(np.float32)
    stats = acc_cmvn_stats(torch.as_tensor(feats))
    np.testing.assert_array_equal(stats, j_acc(feats))
    got = apply_cmvn(torch.as_tensor(feats), stats, norm_vars=norm_vars)
    ref = j_apply(jnp.asarray(feats), stats, norm_vars=norm_vars)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_wave_and_resample_copies_match_jax(tmp_path):
    from kaldi_ctc_tpu.features.resample import resample as j_resample
    from kaldi_ctc_tpu.features.wave import read_wave as j_read
    from kaldi_ctc_tpu_torch.features import read_wave
    from kaldi_ctc_tpu_torch.features.resample import resample
    pcm = (_wave(0.1, seed=8, scale=3000.0)).astype("<i2")
    data = pcm.tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 16000, 2, 16)
           + b"data" + struct.pack("<I", len(data)))
    path = tmp_path / "a.wav"
    path.write_bytes(hdr + data)
    (s, r), (js, jr) = read_wave(str(path)), j_read(str(path))
    assert r == jr == 8000.0
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(resample(s[0], 8000, 16000),
                                  j_resample(js[0], 8000, 16000))
