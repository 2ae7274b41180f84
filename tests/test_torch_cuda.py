"""The port's CUDA kernels: their build layer (on any machine) and,
on the card, each kernel and the served slice against the plain PyTorch
versions on the same inputs on the card.

These import neither jax nor kaldi_ctc_tpu, so they also run on a machine
without JAX: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Without a CUDA device the ``cuda``-marked cases skip (the ``cuda`` fixture
decides at run time, never at import).
"""

import os
import stat

import numpy as np
import pytest
import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.features import stft_cuda
from kaldi_ctc_tpu_torch.features.mel import MelOptions, mel_banks
from kaldi_ctc_tpu_torch.features.window import FrameOptions, feature_window
from kaldi_ctc_tpu_torch.ops import rnn_cuda

# K4: the kernel sums the DFT directly in f32 where the plain version
# uses cuFFT; both are IEEE f32, the order of the sums differs.  2e-4 is
# the tolerance the JAX package holds its own Pallas kernel to against
# its XLA path (tests/test_features.py TestPallasStft).
LOG_MEL_TOL = 2e-4
# K2 f32: the same f32 math with another summation order over H terms
# per step, compounded over T steps of a contracting recurrence.
BILSTM_F32_TOL = 2e-5
# K2 bf16: y is stored in bf16 (ulp 2^-8 near 1) and h enters each step
# rounded to bf16, so one flipped rounding moves later steps by ~1 ulp;
# the JAX package holds its bf16 Pallas path to its scan path at 2e-2.
BILSTM_BF16_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("num_frames", [1, 37, 798])
def test_log_mel_kernel_matches_plain(cuda, num_frames):
    fo = FrameOptions()
    rng = np.random.default_rng(num_frames)
    frames = torch.as_tensor(
        (rng.standard_normal((num_frames, fo.window_size)) * 1000)
        .astype(np.float32), device=cuda)
    window = torch.as_tensor(feature_window(fo), device=cuda)
    mel = torch.as_tensor(mel_banks(
        MelOptions(num_bins=40, low_freq=20.0, high_freq=-400.0), fo),
        device=cuda)
    before = stft_cuda.log_mel.launches
    got, got_e = stft_cuda.log_mel(frames, window, mel,
                                   fo.padded_window_size)
    torch.cuda.synchronize()
    assert stft_cuda.log_mel.launches == before + 1
    ref, ref_e = stft_cuda.log_mel_reference(frames, window, mel,
                                             fo.padded_window_size)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)
    np.testing.assert_allclose(got_e.cpu().numpy(), ref_e.cpu().numpy(),
                               rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)


@pytest.mark.cuda
def test_log_mel_kernel_options(cuda):
    """Magnitude spectrum, no log, no DC removal, no preemphasis."""
    fo = FrameOptions()
    rng = np.random.default_rng(7)
    frames = torch.as_tensor((rng.standard_normal((9, fo.window_size))
                              * 100 + 30).astype(np.float32), device=cuda)
    window = torch.as_tensor(feature_window(fo), device=cuda)
    mel = torch.as_tensor(mel_banks(MelOptions(), fo), device=cuda)
    kw = dict(remove_dc=False, preemph=0.0, use_power=False, use_log=False)
    got, got_e = stft_cuda.log_mel(frames, window, mel,
                                   fo.padded_window_size, **kw)
    ref, ref_e = stft_cuda.log_mel_reference(frames, window, mel,
                                             fo.padded_window_size, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)
    np.testing.assert_allclose(got_e.cpu().numpy(), ref_e.cpu().numpy(),
                               rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)


def _bilstm_inputs(t, b, h, dtype, device, seed):
    rng = np.random.default_rng(seed)
    xp = torch.as_tensor(rng.standard_normal((t, b, 8 * h))
                         .astype(np.float32), device=device).to(dtype)
    w_f = torch.as_tensor((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                          .astype(np.float32), device=device).to(dtype)
    w_b = torch.as_tensor((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                          .astype(np.float32), device=device).to(dtype)
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(0, t + 1, size=b - 1)   # row 0 full length
    return xp, w_f, w_b, torch.as_tensor(lens, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, BILSTM_F32_TOL),
                                       (torch.bfloat16, BILSTM_BF16_TOL)])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (16, 3, 128), (40, 2, 320)])
def test_bilstm_kernel_matches_plain(cuda, dtype, tol, t, b, h):
    xp, w_f, w_b, lens = _bilstm_inputs(t, b, h, dtype, cuda, seed=h + t)
    before = rnn_cuda.bilstm_seq_fwd.launches
    got = rnn_cuda.bilstm_seq_fwd(xp, w_f, w_b, lens)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_fwd.launches == before + 1
    ref = rnn_cuda.bilstm_seq_fwd_reference(xp, w_f, w_b, lens)
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(),
                                   rtol=0, atol=tol, err_msg=name)
    # pad frames write y = 0
    lens_np = lens.cpu().numpy()
    for row, n in enumerate(lens_np):
        assert not got[0][n:, row].any() and not got[2][n:, row].any()


@pytest.mark.cuda
def test_bilstm_kernel_rejects_bad_inputs(cuda):
    xp, w_f, w_b, lens = _bilstm_inputs(4, 2, 16, torch.float32, cuda, 0)
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_seq_fwd(xp, w_f.to(torch.bfloat16), w_b, lens)
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_seq_fwd(xp, w_f, w_b, lens,
                                y_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_seq_fwd(xp[:, :, :-8], w_f, w_b, lens)


@pytest.mark.cuda
def test_log_mel_kernel_rejects_bad_inputs(cuda):
    fo = FrameOptions()
    frames = torch.zeros((5, fo.window_size), device=cuda)
    window = torch.as_tensor(feature_window(fo), device=cuda)
    mel = torch.as_tensor(mel_banks(MelOptions(), fo), device=cuda)
    with pytest.raises(ValueError):       # not contiguous
        stft_cuda.log_mel(frames.T.contiguous().T, window, mel, 512)
    with pytest.raises(ValueError):       # window on the CPU
        stft_cuda.log_mel(frames, window.cpu(), mel, 512)
    with pytest.raises(ValueError):       # f64 frames
        stft_cuda.log_mel(frames.double(), window, mel, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_slice_on_cuda_matches_plain(cuda, dtype, tmp_path):
    """The serving engine on the card goes through both kernels (5 K2
    launches for 5 layers, K4 once) and agrees with the same engine on
    the CPU, where the plain versions run."""
    from kaldi_ctc_tpu_torch.cli import serve
    from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig,
                                                     default_priors,
                                                     init_am_params)
    from kaldi_ctc_tpu_torch.models.artifact import save_inference_artifact

    cfg = AmConfig(input_dim=40, num_targets=9, hidden_dim=32, num_layers=5,
                   compute_dtype=dtype)
    path = str(tmp_path / "m.npz")
    save_inference_artifact(path, init_am_params(
        cfg, torch.Generator().manual_seed(0)), cfg, default_priors(9))
    gpu = serve.Engine(serve.parse_args(["--model", path]))
    cpu = serve.Engine(serve.parse_args(["--model", path, "--device", "cpu"]))
    rng = np.random.default_rng(1)
    x = (np.cumsum(rng.standard_normal(16000)) * 50).astype(np.float32)
    k2, k4 = rnn_cuda.bilstm_seq_fwd.launches, stft_cuda.log_mel.launches
    out = gpu.recognize(x)
    assert rnn_cuda.bilstm_seq_fwd.launches - k2 == 5
    assert stft_cuda.log_mel.launches - k4 == 1
    assert out["num_frames"] == 98
    feats = gpu.feats_for(x)
    np.testing.assert_allclose(feats.cpu().numpy(),
                               cpu.feats_for(x).numpy(), rtol=LOG_MEL_TOL,
                               atol=LOG_MEL_TOL)
    tol = BILSTM_F32_TOL * 10 if dtype == "float32" else 5e-2
    for g, c in zip(gpu.score_utt(feats), cpu.score_utt(feats.cpu())):
        np.testing.assert_allclose(g, c, rtol=0, atol=tol)


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """_kernels with its source and build directories in tmp_path and a
    fake nvcc that records each call and writes an empty library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 1 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n"
                    "grep -q FAIL \"$1\" && echo 'error: bad' >&2 && exit 1\n"
                    "exit 0\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_kernels, "_CSRC", str(csrc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    return csrc / "k.cu", log


def test_build_is_keyed_by_source_hash(fake_build):
    src, log = fake_build
    first = _kernels.build("k")
    assert os.path.exists(first) and "sm_90a" in log.read_text()
    assert _kernels.build("k") == first              # cached: no rebuild
    assert len(log.read_text().splitlines()) == 1
    src.write_text("// v2\n")
    second = _kernels.build("k")                     # edited: rebuilt
    assert second != first and os.path.exists(second)
    assert len(log.read_text().splitlines()) == 2


def test_build_failure_raises_with_compiler_output(fake_build):
    src, _ = fake_build
    src.write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="error: bad"):
        _kernels.build("k")
    assert not os.listdir(_kernels.BUILD_DIR)       # nothing half-written


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._nvcc()
