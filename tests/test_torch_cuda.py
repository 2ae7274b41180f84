"""The port's CUDA kernels: their build layer (on any machine) and,
on the card, each kernel, the served slice, the streaming engine, the
BLSTM layer's choice between K2/K3 and K10a/K10b, and the training steps
against the plain PyTorch versions on the same inputs on the card.

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
from kaldi_ctc_tpu_torch.ops import ctc, ctc_cuda, gru_cuda, rnn_cuda

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
# K1/K11/K12: the same f32 log-space sums as the plain loops, with the
# card's expf/log1pf where the plain version calls torch's; alphas and
# betas reach ~-3000 at T = 1250 (f32 ulp 2.4e-4).
CTC_RTOL, CTC_ATOL = 1e-5, 1e-4
# The CTC gradient holds state posteriors exp(alpha + beta - lp - log Z)
# whose exponent sums terms of ~-3000 at T = 1250: an f32 ulp there
# (2.4e-4) is that relative error in a posterior of up to 1.
CTC_GRAD_TOL = 5e-4
# K3 f32: dh and dc carried over T steps in another summation order (the
# partial-dh exchange sums per block, then over blocks).
BILSTM_BWD_F32_TOL = 1e-4
# K3 bf16: dgates are stored in bf16 and enter the dh product rounded to
# bf16, so a flipped rounding moves later steps by about a bf16 ulp.
BILSTM_BWD_BF16_TOL = 5e-2
# K5, K6, K7, K10a and K10b share K2's and K3's arithmetic and its reasons
# (K10a and K10b also sum the projection in another order than cuBLAS).
LSTM_TOL = {torch.float32: BILSTM_F32_TOL, torch.bfloat16: BILSTM_BF16_TOL}
LSTM_BWD_TOL = {torch.float32: BILSTM_BWD_F32_TOL,
                torch.bfloat16: BILSTM_BWD_BF16_TOL}
# K8a, K8b, K9a and K9b: the same f32 sums over H terms per gate column,
# the same bf16 storage and rounding sites, the same partial-dh exchange.
GRU_TOL, GRU_BWD_TOL = LSTM_TOL, LSTM_BWD_TOL


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


def _ctc_inputs(t, b, lmax, device, seed):
    """Seeded logits and labels with ragged, short and infeasible rows
    (row 1 has fewer frames than its labels need)."""
    rng = np.random.default_rng(seed)
    a = 9
    logits = torch.as_tensor((rng.standard_normal((b, t, a)) * 2).astype(
        np.float32), device=device)
    label_lens = rng.integers(min(1, lmax), lmax + 1, size=b)
    labels = np.zeros((b, lmax), np.int32)
    for i in range(b):
        labels[i, :label_lens[i]] = rng.integers(1, a, size=label_lens[i])
    input_lens = rng.integers(max(1, min(t, 2 * lmax + 1)), t + 1, size=b)
    input_lens[0] = t
    if b > 1:
        input_lens[1] = max(1, min(t, label_lens[1]))
    return (logits, torch.as_tensor(labels, device=device),
            torch.as_tensor(input_lens.astype(np.int32), device=device),
            torch.as_tensor(label_lens.astype(np.int32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,lmax", [(24, 6, 5), (30, 3, 0), (240, 4, 70),
                                      (1250, 2, 600)])
def test_ctc_kernels_match_plain(cuda, t, b, lmax):
    """K1, K11 and K12 against their plain loops on the card, including
    S = 1 (empty labels) and S = 1201 > 1024 (threads stride over S)."""
    logits, labels, input_lens, label_lens = _ctc_inputs(t, b, lmax, cuda,
                                                         seed=t + b)
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    skip_down = ctc._skip_down(skip_ok)
    before = (ctc_cuda.alpha_beta.launches, ctc_cuda.forward_alphas.launches,
              ctc_cuda.backward_betas.launches)
    got = {"alpha_beta": ctc_cuda.alpha_beta(lp, skip_ok, skip_down,
                                             input_lens, label_lens),
           "forward_alphas": (ctc_cuda.forward_alphas(lp, skip_ok,
                                                      input_lens),),
           "backward_betas": (ctc_cuda.backward_betas(lp, skip_down,
                                                      input_lens,
                                                      label_lens),)}
    torch.cuda.synchronize()
    assert (ctc_cuda.alpha_beta.launches, ctc_cuda.forward_alphas.launches,
            ctc_cuda.backward_betas.launches) == tuple(n + 1 for n in before)
    ref_a, ref_b = ctc_cuda.alpha_beta_reference(lp, skip_ok, skip_down,
                                                 input_lens, label_lens)
    want = {"alpha_beta": (ref_a, ref_b), "forward_alphas": (ref_a,),
            "backward_betas": (ref_b,)}
    for name, outs in got.items():
        for g, r in zip(outs, want[name]):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=CTC_RTOL, atol=CTC_ATOL,
                                       err_msg=name)
    ref_loss, ref_grad = ctc.ctc_loss_and_grad(
        *(v.cpu() for v in (logits, labels, input_lens, label_lens)))
    for impl in ("fused", "separate"):
        loss, grad = ctc.ctc_loss_and_grad(logits, labels, input_lens,
                                           label_lens, implementation=impl)
        np.testing.assert_allclose(loss.cpu().numpy(), ref_loss.numpy(),
                                   rtol=CTC_RTOL, atol=CTC_ATOL)
        np.testing.assert_allclose(grad.cpu().numpy(), ref_grad.numpy(),
                                   rtol=0, atol=CTC_GRAD_TOL)


@pytest.mark.cuda
def test_ctc_kernels_reject_bad_inputs(cuda):
    logits, labels, input_lens, label_lens = _ctc_inputs(8, 2, 2, cuda, 0)
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    with pytest.raises(ValueError):                  # f64 log-probs
        ctc_cuda.forward_alphas(lp.double(), skip_ok, input_lens)
    with pytest.raises(ValueError):                  # mask not bool
        ctc_cuda.forward_alphas(lp, skip_ok.float(), input_lens)
    with pytest.raises(ValueError):                  # lens on the CPU
        ctc_cuda.backward_betas(lp, skip_ok, input_lens.cpu(), label_lens)
    with pytest.raises(ValueError):                  # not contiguous
        ctc_cuda.alpha_beta(lp.transpose(0, 1), skip_ok, skip_ok,
                            input_lens, label_lens)
    big = torch.zeros((2, 1, ctc_cuda._MAX_S + 1), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_cuda.forward_alphas(big, torch.zeros(big.shape[1:], dtype=bool,
                                                 device=cuda),
                                input_lens[:1])


# ---------------------------------------------------------------------------
# K4's two routes (stft_cuda.k4_plan) and K1's (ctc_cuda.k1_plan)
# ---------------------------------------------------------------------------


def _log_mel_inputs(num_frames, fo, device, seed, mel_opts=None):
    rng = np.random.default_rng(seed)
    frames = torch.as_tensor(
        (rng.standard_normal((num_frames, fo.window_size)) * 1000)
        .astype(np.float32), device=device)
    window = torch.as_tensor(feature_window(fo), device=device)
    mel = torch.as_tensor(mel_banks(mel_opts or MelOptions(
        num_bins=40, low_freq=20.0, high_freq=-400.0), fo), device=device)
    return frames, window, mel


def _log_mel_close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("num_frames", [1, 20, 37, 798])
def test_log_mel_fft_route_matches_plain(cuda, num_frames):
    """The MFCC-hires shapes (400 samples, 512 points, K = N/2 = 256) on
    the fft route: one frame, a stream chunk, a ragged last block, 8 s."""
    fo = FrameOptions()
    args = _log_mel_inputs(num_frames, fo, cuda, num_frames)
    assert stft_cuda.k4_plan(fo.window_size, fo.padded_window_size,
                             args[2].shape[1], 40).route == "fft"
    before = (stft_cuda.log_mel.launches, stft_cuda.log_mel.fft_launches,
              stft_cuda.log_mel.dft_launches)
    got = stft_cuda.log_mel(*args, fo.padded_window_size)
    torch.cuda.synchronize()
    assert (stft_cuda.log_mel.launches, stft_cuda.log_mel.fft_launches,
            stft_cuda.log_mel.dft_launches) == (before[0] + 1,
                                                before[1] + 1, before[2])
    _log_mel_close(got, stft_cuda.log_mel_reference(
        *args, fo.padded_window_size))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(remove_dc=False, preemph=0.0, use_power=False, use_log=False),
    dict(remove_dc=True, preemph=0.0, use_power=True, use_log=False),
    dict(remove_dc=False, preemph=0.97, use_power=False, use_log=True)])
def test_log_mel_fft_route_options(cuda, kw):
    """test_log_mel_kernel_options's magnitude spectrum, no log, no DC
    removal, no preemphasis, and two mixes, on the fft route."""
    fo = FrameOptions()
    rng = np.random.default_rng(7)
    frames = torch.as_tensor((rng.standard_normal((9, fo.window_size))
                              * 100 + 30).astype(np.float32), device=cuda)
    window = torch.as_tensor(feature_window(fo), device=cuda)
    mel = torch.as_tensor(mel_banks(MelOptions(), fo), device=cuda)
    before = stft_cuda.log_mel.fft_launches
    got = stft_cuda.log_mel(frames, window, mel, fo.padded_window_size, **kw)
    assert stft_cuda.log_mel.fft_launches == before + 1
    _log_mel_close(got, stft_cuda.log_mel_reference(
        frames, window, mel, fo.padded_window_size, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("length,padded,k_bins,frames", [
    (400, 512, 257, 20),     # Nyquist included: K = N/2 + 1
    (200, 256, 128, 37),     # 8 kHz: a radix-4 transform of 128
    (1000, 1024, 512, 9),    # radix 2, then radix 4
    (3, 4, 3, 5),            # two points: one radix-2 pass
    (401, 4096, 300, 3)])    # the plan's largest transform
def test_log_mel_fft_route_at_other_sizes(cuda, length, padded, k_bins,
                                          frames):
    """The fft route against the plain version where the transform, the
    bins and the mel rows (random spans, one row empty, K not a multiple
    of 4) differ from the hires shapes."""
    rng = np.random.default_rng(length)
    x = torch.as_tensor((rng.standard_normal((frames, length)) * 300)
                        .astype(np.float32), device=cuda)
    window = torch.as_tensor(rng.uniform(0.1, 1.0, length)
                             .astype(np.float32), device=cuda)
    mel = np.zeros((11, k_bins), np.float32)
    for m in range(1, 11):
        lo = rng.integers(0, k_bins)
        hi = rng.integers(lo, k_bins) + 1
        mel[m, lo:hi] = rng.uniform(0.0, 1.0, hi - lo)
    mel = torch.as_tensor(mel, device=cuda)
    assert stft_cuda.k4_plan(length, padded, k_bins, 11).route == "fft"
    before = stft_cuda.log_mel.fft_launches
    got = stft_cuda.log_mel(x, window, mel, padded)
    assert stft_cuda.log_mel.fft_launches == before + 1
    _log_mel_close(got, stft_cuda.log_mel_reference(x, window, mel, padded))


@pytest.mark.cuda
def test_log_mel_dft_route_on_a_400_point_transform(cuda):
    """round_to_power_of_two=False pads to 400 points: the dft route."""
    fo = FrameOptions(round_to_power_of_two=False)
    assert fo.padded_window_size == 400
    args = _log_mel_inputs(37, fo, cuda, 5)
    assert stft_cuda.k4_plan(400, 400, args[2].shape[1], 40).route == "dft"
    before = (stft_cuda.log_mel.fft_launches, stft_cuda.log_mel.dft_launches)
    got = stft_cuda.log_mel(*args, 400)
    assert (stft_cuda.log_mel.fft_launches,
            stft_cuda.log_mel.dft_launches) == (before[0], before[1] + 1)
    _log_mel_close(got, stft_cuda.log_mel_reference(*args, 400))


@pytest.mark.cuda
@pytest.mark.parametrize("num_frames", [20, 798])
def test_log_mel_routes_agree(cuda, num_frames):
    """The fft and dft routes on the same operands: one sums an FFT, the
    other the direct DFT, so they agree to K4's tolerance, not bit for
    bit; the launches of the routes called alone count nothing."""
    fo = FrameOptions()
    args = _log_mel_inputs(num_frames, fo, cuda, 3)
    counts = (stft_cuda.log_mel.launches, stft_cuda.log_mel.fft_launches)
    fft = stft_cuda._log_mel_fft(*args, fo.padded_window_size, True, 0.97,
                                 True, True)
    dft = stft_cuda._log_mel_dft(*args, fo.padded_window_size, True, 0.97,
                                 True, True)
    assert (stft_cuda.log_mel.launches,
            stft_cuda.log_mel.fft_launches) == counts
    _log_mel_close(fft, dft)


@pytest.mark.cuda
@pytest.mark.parametrize("length,padded,k_bins,m_bins,nnz", [
    (400, 512, 256, 40, 468), (400, 512, 257, 23, 0), (200, 256, 128, 11, 9),
    (1000, 1024, 512, 80, 40960), (3, 4, 3, 2, 5)])
def test_log_mel_smem_queries_are_the_plan_formulas(cuda, length, padded,
                                                    k_bins, m_bins, nnz):
    lib = _kernels.load("log_mel", stft_cuda._SIGNATURES)
    for fpb in (1, 2, 4):
        assert lib.log_mel_fft_smem(length, padded, m_bins, nnz, fpb) \
            == stft_cuda._fft_smem_bytes(length, padded, m_bins, nnz, fpb)
    assert lib.log_mel_dft_smem(length, k_bins) \
        == stft_cuda._dft_smem_bytes(length, k_bins)


def _k1_inputs(t, b, lmax, device, seed):
    """``_ctc_inputs`` where, if the batch has room, row 1 has half the
    frames its lmax labels need (infeasible), row 2 no frames and row 3
    no labels: short, empty and infeasible rows."""
    logits, labels, input_lens, label_lens = _ctc_inputs(t, b, lmax, device,
                                                         seed)
    if b > 3 and lmax > 1:
        label_lens[1] = lmax
        labels[1] = torch.arange(lmax, device=device) % 8 + 1
        input_lens[1] = lmax // 2
        input_lens[2] = 0
        label_lens[3] = 0
        labels[3] = 0
    return logits, labels, input_lens, label_lens


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,lmax", [(24, 6, 5), (30, 3, 0), (240, 4, 70),
                                      (240, 48, 70)])
def test_k1_warp_route_equals_block_route_bit_for_bit(cuda, t, b, lmax):
    """The warp route computes each state with the block route's
    expressions in its order: alphas and betas equal bit for bit (S = 1
    at L = 0, S = 141 at bench's shape)."""
    logits, labels, input_lens, label_lens = _k1_inputs(t, b, lmax, cuda,
                                                        seed=t * b)
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    skip_down = ctc._skip_down(skip_ok)
    assert ctc_cuda.k1_plan(lp.shape[2]).route == "warp"
    ops = (lp, skip_ok, skip_down, input_lens.to(torch.int32),
           label_lens.to(torch.int32))
    warp = ctc_cuda._alpha_beta_route("warp", *ops)
    block = ctc_cuda._alpha_beta_route("block", *ops)
    torch.cuda.synchronize()
    for w, k in zip(warp, block):
        assert torch.equal(w, k)
    ref = ctc_cuda.alpha_beta_reference(lp, skip_ok, skip_down, input_lens,
                                        label_lens)
    for w, r in zip(warp, ref):
        np.testing.assert_allclose(w.cpu().numpy(), r.cpu().numpy(),
                                   rtol=CTC_RTOL, atol=CTC_ATOL)


@pytest.mark.cuda
def test_k1_warp_route_log1p_equals_log1pf_on_the_unit_interval(cuda):
    """The warp route's branch-free log1p equals libdevice's log1pf bit
    for bit at every float in [0, 1], the range of a log-add's
    expf(-|a-b|)."""
    lib = _kernels.load("ctc_alpha_beta", ctc_cuda._SIGNATURES)
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    one = int(np.float32(1.0).view(np.uint32))
    err = lib.ctc_log1p_unit_check(0, one, bad.data_ptr(),
                                   _kernels.stream_ptr(cuda))
    _kernels.check(lib, err, "ctc_log1p_unit_check")
    assert int(bad) == 0


@pytest.mark.cuda
def test_k1_warp_route_on_the_fused_loss(cuda):
    """ctc_loss_and_grad(implementation="fused") at bench's shape takes
    the warp route; it matches the plain loops, and the infeasible and
    frameless rows keep loss 0 (frameless: F8's frame-0 loss) and a zero
    gradient as there."""
    logits, labels, input_lens, label_lens = _k1_inputs(240, 48, 70, cuda,
                                                        seed=11)
    before = (ctc_cuda.alpha_beta.launches, ctc_cuda.alpha_beta.warp_launches,
              ctc_cuda.alpha_beta.block_launches)
    loss, grad = ctc.ctc_loss_and_grad(logits, labels, input_lens,
                                       label_lens, implementation="fused")
    torch.cuda.synchronize()
    assert (ctc_cuda.alpha_beta.launches, ctc_cuda.alpha_beta.warp_launches,
            ctc_cuda.alpha_beta.block_launches) == (
                before[0] + 1, before[1] + 1, before[2])
    ref_loss, ref_grad = ctc.ctc_loss_and_grad(
        *(v.cpu() for v in (logits, labels, input_lens, label_lens)))
    np.testing.assert_allclose(loss.cpu().numpy(), ref_loss.numpy(),
                               rtol=CTC_RTOL, atol=CTC_ATOL)
    np.testing.assert_allclose(grad.cpu().numpy(), ref_grad.numpy(), rtol=0,
                               atol=CTC_GRAD_TOL)
    assert float(loss[1]) == 0.0 and float(grad[1].abs().max()) == 0.0
    assert float(grad[2].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K11's and K12's band route (ctc_cuda.k11_plan, k12_plan)
# ---------------------------------------------------------------------------


def _band_operands(t, b, lmax, device, seed):
    """``_k1_inputs``' lattice: (lp, skip_ok, skip_down, lens, label_lens)
    with int32 counts, as the routes take them."""
    logits, labels, input_lens, label_lens = _k1_inputs(t, b, lmax, device,
                                                        seed)
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    return (lp, skip_ok, ctc._skip_down(skip_ok), input_lens.to(torch.int32),
            label_lens.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,lmax", [(1, 1, 0), (24, 6, 5), (24, 6, 16),
                                      (24, 3, 32), (240, 48, 70),
                                      (240, 4, 127), (240, 4, 255),
                                      (240, 600, 70)])
def test_k11_k12_band_route_equals_block_and_k1_routes_bit_for_bit(
        cuda, t, b, lmax):
    """The band route computes each state with the block route's
    expressions in its order: K11's alphas and K12's betas equal the
    block route's and K1's (its warp route up to 256 states, its block
    route above) bit for bit, on short, empty, infeasible and label-less
    rows; S = 1, 11, 33 and 65 (a top band of one live state), 141
    (bench), 255 (8 bands, the band route's last odd S) and B = 600; at
    S = 511 both wrappers take the block kernel.  The wrappers take their
    plan's route."""
    lp, skip_ok, skip_down, lens32, ll32 = _band_operands(t, b, lmax, cuda,
                                                          seed=t + b)
    s = lp.shape[2]
    route = "band" if s <= ctc_cuda.BAND_MAX_S else "block"
    assert ctc_cuda.k11_plan(s).route == ctc_cuda.k12_plan(s).route == route
    routes = ("band", "block") if route == "band" else ("block",)
    alphas = {r: ctc_cuda._alphas_route(r, lp, skip_ok, lens32)
              for r in routes}
    betas = {r: ctc_cuda._betas_route(r, lp, skip_down, lens32, ll32)
             for r in routes}
    fns = (ctc_cuda.forward_alphas, ctc_cuda.backward_betas)
    before = [getattr(f, f"{route}_launches") for f in fns]
    wrapped = (ctc_cuda.forward_alphas(lp, skip_ok, lens32),
               ctc_cuda.backward_betas(lp, skip_down, lens32, ll32))
    k1 = {r: ctc_cuda._alpha_beta_route(r, lp, skip_ok, skip_down, lens32,
                                        ll32)
          for r in (("warp", "block") if s <= ctc_cuda.K1_WARP_MAX_S
                    else ("block",))}
    torch.cuda.synchronize()
    assert [getattr(f, f"{route}_launches") for f in fns] == [
        n + 1 for n in before]
    got_a, got_b = alphas[route], betas[route]
    assert torch.equal(got_a, alphas["block"])
    assert torch.equal(got_b, betas["block"])
    assert torch.equal(wrapped[0], got_a)
    assert torch.equal(wrapped[1], got_b)
    for a, b_ in k1.values():
        assert torch.equal(got_a, a)
        assert torch.equal(got_b, b_)
    ref_a, ref_b = ctc_cuda.alpha_beta_reference(lp, skip_ok, skip_down,
                                                 lens32, ll32)
    np.testing.assert_allclose(got_a.cpu().numpy(),
                               ref_a.cpu().numpy(), rtol=CTC_RTOL,
                               atol=CTC_ATOL)
    np.testing.assert_allclose(got_b.cpu().numpy(),
                               ref_b.cpu().numpy(), rtol=CTC_RTOL,
                               atol=CTC_ATOL)


@pytest.mark.cuda
def test_band_smem_query_equals_the_python_formula(cuda):
    """One shared-memory formula for the band launch and its query, and
    its Python twin, at every S the band route takes; an S the launch
    refuses has none."""
    lib = _kernels.load("ctc_alpha_beta", ctc_cuda._SIGNATURES)
    for s in range(1, ctc_cuda.BAND_MAX_S + 1):
        assert lib.ctc_band_smem(s) == ctc_cuda._band_smem_bytes(
            ctc_cuda.k11_plan(s).warps)
    assert lib.ctc_band_smem(0) == lib.ctc_band_smem(
        ctc_cuda.BAND_MAX_S + 1) == -1


@pytest.mark.cuda
def test_band_launch_refuses_s_above_its_limit(cuda):
    """The C entry points themselves refuse S above 256 states."""
    lp, skip_ok, skip_down, lens32, ll32 = _band_operands(24, 6, 5, cuda,
                                                          seed=3)
    lib = _kernels.load("ctc_alpha_beta", ctc_cuda._SIGNATURES)
    out = torch.empty_like(lp)
    t_max, b, _ = lp.shape
    s = ctc_cuda.BAND_MAX_S + 1
    stream = _kernels.stream_ptr(cuda)
    assert lib.ctc_alphas_band(lp.data_ptr(), skip_ok.data_ptr(),
                               lens32.data_ptr(), out.data_ptr(), t_max, b,
                               s, stream) != 0
    assert lib.ctc_betas_band(lp.data_ptr(), skip_down.data_ptr(),
                              lens32.data_ptr(), ll32.data_ptr(),
                              out.data_ptr(), t_max, b, s, stream) != 0


@pytest.mark.cuda
def test_separate_ctc_path_on_the_band_route(cuda):
    """ctc_loss_and_grad(implementation="separate") at bench's shape
    launches K11 and K12 once each, on the band route, and matches the
    plain loops; infeasible and frameless rows keep loss 0 (frameless:
    F8's frame-0 loss) and a zero gradient."""
    logits, labels, input_lens, label_lens = _k1_inputs(240, 48, 70, cuda,
                                                        seed=13)
    fns = (ctc_cuda.forward_alphas, ctc_cuda.backward_betas)
    before = [(f.launches, f.band_launches, f.block_launches) for f in fns]
    loss, grad = ctc.ctc_loss_and_grad(logits, labels, input_lens,
                                       label_lens, implementation="separate")
    torch.cuda.synchronize()
    after = [(f.launches, f.band_launches, f.block_launches) for f in fns]
    assert after == [(n + 1, band + 1, block)
                     for n, band, block in before]
    ref_loss, ref_grad = ctc.ctc_loss_and_grad(
        *(v.cpu() for v in (logits, labels, input_lens, label_lens)))
    np.testing.assert_allclose(loss.cpu().numpy(), ref_loss.numpy(),
                               rtol=CTC_RTOL, atol=CTC_ATOL)
    np.testing.assert_allclose(grad.cpu().numpy(), ref_grad.numpy(), rtol=0,
                               atol=CTC_GRAD_TOL)
    assert float(loss[1]) == 0.0 and float(grad[1].abs().max()) == 0.0
    assert float(grad[2].abs().max()) == 0.0


@pytest.mark.cuda
def test_k1_block_route_above_the_warp_limit(cuda):
    """S = 1201 (L = 600) is above the warp route's 256 states: the block
    route, against the plain loops; S = 257 is the first such S."""
    assert ctc_cuda.k1_plan(ctc_cuda.K1_WARP_MAX_S + 1).route == "block"
    logits, labels, input_lens, label_lens = _ctc_inputs(1250, 2, 600, cuda,
                                                         seed=1252)
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    skip_down = ctc._skip_down(skip_ok)
    assert lp.shape[2] == 1201
    assert ctc_cuda.k1_plan(1201).route == "block"
    before = (ctc_cuda.alpha_beta.warp_launches,
              ctc_cuda.alpha_beta.block_launches)
    got = ctc_cuda.alpha_beta(lp, skip_ok, skip_down, input_lens, label_lens)
    torch.cuda.synchronize()
    assert (ctc_cuda.alpha_beta.warp_launches,
            ctc_cuda.alpha_beta.block_launches) == (before[0], before[1] + 1)
    ref = ctc_cuda.alpha_beta_reference(lp, skip_ok, skip_down, input_lens,
                                        label_lens)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=CTC_RTOL, atol=5e-4)


@pytest.mark.cuda
def test_k1_warp_route_at_its_limit_and_a_large_batch(cuda):
    """S = 255 (L = 127, 8 states a lane) at B = 600: the warp route,
    1,200 warps in a plain grid, bit for bit against the block route."""
    logits, labels, input_lens, label_lens = _k1_inputs(40, 600, 127, cuda,
                                                        seed=600)
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    skip_down = ctc._skip_down(skip_ok)
    assert lp.shape[2] == 255
    assert ctc_cuda.k1_plan(255) == ctc_cuda.K1Plan("warp", 8)
    ops = (lp, skip_ok, skip_down, input_lens.to(torch.int32),
           label_lens.to(torch.int32))
    warp = ctc_cuda._alpha_beta_route("warp", *ops)
    block = ctc_cuda._alpha_beta_route("block", *ops)
    torch.cuda.synchronize()
    for w, k in zip(warp, block):
        assert torch.equal(w, k)


def _bwd_inputs(t, b, h, dtype, device, seed):
    """A forward pass through K2's plain version on the card, and seeded
    cotangents: K3's operands."""
    xp, w_f, w_b, lens = _bilstm_inputs(t, b, h, dtype, device, seed)
    y_f, c_f, y_b, c_b = rnn_cuda.bilstm_seq_fwd_reference(xp, w_f, w_b,
                                                           lens)
    rng = np.random.default_rng(seed + 1)
    dy_f, dy_b = (torch.as_tensor(rng.standard_normal((t, b, h)).astype(
        np.float32), device=device).to(dtype) for _ in range(2))
    return dy_f, dy_b, xp, y_f, c_f, y_b, c_b, w_f, w_b, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, BILSTM_BWD_F32_TOL),
                                       (torch.bfloat16, BILSTM_BWD_BF16_TOL)])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (16, 3, 128), (40, 2, 320),
                                   (240, 48, 320)])
def test_bilstm_bwd_kernel_matches_plain(cuda, dtype, tol, t, b, h):
    args = _bwd_inputs(t, b, h, dtype, cuda, seed=h + t)
    before = rnn_cuda.bilstm_seq_bwd_dgates.launches
    got = rnn_cuda.bilstm_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_bwd_dgates.launches == before + 1
    ref = rnn_cuda.bilstm_seq_bwd_dgates_reference(*args)
    lens_np = args[-1].cpu().numpy()
    for name, g, r in zip(("dg_f", "dg_b"), got, ref):
        assert g.dtype == r.dtype == dtype and g.shape == r.shape, name
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(), rtol=0, atol=tol,
                                   err_msg=name)
        for row, n in enumerate(lens_np):       # zero at pad frames
            assert not g[n:, row].any(), name


@pytest.mark.cuda
def test_bilstm_bwd_kernel_rejects_bad_inputs(cuda):
    args = list(_bwd_inputs(4, 2, 16, torch.float32, cuda, 0))
    bad = list(args)
    bad[0] = args[0].to(torch.bfloat16)                 # dy dtype
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_seq_bwd_dgates(*bad)
    bad = list(args)
    bad[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1)  # c_f
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_seq_bwd_dgates(*bad)
    bad = list(args)
    bad[8] = args[8][:, :-4].contiguous()               # w_h_b shape
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_seq_bwd_dgates(*bad)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Route every kernel wrapper of the training path to its plain
    version (for a comparison run on the card)."""
    def use_plain():
        monkeypatch.setattr(rnn_cuda, "bilstm_seq_fwd",
                            rnn_cuda.bilstm_seq_fwd_reference)
        monkeypatch.setattr(rnn_cuda, "bilstm_seq_bwd_dgates",
                            rnn_cuda.bilstm_seq_bwd_dgates_reference)
        monkeypatch.setattr(rnn_cuda, "bilstm_seq_fwd_proj",
                            rnn_cuda.bilstm_seq_fwd_proj_reference)
        monkeypatch.setattr(rnn_cuda, "bilstm_seq_bwd_dgates_proj",
                            rnn_cuda.bilstm_seq_bwd_dgates_proj_reference)
        monkeypatch.setattr(ctc_cuda, "alpha_beta",
                            ctc_cuda.alpha_beta_reference)
        monkeypatch.setattr(rnn_cuda, "lstm_seq_fwd",
                            rnn_cuda.lstm_seq_fwd_reference)
        monkeypatch.setattr(rnn_cuda, "lstm_seq_bwd_dgates",
                            rnn_cuda.lstm_seq_bwd_dgates_reference)
        monkeypatch.setattr(rnn_cuda, "lstm_stack_fwd",
                            rnn_cuda.lstm_stack_fwd_reference)
        for name in ("gru_seq_fwd", "gru_seq_bwd_dgates", "bigru_seq_fwd",
                     "bigru_seq_bwd_dgates"):
            monkeypatch.setattr(gru_cuda, name,
                                getattr(gru_cuda, name + "_reference"))
    return use_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_bilstm_layer_backward_on_cuda_matches_plain(cuda, dtype, tol,
                                                     plain_kernels):
    t, b, d, h = 30, 5, 40, 320
    rng = np.random.default_rng(11)
    primals = [rng.standard_normal((t, b, d)).astype(np.float32),
               (rng.standard_normal((d, 8 * h)) / np.sqrt(d)).astype(
                   np.float32),
               (rng.standard_normal(8 * h) * 0.2).astype(np.float32),
               (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(
                   np.float32),
               (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(
                   np.float32)]
    lens = torch.as_tensor(np.array([t, 17, 3, 29, 1], np.int32),
                           device=cuda)
    cot = [torch.as_tensor(rng.standard_normal((t, b, h)).astype(np.float32),
                           device=cuda) for _ in range(2)]

    def grads():
        leaves = [torch.tensor(p, device=cuda, requires_grad=True)
                  for p in primals]
        y_f, y_b = rnn_cuda.bilstm_layer(*leaves, lens, dtype)
        torch.autograd.backward([y_f, y_b], [c.to(y_f.dtype) for c in cot])
        return [p.grad for p in leaves]

    k3 = rnn_cuda.bilstm_seq_bwd_dgates.launches
    got = grads()
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_bwd_dgates.launches == k3 + 1
    plain_kernels()
    ref = grads()
    for name, g, r in zip(("dx", "dw_x", "dbias", "dw_h_f", "dw_h_b"),
                          got, ref):
        assert g.dtype == r.dtype == torch.float32, name
        scale = max(float(r.abs().max()), 1.0)
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=tol * scale, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_train_step_on_cuda_matches_plain(cuda, dtype,
                                                   plain_kernels):
    """One step of the 5x320 flagship (T cut to 40) through K2, K3 and
    K1, against the same step on the plain versions on the card."""
    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train

    cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=320,
                   num_layers=5, compute_dtype=dtype)
    rng = np.random.default_rng(0)
    b, t, lmax = 6, 40, 8
    batch = {"feats": rng.standard_normal((b, t, 40)).astype(np.float32),
             "labels": rng.integers(1, 72, (b, lmax)).astype(np.int32),
             "input_lens": np.array([40, 40, 33, 25, 17, 5], np.int32),
             "label_lens": np.array([8, 5, 8, 3, 8, 1], np.int32)}
    params = init_am_params(cfg, torch.Generator().manual_seed(0), cuda)
    step = train.build_train_step(cfg, train.TrainOptions(momentum=0.9))
    counts = (rnn_cuda.bilstm_seq_fwd.launches,
              rnn_cuda.bilstm_seq_bwd_dgates.launches,
              ctc_cuda.alpha_beta.launches)
    state, m = step(train.init_train_state(params), batch)
    torch.cuda.synchronize()
    assert (rnn_cuda.bilstm_seq_fwd.launches - counts[0],
            rnn_cuda.bilstm_seq_bwd_dgates.launches - counts[1],
            ctc_cuda.alpha_beta.launches - counts[2]) == (5, 5, 1)
    assert bool(m["finite"]) and np.isfinite(float(m["loss_total"]))
    plain_kernels()
    state_p, m_p = step(train.init_train_state(params), batch)
    rtol = 1e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(float(m["loss_total"]),
                               float(m_p["loss_total"]), rtol=rtol)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_p["grad_norm"]), rtol=10 * rtol)
    for g, r in zip(tree_flatten(state.params),
                    tree_flatten(state_p.params)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=1e-5 if dtype == "float32" else 1e-4)


def _proj_inputs(t, b, d, h, dtype, device, seed):
    """Seeded K10a/K10b operands: x [T, B, D], w_x [D, 8H], w_h_f,
    w_h_b [H, 4H] and the cotangents dy_f, dy_b [T, B, H] in ``dtype``,
    the bias [8H] f32, lengths with row 0 full and the rest ragged."""
    rng = np.random.default_rng(seed)

    def mat(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=device)

    x = mat(t, b, d).to(dtype)
    w_x = mat(d, 8 * h, scale=d ** -0.5).to(dtype)
    bias = mat(8 * h, scale=0.2)
    w_f, w_b = (mat(h, 4 * h, scale=h ** -0.5).to(dtype) for _ in range(2))
    dy_f, dy_b = (mat(t, b, h).to(dtype) for _ in range(2))
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(0, t + 1, size=b - 1)
    return (x, w_x, bias, w_f, w_b, torch.as_tensor(lens, device=device),
            dy_f, dy_b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,d,h", [
    (24, 1, 256, 128),      # serving, the 3x128's layers 2-3
    (24, 48, 256, 128),     # training
    (8, 3, 512, 256),       # exactly the rule's 8 MiB of resident weights
    (8, 3, 128, 320),       # its largest H: K10b's clusters of 16 CTAs
    (8, 3, 8064, 32),       # its widest D: 7 gate columns a phase-1 block
    (16, 3, 40, 16)])       # unaligned: the kernels take any D and H
def test_bilstm_proj_kernels_match_plain(cuda, dtype, t, b, d, h):
    """K10a and then K10b on K10a's outputs against their plain versions
    on the card; zero outputs past each row's length."""
    x, w_x, bias, w_f, w_b, lens, dy_f, dy_b = _proj_inputs(
        t, b, d, h, dtype, cuda, seed=d + h + b)
    fwd = rnn_cuda.bilstm_seq_fwd_proj
    bwd = rnn_cuda.bilstm_seq_bwd_dgates_proj
    counts = (fwd.launches, bwd.launches)
    got = fwd(x, w_x, bias, w_f, w_b, lens)
    torch.cuda.synchronize()
    ref = rnn_cuda.bilstm_seq_fwd_proj_reference(x, w_x, bias, w_f, w_b,
                                                 lens)
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)
    _zero_past_lens((got[0], got[2]), lens, "y")
    args = (dy_f, dy_b, x, *got, w_x, bias, w_f, w_b, lens)
    dg = bwd(*args)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    ref_dg = rnn_cuda.bilstm_seq_bwd_dgates_proj_reference(*args)
    for name, g, r in zip(("dg_f", "dg_b"), dg, ref_dg):
        _close(g, r, LSTM_BWD_TOL[dtype], name)
    _zero_past_lens(dg, lens, "dg")


@pytest.mark.cuda
def test_bilstm_fwd_kernels_tile_a_large_batch(cuda):
    """At B=600 K2 and K10a walk their recurrences in several waves of
    clusters and still match their plain versions; K10b, whose clusters
    each take a group of rows, matches its plain version too (one
    launch)."""
    t, b, d, h = 4, 600, 256, 128
    x, w_x, bias, w_f, w_b, lens, dy_f, dy_b = _proj_inputs(
        t, b, d, h, torch.float32, cuda, seed=5)
    got = rnn_cuda.bilstm_seq_fwd_proj(x, w_x, bias, w_f, w_b, lens)
    ref = rnn_cuda.bilstm_seq_fwd_proj_reference(x, w_x, bias, w_f, w_b,
                                                 lens)
    xp = rnn_cuda._project_bilstm(x, w_x, bias)
    got_k2 = rnn_cuda.bilstm_seq_fwd(xp, w_f, w_b, lens)
    torch.cuda.synchronize()
    for name, g, k2, r in zip(("y_f", "c_f", "y_b", "c_b"), got, got_k2,
                              ref):
        _close(g, r, BILSTM_F32_TOL, name)
        _close(k2, r, BILSTM_F32_TOL, name)
    args = (dy_f, dy_b, x, *got, w_x, bias, w_f, w_b, lens)
    before = rnn_cuda.bilstm_seq_bwd_dgates_proj.launches
    dg = rnn_cuda.bilstm_seq_bwd_dgates_proj(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_bwd_dgates_proj.launches == before + 1
    ref_dg = rnn_cuda.bilstm_seq_bwd_dgates_proj_reference(*args)
    for name, g, r in zip(("dg_f", "dg_b"), dg, ref_dg):
        _close(g, r, BILSTM_BWD_F32_TOL, name)
    _zero_past_lens(dg, lens, "dg")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", [(256, 128), (40, 16), (128, 256)])
def test_k10b_phase1_kernels_agree_bit_for_bit(cuda, dtype, d, h):
    """K10b's tiled phase 1 (tile_dot, warp_dot's order walked by one
    thread) and its warp kernel (warp_dot and project() themselves, as
    K10a calls them) give the same gate pre-activations bit for bit, on a
    chunk of steps that starts mid-walk and one that ends it."""
    t, b = 7, 5
    x, w_x, bias, w_f, w_b, lens, _, _ = _proj_inputs(t, b, d, h, dtype,
                                                      cuda, seed=d + h)
    y_f, _, y_b, _ = rnn_cuda.bilstm_seq_fwd_proj(x, w_x, bias, w_f, w_b,
                                                  lens)
    lib = _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)
    plan = rnn_cuda.k10b_plan(b, d, h, 132, 232448)
    assert plan.gates_tiled
    warp = plan._replace(gates_tiled=False, gate_cols=32)
    for s0, n in ((2, 3), (4, 3)):
        got = []
        for p in (plan, warp):
            pre = torch.full((n, b, 8 * h), float("nan"), device=cuda)
            rnn_cuda._k10b_gates(lib, x, y_f, y_b, w_x, bias, w_f, w_b, pre,
                                 s0, n, p)
            got.append(pre)
        torch.cuda.synchronize()
        assert not got[0].isnan().any()
        assert torch.equal(got[0], got[1]), (s0, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_proj_bwd_in_chunks_of_steps(cuda, dtype, monkeypatch):
    """K10b with its scratch cut to 3 steps (a scratch above 256 MiB runs
    in chunks): phase 2 carries dh and dc between the chunks, and the
    dgates equal one chunk's exactly and the plain version's within K3's
    tolerance."""
    t, b, d, h = 10, 5, 128, 32
    x, w_x, bias, w_f, w_b, lens, dy_f, dy_b = _proj_inputs(
        t, b, d, h, dtype, cuda, seed=9)
    y_f, c_f, y_b, c_b = rnn_cuda.bilstm_seq_fwd_proj(x, w_x, bias, w_f,
                                                      w_b, lens)
    args = (dy_f, dy_b, x, y_f, c_f, y_b, c_b, w_x, bias, w_f, w_b, lens)
    whole = rnn_cuda.bilstm_seq_bwd_dgates_proj(*args)
    monkeypatch.setattr(rnn_cuda, "_K10_SCRATCH_BYTES", 3 * b * 8 * h * 4)
    chunked = rnn_cuda.bilstm_seq_bwd_dgates_proj(*args)
    torch.cuda.synchronize()
    ref = rnn_cuda.bilstm_seq_bwd_dgates_proj_reference(*args)
    for name, c, w, r in zip(("dg_f", "dg_b"), chunked, whole, ref):
        assert torch.equal(c, w), name
        _close(c, r, LSTM_BWD_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_k10a_chain_matches_plain_at_any_batch(cuda, dtype, b):
    """K10a (phase 1, then the forward chain in clusters) at the 3x128's
    layers 2-3 against its plain version, ragged rows, one launch at
    B = 1, 48 and 600 (25 row groups of clusters in several waves)."""
    t, d, h = 12, 256, 128
    x, w_x, bias, w_f, w_b, lens, _, _ = _proj_inputs(t, b, d, h, dtype,
                                                      cuda, seed=b)
    fwd = rnn_cuda.bilstm_seq_fwd_proj
    before = fwd.launches
    got = fwd(x, w_x, bias, w_f, w_b, lens)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    ref = rnn_cuda.bilstm_seq_fwd_proj_reference(x, w_x, bias, w_f, w_b,
                                                 lens)
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)
    _zero_past_lens((got[0], got[2]), lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_proj_fwd_in_chunks_of_steps(cuda, dtype, monkeypatch):
    """K10a with its scratch cut to 3 frames a direction (a scratch above
    256 MiB runs in chunks): the chain carries h and c between the
    chunks, and the outputs equal one chunk's exactly and the plain
    version's within K2's tolerance."""
    t, b, d, h = 10, 5, 128, 32
    x, w_x, bias, w_f, w_b, lens, _, _ = _proj_inputs(t, b, d, h, dtype,
                                                      cuda, seed=19)
    args = (x, w_x, bias, w_f, w_b, lens)
    whole = rnn_cuda.bilstm_seq_fwd_proj(*args)
    monkeypatch.setattr(rnn_cuda, "_K10_SCRATCH_BYTES", 3 * b * 8 * h * 4)
    chunked = rnn_cuda.bilstm_seq_fwd_proj(*args)
    torch.cuda.synchronize()
    ref = rnn_cuda.bilstm_seq_fwd_proj_reference(*args)
    for name, c, w, r in zip(("y_f", "c_f", "y_b", "c_b"), chunked, whole,
                             ref):
        assert torch.equal(c, w), name
        _close(c, r, LSTM_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", [(256, 128), (40, 16), (8064, 32)])
def test_k10a_equals_k2_on_its_own_projection_bit_for_bit(cuda, dtype, d, h):
    """K10a's outputs equal those of K2's cooperative kernel on the
    projection K10a's phase 1 wrote (tiled, or the warp kernel at D=8064),
    bit for bit: the chain's sums are warp_dot's, its gate math K2's."""
    t, b = 9, 5
    x, w_x, bias, w_f, w_b, lens, _, _ = _proj_inputs(t, b, d, h, dtype,
                                                      cuda, seed=d + h)
    got = rnn_cuda.bilstm_seq_fwd_proj(x, w_x, bias, w_f, w_b, lens)
    lib = _kernels.load("bilstm_fwd", rnn_cuda._SIGNATURES)
    plan = rnn_cuda.fwd_chain_plan(b, d, h, dtype, 2, 132, 232448)
    assert (plan.proj_cols == 0) == (d <= 426)
    pre = torch.full((t, b, 8 * h), float("nan"), device=cuda)
    err = getattr(lib, "bilstm_proj_x_" + rnn_cuda._SUFFIX[dtype])(
        x.data_ptr(), w_x.data_ptr(), bias.data_ptr(), pre.data_ptr(), 0, 0,
        t, t, b, d, h, plan.proj_cols, _kernels.stream_ptr(cuda))
    _kernels.check(lib, err, "bilstm_proj_x")
    assert not pre.isnan().any()
    xp = pre.to(dtype)                  # exact: phase 1 rounded it
    assert torch.equal(xp.float(), pre)
    # K2's cooperative kernel: a witness independent of the chain
    k2 = rnn_cuda._bilstm_fwd_cooperative(lib, xp, w_f, w_b,
                                          lens.to(torch.int32))
    torch.cuda.synchronize()
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, k2):
        assert torch.equal(g, r), name


def _k2_lib():
    return _kernels.load("bilstm_fwd", rnn_cuda._SIGNATURES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
@pytest.mark.parametrize("h", [128, 320])
def test_k2_chain_matches_plain_at_any_batch(cuda, dtype, b, h):
    """K2 at the 3x128's layer 1 (H=128, clusters of 4) and the 5x320's
    layers (H=320, clusters of 16) against its plain version, ragged rows,
    one launch at B = 1, 48 and 600 (several waves of clusters, no row
    slices), through the wrapper and through the cluster route's export."""
    t = 12
    xp, w_f, w_b, lens = _bilstm_inputs(t, b, h, dtype, cuda, seed=b + h)
    lib = _k2_lib()
    assert rnn_cuda.k2_plan(lib, b, h, dtype, cuda).route == "cluster"
    before = rnn_cuda.bilstm_seq_fwd.launches
    got = rnn_cuda.bilstm_seq_fwd(xp, w_f, w_b, lens)
    chain = rnn_cuda._bilstm_fwd_chain(
        lib, xp, w_f, w_b, lens.to(torch.int32),
        rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 2, 132, 232448))
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_fwd.launches == before + 1
    ref = rnn_cuda.bilstm_seq_fwd_reference(xp, w_f, w_b, lens)
    for outs in (got, chain):
        for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), outs, ref):
            _close(g, r, LSTM_TOL[dtype], name)
        _zero_past_lens((outs[0], outs[2]), lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h", [(torch.float32, 512),
                                     (torch.bfloat16, 704)])
def test_k2_cooperative_route_at_a_large_h(cuda, dtype, h):
    """Where W_h fits no cluster of 16 the plan sends K2 to its
    cooperative kernel, which still matches its plain version."""
    t, b = 10, 3
    xp, w_f, w_b, lens = _bilstm_inputs(t, b, h, dtype, cuda, seed=h)
    assert rnn_cuda.k2_plan(_k2_lib(), b, h, dtype, cuda).route \
        == "cooperative"
    before = rnn_cuda.bilstm_seq_fwd.launches
    got = rnn_cuda.bilstm_seq_fwd(xp, w_f, w_b, lens)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_fwd.launches == before + 1
    ref = rnn_cuda.bilstm_seq_fwd_reference(xp, w_f, w_b, lens)
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("h", [128, 320])
def test_k2_chain_equals_k2_cooperative_bit_for_bit(cuda, dtype, b, h):
    """K2's two routes give the same (y, c) of both directions bit for
    bit, ragged rows: the chain's sums are warp_dot's, its gate math the
    cooperative kernel's."""
    t = 20
    xp, w_f, w_b, lens = _bilstm_inputs(t, b, h, dtype, cuda, seed=7 * h + b)
    lib = _k2_lib()
    lens32 = lens.to(torch.int32)
    chain = rnn_cuda._bilstm_fwd_chain(
        lib, xp, w_f, w_b, lens32,
        rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 2, 132, 232448))
    coop = rnn_cuda._bilstm_fwd_cooperative(lib, xp, w_f, w_b, lens32)
    torch.cuda.synchronize()
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), chain, coop):
        assert torch.equal(g, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10a_projection_kernels_agree_bit_for_bit(cuda, dtype):
    """K10a's tiled phase 1 and its warp kernel write the same projection
    bit for bit, on a chunk of frames that starts mid-sequence for both
    directions."""
    t, b, d, h = 7, 5, 256, 64
    x, w_x, bias, *_ = _proj_inputs(t, b, d, h, dtype, cuda, seed=3)
    lib = _kernels.load("bilstm_fwd", rnn_cuda._SIGNATURES)
    got = []
    for cols in (0, 32):
        pre = torch.full((3, b, 8 * h), float("nan"), device=cuda)
        err = getattr(lib, "bilstm_proj_x_" + rnn_cuda._SUFFIX[dtype])(
            x.data_ptr(), w_x.data_ptr(), bias.data_ptr(), pre.data_ptr(), 2,
            4, 3, t, b, d, h, cols, _kernels.stream_ptr(cuda))
        _kernels.check(lib, err, "bilstm_proj_x")
        got.append(pre)
    torch.cuda.synchronize()
    assert not got[0].isnan().any()
    assert torch.equal(got[0], got[1])
    # row i: the forward half at t = 2 + i, the backward half at t = 4 + i
    ref = rnn_cuda._project_bilstm(x, w_x, bias).float()
    g4 = 4 * h
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _close(got[0][:, :, :g4], ref[2:5, :, :g4], tol, "forward half")
    _close(got[0][:, :, g4:], ref[4:7, :, g4:], tol, "backward half")


@pytest.mark.cuda
def test_bilstm_proj_kernels_reject_bad_inputs(cuda):
    x, w_x, bias, w_f, w_b, lens, dy_f, dy_b = _proj_inputs(
        4, 2, 128, 32, torch.float32, cuda, 0)
    fwd = rnn_cuda.bilstm_seq_fwd_proj
    bwd = rnn_cuda.bilstm_seq_bwd_dgates_proj
    with pytest.raises(ValueError):                   # w_x dtype
        fwd(x, w_x.to(torch.bfloat16), bias, w_f, w_b, lens)
    with pytest.raises(ValueError):                   # bias not f32
        fwd(x, w_x, bias.to(torch.bfloat16), w_f, w_b, lens)
    with pytest.raises(ValueError):                   # w_x not [D, 8H]
        fwd(x, w_x[:, :-8].contiguous(), bias, w_f, w_b, lens)
    with pytest.raises(ValueError):                   # x not contiguous
        fwd(x.transpose(0, 1).contiguous().transpose(0, 1), w_x, bias, w_f,
            w_b, lens)
    with pytest.raises(ValueError):                   # w_h_b on the CPU
        fwd(x, w_x, bias, w_f, w_b.cpu(), lens)
    with pytest.raises(ValueError):                   # f64 x
        fwd(x.double(), w_x, bias, w_f, w_b, lens)
    with pytest.raises(ValueError):                   # lens not int
        fwd(x, w_x, bias, w_f, w_b, lens.float())
    y_f, c_f, y_b, c_b = fwd(x, w_x, bias, w_f, w_b, lens)
    with pytest.raises(ValueError):                   # dy dtype
        bwd(dy_f.to(torch.bfloat16), dy_b, x, y_f, c_f, y_b, c_b, w_x, bias,
            w_f, w_b, lens)
    with pytest.raises(ValueError):                   # c not f32
        bwd(dy_f, dy_b, x, y_f, c_f.to(torch.bfloat16), y_b, c_b, w_x, bias,
            w_f, w_b, lens)
    with pytest.raises(ValueError):                   # y_b shape
        bwd(dy_f, dy_b, x, y_f, c_f, y_b[:, :1].contiguous(), c_b, w_x, bias,
            w_f, w_b, lens)
    with pytest.raises(ValueError):                   # w_x on the CPU
        bwd(dy_f, dy_b, x, y_f, c_f, y_b, c_b, w_x.cpu(), bias, w_f, w_b,
            lens)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,dtype,proj", [
    (640, 320, "float32", False),     # a flagship layer above the first
    (40, 128, "float32", False),      # the 3x128's layer 1
    (256, 128, "float32", True),      # the 3x128's layers 2-3
    (256, 128, "bfloat16", False)])   # the same layer in bf16
def test_bilstm_layer_takes_the_reference_route(cuda, d, h, dtype, proj):
    """``bilstm_layer`` on the card launches K10a where
    ``use_in_kernel_proj`` holds and K2 elsewhere, once per layer."""
    t, b = 8, 2
    rng = np.random.default_rng(d + h)
    args = [torch.as_tensor((rng.standard_normal(s) * 0.1).astype(
        np.float32), device=cuda)
        for s in ((t, b, d), (d, 8 * h), (8 * h,), (h, 4 * h), (h, 4 * h))]
    lens = torch.full((b,), t, dtype=torch.int32, device=cuda)
    counts = (rnn_cuda.bilstm_seq_fwd.launches,
              rnn_cuda.bilstm_seq_fwd_proj.launches)
    with torch.no_grad():
        rnn_cuda.bilstm_layer(*args, lens, dtype)
    torch.cuda.synchronize()
    assert (rnn_cuda.bilstm_seq_fwd.launches - counts[0],
            rnn_cuda.bilstm_seq_fwd_proj.launches - counts[1]) == (
                (0, 1) if proj else (1, 0))


@pytest.mark.cuda
def test_proj_train_step_on_cuda_matches_plain(cuda, plain_kernels):
    """One f32 step of the 3x128 BLSTM of recipes/medium and recipes/hard
    (T cut to 40) through K2/K3 (layer 1), K10a/K10b (layers 2-3) and K1,
    against the same step on the plain versions on the card."""
    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train

    cfg = AmConfig(input_dim=40, num_targets=42, hidden_dim=128,
                   num_layers=3)
    rng = np.random.default_rng(0)
    b, t, lmax = 6, 40, 8
    batch = {"feats": rng.standard_normal((b, t, 40)).astype(np.float32),
             "labels": rng.integers(1, 42, (b, lmax)).astype(np.int32),
             "input_lens": np.array([40, 40, 33, 25, 17, 5], np.int32),
             "label_lens": np.array([8, 5, 8, 3, 8, 1], np.int32)}
    params = init_am_params(cfg, torch.Generator().manual_seed(0), cuda)
    step = train.build_train_step(cfg, train.TrainOptions(
        momentum=0.9, initial_learning_rate=1e-3))
    wrappers = (rnn_cuda.bilstm_seq_fwd, rnn_cuda.bilstm_seq_fwd_proj,
                rnn_cuda.bilstm_seq_bwd_dgates,
                rnn_cuda.bilstm_seq_bwd_dgates_proj, ctc_cuda.alpha_beta)
    counts = [w.launches for w in wrappers]
    state, m = step(train.init_train_state(params), batch)
    torch.cuda.synchronize()
    assert [w.launches - c for w, c in zip(wrappers, counts)] == \
        [1, 2, 1, 2, 1]
    assert bool(m["finite"]) and np.isfinite(float(m["loss_total"]))
    plain_kernels()
    state_p, m_p = step(train.init_train_state(params), batch)
    np.testing.assert_allclose(float(m["loss_total"]),
                               float(m_p["loss_total"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_p["grad_norm"]), rtol=1e-4)
    for g, r in zip(tree_flatten(state.params),
                    tree_flatten(state_p.params)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=1e-5)


def _uni_inputs(t, b, h, dtype, device, seed):
    rng = np.random.default_rng(seed)
    xp = torch.as_tensor(rng.standard_normal((t, b, 4 * h))
                         .astype(np.float32), device=device).to(dtype)
    w = torch.as_tensor((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                        .astype(np.float32), device=device).to(dtype)
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(0, t + 1, size=b - 1)   # row 0 full length
    return xp, w, torch.as_tensor(lens, device=device)


def _k6_lib():
    return _kernels.load("lstm_bwd", rnn_cuda._UNI_BWD_SIGNATURES)


def _k9b_lib():
    return _kernels.load("gru_bwd", gru_cuda._BWD_SIGNATURES)


def _close(got, ref, tol, name):
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=0, atol=tol,
                               err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (40, 2, 320), (240, 48, 320)])
def test_lstm_kernel_matches_plain(cuda, dtype, t, b, h, reverse):
    """K5 against its plain version, both directions, ragged rows."""
    xp, w, lens = _uni_inputs(t, b, h, dtype, cuda, seed=h + t)
    before = rnn_cuda.lstm_seq_fwd.launches
    got = rnn_cuda.lstm_seq_fwd(xp, w, lens, reverse)
    torch.cuda.synchronize()
    assert rnn_cuda.lstm_seq_fwd.launches == before + 1
    ref = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens, reverse)
    for name, g, r in zip(("y", "c_seq"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)
    for row, n in enumerate(lens.cpu().numpy()):     # y = 0 at pad frames
        assert not got[0][n:, row].any()


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (40, 2, 320), (240, 48, 320)])
def test_lstm_bwd_kernel_matches_plain(cuda, dtype, t, b, h, reverse):
    """K6 against its plain version on a forward of K5's plain version:
    its cluster route (phase 1, then the backward chain), as every H <=
    464 takes."""
    xp, w, lens = _uni_inputs(t, b, h, dtype, cuda, seed=h + t + 1)
    assert rnn_cuda.k6_plan(_k6_lib(), b, h, dtype, cuda).route == "cluster"
    y, c_seq = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens, reverse)
    dy = torch.as_tensor(np.random.default_rng(t).standard_normal(
        (t, b, h)).astype(np.float32), device=cuda).to(dtype)
    args = (dy, xp, y, c_seq, w, lens, reverse)
    before = rnn_cuda.lstm_seq_bwd_dgates.launches
    got = rnn_cuda.lstm_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.lstm_seq_bwd_dgates.launches == before + 1
    _close(got, rnn_cuda.lstm_seq_bwd_dgates_reference(*args),
           LSTM_BWD_TOL[dtype], "dgates")
    for row, n in enumerate(lens.cpu().numpy()):     # zero at pad frames
        assert not got[n:, row].any()


@pytest.mark.cuda
def test_lstm_kernels_reject_bad_inputs(cuda):
    xp, w, lens = _uni_inputs(4, 2, 16, torch.float32, cuda, 0)
    with pytest.raises(ValueError):                   # w_h dtype
        rnn_cuda.lstm_seq_fwd(xp, w.to(torch.bfloat16), lens)
    with pytest.raises(ValueError):                   # not [T, B, 4H]
        rnn_cuda.lstm_seq_fwd(xp[:, :, :-2], w, lens)
    with pytest.raises(ValueError):                   # lens on the CPU
        rnn_cuda.lstm_seq_fwd(xp, w, lens.cpu())
    y, c = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens)
    with pytest.raises(ValueError):                   # c_seq not f32
        rnn_cuda.lstm_seq_bwd_dgates(y, xp, y, c.to(torch.bfloat16), w, lens)
    with pytest.raises(ValueError):                   # y not contiguous
        rnn_cuda.lstm_seq_bwd_dgates(y, xp, y.transpose(0, 1).contiguous()
                                     .transpose(0, 1), c, w, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_k5_chain_matches_plain_at_any_batch(cuda, dtype, b, reverse):
    """K5 on its cluster route at H=320 (clusters of 16) against its plain
    version, ragged rows, both directions, one launch at B = 1, 48 and
    600 (in several waves of clusters, no row slices)."""
    t, h = 12, 320
    xp, w, lens = _uni_inputs(t, b, h, dtype, cuda, seed=b + reverse)
    assert rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 1, 132, 232448).route \
        == "cluster"
    before = rnn_cuda.lstm_seq_fwd.launches
    got = rnn_cuda.lstm_seq_fwd(xp, w, lens, reverse)
    torch.cuda.synchronize()
    assert rnn_cuda.lstm_seq_fwd.launches == before + 1
    ref = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens, reverse)
    for name, g, r in zip(("y", "c_seq"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)
    _zero_past_lens((got[0],), lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h", [(torch.float32, 512),
                                     (torch.bfloat16, 704)])
def test_k5_cooperative_route_at_a_large_h(cuda, dtype, h):
    """Where W_h fits no cluster of 16 the plan sends K5 to its
    cooperative kernel, which still matches its plain version."""
    t, b = 10, 3
    xp, w, lens = _uni_inputs(t, b, h, dtype, cuda, seed=h)
    assert rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 1, 132, 232448).route \
        == "cooperative"
    for reverse in (False, True):
        got = rnn_cuda.lstm_seq_fwd(xp, w, lens, reverse)
        torch.cuda.synchronize()
        ref = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens, reverse)
        for name, g, r in zip(("y", "c_seq"), got, ref):
            _close(g, r, LSTM_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_equals_k2_direction_bit_for_bit(cuda, dtype, reverse):
    """K5's (y, c) equal the forward direction of K2's cooperative kernel
    on the same x_proj and W_h (the backward direction for ``reverse``),
    bit for bit: the same warp_dot sums and the same gate math."""
    t, b, h = 20, 4, 320
    xp, w, lens = _uni_inputs(t, b, h, dtype, cuda, seed=5 + reverse)
    other, w2, _ = _uni_inputs(t, b, h, dtype, cuda, seed=9)
    halves = (other, xp) if reverse else (xp, other)
    ws = (w2, w) if reverse else (w, w2)
    got = rnn_cuda.lstm_seq_fwd(xp, w, lens, reverse)
    y_f, c_f, y_b, c_b = rnn_cuda._bilstm_fwd_cooperative(
        _kernels.load("bilstm_fwd", rnn_cuda._SIGNATURES),
        torch.cat(halves, dim=2).contiguous(), *ws, lens.to(torch.int32))
    torch.cuda.synchronize()
    want = (y_b, c_b) if reverse else (y_f, c_f)
    for name, g, r in zip(("y", "c_seq"), got, want):
        assert torch.equal(g, r), name


def _stack_inputs(layers, t, b, h, dtype, device, seed, stateful):
    rng = np.random.default_rng(seed)

    def mat(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=device)

    xp0 = mat(t, b, 4 * h).to(dtype)
    whs = [mat(h, 4 * h, scale=h ** -0.5).to(dtype) for _ in range(layers)]
    wxs = [mat(h, 4 * h, scale=h ** -0.5).to(dtype)
           for _ in range(layers - 1)]
    bs = [mat(4 * h, scale=0.2) for _ in range(layers - 1)]
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(0, t + 1, size=b - 1)
    lens[-1] = 0                                      # an idle slot
    h0 = mat(layers, b, h, scale=0.5) if stateful else None
    c0 = mat(layers, b, h, scale=0.5) if stateful else None
    return xp0, wxs, whs, bs, torch.as_tensor(lens, device=device), h0, c0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,t,b,h,stateful", [
    (1, 9, 3, 16, False), (3, 17, 3, 16, True), (5, 20, 8, 320, True),
    (2, 33, 4, 320, False)])
def test_lstm_stack_kernel_matches_plain(cuda, dtype, layers, t, b, h,
                                         stateful):
    """K7 against its plain version: y, h_fin and c_fin, with carries
    from a previous chunk, ragged rows and an idle slot."""
    args = _stack_inputs(layers, t, b, h, dtype, cuda, layers + t, stateful)
    assert rnn_cuda.lstm_stack_fits(layers, b, h, dtype, cuda)
    before = rnn_cuda.lstm_stack_fwd.launches
    got = rnn_cuda.lstm_stack_fwd(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.lstm_stack_fwd.launches == before + 1
    ref = rnn_cuda.lstm_stack_fwd_reference(*args)
    for name, g, r in zip(("y", "h_fin", "c_fin"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)
    if stateful:                                      # the idle slot keeps
        assert torch.equal(got[1][:, -1], args[5][:, -1])   # its state
        assert torch.equal(got[2][:, -1], args[6][:, -1])


@pytest.mark.cuda
def test_lstm_stack_kernel_rejects_bad_inputs(cuda):
    xp0, wxs, whs, bs, lens, h0, c0 = _stack_inputs(
        3, 5, 2, 16, torch.float32, cuda, 0, True)
    with pytest.raises(ValueError):                   # one w_x too few
        rnn_cuda.lstm_stack_fwd(xp0, wxs[:1], whs, bs, lens, h0, c0)
    with pytest.raises(ValueError):                   # bias not f32
        rnn_cuda.lstm_stack_fwd(xp0, wxs, whs, [b.half() for b in bs], lens)
    with pytest.raises(ValueError):                   # h0 of 2 layers
        rnn_cuda.lstm_stack_fwd(xp0, wxs, whs, bs, lens, h0[:2], c0)
    # the residency rule, from shapes alone (k7_plan): the 8-slot tick of
    # the 5 x 320 stack in one launch, bf16 on the cluster route, f32 on
    # the cooperative kernel (f32 W_h and W_x leave a cluster 5 rows)
    lib = _k7_lib()
    assert rnn_cuda.lstm_stack_fits(5, 8, 320, torch.bfloat16, cuda)
    assert rnn_cuda.k7_plan(lib, 5, 8, 320, torch.bfloat16,
                            cuda).route == "cluster"
    assert rnn_cuda.lstm_stack_fits(5, 8, 320, torch.float32, cuda)
    assert rnn_cuda.k7_plan(lib, 5, 8, 320, torch.float32,
                            cuda).route == "cooperative"
    assert not rnn_cuda.lstm_stack_fits(5, 4096, 320, torch.float32, cuda)
    assert not rnn_cuda.lstm_stack_fits(17, 1, 16, torch.float32, cuda)


def _k7_lib():
    return _kernels.load("lstm_stack", rnn_cuda._STACK_SIGNATURES)


def _k7_routes(args, plan):
    """(cluster route, cooperative route) of K7 on the same checked
    operands, each (y, h_fin, c_fin)."""
    lib = _k7_lib()
    xp0, wxs, whs, bs, lens, h0, c0 = args
    ops = (xp0, wxs, whs, bs, lens.to(torch.int32), h0, c0)
    return (rnn_cuda._lstm_stack_chain(lib, *ops, plan),
            rnn_cuda._lstm_stack_cooperative(lib, *ops))


# the smoke's ragged lengths of an 8-slot tick: full, short, idle, one
STREAM_LENS = [20, 20, 13, 0, 20, 7, 20, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,t,b,h,stateful", [
    (1, 9, 3, 16, False), (3, 17, 3, 16, True), (5, 20, 8, 320, True),
    (2, 33, 4, 320, False), (5, 20, 1, 320, True), (1, 20, 200, 320, True),
    (4, 7, 5, 96, True)])
def test_k7_chain_matches_plain(cuda, dtype, layers, t, b, h, stateful):
    """K7's cluster route (the wavefront of per-layer clusters) against
    its plain version: y, h_fin and c_fin, carries from a previous chunk,
    ragged rows and an idle slot that keeps (h, c); f32 at B = 8 (5 rows a
    cluster) in row slices of the cluster route."""
    args = _stack_inputs(layers, t, b, h, dtype, cuda, 3 * layers + t,
                         stateful)
    plan = rnn_cuda.k7_plan(_k7_lib(), layers, b, h, dtype, cuda)
    assert plan.cluster > 0, plan
    xp0, wxs, whs, bs, lens, h0, c0 = args
    got = rnn_cuda._lstm_stack_chain(_k7_lib(), xp0, wxs, whs, bs,
                                     lens.to(torch.int32), h0, c0, plan)
    torch.cuda.synchronize()
    ref = rnn_cuda.lstm_stack_fwd_reference(*args)
    for name, g, r in zip(("y", "h_fin", "c_fin"), got, ref):
        _close(g, r, LSTM_TOL[dtype], name)
    _zero_past_lens(got[:1], lens, "y")
    if stateful:                                      # the idle slot keeps
        assert torch.equal(got[1][:, -1], h0[:, -1])  # its state
        assert torch.equal(got[2][:, -1], c0[:, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8])
def test_k7_chain_equals_cooperative_bit_for_bit(cuda, dtype, b):
    """The witness: at the streaming shape (L=5, T=20, H=320) with the
    smoke's ragged lengths and carried (h0, c0), the cluster route's y,
    h_fin and c_fin equal the cooperative lstm_stack_kernel's bit for bit
    (warp_dot's sums, one fmaf form of c', the projection rounded as
    round(p + b), the f32 carry of h)."""
    layers, t, h = 5, 20, 320
    args = list(_stack_inputs(layers, t, b, h, dtype, cuda, b + 40, True))
    args[4] = torch.tensor(STREAM_LENS[:b], dtype=torch.int32, device=cuda)
    plan = rnn_cuda.k7_plan(_k7_lib(), layers, b, h, dtype, cuda)
    chain, coop = _k7_routes(args, plan)
    torch.cuda.synchronize()
    for name, c, k in zip(("y", "h_fin", "c_fin"), chain, coop):
        assert torch.equal(c, k), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_at_its_ceiling_and_one_row_above(cuda, dtype):
    """The 5 x 320 stack at the most rows one launch takes (the larger of
    the cluster route's and the cooperative kernel's: 42 rows in bf16 on
    the cluster route, 32 in f32 on the cooperative kernel) fits and runs
    in one launch; one row more does not fit and runs the cluster route in
    row slices; both match the plain version, one counted launch each."""
    layers, t, h = 5, 6, 320
    lib = _k7_lib()
    plan = rnn_cuda.k7_plan(lib, layers, 1, h, dtype, cuda)
    top = max(plan.chain_rows, plan.coop_rows)
    for b, fits in ((top, True), (top + 1, False)):
        assert rnn_cuda.lstm_stack_fits(layers, b, h, dtype, cuda) == fits
        route = rnn_cuda.k7_plan(lib, layers, b, h, dtype, cuda).route
        assert route == ("cluster" if b == plan.chain_rows or not fits
                         else "cooperative"), (b, route)
        args = _stack_inputs(layers, t, b, h, dtype, cuda, b, True)
        before = rnn_cuda.lstm_stack_fwd.launches
        got = rnn_cuda.lstm_stack_fwd(*args)
        torch.cuda.synchronize()
        assert rnn_cuda.lstm_stack_fwd.launches == before + 1
        for name, g, r in zip(("y", "h_fin", "c_fin"), got,
                              rnn_cuda.lstm_stack_fwd_reference(*args)):
            _close(g, r, LSTM_TOL[dtype], name)


@pytest.mark.cuda
def test_k7_chain_residency_and_launch_errors(cuda):
    """A launch of the cluster route over several layers holds one of its
    two guarantees of co-residency (the cooperative launch, or the checked
    count of co-resident clusters), and the card holds at least the five
    clusters of the 5 x 320 stack; a launch the card refuses (a cluster of
    32 CTAs) raises through _kernels.check."""
    lib = _k7_lib()
    args = _stack_inputs(5, 6, 3, 320, torch.bfloat16, cuda, 1, True)
    plan = rnn_cuda.k7_plan(lib, 5, 3, 320, torch.bfloat16, cuda)
    assert lib.lstm_stack_chain_clusters_bf16(5, 320, plan.cluster,
                                              plan.rows) >= 5
    _k7_routes(args, plan)
    torch.cuda.synchronize()
    assert lib.lstm_stack_chain_residency() in (1, 2)
    with pytest.raises(RuntimeError, match="lstm_stack_fwd"):
        _k7_routes(args, plan._replace(cluster=32))


def _uni_model(tmp_path, dtype, layers=5, h=32, mode=None):
    from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig,
                                                     default_priors,
                                                     init_am_params)
    from kaldi_ctc_tpu_torch.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode

    cfg = AmConfig(input_dim=40, num_targets=9, hidden_dim=h,
                   num_layers=layers, mode=mode or RnnMode.LSTM,
                   bidirectional=False, compute_dtype=dtype)
    path = str(tmp_path / "uni.npz")
    save_inference_artifact(path, init_am_params(
        cfg, torch.Generator().manual_seed(0)), cfg, default_priors(9))
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uni_stream_engine_on_cuda_matches_plain(cuda, dtype, per_layer,
                                                 tmp_path, monkeypatch):
    """A unidirectional engine on the card: /recognize through K5 (5
    launches), every streaming tick through one K7 launch (or, where the
    stack does not fit, one per layer), the streamed labels equal to
    /recognize's, and the chunk scores equal to the CPU engine's."""
    from kaldi_ctc_tpu_torch.cli import serve

    if per_layer:
        monkeypatch.setattr(rnn_cuda, "lstm_stack_fits",
                            lambda *a, **k: False)
    path = _uni_model(tmp_path, dtype)
    flags = ["--model", path, "--max-streams", "3", "--chunk-frames", "7"]
    gpu = serve.Engine(serve.parse_args(flags))
    cpu = serve.Engine(serve.parse_args(flags + ["--device", "cpu"]))
    rng = np.random.default_rng(2)
    x = (np.cumsum(rng.standard_normal(12000)) * 50).astype(np.float32)
    k5 = rnn_cuda.lstm_seq_fwd.launches
    offline = gpu.recognize(x)
    assert rnn_cuda.lstm_seq_fwd.launches - k5 == 5
    k7, ticks = rnn_cuda.lstm_stack_fwd.launches, gpu.stream.ticks
    slot = gpu.stream_start()
    for lo in range(0, len(x), 1700):
        gpu.stream_chunk(slot, x[lo:lo + 1700])
    assert gpu.stream_end(slot)["labels"] == offline["labels"]
    ticks = gpu.stream.ticks - ticks
    assert ticks > 0
    assert rnn_cuda.lstm_stack_fwd.launches - k7 == ticks * (
        5 if per_layer else 1)
    feats = gpu.feats_for(x)[:21]                     # three full chunks
    block = torch.zeros((3, 7, 40), device=cuda)
    st_g = gpu.stream._state
    st_c = [tuple(a.cpu() for a in st) for st in st_g]
    tol = 1e-4 if dtype == "float32" else 5e-2
    for lo in range(0, 21, 7):
        block[1] = feats[lo:lo + 7]
        lens = torch.tensor([0, 7, 3], dtype=torch.int32)
        sg, st_g = gpu.stream.chunk_fn(block.transpose(0, 1), lens.to(cuda),
                                       st_g)
        sc, st_c = cpu.stream.chunk_fn(block.transpose(0, 1).cpu(), lens,
                                       st_c)
        np.testing.assert_allclose(sg.cpu().numpy(), sc.numpy(), rtol=0,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uni_train_step_on_cuda_matches_plain(cuda, dtype, plain_kernels):
    """One step of the unidirectional 5x320 (T cut to 40) through K5, K6
    and K1, against the same step on the plain versions on the card."""
    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train

    cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=320,
                   num_layers=5, bidirectional=False, compute_dtype=dtype)
    rng = np.random.default_rng(0)
    b, t, lmax = 6, 40, 8
    batch = {"feats": rng.standard_normal((b, t, 40)).astype(np.float32),
             "labels": rng.integers(1, 72, (b, lmax)).astype(np.int32),
             "input_lens": np.array([40, 40, 33, 25, 17, 5], np.int32),
             "label_lens": np.array([8, 5, 8, 3, 8, 1], np.int32)}
    params = init_am_params(cfg, torch.Generator().manual_seed(0), cuda)
    step = train.build_train_step(cfg, train.TrainOptions(momentum=0.9))
    counts = (rnn_cuda.lstm_seq_fwd.launches,
              rnn_cuda.lstm_seq_bwd_dgates.launches,
              ctc_cuda.alpha_beta.launches)
    state, m = step(train.init_train_state(params), batch)
    torch.cuda.synchronize()
    assert (rnn_cuda.lstm_seq_fwd.launches - counts[0],
            rnn_cuda.lstm_seq_bwd_dgates.launches - counts[1],
            ctc_cuda.alpha_beta.launches - counts[2]) == (5, 5, 1)
    assert bool(m["finite"]) and np.isfinite(float(m["loss_total"]))
    plain_kernels()
    state_p, m_p = step(train.init_train_state(params), batch)
    rtol = 1e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(float(m["loss_total"]),
                               float(m_p["loss_total"]), rtol=rtol)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_p["grad_norm"]), rtol=10 * rtol)
    for g, r in zip(tree_flatten(state.params),
                    tree_flatten(state_p.params)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=1e-5 if dtype == "float32" else 1e-4)


def _gru_inputs(t, b, h, dtype, device, seed, dirs=1):
    """Seeded GRU operands: a projection [T, B, dirs*3H], ``dirs``
    recurrent weights [H, 3H] and cotangents [T, B, H], lengths with row 0
    full and the rest ragged (some 0)."""
    rng = np.random.default_rng(seed)

    def mat(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=device).to(dtype)

    xp = mat(t, b, dirs * 3 * h)
    ws = [mat(h, 3 * h, scale=h ** -0.5) for _ in range(dirs)]
    dys = [mat(t, b, h) for _ in range(dirs)]
    lens = np.full(b, t, np.int32)
    lens[1:] = rng.integers(0, t + 1, size=b - 1)
    return xp, ws, dys, torch.as_tensor(lens, device=device)


def _zero_past_lens(outs, lens, name):
    for row, n in enumerate(lens.cpu().numpy()):
        for g in outs:
            assert not g[n:, row].any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (40, 2, 320), (240, 48, 320)])
def test_gru_kernel_matches_plain(cuda, dtype, t, b, h, reverse):
    """K9a against its plain version, both directions, ragged rows."""
    xp, (w,), _, lens = _gru_inputs(t, b, h, dtype, cuda, seed=h + t)
    before = gru_cuda.gru_seq_fwd.launches
    got = gru_cuda.gru_seq_fwd(xp, w, lens, reverse)
    torch.cuda.synchronize()
    assert gru_cuda.gru_seq_fwd.launches == before + 1
    _close(got, gru_cuda.gru_seq_fwd_reference(xp, w, lens, reverse),
           GRU_TOL[dtype], "y")
    _zero_past_lens([got], lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (40, 2, 320), (240, 48, 320)])
def test_gru_bwd_kernel_matches_plain(cuda, dtype, t, b, h, reverse):
    """K9b's dgx and dgh against its plain version on a forward of K9a's
    plain version: its cluster route (phase 1, then the backward chain),
    as every H <= 544 takes."""
    xp, (w,), (dy,), lens = _gru_inputs(t, b, h, dtype, cuda, seed=h + t + 1)
    assert gru_cuda.k9b_plan(_k9b_lib(), b, h, dtype, cuda).route \
        == "cluster"
    y = gru_cuda.gru_seq_fwd_reference(xp, w, lens, reverse)
    args = (dy, xp, y, w, lens, reverse)
    before = gru_cuda.gru_seq_bwd_dgates.launches
    got = gru_cuda.gru_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert gru_cuda.gru_seq_bwd_dgates.launches == before + 1
    for name, g, r in zip(("dgx", "dgh"), got,
                          gru_cuda.gru_seq_bwd_dgates_reference(*args)):
        _close(g, r, GRU_BWD_TOL[dtype], name)
    _zero_past_lens(got, lens, "dgates")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (16, 3, 128), (40, 2, 320),
                                   (240, 48, 320)])
def test_bigru_kernel_matches_plain(cuda, dtype, t, b, h):
    """K8a against its plain version: both directions in one launch."""
    xp, (w_f, w_b), _, lens = _gru_inputs(t, b, h, dtype, cuda, h + t, 2)
    before = gru_cuda.bigru_seq_fwd.launches
    got = gru_cuda.bigru_seq_fwd(xp, w_f, w_b, lens)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_seq_fwd.launches == before + 1
    ref = gru_cuda.bigru_seq_fwd_reference(xp, w_f, w_b, lens)
    for name, g, r in zip(("y_f", "y_b"), got, ref):
        _close(g, r, GRU_TOL[dtype], name)
    _zero_past_lens(got, lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(16, 3, 16), (16, 3, 128), (40, 2, 320),
                                   (240, 48, 320)])
def test_bigru_bwd_kernel_matches_plain(cuda, dtype, t, b, h):
    """K8b's four outputs against its plain version on a forward of K8a's
    plain version."""
    xp, (w_f, w_b), (dy_f, dy_b), lens = _gru_inputs(t, b, h, dtype, cuda,
                                                     h + t + 1, 2)
    y_f, y_b = gru_cuda.bigru_seq_fwd_reference(xp, w_f, w_b, lens)
    args = (dy_f, dy_b, xp, y_f, y_b, w_f, w_b, lens)
    before = gru_cuda.bigru_seq_bwd_dgates.launches
    got = gru_cuda.bigru_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_seq_bwd_dgates.launches == before + 1
    ref = gru_cuda.bigru_seq_bwd_dgates_reference(*args)
    for name, g, r in zip(("dgx_f", "dgh_f", "dgx_b", "dgh_b"), got, ref):
        _close(g, r, GRU_BWD_TOL[dtype], name)
    _zero_past_lens(got, lens, "dgates")


# the f32 and bf16 H from which K9a takes its cooperative route (W_h's
# three gate columns fit no cluster of 16: fwd_chain_plan with 3 gates)
K9A_COOPERATIVE_H = {torch.float32: 576, torch.bfloat16: 800}


def _gru_lib():
    return _kernels.load("gru_fwd", gru_cuda._FWD_SIGNATURES)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_k9a_chain_matches_plain_at_any_batch(cuda, dtype, b, reverse):
    """K9a at H=320 (clusters of 16) against its plain version, ragged
    rows, both directions, one launch at B = 1, 48 and 600 (several waves
    of clusters, no row slices), through the wrapper and through the
    cluster route's export."""
    t, h = 12, 320
    xp, (w,), _, lens = _gru_inputs(t, b, h, dtype, cuda, seed=b + reverse)
    lib = _gru_lib()
    assert gru_cuda.k9a_plan(lib, b, h, dtype, cuda).route == "cluster"
    before = gru_cuda.gru_seq_fwd.launches
    got = gru_cuda.gru_seq_fwd(xp, w, lens, reverse)
    chain = gru_cuda._gru_fwd_chain(
        lib, xp, w, lens.to(torch.int32), reverse,
        rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 1, 132, 232448, gates=3))
    torch.cuda.synchronize()
    assert gru_cuda.gru_seq_fwd.launches == before + 1
    ref = gru_cuda.gru_seq_fwd_reference(xp, w, lens, reverse)
    for y in (got, chain):
        _close(y, ref, GRU_TOL[dtype], "y")
        _zero_past_lens([y], lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9a_cooperative_route_at_a_large_h(cuda, dtype):
    """Where W_h fits no cluster of 16 the plan sends K9a to its
    cooperative kernel, which still matches its plain version."""
    t, b, h = 10, 3, K9A_COOPERATIVE_H[dtype]
    xp, (w,), _, lens = _gru_inputs(t, b, h, dtype, cuda, seed=h)
    assert gru_cuda.k9a_plan(_gru_lib(), b, h, dtype, cuda).route \
        == "cooperative"
    for reverse in (False, True):
        before = gru_cuda.gru_seq_fwd.launches
        got = gru_cuda.gru_seq_fwd(xp, w, lens, reverse)
        torch.cuda.synchronize()
        assert gru_cuda.gru_seq_fwd.launches == before + 1
        _close(got, gru_cuda.gru_seq_fwd_reference(xp, w, lens, reverse),
               GRU_TOL[dtype], "y")


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(1, 320), (5, 128), (5, 320)])
def test_k9a_chain_equals_k9a_cooperative_bit_for_bit(cuda, dtype, b, h,
                                                      reverse):
    """K9a's two routes give the same y bit for bit, ragged rows: the same
    warp_dot sums and the same gru_cell(), the f32 carry in both."""
    t = 20
    xp, (w,), _, lens = _gru_inputs(t, b, h, dtype, cuda, seed=3 * h + b)
    lib = _gru_lib()
    lens32 = lens.to(torch.int32)
    chain = gru_cuda._gru_fwd_chain(
        lib, xp, w, lens32, reverse,
        rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 1, 132, 232448, gates=3))
    coop = gru_cuda._gru_fwd_cooperative(lib, xp, w, lens32, reverse)
    torch.cuda.synchronize()
    assert torch.equal(chain, coop)


@pytest.mark.cuda
def test_gru_kernels_reject_bad_inputs(cuda):
    xp, (w,), (dy,), lens = _gru_inputs(4, 2, 16, torch.float32, cuda, 0)
    with pytest.raises(ValueError):                   # w_h dtype
        gru_cuda.gru_seq_fwd(xp, w.to(torch.bfloat16), lens)
    with pytest.raises(ValueError):                   # not [T, B, 3H]
        gru_cuda.gru_seq_fwd(xp[:, :, :-2].contiguous(), w, lens)
    with pytest.raises(ValueError):                   # lens on the CPU
        gru_cuda.gru_seq_fwd(xp, w, lens.cpu())
    y = gru_cuda.gru_seq_fwd_reference(xp, w, lens)
    with pytest.raises(ValueError):                   # y not contiguous
        gru_cuda.gru_seq_bwd_dgates(dy, xp, y.transpose(0, 1).contiguous()
                                    .transpose(0, 1), w, lens)
    with pytest.raises(ValueError):                   # dy dtype
        gru_cuda.gru_seq_bwd_dgates(dy.double(), xp, y, w, lens)
    xp2, (w_f, w_b), (dy_f, dy_b), lens2 = _gru_inputs(
        4, 2, 16, torch.float32, cuda, 0, 2)
    with pytest.raises(ValueError):                   # w_h_b dtype
        gru_cuda.bigru_seq_fwd(xp2, w_f, w_b.to(torch.bfloat16), lens2)
    with pytest.raises(ValueError):                   # y in another dtype
        gru_cuda.bigru_seq_fwd(xp2, w_f, w_b, lens2, y_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                   # lens not int
        gru_cuda.bigru_seq_fwd(xp2, w_f, w_b, lens2.float())
    y_f, y_b = gru_cuda.bigru_seq_fwd_reference(xp2, w_f, w_b, lens2)
    with pytest.raises(ValueError):                   # xp not contiguous
        gru_cuda.bigru_seq_bwd_dgates(
            dy_f, dy_b, xp2.transpose(0, 1).contiguous().transpose(0, 1),
            y_f, y_b, w_f, w_b, lens2)
    with pytest.raises(ValueError):                   # lens on the CPU
        gru_cuda.bigru_seq_bwd_dgates(dy_f, dy_b, xp2, y_f, y_b, w_f, w_b,
                                      lens2.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_train_step_on_cuda_matches_plain(cuda, dtype, bidirectional,
                                              plain_kernels):
    """One step of the 5x320 BiGRU (K8a, K8b) or GRU (K9a, K9b), T cut to
    40, with K1, against the same step on the plain versions on the
    card."""
    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train

    cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=320,
                   num_layers=5, mode=RnnMode.GRU,
                   bidirectional=bidirectional, compute_dtype=dtype)
    fwd, bwd = ((gru_cuda.bigru_seq_fwd, gru_cuda.bigru_seq_bwd_dgates)
                if bidirectional else
                (gru_cuda.gru_seq_fwd, gru_cuda.gru_seq_bwd_dgates))
    rng = np.random.default_rng(0)
    b, t, lmax = 6, 40, 8
    batch = {"feats": rng.standard_normal((b, t, 40)).astype(np.float32),
             "labels": rng.integers(1, 72, (b, lmax)).astype(np.int32),
             "input_lens": np.array([40, 40, 33, 25, 17, 5], np.int32),
             "label_lens": np.array([8, 5, 8, 3, 8, 1], np.int32)}
    params = init_am_params(cfg, torch.Generator().manual_seed(0), cuda)
    step = train.build_train_step(cfg, train.TrainOptions(momentum=0.9))
    counts = (fwd.launches, bwd.launches, ctc_cuda.alpha_beta.launches)
    state, m = step(train.init_train_state(params), batch)
    torch.cuda.synchronize()
    assert (fwd.launches - counts[0], bwd.launches - counts[1],
            ctc_cuda.alpha_beta.launches - counts[2]) == (5, 5, 1)
    assert bool(m["finite"]) and np.isfinite(float(m["loss_total"]))
    plain_kernels()
    state_p, m_p = step(train.init_train_state(params), batch)
    rtol = 1e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(float(m["loss_total"]),
                               float(m_p["loss_total"]), rtol=rtol)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_p["grad_norm"]), rtol=10 * rtol)
    for g, r in zip(tree_flatten(state.params),
                    tree_flatten(state_p.params)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=1e-5 if dtype == "float32" else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_stream_engine_on_cuda_matches_plain(cuda, dtype, tmp_path):
    """A unidirectional GRU engine on the card: /recognize through K9a (5
    launches), the streaming ticks through the per-layer loop in torch ops
    (no kernel launch, as the JAX package runs its XLA scan), the
    streamed labels equal to /recognize's, and the chunk scores equal to
    the CPU engine's."""
    from kaldi_ctc_tpu_torch.cli import serve
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode

    path = _uni_model(tmp_path, dtype, mode=RnnMode.GRU)
    flags = ["--model", path, "--max-streams", "3", "--chunk-frames", "7"]
    gpu = serve.Engine(serve.parse_args(flags))
    cpu = serve.Engine(serve.parse_args(flags + ["--device", "cpu"]))
    rng = np.random.default_rng(2)
    x = (np.cumsum(rng.standard_normal(12000)) * 50).astype(np.float32)
    k9 = gru_cuda.gru_seq_fwd.launches
    offline = gpu.recognize(x)
    assert gru_cuda.gru_seq_fwd.launches - k9 == 5
    k7, ticks = rnn_cuda.lstm_stack_fwd.launches, gpu.stream.ticks
    slot = gpu.stream_start()
    for lo in range(0, len(x), 1700):
        gpu.stream_chunk(slot, x[lo:lo + 1700])
    assert gpu.stream_end(slot)["labels"] == offline["labels"]
    assert gpu.stream.ticks - ticks > 0
    assert rnn_cuda.lstm_stack_fwd.launches == k7
    feats = gpu.feats_for(x)[:21]                     # three full chunks
    block = torch.zeros((3, 7, 40), device=cuda)
    st_g = gpu.stream._state
    st_c = [h.cpu() for h in st_g]                    # a GRU carries h only
    tol = 1e-4 if dtype == "float32" else 5e-2
    for lo in range(0, 21, 7):
        block[1] = feats[lo:lo + 7]
        lens = torch.tensor([0, 7, 3], dtype=torch.int32)
        sg, st_g = gpu.stream.chunk_fn(block.transpose(0, 1), lens.to(cuda),
                                       st_g)
        sc, st_c = cpu.stream.chunk_fn(block.transpose(0, 1).cpu(), lens,
                                       st_c)
        np.testing.assert_allclose(sg.cpu().numpy(), sc.numpy(), rtol=0,
                                   atol=tol)


# ---------------------------------------------------------------------------
# K6 and K9b on the backward chain (csrc/bwd_chain.cuh)
# ---------------------------------------------------------------------------

# the f32 H from which K6 and K9b take their cooperative routes: W_h's
# four or three gate columns as f32 fit no cluster of 16 (bwd_chain_plan)
BWD_COOPERATIVE_H = {"K6": 512, "K9b": 576}


def _bwd_case(name, t, b, h, dtype, device, seed, reverse=False):
    """(wrapper, plain version, operands, tolerance, names of the
    outputs, lib, plan) of K6 or K9b on a forward of the plain version,
    ragged rows."""
    if name == "K6":
        xp, w, lens = _uni_inputs(t, b, h, dtype, device, seed)
        y, c = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens, reverse)
        dy = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
            (t, b, h)).astype(np.float32), device=device).to(dtype)
        lib = _k6_lib()
        return (rnn_cuda.lstm_seq_bwd_dgates,
                rnn_cuda.lstm_seq_bwd_dgates_reference,
                (dy, xp, y, c, w, lens, reverse), LSTM_BWD_TOL[dtype],
                ("dgates",), lib, rnn_cuda.k6_plan(lib, b, h, dtype, device))
    xp, (w,), (dy,), lens = _gru_inputs(t, b, h, dtype, device, seed)
    y = gru_cuda.gru_seq_fwd_reference(xp, w, lens, reverse)
    lib = _k9b_lib()
    return (gru_cuda.gru_seq_bwd_dgates, gru_cuda.gru_seq_bwd_dgates_reference,
            (dy, xp, y, w, lens, reverse), GRU_BWD_TOL[dtype], ("dgx", "dgh"),
            lib, gru_cuda.k9b_plan(lib, b, h, dtype, device))


def _routes(name, lib, args, plan):
    """(cluster route, cooperative route) of K6 or K9b on the same checked
    operands, each a tuple of outputs."""
    *ops, lens, reverse = args
    lens32 = lens.to(torch.int32)
    if name == "K6":
        return ((rnn_cuda._lstm_bwd_chain(lib, *ops, lens32, reverse, plan),),
                (rnn_cuda._lstm_bwd_cooperative(lib, *ops, lens32, reverse),))
    return (gru_cuda._gru_bwd_chain(lib, *ops, lens32, reverse, plan),
            gru_cuda._gru_bwd_cooperative(lib, *ops, lens32, reverse))


def _outputs(got):
    return got if isinstance(got, tuple) else (got,)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 600])
@pytest.mark.parametrize("name", ["K6", "K9b"])
def test_k6_k9b_chain_matches_plain_at_any_batch(cuda, name, b, dtype,
                                                 reverse):
    """K6 and K9b on their cluster route at H=320 at the serving batch B=1
    and at B=600 (several waves of clusters, no row slices; T=120 puts
    the phase-1 scratch above 256 MiB, so the walk runs in two chunks of
    steps) against their plain versions, ragged rows, zero at pad frames,
    one launch a call."""
    t = 120 if b == 600 else 30
    fn, ref, args, tol, names, _, plan = _bwd_case(
        name, t, b, 320, dtype, cuda, seed=b + reverse, reverse=reverse)
    assert plan.route == "cluster" and plan.cluster == 16, plan
    g = (4 if name == "K6" else 3) * 320
    chunks = -(-t // rnn_cuda._scratch_steps(t, b, g))
    assert chunks == (2 if b == 600 else 1)
    before = fn.launches
    got = _outputs(fn(*args))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for n, gv, rv in zip(names, got, _outputs(ref(*args))):
        _close(gv, rv, tol, n)
    _zero_past_lens(got, args[-2], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [32, 320])
@pytest.mark.parametrize("name", ["K6", "K9b"])
def test_k6_k9b_in_chunks_of_steps_equal_one_chunk(cuda, name, h, dtype,
                                                   monkeypatch):
    """K6 and K9b with their scratch cut to 3 steps: the chain carries dh
    (and K6's dc) between the chunks, and the outputs equal one chunk's
    bit for bit (both directions)."""
    t, b = 10, 5
    for reverse in (False, True):
        fn, _, args, _, names, _, _ = _bwd_case(name, t, b, h, dtype, cuda,
                                                seed=h, reverse=reverse)
        whole = _outputs(fn(*args))
        g = (4 if name == "K6" else 3) * h
        with monkeypatch.context() as m:
            m.setattr(rnn_cuda, "_K10_SCRATCH_BYTES", 3 * b * g * 4)
            assert rnn_cuda._scratch_steps(t, b, g) == 3
            chunked = _outputs(fn(*args))
        torch.cuda.synchronize()
        for n, c, w in zip(names, chunked, whole):
            assert torch.equal(c, w), (n, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["K6", "K9b"])
def test_k6_k9b_cluster_route_agrees_with_cooperative(cuda, name, dtype,
                                                      reverse):
    """K6's and K9b's two routes on the same operands (H=320, ragged
    rows): the same gates (warp_dot's sums in both), the dh sums in
    another order (partials per CTA of a cluster, then over the ranks),
    so within the backward tolerance rather than bit for bit."""
    fn, _, args, tol, names, lib, plan = _bwd_case(
        name, 40, 5, 320, dtype, cuda, seed=11, reverse=reverse)
    chain, coop = _routes(name, lib, args, plan)
    torch.cuda.synchronize()
    for n, c, k in zip(names, chain, coop):
        _close(c, k, tol, n)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["K6", "K9b"])
def test_k6_k9b_routes_equal_where_dh_is_zero(cuda, name, dtype, reverse):
    """The recompute invariant, witnessed by K6's and K9b's cooperative
    kernels, which recompute the gates with warp_dot in its order: at
    each row's first valid frame of the walk (t = len - 1, or t = 0 for a
    reverse direction) dh (and dc) are still zero, so the two routes'
    outputs there depend on the gates alone and are equal bit for bit."""
    t, b, h = 24, 6, 320
    fn, _, args, _, names, lib, plan = _bwd_case(
        name, t, b, h, dtype, cuda, seed=29, reverse=reverse)
    chain, coop = _routes(name, lib, args, plan)
    torch.cuda.synchronize()
    lens = args[-2].cpu().numpy()
    assert lens.min() >= 0 and (lens > 0).sum() >= 3
    for n, c, k in zip(names, chain, coop):
        for row, length in enumerate(lens):
            if length:
                first = 0 if reverse else length - 1
                assert torch.equal(c[first, row], k[first, row]), (n, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [128, 320])
@pytest.mark.parametrize("name", ["K6", "K9b"])
def test_k6_k9b_phase1_kernels_agree_bit_for_bit(cuda, name, h, dtype):
    """K6's and K9b's tiled phase 1 (tile_dot4x4, warp_dot's order walked
    by one thread) and their warp kernel (warp_dot itself) give the same
    recurrent sums bit for bit, for four and three gate columns, on a
    chunk of steps that starts mid-walk and one that ends it (its last
    step, the forward's first, sums over zeros), both directions."""
    t, b = 7, 5
    _, _, args, _, _, lib, plan = _bwd_case(name, t, b, h, dtype, cuda,
                                            seed=h + 3)
    assert plan.gate_cols == 0                # tiled at these H
    gates = 4 if name == "K6" else 3
    y, w = args[2], args[-3]
    prefix = "lstm_bwd_gates_" if name == "K6" else "gru_bwd_gates_"
    fn = getattr(lib, prefix + rnn_cuda._SUFFIX[dtype])
    for reverse in (0, 1):
        for s0, n in ((2, 3), (4, 3)):
            got = []
            for cols in (0, 32):
                pre = torch.full((n, b, gates * h), float("nan"), device=cuda)
                _kernels.check(lib, fn(y.data_ptr(), w.data_ptr(),
                                       pre.data_ptr(), s0, n, t, b, h, cols,
                                       reverse,
                                       _kernels.stream_ptr(cuda)), prefix)
                got.append(pre)
            torch.cuda.synchronize()
            assert not got[0].isnan().any()
            assert torch.equal(got[0], got[1]), (reverse, s0, n)
            if s0 + n == t:                   # the forward's first step
                assert not got[0][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["K6", "K9b"])
def test_k6_k9b_cooperative_route_at_a_large_h(cuda, name, dtype):
    """Where W_h's gate columns as f32 fit no cluster of 16 (K6 from H ~
    470, K9b from ~550, in either dtype) the plan sends K6 and K9b to
    their cooperative kernels, which still match their plain versions."""
    h = BWD_COOPERATIVE_H[name]
    for reverse in (False, True):
        fn, ref, args, tol, names, _, plan = _bwd_case(
            name, 10, 3, h, dtype, cuda, seed=h, reverse=reverse)
        assert plan.route == "cooperative", plan
        before = fn.launches
        got = _outputs(fn(*args))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for n, gv, rv in zip(names, got, _outputs(ref(*args))):
            _close(gv, rv, tol, n)


@pytest.mark.cuda
def test_k6_k9b_chain_launch_errors_raise(cuda):
    """A cluster launch the card refuses (here a cluster of 32 CTAs, past
    the 16 the chain takes) raises through _kernels.check: no silent
    switch to the other route or to the plain version."""
    for name in ("K6", "K9b"):
        _, _, args, _, _, lib, plan = _bwd_case(name, 6, 3, 32,
                                                torch.float32, cuda, seed=1)
        with pytest.raises(RuntimeError, match="phase 2"):
            _routes(name, lib, args, plan._replace(cluster=32))


# ---------------------------------------------------------------------------
# K8a on the forward chain and K3 on the backward chain, both directions
# ---------------------------------------------------------------------------

# the f32 H from which K3 and K8a take their cooperative routes: W_h fits
# no cluster of 16 (bwd_chain_plan with four gates; fwd_chain_plan with
# three gates, where bf16 halves W_h's share: 800)
K3_COOPERATIVE_H = 512
K8A_COOPERATIVE_H = K9A_COOPERATIVE_H


def _k3_lib():
    return _kernels.load("bilstm_bwd", rnn_cuda._BWD_SIGNATURES)


def _k3_routes(args, plan):
    """(cluster route, cooperative route) of K3 on the same checked
    operands, each (dg_f, dg_b)."""
    lib = _k3_lib()
    *ops, lens = args
    lens32 = lens.to(torch.int32)
    return (rnn_cuda._bilstm_bwd_chain(lib, *ops, lens32, plan),
            rnn_cuda._bilstm_bwd_cooperative(lib, *ops, lens32))


def _k8a_routes(xp, w_f, w_b, lens, dtype):
    """(cluster route, cooperative route) of K8a on the same operands."""
    lib = _gru_lib()
    b, h = xp.shape[1], xp.shape[2] // 6
    lens32 = lens.to(torch.int32)
    plan = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 2, 132, 232448, gates=3)
    return (gru_cuda._bigru_fwd_chain(lib, xp, w_f, w_b, lens32, plan),
            gru_cuda._bigru_fwd_cooperative(lib, xp, w_f, w_b, lens32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_k8a_chain_matches_plain_at_any_batch(cuda, dtype, b):
    """K8a at H=320 (clusters of 16) against its plain version, ragged
    rows, one launch at B = 1, 48 and 600 (several waves of clusters, no
    row slices), through the wrapper and through the cluster route's
    export."""
    t, h = 12, 320
    xp, (w_f, w_b), _, lens = _gru_inputs(t, b, h, dtype, cuda, b + 1, 2)
    plan = gru_cuda.k8a_plan(_gru_lib(), b, h, dtype, cuda)
    assert plan.route == "cluster" and plan.cluster == 16, plan
    before = gru_cuda.bigru_seq_fwd.launches
    got = gru_cuda.bigru_seq_fwd(xp, w_f, w_b, lens)
    chain, _ = _k8a_routes(xp, w_f, w_b, lens, dtype)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_seq_fwd.launches == before + 1
    ref = gru_cuda.bigru_seq_fwd_reference(xp, w_f, w_b, lens)
    for ys in (got, chain):
        for name, y, r in zip(("y_f", "y_b"), ys, ref):
            _close(y, r, GRU_TOL[dtype], name)
        _zero_past_lens(ys, lens, "y")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(1, 320), (5, 128), (5, 320), (48, 320)])
def test_k8a_chain_equals_cooperative_and_k9a_bit_for_bit(cuda, dtype, b, h):
    """K8a's two routes give the same y bit for bit, ragged rows, and each
    direction of its chain equals K9a's chain on that direction's half of
    xp (the backward direction as K9a with reverse): the same warp_dot
    sums and the same gru_cell(), the f32 carry in every route."""
    t = 20
    xp, (w_f, w_b), _, lens = _gru_inputs(t, b, h, dtype, cuda, 7 * h + b, 2)
    chain, coop = _k8a_routes(xp, w_f, w_b, lens, dtype)
    lib = _gru_lib()
    lens32 = lens.to(torch.int32)
    k9a = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 1, 132, 232448, gates=3)
    uni = (gru_cuda._gru_fwd_chain(lib, xp[..., :3 * h].contiguous(), w_f,
                                   lens32, False, k9a),
           gru_cuda._gru_fwd_chain(lib, xp[..., 3 * h:].contiguous(), w_b,
                                   lens32, True, k9a))
    torch.cuda.synchronize()
    for name, c, k, u in zip(("y_f", "y_b"), chain, coop, uni):
        assert torch.equal(c, k), name
        assert torch.equal(c, u), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8a_cooperative_route_at_a_large_h(cuda, dtype):
    """Where W_h fits no cluster of 16 the plan sends K8a to its
    cooperative kernel, which still matches its plain version."""
    t, b, h = 10, 3, K8A_COOPERATIVE_H[dtype]
    xp, (w_f, w_b), _, lens = _gru_inputs(t, b, h, dtype, cuda, h, 2)
    assert gru_cuda.k8a_plan(_gru_lib(), b, h, dtype, cuda).route \
        == "cooperative"
    before = gru_cuda.bigru_seq_fwd.launches
    got = gru_cuda.bigru_seq_fwd(xp, w_f, w_b, lens)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_seq_fwd.launches == before + 1
    for name, g, r in zip(("y_f", "y_b"), got,
                          gru_cuda.bigru_seq_fwd_reference(xp, w_f, w_b,
                                                           lens)):
        _close(g, r, GRU_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_k3_chain_matches_plain_at_any_batch(cuda, dtype, b):
    """K3 on its cluster route at H=320 at B = 1, 48 and 600 (several
    waves of clusters, no row slices; at B=600, T=120 puts the phase-1
    scratch above 256 MiB, so the walk runs in three chunks of steps)
    against its plain version, ragged rows, zero at pad frames, one launch
    a call."""
    t = 120 if b == 600 else 30
    args = _bwd_inputs(t, b, 320, dtype, cuda, seed=b + 5)
    plan = rnn_cuda.k3_plan(_k3_lib(), b, 320, dtype, cuda)
    assert plan.route == "cluster" and plan.cluster == 16, plan
    assert -(-t // rnn_cuda._scratch_steps(t, b, 8 * 320)) == \
        (3 if b == 600 else 1)
    before = rnn_cuda.bilstm_seq_bwd_dgates.launches
    got = rnn_cuda.bilstm_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_bwd_dgates.launches == before + 1
    for name, g, r in zip(("dg_f", "dg_b"), got,
                          rnn_cuda.bilstm_seq_bwd_dgates_reference(*args)):
        _close(g, r, LSTM_BWD_TOL[dtype], name)
    _zero_past_lens(got, args[-1], "dgates")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [32, 320])
def test_k3_in_chunks_of_steps_equal_one_chunk(cuda, h, dtype, monkeypatch):
    """K3 with its scratch cut to 3 steps: the chain carries dh and dc of
    both directions between the chunks, and the outputs equal one
    chunk's bit for bit."""
    t, b = 10, 5
    args = _bwd_inputs(t, b, h, dtype, cuda, seed=h + 1)
    whole = rnn_cuda.bilstm_seq_bwd_dgates(*args)
    with monkeypatch.context() as m:
        m.setattr(rnn_cuda, "_K10_SCRATCH_BYTES", 3 * b * 8 * h * 4)
        assert rnn_cuda._scratch_steps(t, b, 8 * h) == 3
        chunked = rnn_cuda.bilstm_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    for name, c, w in zip(("dg_f", "dg_b"), chunked, whole):
        assert torch.equal(c, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_routes_agree_and_equal_where_dh_is_zero(cuda, dtype):
    """The recompute invariant, witnessed by K3's cooperative kernel,
    which recomputes the gates with warp_dot in its order: at each row's
    first valid frame of the walk (t = len - 1 for the forward direction,
    t = 0 for the backward one) dh and dc are still zero, so the two
    routes' dgates there depend on the gates alone and are equal bit for
    bit; elsewhere dh is summed in another order, within tolerance."""
    t, b, h = 24, 6, 320
    args = _bwd_inputs(t, b, h, dtype, cuda, seed=29)
    plan = rnn_cuda.k3_plan(_k3_lib(), b, h, dtype, cuda)
    chain, coop = _k3_routes(args, plan)
    torch.cuda.synchronize()
    lens = args[-1].cpu().numpy()
    assert (lens > 0).sum() >= 3
    for d, (name, c, k) in enumerate(zip(("dg_f", "dg_b"), chain, coop)):
        _close(c, k, LSTM_BWD_TOL[dtype], name)
        for row, length in enumerate(lens):
            if length:
                first = length - 1 if d == 0 else 0
                assert torch.equal(c[first, row], k[first, row]), (name, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [5, 48])
def test_k3_directions_equal_k6_bit_for_bit(cuda, dtype, b):
    """Each direction of K3 equals K6 on that direction's operands (the
    backward one as K6 with reverse), bit for bit over the whole walk:
    both plans take clusters of 16 at H=320 and rows never meet, so each
    row's sums are the same whatever the rows a cluster."""
    t, h = 30, 320
    dy_f, dy_b, xp, y_f, c_f, y_b, c_b, w_f, w_b, lens = _bwd_inputs(
        t, b, h, dtype, cuda, seed=b + 11)
    k3 = rnn_cuda.k3_plan(_k3_lib(), b, h, dtype, cuda)
    k6 = rnn_cuda.k6_plan(_k6_lib(), b, h, dtype, cuda)
    assert k3.cluster == k6.cluster == 16, (k3, k6)
    got = rnn_cuda.bilstm_seq_bwd_dgates(dy_f, dy_b, xp, y_f, c_f, y_b, c_b,
                                         w_f, w_b, lens)
    uni = (rnn_cuda.lstm_seq_bwd_dgates(dy_f, xp[..., :4 * h].contiguous(),
                                        y_f, c_f, w_f, lens),
           rnn_cuda.lstm_seq_bwd_dgates(dy_b, xp[..., 4 * h:].contiguous(),
                                        y_b, c_b, w_b, lens, True))
    torch.cuda.synchronize()
    for name, g, u in zip(("dg_f", "dg_b"), got, uni):
        assert torch.equal(g, u), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [128, 320])
def test_k3_phase1_kernels_agree_bit_for_bit(cuda, h, dtype):
    """K3's tiled phase 1 and its warp kernel give the same recurrent sums
    of both directions bit for bit, on a chunk of steps that starts
    mid-walk and one that ends it (its last step, each direction's first
    forward step, sums over zeros)."""
    t, b = 7, 5
    _, _, _, y_f, _, y_b, _, w_f, w_b, _ = _bwd_inputs(t, b, h, dtype, cuda,
                                                       seed=h + 3)
    lib = _k3_lib()
    assert rnn_cuda.k3_plan(lib, b, h, dtype, cuda).gate_cols == 0
    fn = getattr(lib, "bilstm_bwd_gates_" + rnn_cuda._SUFFIX[dtype])
    for s0, n in ((2, 3), (4, 3)):
        got = []
        for cols in (0, 32):
            pre = torch.full((n, b, 8 * h), float("nan"), device=cuda)
            _kernels.check(lib, fn(y_f.data_ptr(), y_b.data_ptr(),
                                   w_f.data_ptr(), w_b.data_ptr(),
                                   pre.data_ptr(), s0, n, t, b, h, cols,
                                   _kernels.stream_ptr(cuda)), "K3 phase 1")
            got.append(pre)
        torch.cuda.synchronize()
        assert not got[0].isnan().any()
        assert torch.equal(got[0], got[1]), (s0, n)
        if s0 + n == t:                       # the forward's first step
            assert not got[0][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_cooperative_route_at_a_large_h(cuda, dtype):
    """Where W_h's gate columns as f32 fit no cluster of 16 (from H ~470,
    in either dtype) the plan sends K3 to its cooperative kernel, which
    still matches its plain version."""
    h = K3_COOPERATIVE_H
    args = _bwd_inputs(10, 3, h, dtype, cuda, seed=h)
    assert rnn_cuda.k3_plan(_k3_lib(), 3, h, dtype, cuda).route \
        == "cooperative"
    before = rnn_cuda.bilstm_seq_bwd_dgates.launches
    got = rnn_cuda.bilstm_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_seq_bwd_dgates.launches == before + 1
    for name, g, r in zip(("dg_f", "dg_b"), got,
                          rnn_cuda.bilstm_seq_bwd_dgates_reference(*args)):
        _close(g, r, LSTM_BWD_TOL[dtype], name)


@pytest.mark.cuda
def test_k3_k8a_chain_launch_errors_raise(cuda):
    """A cluster launch the card refuses (a cluster of 32 CTAs, past the
    16 the chains take) raises through _kernels.check: no silent switch
    to the other route or to the plain version."""
    f32 = torch.float32
    args = _bwd_inputs(6, 3, 32, f32, cuda, seed=1)
    plan = rnn_cuda.k3_plan(_k3_lib(), 3, 32, f32, cuda)
    with pytest.raises(RuntimeError, match="phase 2"):
        _k3_routes(args, plan._replace(cluster=32))
    xp, (w_f, w_b), _, lens = _gru_inputs(6, 3, 32, f32, cuda, 1, 2)
    plan = gru_cuda.k8a_plan(_gru_lib(), 3, 32, f32, cuda)
    with pytest.raises(RuntimeError, match="bigru_seq_fwd"):
        gru_cuda._bigru_fwd_chain(_gru_lib(), xp, w_f, w_b,
                                  lens.to(torch.int32),
                                  plan._replace(cluster=32))


def _k8b_case(t, b, h, dtype, device, seed):
    """K8b's operands on a forward of K8a's plain version, ragged rows:
    (dy_f, dy_b, xp, y_f, y_b, w_h_f, w_h_b, lens)."""
    xp, (w_f, w_b), (dy_f, dy_b), lens = _gru_inputs(t, b, h, dtype, device,
                                                     seed, 2)
    y_f, y_b = gru_cuda.bigru_seq_fwd_reference(xp, w_f, w_b, lens)
    return dy_f, dy_b, xp, y_f, y_b, w_f, w_b, lens


def _k8b_routes(args, plan):
    """(cluster route, cooperative route) of K8b on the same checked
    operands, each (dgx_f, dgh_f, dgx_b, dgh_b)."""
    lib = _k9b_lib()
    *ops, lens = args
    lens32 = lens.to(torch.int32)
    return (gru_cuda._bigru_bwd_chain(lib, *ops, lens32, plan),
            gru_cuda._bigru_bwd_cooperative(lib, *ops, lens32))


K8B_OUTPUTS = ("dgx_f", "dgh_f", "dgx_b", "dgh_b")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_k8b_chain_matches_plain_at_any_batch(cuda, dtype, b):
    """K8b on its cluster route at H=320 at B = 1, 48 and 600 (one launch,
    36 rows a cluster; at B=600, T=120 the phase-1 scratch is above 256
    MiB, so the walk runs in three chunks of steps) against its plain
    version, ragged rows, zero at pad frames, one launch a call."""
    t = 120 if b == 600 else 30
    args = _k8b_case(t, b, 320, dtype, cuda, b + 9)
    plan = gru_cuda.k8b_plan(_k9b_lib(), b, 320, dtype, cuda)
    assert plan.route == "cluster" and plan.cluster == 16, plan
    assert -(-t // rnn_cuda._scratch_steps(t, b, 6 * 320)) == \
        (3 if b == 600 else 1)
    before = gru_cuda.bigru_seq_bwd_dgates.launches
    got = gru_cuda.bigru_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_seq_bwd_dgates.launches == before + 1
    for name, g, r in zip(K8B_OUTPUTS, got,
                          gru_cuda.bigru_seq_bwd_dgates_reference(*args)):
        _close(g, r, GRU_BWD_TOL[dtype], name)
    _zero_past_lens(got, args[-1], "dgates")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8b_in_chunks_of_steps_equal_one_chunk(cuda, dtype, monkeypatch):
    """K8b with its scratch cut to 3 steps: the chain carries both
    directions' dh between the chunks, and the outputs equal one chunk's
    bit for bit."""
    t, b, h = 10, 5, 320
    args = _k8b_case(t, b, h, dtype, cuda, 17)
    whole = gru_cuda.bigru_seq_bwd_dgates(*args)
    with monkeypatch.context() as m:
        m.setattr(gru_cuda, "_scratch_steps", lambda *a: 3)
        chunked = gru_cuda.bigru_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    for name, c, w in zip(K8B_OUTPUTS, chunked, whole):
        assert torch.equal(c, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8b_routes_agree_and_equal_where_dh_is_zero(cuda, dtype):
    """The recompute invariant, witnessed by K8b's cooperative kernel: at
    each row's first valid walk step (t = len - 1 forward, t = 0
    backward) dh is still zero, so the two routes' outputs there depend
    on the gates alone and are equal bit for bit; elsewhere dh is summed
    in another order, within tolerance."""
    t, b, h = 24, 6, 320
    args = _k8b_case(t, b, h, dtype, cuda, 31)
    plan = gru_cuda.k8b_plan(_k9b_lib(), b, h, dtype, cuda)
    chain, coop = _k8b_routes(args, plan)
    torch.cuda.synchronize()
    lens = args[-1].cpu().numpy()
    assert (lens > 0).sum() >= 3
    for i, (name, c, k) in enumerate(zip(K8B_OUTPUTS, chain, coop)):
        _close(c, k, GRU_BWD_TOL[dtype], name)
        for row, length in enumerate(lens):
            if length:
                first = length - 1 if i < 2 else 0
                assert torch.equal(c[first, row], k[first, row]), (name, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [5, 48])
def test_k8b_directions_equal_k9b_bit_for_bit(cuda, dtype, b):
    """Each direction of K8b equals K9b's cluster route on that
    direction's operands (the backward one as K9b with reverse), bit for
    bit over the whole walk: rows never meet, so 16 rows a cluster (K8b at
    B=48) against K9b's 8 change no row's sums."""
    t, h = 30, 320
    dy_f, dy_b, xp, y_f, y_b, w_f, w_b, lens = _k8b_case(t, b, h, dtype,
                                                         cuda, b + 13)
    got = gru_cuda.bigru_seq_bwd_dgates(dy_f, dy_b, xp, y_f, y_b, w_f, w_b,
                                        lens)
    uni = (gru_cuda.gru_seq_bwd_dgates(dy_f, xp[..., :3 * h].contiguous(),
                                       y_f, w_f, lens)
           + gru_cuda.gru_seq_bwd_dgates(dy_b, xp[..., 3 * h:].contiguous(),
                                         y_b, w_b, lens, True))
    torch.cuda.synchronize()
    for name, g, u in zip(K8B_OUTPUTS, got, uni):
        assert torch.equal(g, u), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [128, 320])
def test_k8b_phase1_kernels_agree_bit_for_bit(cuda, h, dtype):
    """K8b's tiled phase 1 and its warp kernel give the same recurrent
    sums of both directions bit for bit, on a chunk of steps mid-walk and
    one that ends it (each direction's first forward step sums zeros)."""
    t, b = 7, 5
    _, _, _, y_f, y_b, w_f, w_b, _ = _k8b_case(t, b, h, dtype, cuda, h + 5)
    lib = _k9b_lib()
    assert gru_cuda.k8b_plan(lib, b, h, dtype, cuda).gate_cols == 0
    fn = getattr(lib, "bigru_bwd_gates_" + rnn_cuda._SUFFIX[dtype])
    for s0, n in ((2, 3), (4, 3)):
        got = []
        for cols in (0, 32):
            pre = torch.full((n, b, 6 * h), float("nan"), device=cuda)
            _kernels.check(lib, fn(y_f.data_ptr(), y_b.data_ptr(),
                                   w_f.data_ptr(), w_b.data_ptr(),
                                   pre.data_ptr(), s0, n, t, b, h, cols,
                                   _kernels.stream_ptr(cuda)), "K8b phase 1")
            got.append(pre)
        torch.cuda.synchronize()
        assert not got[0].isnan().any()
        assert torch.equal(got[0], got[1]), (s0, n)
        if s0 + n == t:                       # the forward's first step
            assert not got[0][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8b_cooperative_route_at_a_large_h(cuda, dtype):
    """Where W_h's gate columns as f32 fit no cluster of 16 (from H ~545,
    in either dtype) the plan sends K8b to its cooperative kernel, which
    still matches its plain version."""
    h = BWD_COOPERATIVE_H["K9b"]
    args = _k8b_case(10, 3, h, dtype, cuda, h)
    assert gru_cuda.k8b_plan(_k9b_lib(), 3, h, dtype, cuda).route \
        == "cooperative"
    before = gru_cuda.bigru_seq_bwd_dgates.launches
    got = gru_cuda.bigru_seq_bwd_dgates(*args)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_seq_bwd_dgates.launches == before + 1
    for name, g, r in zip(K8B_OUTPUTS, got,
                          gru_cuda.bigru_seq_bwd_dgates_reference(*args)):
        _close(g, r, GRU_BWD_TOL[dtype], name)


@pytest.mark.cuda
def test_k8b_chain_launch_errors_raise(cuda):
    """A cluster launch the card refuses (a cluster of 32 CTAs) raises
    through _kernels.check."""
    args = _k8b_case(6, 3, 32, torch.float32, cuda, 1)
    plan = gru_cuda.k8b_plan(_k9b_lib(), 3, 32, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="phase 2"):
        _k8b_routes(args, plan._replace(cluster=32))


def _above_ceiling(source, signatures, query, *dims):
    """One row more than a kernel takes in one launch on the card: its
    source's own ceiling query (``*_max_rows``) plus one."""
    lib = _kernels.load(source, signatures)
    rows = rnn_cuda.max_rows(lib, query, torch.device("cuda"), *dims)
    assert 50 < rows < 200, (query, rows)  # ~139-167 at H = 320, ~93 K5's
    return rows + 1


# the f32 H from which K5 takes its cooperative route (fwd_chain_plan)
K5_COOPERATIVE_H = 512


def _sliced_case(name, t, h, device):
    """(wrapper, plain version, operands, tolerance) of one kernel that
    keeps every row in a block, at one row above its ceiling, f32 (K3, K5,
    K6, K7, K8a, K8b, K9a and K9b on their cooperative routes, at
    K3_COOPERATIVE_H, K5_COOPERATIVE_H (K7 one layer), BWD_COOPERATIVE_H
    (K8b as K9b) and K9A_COOPERATIVE_H)."""
    f32 = torch.float32
    if name == "K3":
        # only K3's cooperative route keeps its rows in one block: H=512
        h = K3_COOPERATIVE_H
        assert rnn_cuda.bwd_chain_plan(1, h, f32, 2, 132,
                                       232448).route == "cooperative"
        b = _above_ceiling("bilstm_bwd", rnn_cuda._BWD_SIGNATURES,
                           "bilstm_bwd_max_rows_f32", h)
        return (rnn_cuda.bilstm_seq_bwd_dgates,
                rnn_cuda.bilstm_seq_bwd_dgates_reference,
                _bwd_inputs(t, b, h, f32, device, seed=b), BILSTM_BWD_F32_TOL)
    if name == "K5":
        # only K5's cooperative route keeps its rows in one block: H=512
        assert rnn_cuda.fwd_chain_plan(1, 0, K5_COOPERATIVE_H, f32, 1, 132,
                                       232448).route == "cooperative"
        b = _above_ceiling("lstm_fwd", rnn_cuda._UNI_SIGNATURES,
                           "lstm_fwd_max_rows_f32", K5_COOPERATIVE_H)
        xp, w, lens = _uni_inputs(t, b, K5_COOPERATIVE_H, f32, device, b)
        return (rnn_cuda.lstm_seq_fwd, rnn_cuda.lstm_seq_fwd_reference,
                (xp, w, lens, True), LSTM_TOL[f32])
    if name == "K6":
        # only K6's cooperative route keeps its rows in one block: H=512
        h = BWD_COOPERATIVE_H["K6"]
        assert rnn_cuda.bwd_chain_plan(1, h, f32, 1, 132,
                                       232448).route == "cooperative"
        b = _above_ceiling("lstm_bwd", rnn_cuda._UNI_BWD_SIGNATURES,
                           "lstm_bwd_max_rows_f32", h)
        xp, w, lens = _uni_inputs(t, b, h, f32, device, b)
        y, c = rnn_cuda.lstm_seq_fwd_reference(xp, w, lens)
        dy = torch.as_tensor(np.random.default_rng(b).standard_normal(
            (t, b, h)).astype(np.float32), device=device)
        return (rnn_cuda.lstm_seq_bwd_dgates,
                rnn_cuda.lstm_seq_bwd_dgates_reference,
                (dy, xp, y, c, w, lens), LSTM_BWD_TOL[f32])
    if name == "K7":
        # one layer with carries (the streaming server's per-layer route)
        # where W_h fits no cluster: only the cooperative route keeps its
        # rows in one block
        h = K5_COOPERATIVE_H
        b = _above_ceiling("lstm_stack", rnn_cuda._STACK_SIGNATURES,
                           "lstm_stack_max_rows_f32", 1, h)
        assert rnn_cuda.k7_plan(_k7_lib(), 1, b, h, f32, device).route \
            == "cooperative"
        return (rnn_cuda.lstm_stack_fwd, rnn_cuda.lstm_stack_fwd_reference,
                _stack_inputs(1, t, b, h, f32, device, b, True),
                LSTM_TOL[f32])
    bi = name.startswith("K8")
    kernel = "bigru" if bi else "gru"
    if name == "K8b":
        # only K8b's cooperative route keeps its rows in one block
        h = BWD_COOPERATIVE_H["K9b"]
        assert rnn_cuda.bwd_chain_plan(1, h, f32, 2, 132, 232448,
                                       gates=3).route == "cooperative"
    if name.endswith("a"):
        # only K8a's and K9a's cooperative routes keep their rows in one
        # block
        h = K9A_COOPERATIVE_H[f32]
        assert rnn_cuda.fwd_chain_plan(1, 0, h, f32, 2 if bi else 1, 132,
                                       232448, gates=3).route \
            == "cooperative"
        b = _above_ceiling("gru_fwd", gru_cuda._FWD_SIGNATURES,
                           f"{kernel}_fwd_max_rows_f32", h)
        xp, ws, _, lens = _gru_inputs(t, b, h, f32, device, b, 2 if bi else 1)
        if bi:
            return (gru_cuda.bigru_seq_fwd, gru_cuda.bigru_seq_fwd_reference,
                    (xp, *ws, lens), GRU_TOL[f32])
        return (gru_cuda.gru_seq_fwd, gru_cuda.gru_seq_fwd_reference,
                (xp, ws[0], lens, True), GRU_TOL[f32])
    if not bi:
        # only K9b's cooperative route keeps its rows in one block
        h = BWD_COOPERATIVE_H["K9b"]
        assert rnn_cuda.bwd_chain_plan(1, h, f32, 1, 132, 232448,
                                       gates=3).route == "cooperative"
    b = _above_ceiling("gru_bwd", gru_cuda._BWD_SIGNATURES,
                       f"{kernel}_bwd_max_rows_f32", h)
    xp, ws, dys, lens = _gru_inputs(t, b, h, f32, device, b, 2 if bi else 1)
    if bi:
        ys = gru_cuda.bigru_seq_fwd_reference(xp, *ws, lens)
        return (gru_cuda.bigru_seq_bwd_dgates,
                gru_cuda.bigru_seq_bwd_dgates_reference,
                (*dys, xp, *ys, *ws, lens), GRU_BWD_TOL[f32])
    y = gru_cuda.gru_seq_fwd_reference(xp, ws[0], lens)
    return (gru_cuda.gru_seq_bwd_dgates, gru_cuda.gru_seq_bwd_dgates_reference,
            (dys[0], xp, y, ws[0], lens), GRU_BWD_TOL[f32])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["K3", "K5", "K6", "K7", "K8a", "K8b",
                                  "K9a", "K9b"])
def test_sliced_kernel_above_its_ceiling_matches_plain(cuda, name):
    """Each kernel that keeps every row in one block's shared memory, at
    one row above the most its launch takes (the cooperative routes of
    K3, K5, K6 and K7 at H=512, of K8a, K8b, K9a and K9b at H=576, where
    W_h fits no cluster), runs as row slices and returns its plain
    version's result, as the reference does at any batch; the launch
    counter rises by one (it counts wrapper calls)."""
    fn, ref, args, tol = _sliced_case(name, 4, 320, cuda)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(*args)
    got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
    for i, (g, r) in enumerate(zip(got, want)):
        _close(g, r, tol, f"{name}[{i}]")


@pytest.mark.cuda
def test_stream_tick_of_200_slots_takes_the_per_layer_route(cuda, tmp_path):
    """``serve --max-streams 200`` on a 2x320 LSTM: the stack does not fit
    K7 whole, so a tick runs one K7 launch per layer, each one launch of
    the cluster route (one layer waits on nothing: any B, no row slices);
    its scores and carries equal the plain loop's on the CPU."""
    from kaldi_ctc_tpu_torch.cli import serve

    path = _uni_model(tmp_path, "float32", layers=2, h=320)
    flags = ["--model", path, "--max-streams", "200", "--chunk-frames", "7"]
    gpu = serve.Engine(serve.parse_args(flags))
    cpu = serve.Engine(serve.parse_args(flags + ["--device", "cpu"]))
    assert not rnn_cuda.lstm_stack_fits(2, 200, 320, torch.float32, cuda)
    layer = rnn_cuda.k7_plan(_k7_lib(), 1, 200, 320, torch.float32, cuda)
    assert layer.route == "cluster" and layer.launch_rows == 0, layer
    rng = np.random.default_rng(4)
    block = torch.as_tensor(rng.standard_normal((7, 200, 40)).astype(
        np.float32), device=cuda)
    lens = torch.as_tensor(rng.integers(0, 8, 200).astype(np.int32))
    st_g = gpu.stream._state
    st_c = [tuple(a.cpu() for a in st) for st in st_g]
    k7 = rnn_cuda.lstm_stack_fwd.launches
    sg, st_g = gpu.stream.chunk_fn(block, lens.to(cuda), st_g)
    torch.cuda.synchronize()
    assert rnn_cuda.lstm_stack_fwd.launches - k7 == 2
    sc, st_c = cpu.stream.chunk_fn(block.cpu(), lens, st_c)
    np.testing.assert_allclose(sg.cpu().numpy(), sc.numpy(), rtol=0,
                               atol=1e-4)
    for layer_g, layer_c in zip(st_g, st_c):
        for g, c in zip(layer_g, layer_c):
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=0,
                                       atol=1e-4)


def _decode_exp(tmp_path, dtype):
    """A port init_model directory (8-dim input, 6 targets, 2x32 BLSTM,
    weights large enough for clear frame decisions) in ``dtype``, 6
    utterances of <= 60 frames and a word-loop CTC graph (words = labels
    1..5)."""
    import json

    from kaldi_ctc_tpu_torch.cli import init_model
    from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
    from kaldi_ctc_tpu_torch.utils.kaldi_io import MatrixWriter

    exp = str(tmp_path / "exp")
    init_model.main(["--dir", exp, "--input-dim", "8", "--num-targets", "6",
                     "--hidden-dim", "32", "--num-layers", "2",
                     "--param-stddev", "0.5"])
    cfg_path = os.path.join(exp, "model_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["compute_dtype"] = dtype
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    rng = np.random.default_rng(21)
    with MatrixWriter(f"ark:{tmp_path}/feats.ark") as w:
        for i in range(6):
            w[f"u{i}"] = rng.standard_normal(
                (int(rng.integers(20, 61)), 8)).astype(np.float32) * 2.0
    arcs, weights = [], []
    for lab in range(1, 6):
        arcs += [[0, lab, lab, lab], [lab, lab, 0, lab], [lab, 0, 0, 0]]
        weights += [1.0, 0.0, 0.0]
    finals = np.full(6, np.inf, np.float32)
    finals[0] = 0.0
    graph = str(tmp_path / "ctc.fst")
    NativeFst.from_arrays(0, 6, np.asarray(arcs, np.int32),
                          np.asarray(weights, np.float32),
                          finals).make_ctc_graph().write(graph)
    return exp, f"ark:{tmp_path}/feats.ark", graph


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["greedy", "beam", "wfst"])
def test_decode_ctc_on_cuda_equals_cpu(cuda, method, dtype, tmp_path):
    """decode_ctc on the card (K2 per layer, greedy and beam on the card)
    prints the hypotheses of the same call on the CPU's plain versions."""
    from kaldi_ctc_tpu_torch.cli import decode_ctc

    exp, feats, graph = _decode_exp(tmp_path, dtype)
    flags = ["--feats", feats, "--dir", exp, "--method", method,
             "--use-priors", "0", "--minibatch-size", "4"]
    if method == "wfst":
        flags += ["--graph", graph]
    out = {}
    for device in ("cuda", "cpu"):
        path = str(tmp_path / f"{device}.txt")
        k2 = rnn_cuda.bilstm_seq_fwd.launches
        decode_ctc.main(flags + ["--device", device, "--output", path])
        if device == "cuda":
            assert rnn_cuda.bilstm_seq_fwd.launches - k2 == 2 * 2
        with open(path) as f:
            out[device] = f.read()
    assert out["cuda"] == out["cpu"]
    assert sum(1 for line in out["cpu"].splitlines()
               if len(line.split()) > 1) >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_prefix_beam_on_cuda_equals_cpu(cuda, ties):
    """prefix_beam_search on CUDA scores equals it on the same scores on
    the CPU: labels and lengths exact, scores within 1e-5 (the same f32
    steps on two devices); tie-heavy scores hold the stable top-k."""
    from kaldi_ctc_tpu_torch.decoding import prefix_beam_search

    rng = np.random.default_rng(22)
    x = rng.standard_normal((5, 80, 12)).astype(np.float32) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    if ties:
        lp = np.round(lp * 2.0) / 2.0
    lp = torch.as_tensor(lp)
    lens = torch.as_tensor([80, 61, 0, 1, 33], dtype=torch.int32)
    for beam, max_len in ((8, 0), (4, 10)):
        want = prefix_beam_search(lp, lens, beam=beam, max_len=max_len)
        got = prefix_beam_search(lp.to(cuda), lens.to(cuda), beam=beam,
                                 max_len=max_len)
        assert all(g.device.type == "cuda" for g in got)
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      want[1].numpy())
        for j, n in enumerate(want[1].tolist()):
            np.testing.assert_array_equal(got[0][j, :n].cpu().numpy(),
                                          want[0][j, :n].numpy())
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(),
                                   rtol=0, atol=1e-5)


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


def test_build_is_keyed_by_header_hash(fake_build):
    """A source is rebuilt when a header of csrc/ it may include changes."""
    src, log = fake_build
    first = _kernels.build("k")
    header = src.parent / "shared.cuh"
    header.write_text("// h1\n")
    second = _kernels.build("k")
    assert second != first and _kernels.build("k") == second
    header.write_text("// h2\n")
    assert _kernels.build("k") not in (first, second)
    assert len(log.read_text().splitlines()) == 3


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


def _train_set(path, n=16, dim=8, targets=6, seed=23):
    """n seeded utterances (labels painted onto a feature channel) with
    pdf alignments, written by the port's own archive writers."""
    from kaldi_ctc_tpu_torch.utils.kaldi_io import IntVectorWriter, MatrixWriter

    rng = np.random.default_rng(seed)
    with MatrixWriter(f"ark:{path}/feats.ark") as fw, \
            IntVectorWriter(f"ark:{path}/ali.ark") as aw:
        for i in range(n):
            pdfs = rng.integers(0, targets - 1, int(rng.integers(2, 6)))
            feats = rng.standard_normal((8 * len(pdfs), dim)).astype(
                np.float32) * 0.1
            for j, p in enumerate(pdfs):
                feats[8 * j:8 * (j + 1), (p + 1) % dim] += 2.0
            fw[f"u{i:02d}"] = feats
            aw[f"u{i:02d}"] = np.repeat(pdfs, 8).astype(np.int32)


@pytest.mark.cuda
def test_train_ctc_on_cuda_launches_k2_k3_k1(cuda, tmp_path):
    """train_ctc --device cuda, 2 steps of a 2x32 BLSTM: each step
    launches K2 and K3 once per layer and K1 once, and logs finite
    records."""
    import json

    from kaldi_ctc_tpu_torch.cli import train_ctc

    _train_set(tmp_path)
    before = (rnn_cuda.bilstm_seq_fwd.launches,
              rnn_cuda.bilstm_seq_bwd_dgates.launches,
              ctc_cuda.alpha_beta.launches)
    exp = tmp_path / "exp"
    train_ctc.main(["--feats", f"ark:{tmp_path}/feats.ark", "--ali",
                    f"ark:{tmp_path}/ali.ark", "--num-targets", "6",
                    "--hidden-dim", "32", "--num-layers", "2", "--epochs",
                    "1", "--minibatch-size", "8", "--dir", str(exp),
                    "--device", "cuda"])
    after = (rnn_cuda.bilstm_seq_fwd.launches,
             rnn_cuda.bilstm_seq_bwd_dgates.launches,
             ctc_cuda.alpha_beta.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 4, 2]
    with open(exp / "metrics.jsonl") as f:
        steps = [r for r in map(json.loads, f) if r["event"] == "train_step"]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss_per_frame"]) and r["grad_norm"] > 0
               for r in steps)


def test_train_ctc_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """--device cuda where torch sees no card raises before any file is
    written; it never falls back to the CPU."""
    from kaldi_ctc_tpu_torch.cli import train_ctc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _train_set(tmp_path, n=2)
    exp = tmp_path / "exp"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ctc.main(["--feats", f"ark:{tmp_path}/feats.ark", "--ali",
                        f"ark:{tmp_path}/ali.ark", "--num-targets", "6",
                        "--dir", str(exp)])
    assert not exp.exists()


# ---- slice 8: the model's extras, NG-SGD and alignment on the card ----

def _extras_batch(b=6, t=40, l=5, dim=8, targets=7, seed=31):
    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((b, t, dim)).astype(np.float32),
            "labels": rng.integers(1, targets, (b, l)).astype(np.int32),
            "input_lens": np.array([t, t - 3, t - 10, 25, 30, t][:b],
                                   np.int32),
            "label_lens": np.array([l, l - 1, 3, 2, l, 1][:b], np.int32)}


def _steps_on(device, cfg, opts, batch, n=2):
    from kaldi_ctc_tpu_torch.models import init_am_params
    from kaldi_ctc_tpu_torch.training import (build_train_step,
                                              init_train_state)
    state = init_train_state(init_am_params(
        cfg, torch.Generator().manual_seed(0), device), opts)
    step = build_train_step(cfg, opts)
    losses = []
    for _ in range(n):
        state, m = step(state, batch)
        losses.append(float(m["loss_total"]))
    return state, losses


@pytest.mark.cuda
@pytest.mark.parametrize("extra", ["ds2", "ds2_stride1", "ft_dropout",
                                   "natural", "natural_front"])
def test_extras_train_steps_on_cuda_match_cpu(cuda, extra):
    """Two train steps of each slice-8 configuration on the card (K2/K3 or
    K10a/K10b per layer, K1) against the same steps on the CPU's plain
    path: the DS2 conv front (cuDNN convs, TF32 off) at time strides 2
    and 1, a pnorm FT front with dropout (the masks drawn on each device
    differ, so that case compares the card with itself: finite, and the
    same mask for the same step), and NG-SGD on the output affine and the
    FT front.  f32 sums in another order: loss 1e-5, params 1e-5 of
    their largest entry; the preconditioners' eigenvalues d and rho
    1e-3.  W itself is not compared: its top-R subspace turns where
    eigenvalues nearly tie at rank R, and cusolver's and LAPACK's eigh
    put W^T W up to 4% of its largest entry apart after two steps (the
    first card run) while the parameters agreed to 1e-5."""
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import TrainOptions

    kw = {"ds2": dict(conv_layers=2, conv_channels=8),
          "ds2_stride1": dict(conv_layers=2, conv_channels=8,
                              conv_time_stride=1),
          "ft_dropout": dict(front_affine_dim=64, front_nonlin="pnorm",
                             front_group=2, dropout=0.2),
          "natural": {},
          "natural_front": dict(front_affine_dim=128)}[extra]
    cfg = AmConfig(input_dim=8, num_targets=7, hidden_dim=64, num_layers=2,
                   param_stddev=0.2, **kw)
    opts = TrainOptions(initial_learning_rate=1e-2, momentum=0.9,
                        affine_type=("natural" if extra.startswith("natural")
                                     else "simple"))
    batch = _extras_batch()
    k1 = ctc_cuda.alpha_beta.launches
    got, got_losses = _steps_on(cuda, cfg, opts, batch)
    assert ctc_cuda.alpha_beta.launches == k1 + 2
    if extra == "ft_dropout":
        again, again_losses = _steps_on(cuda, cfg, opts, batch)
        assert got_losses == again_losses and np.isfinite(got_losses).all()
        return
    ref, ref_losses = _steps_on("cpu", cfg, opts, batch)
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-5)
    for g, r in zip(tree_flatten(got.params), tree_flatten(ref.params)):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=0,
                                   atol=1e-5 * max(float(r.abs().max()), 1))
    if got.ng:
        for name in got.ng:
            for side in ("in", "out"):
                g, r = got.ng[name][side], ref.ng[name][side]
                assert g.t.dtype == torch.int32 and int(g.t) == int(r.t)
                for f in ("rho", "d"):
                    a, b = getattr(g, f).cpu().numpy(), getattr(r, f).numpy()
                    np.testing.assert_allclose(a, b, rtol=0,
                                               atol=1e-3 * np.abs(b).max())


@pytest.mark.cuda
def test_viterbi_align_on_cuda_equals_cpu(cuda):
    """ctc_viterbi_align on the card and on the CPU at B=16, T=200,
    L=40 with ragged rows: the same feasibility, path log-probs to f32
    rounding, and the card's path scores the CPU's best under the CPU's
    log-softmax (a near-tie may pick another path of the same score)."""
    rng = np.random.default_rng(5)
    b, t, a, l = 16, 200, 30, 40
    logits = torch.as_tensor((rng.standard_normal((b, t, a)) * 3).astype(
        np.float32))
    labels = torch.as_tensor(rng.integers(1, a, (b, l)).astype(np.int32))
    lens = rng.integers(30, t + 1, b).astype(np.int32)
    llens = rng.integers(0, l + 1, b).astype(np.int32)
    lens[0], llens[0] = 10, l           # infeasible: 40 labels, 10 frames
    lens, llens = torch.as_tensor(lens), torch.as_tensor(llens)
    ref = ctc.ctc_viterbi_align(logits, labels, lens, llens)
    got = ctc.ctc_viterbi_align(logits.to(cuda), labels.to(cuda),
                                lens.to(cuda), llens.to(cuda))
    assert torch.equal(got[2].cpu(), ref[2]) and bool(ref[2].any())
    assert not bool(ref[2].all())
    np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].numpy(),
                               rtol=1e-5)
    logp = torch.log_softmax(logits, -1)
    for row in torch.nonzero(ref[2]).flatten().tolist():
        n = int(lens[row])
        path = got[0][row, :n].cpu().long()
        score = float(logp[row, torch.arange(n), path].sum())
        np.testing.assert_allclose(score, float(ref[1][row]), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nonlin", ["relu", "pnorm"])
def test_ft_front_stream_on_cuda_equals_offline(cuda, nonlin):
    """A uni LSTM 3x64 behind an FT front streamed on the card in chunks
    of 7 (K7 a chunk) gives the labels of the offline forward (K5)."""
    from kaldi_ctc_tpu_torch.decoding.streaming import StreamingRecognizer
    from kaldi_ctc_tpu_torch.models import AmConfig, am_forward, init_am_params

    cfg = AmConfig(input_dim=8, num_targets=7, hidden_dim=64, num_layers=3,
                   bidirectional=False, param_stddev=0.4,
                   front_affine_dim=32, front_nonlin=nonlin,
                   front_group=2 if nonlin == "pnorm" else 1)
    params = init_am_params(cfg, torch.Generator().manual_seed(2), cuda)
    x = np.random.default_rng(3).standard_normal((60, 8)).astype(
        np.float32) * 2
    k7 = rnn_cuda.lstm_stack_fwd.launches
    rec = StreamingRecognizer(params, cfg)
    for i in range(0, 60, 7):
        rec.process(x[i:i + 7])
    assert rnn_cuda.lstm_stack_fwd.launches > k7
    k5 = rnn_cuda.lstm_seq_fwd.launches
    with torch.inference_mode():
        ids = am_forward(params, torch.as_tensor(x[None], device=cuda),
                         cfg)[0].argmax(-1).tolist()
    assert rnn_cuda.lstm_seq_fwd.launches == k5 + 3
    want, last = [], 0
    for lab in ids:
        if lab not in (0, last):
            want.append(lab)
        last = lab
    assert rec.finalize() == want and want


@pytest.mark.cuda
def test_train_ctc_realign_and_align_ctc_on_cuda(cuda, tmp_path):
    """train_ctc --realign-epochs 1 --epochs 2 on the card (the realign
    aligns every utterance on the card and writes its priors and labels),
    then align_ctc on the card against align_ctc on the CPU: the same
    counts, mean path log-prob to 1e-5."""
    import contextlib
    import io
    import json

    from kaldi_ctc_tpu_torch.cli import align_ctc, train_ctc

    _train_set(tmp_path)
    exp = tmp_path / "exp"
    train_ctc.main(["--feats", f"ark:{tmp_path}/feats.ark", "--ali",
                    f"ark:{tmp_path}/ali.ark", "--num-targets", "6",
                    "--hidden-dim", "32", "--num-layers", "2", "--epochs",
                    "2", "--minibatch-size", "8", "--realign-epochs", "1",
                    "--dir", str(exp), "--device", "cuda"])
    with open(exp / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs if r["event"] == "realign"] == [1]
    assert (exp / "realign_labels.host0.json").exists()
    summaries = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            align_ctc.main(["--feats", f"ark:{tmp_path}/feats.ark", "--ali",
                            f"ark:{tmp_path}/ali.ark", "--dir", str(exp),
                            "--frame-labels",
                            f"ark:{tmp_path}/fl_{device}.ark",
                            "--device", device])
        summaries[device] = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert summaries["cuda"]["aligned"] == summaries["cpu"]["aligned"] == 16
    np.testing.assert_allclose(summaries["cuda"]["avg_logprob_per_frame"],
                               summaries["cpu"]["avg_logprob_per_frame"],
                               rtol=1e-5)


# ---- slice 9: one NCCL rank, and lattices on the card ----

@pytest.fixture
def one_nccl_rank(cuda, monkeypatch):
    """A process group of one NCCL rank on cuda:0 (a free port), left
    when the test ends."""
    import socket

    from kaldi_ctc_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    device = distributed.init_distributed(f"localhost:{port}", 1, 0,
                                          device="cuda")
    yield device
    distributed.shutdown()


@pytest.mark.cuda
def test_make_mesh_and_shard_batch_on_one_nccl_rank(one_nccl_rank):
    """make_mesh on a group of one NCCL rank: the rank's card, a 1x1 mesh
    whose groups run the collectives; shard_batch puts the rows there."""
    from kaldi_ctc_tpu_torch.parallel import make_mesh, shard_batch
    from kaldi_ctc_tpu_torch.parallel.mesh import sum_over_data

    assert torch.distributed.get_backend() == "nccl"
    assert one_nccl_rank == torch.device("cuda", 0)
    mesh = make_mesh()
    assert (mesh.device, mesh.data, mesh.model, mesh.distributed) == (
        torch.device("cuda", 0), 1, 1, True)
    batch = shard_batch({"x": np.arange(6, dtype=np.float32)}, mesh)
    assert batch["x"].device == mesh.device
    (got,) = sum_over_data(mesh, [batch["x"]])
    assert torch.equal(got, batch["x"])


@pytest.mark.cuda
@pytest.mark.parametrize("affine_type", ["simple", "natural"])
def test_step_on_one_nccl_rank_equals_step_alone(one_nccl_rank, affine_type):
    """The train step with a one-rank NCCL mesh (its all-reduce and
    gathers run) equals the step with no mesh, bit for bit, over two
    steps with momentum; the eval step's sums too."""
    from kaldi_ctc_tpu_torch.models import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.parallel import make_mesh
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import train as ttrain

    cfg = AmConfig(input_dim=8, num_targets=7, hidden_dim=32, num_layers=2)
    opts = ttrain.TrainOptions(momentum=0.9, affine_type=affine_type,
                               ng_rank_in=4, ng_rank_out=3)
    batch = _extras_batch()
    out = {}
    for mesh in (None, make_mesh()):
        state = ttrain.init_train_state(init_am_params(
            cfg, torch.Generator().manual_seed(3), "cuda"), opts)
        step = ttrain.make_train_step(cfg, opts, mesh)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append([float(m[k]) for k in (
                "loss_total", "grad_norm", "num_frames")])
        ev = ttrain.make_eval_step(cfg, mesh)(state.params, batch)
        out[mesh is None] = (metrics, tree_flatten(state.params),
                             float(ev["loss_total"]), int(ev["num_frames"]))
    alone, meshed = out[True], out[False]
    assert meshed[0] == alone[0] and meshed[2:] == alone[2:]
    assert all(torch.equal(a, b) for a, b in zip(meshed[1], alone[1]))


@pytest.mark.cuda
def test_decode_ctc_lattice_on_cuda_equals_cpu(cuda, tmp_path):
    """decode_ctc --lattice --determinize 1 on the card (K2 per layer)
    writes the lattices of the same call on the CPU's plain versions:
    the same keys and best paths, best-path costs within 1e-4 relative
    (the kernels' f32 sums against the plain versions')."""
    from kaldi_ctc_tpu_torch.cli import decode_ctc
    from kaldi_ctc_tpu_torch.decoding.det_lattice import \
        read_compact_lattice_text_ark

    exp, feats, graph = _decode_exp(tmp_path, "float32")
    flags = ["--feats", feats, "--dir", exp, "--method", "wfst", "--graph",
             graph, "--use-priors", "0", "--determinize", "1",
             "--lattice-beam", "3", "--max-active", "200"]
    lats = {}
    for device in ("cuda", "cpu"):
        path = str(tmp_path / f"{device}.lat")
        k2 = rnn_cuda.bilstm_seq_fwd.launches
        decode_ctc.main(flags + ["--device", device, "--lattice", path,
                                 "--output", str(tmp_path / device)])
        if device == "cuda":
            assert rnn_cuda.bilstm_seq_fwd.launches - k2 == 2 * 1
        lats[device] = dict(read_compact_lattice_text_ark(path))
    assert sorted(lats["cuda"]) == sorted(lats["cpu"])
    assert len(lats["cpu"]) >= 4
    for key, want in lats["cpu"].items():
        w_words, _, w_cost = want.best_path()
        g_words, _, g_cost = lats["cuda"][key].best_path()
        assert list(g_words) == list(w_words)
        assert abs(g_cost - w_cost) <= 1e-4 * abs(w_cost)


@pytest.mark.cuda
def test_devwatch_cuda_probe_passes_through(cuda):
    """devwatch's probe on the card (the default device, and --device
    cuda named in the wrapped argv) passes through to the CLI."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    for extra in ([], ["--device", "cuda"]):
        r = subprocess.run(
            [sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.devwatch",
             "kaldi_ctc_tpu_torch.cli.decode_ctc"] + extra + ["--help"],
            capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 0, r.stderr
        assert "--dir" in r.stdout


@pytest.mark.cuda
def test_triphone_decode_ctc_on_cuda_equals_cpu(cuda, tmp_path):
    """The triphone chain's decode: a handmade triphone tree (10 pdfs
    over 5 phones), graph_tool make-tlg --tree, a seeded 2x32 BLSTM of
    11 targets (init_model, peaky at stddev 0.5), decode_ctc --method
    wfst --lattice --determinize 1 on the card (K2 per layer) and on the
    CPU's plain versions: the same hypotheses' best paths, best-path
    costs within 1e-4 relative."""
    from kaldi_ctc_tpu_torch.cli import decode_ctc, graph_tool, init_model
    from kaldi_ctc_tpu_torch.decoding.det_lattice import \
        read_compact_lattice_text_ark
    from kaldi_ctc_tpu_torch.utils.kaldi_io import MatrixWriter
    from kaldi_ctc_tpu_torch.utils.tree import (CE, SE, TE,
                                                ContextDependency,
                                                write_tree)

    write_tree(str(tmp_path / "tree"), ContextDependency(3, 1, TE(1, [
        None] + [SE(2, [2], CE(2 * p - 1), CE(2 * p - 2))
                 for p in range(1, 6)])))
    (tmp_path / "lexicon.txt").write_text("ab p1 p2\nc p3\nde p4 p5\n")
    (tmp_path / "phones.txt").write_text(
        "".join(f"p{i} {i}\n" for i in range(1, 6)))
    (tmp_path / "lm.arpa").write_text(
        "\\data\\\nngram 1=5\n\n\\1-grams:\n-0.5 <s>\n-0.5 </s>\n"
        "-0.5 ab\n-0.5 c\n-0.8 de\n\n\\end\\\n")
    tlg = str(tmp_path / "TLG.fst")
    graph_tool.main(["make-tlg", "--lexicon", str(tmp_path / "lexicon.txt"),
                     "--arpa", str(tmp_path / "lm.arpa"), "--phones",
                     str(tmp_path / "phones.txt"), "--tree",
                     str(tmp_path / "tree"), "--output", tlg])
    exp = str(tmp_path / "exp")
    init_model.main(["--dir", exp, "--input-dim", "12", "--num-targets",
                     "11", "--hidden-dim", "32", "--num-layers", "2",
                     "--seed", "0", "--param-stddev", "0.5"])
    rng = np.random.default_rng(4)
    with MatrixWriter(f"ark:{tmp_path}/feats.ark") as w:
        for i in range(8):
            w[f"u{i}"] = rng.standard_normal(
                (int(rng.integers(20, 60)), 12)).astype(np.float32)
    flags = ["--feats", f"ark:{tmp_path}/feats.ark", "--dir", exp,
             "--method", "wfst", "--graph", tlg, "--words",
             tlg + ".words.txt", "--use-priors", "0", "--determinize", "1",
             "--lattice-beam", "3", "--max-active", "200"]
    lats = {}
    for device in ("cuda", "cpu"):
        path = str(tmp_path / f"{device}.lat")
        k2 = rnn_cuda.bilstm_seq_fwd.launches
        decode_ctc.main(flags + ["--device", device, "--lattice", path,
                                 "--output", str(tmp_path / device)])
        if device == "cuda":
            assert rnn_cuda.bilstm_seq_fwd.launches - k2 == 2 * 1
        lats[device] = dict(read_compact_lattice_text_ark(path))
    assert sorted(lats["cuda"]) == sorted(lats["cpu"])
    assert len(lats["cpu"]) == 8
    for key, want in lats["cpu"].items():
        w_words, _, w_cost = want.best_path()
        g_words, _, g_cost = lats["cuda"][key].best_path()
        assert list(g_words) == list(w_words)
        assert abs(g_cost - w_cost) <= 1e-4 * abs(w_cost)
