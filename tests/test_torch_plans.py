"""The launch plans of K4 (``stft_cuda.k4_plan``: the fft or the dft
route) and K1 (``ctc_cuda.k1_plan``: the warp or the block route), and
the fft route's twiddles, on the CPU.

Each plan is a pure function of shapes.  Its shared-memory formula is
the twin of the launch's in ``csrc/log_mel.cu`` (``FftLayout``,
``dft_smem_bytes``); the card tests hold the two equal through the
library's queries.  The FFT's index arithmetic (Stockham passes between
two padded rows, the real split) is modelled here in numpy, step for
step as the kernel runs it, and held to ``np.fft.rfft``.  No JAX here.
"""

import numpy as np
import pytest

from kaldi_ctc_tpu_torch.features import FbankOptions, MfccOptions, stft_cuda
from kaldi_ctc_tpu_torch.features.mel import mel_banks
from kaldi_ctc_tpu_torch.features.window import FrameOptions
from kaldi_ctc_tpu_torch.ops import ctc_cuda

# the opt-in shared memory of one H100 block (bytes)
H100_SMEM = 232448


def _shapes(opts):
    fo = opts.frame_opts
    m = mel_banks(opts.mel_opts, fo)
    return fo.window_size, fo.padded_window_size, m.shape[1], m.shape[0]


@pytest.mark.parametrize("opts", [MfccOptions.hires(), MfccOptions(),
                                  FbankOptions()],
                         ids=["mfcc_hires", "mfcc", "fbank"])
def test_k4_plan_takes_the_fft_route_at_the_feature_shapes(opts):
    length, padded, k_bins, m_bins = _shapes(opts)
    assert (length, padded, k_bins) == (400, 512, 256)
    plan = stft_cuda.k4_plan(length, padded, k_bins, m_bins)
    assert plan.route == "fft"
    assert plan.frames_per_block == stft_cuda.K4_FFT_FRAMES == 4
    assert plan.smem_bytes == stft_cuda._fft_smem_bytes(
        length, padded, m_bins, m_bins * k_bins, 4) <= H100_SMEM


def test_k4_plan_at_the_hires_shape_in_bytes():
    """400 samples, 512 points, 256 bins, 40 mel rows, 4 frames: 257
    twiddles (516 floats), the window (400), 40 spans (120), the packed
    rows (at most 40 x 256; 468 for the hires bank), and per frame 400
    samples and two rows of 256 complex padded to 271 (544 floats)."""
    per_frame = 4 * (400 + 2 * 544)
    assert stft_cuda.k4_plan(400, 512, 256, 40) == stft_cuda.K4Plan(
        "fft", 4, 4 * (516 + 400 + 120 + 10240) + 4 * per_frame)
    assert stft_cuda._fft_smem_bytes(400, 512, 40, 468, 4) == \
        4 * (516 + 400 + 120 + 468) + 4 * per_frame


@pytest.mark.parametrize("length,padded", [(400, 400), (300, 500),
                                           (200, 384)])
def test_k4_plan_takes_the_dft_route_off_a_power_of_two(length, padded):
    """round_to_power_of_two=False (a 400-point transform) and other
    sizes that are no power of two."""
    plan = stft_cuda.k4_plan(length, padded, padded // 2, 23)
    assert plan == stft_cuda.K4Plan(
        "dft", 4, stft_cuda._dft_smem_bytes(length, padded // 2))


def test_k4_plan_at_round_to_power_of_two_off():
    fo = FrameOptions(round_to_power_of_two=False)
    plan = stft_cuda.k4_plan(fo.window_size, fo.padded_window_size,
                             fo.padded_window_size // 2, 40)
    assert plan.route == "dft"
    assert plan.smem_bytes == 4 * (2 * 4 * 400 + 4 * 200)


def test_k4_plan_stops_the_fft_route_at_its_limit():
    limit = stft_cuda.K4_FFT_MAX_POINTS
    assert stft_cuda.k4_plan(1000, limit, 64, 8).route == "fft"
    assert stft_cuda.k4_plan(1000, 2 * limit, 64, 8).route == "dft"


def test_k4_plan_takes_fewer_frames_a_block_before_the_dft_route():
    """A mel matrix that leaves no room for 4 frames: 2, then 1, then the
    dft route; nothing fits: a ValueError, not a launch."""
    assert stft_cuda.k4_plan(1000, 1024, 513, 40).frames_per_block == 4
    assert stft_cuda.k4_plan(4000, 4096, 2049, 11).frames_per_block == 2
    assert stft_cuda.k4_plan(4000, 4096, 2049, 12).frames_per_block == 1
    assert stft_cuda.k4_plan(4000, 4096, 2049, 18) == stft_cuda.K4Plan(
        "fft", 1, stft_cuda._fft_smem_bytes(4000, 4096, 18, 18 * 2049, 1))
    assert stft_cuda.k4_plan(4000, 4096, 2049, 19).route == "dft"
    with pytest.raises(ValueError, match="shared memory"):
        stft_cuda.k4_plan(20000, 32768, 16385, 40)


@pytest.mark.parametrize("padded", [2, 4, 8, 64, 256, 512, 1024, 2048, 4096])
def test_k4_fft_smem_fits_every_shape_it_admits(padded):
    """Every shape the plan sends to the fft route fits one block, at the
    frames a block it chose; the formula grows with each input."""
    for length in sorted({1, padded // 2 + 1, padded}):
        for k_bins in sorted({1, padded // 4 + 1, padded // 2,
                              padded // 2 + 1}):
            for m_bins in (1, 23, 40, 80):
                plan = stft_cuda.k4_plan(length, padded, k_bins, m_bins)
                if plan.route != "fft":
                    continue
                assert plan.smem_bytes <= H100_SMEM
                assert plan.smem_bytes == stft_cuda._fft_smem_bytes(
                    length, padded, m_bins, m_bins * k_bins,
                    plan.frames_per_block)
                # every part starts on 16 bytes
                assert plan.smem_bytes % 16 == 0
                # fewer nonzero mel entries take less
                assert stft_cuda._fft_smem_bytes(
                    length, padded, m_bins, 0, plan.frames_per_block) \
                    <= plan.smem_bytes
    assert (stft_cuda._fft_smem_bytes(400, 512, 40, 468, 2)
            < stft_cuda._fft_smem_bytes(400, 512, 40, 468, 4)
            < stft_cuda._fft_smem_bytes(400, 512, 41, 468, 4)
            < stft_cuda._fft_smem_bytes(400, 512, 41, 472, 4)
            < stft_cuda._fft_smem_bytes(404, 512, 41, 472, 4)
            < stft_cuda._fft_smem_bytes(404, 1024, 41, 472, 4))


@pytest.mark.parametrize("opts", [MfccOptions.hires(), FbankOptions()],
                         ids=["mfcc_hires", "fbank"])
def test_mel_rows_pack_each_rows_nonzero_span(opts):
    """The fft route's mel rows: each row's first and one-past-last
    nonzero bin and its offset; scattered back, the packed spans are the
    matrix; the zeros inside a span stay, those outside are dropped."""
    mel = mel_banks(opts.mel_opts, opts.frame_opts)
    rows, packed = stft_cuda.mel_rows(mel)
    assert rows.dtype == np.int32 and rows.shape == (mel.shape[0], 3)
    assert packed.dtype == np.float32
    back = np.zeros_like(mel)
    for m, (lo, hi, off) in enumerate(rows):
        assert mel[m, lo] != 0 and mel[m, hi - 1] != 0
        assert not mel[m, :lo].any() and not mel[m, hi:].any()
        back[m, lo:hi] = packed[off:off + hi - lo]
    np.testing.assert_array_equal(back, mel)
    assert len(packed) == (rows[:, 1] - rows[:, 0]).sum() < mel.size // 10


def test_mel_rows_of_empty_and_full_rows():
    mel = np.zeros((4, 6), np.float32)
    mel[1, 2] = 0.5
    mel[2] = np.arange(1, 7)
    mel[3, [0, 5]] = 1.0        # a zero inside the span stays
    rows, packed = stft_cuda.mel_rows(mel)
    np.testing.assert_array_equal(rows, [[0, 0, 0], [2, 3, 0], [0, 6, 1],
                                         [0, 6, 7]])
    np.testing.assert_array_equal(
        packed, [0.5, 1, 2, 3, 4, 5, 6, 1, 0, 0, 0, 0, 1])
    rows, packed = stft_cuda.mel_rows(np.zeros((2, 3), np.float32))
    assert not rows.any() and packed.size == 0


def test_k4_dft_smem_fits_the_400_point_transform():
    assert stft_cuda._dft_smem_bytes(400, 200) <= H100_SMEM
    assert stft_cuda._dft_smem_bytes(400, 256) == 4 * (8 * 400 + 4 * 256)


@pytest.mark.parametrize("padded", [2, 4, 16, 256, 512, 1024, 4096])
def test_fft_twiddles_match_the_unit_roots_to_f32_rounding(padded):
    """e^{-2 pi i t / N} for t = 0..N/2, each part within one f32 ulp
    at 1 (2^-24) of numpy's complex exponential, and exact where it is
    exact: 1 at t = 0, -1 at t = N/2."""
    tw = stft_cuda.fft_twiddles(padded)
    assert tw.dtype == np.float32 and tw.shape == (padded // 2 + 1, 2)
    want = np.exp(-2j * np.pi * np.arange(padded // 2 + 1) / padded)
    np.testing.assert_allclose(tw[:, 0], want.real, rtol=0, atol=2.0 ** -24)
    np.testing.assert_allclose(tw[:, 1], want.imag, rtol=0, atol=2.0 ** -24)
    assert tuple(tw[0]) == (1.0, 0.0) and tw[-1, 0] == -1.0
    # rounded once from float64, as the DFT tables are
    cos_t, sin_t = stft_cuda.dft_tables(padded // 2 + 1, padded, 2)
    np.testing.assert_array_equal(tw[:, 0], cos_t[:, 1])
    np.testing.assert_array_equal(tw[:, 1], sin_t[:, 1])


def _cpad(j):
    return j + (j >> 4)


def _fft_route_model(x, padded, k_bins, tw):
    """The fft route's transform of one windowed frame x, as the kernel
    runs it (csrc/log_mel.cu warp_fft and the real split), in float64
    with the route's f32 twiddles → bins 0..k_bins-1."""
    nh = padded // 2
    tw = tw[:, 0].astype(np.float64) + 1j * tw[:, 1]

    def twiddle(t):
        return tw[t] if t <= nh else -tw[t - nh]

    rows = [np.zeros(_cpad(nh - 1) + 1, complex) for _ in range(2)]
    xx = np.zeros(padded)
    xx[:len(x)] = x
    for n in range(nh):
        rows[0][_cpad(n)] = xx[2 * n] + 1j * xx[2 * n + 1]
    src, dst = rows
    ns = 1
    if nh > 1 and int(np.log2(nh)) % 2 == 1:
        for j in range(nh // 2):
            a, b = src[_cpad(j)], src[_cpad(j + nh // 2)]
            dst[_cpad(2 * j)], dst[_cpad(2 * j + 1)] = a + b, a - b
        src, dst, ns = dst, src, 2
    q = nh // 4
    while ns < nh:
        tstep = nh // (2 * ns)
        for j in range(q):
            k = j & (ns - 1)
            v = [src[_cpad(j + r * q)] * twiddle(r * k * tstep)
                 for r in range(4)]
            a0, a1 = v[0] + v[2], v[0] - v[2]
            a2, a3 = v[1] + v[3], (v[1] - v[3]) * -1j
            d = (j - k) * 4 + k
            for r, val in enumerate((a0 + a2, a1 + a3, a0 - a2, a1 - a3)):
                dst[_cpad(d + r * ns)] = val
        src, dst, ns = dst, src, ns * 4
    out = np.empty(k_bins, complex)
    for k in range(k_bins):
        za, zb = src[_cpad(k & (nh - 1))], src[_cpad((nh - k) & (nh - 1))]
        e = 0.5 * (za + np.conj(zb))
        d = 0.5 * (za - np.conj(zb))
        out[k] = e + twiddle(k) * d * -1j
    return out


@pytest.mark.parametrize("length,padded", [(2, 2), (3, 4), (8, 8),
                                           (10, 16), (50, 64), (200, 256),
                                           (400, 512), (1000, 1024)])
def test_fft_route_index_arithmetic_reproduces_rfft(length, padded):
    """Radix 4 alone (N/2 = 4^k), a radix-2 pass first (N/2 = 2 x 4^k),
    the padding of the rows, and bins up to N/2 + 1 (Nyquist)."""
    rng = np.random.default_rng(padded)
    x = rng.standard_normal(length)
    want = np.fft.rfft(x, padded)
    got = _fft_route_model(x, padded, padded // 2 + 1,
                           stft_cuda.fft_twiddles(padded))
    # the twiddles are f32: errors of ~1e-7 of the frame's norm
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.linalg.norm(x) + 1e-12)


@pytest.mark.parametrize("s,plan", [
    (1, ("warp", 1)), (2, ("warp", 1)), (32, ("warp", 1)), (33, ("warp", 2)),
    (141, ("warp", 5)), (255, ("warp", 8)), (256, ("warp", 8)),
    (257, ("block", 0)), (1201, ("block", 0)), (0, ("block", 0))])
def test_k1_plan_chooses_its_route_from_s(s, plan):
    """S = 1 (no labels), bench's S = 141 (L = 70), the warp route's
    limit of 256 states (8 a lane) and one above it."""
    assert ctc_cuda.K1_WARP_MAX_S == 256
    assert tuple(ctc_cuda.k1_plan(s)) == plan


def test_k1_plan_at_the_training_shape():
    """bench.py's L = 70 labels: S = 141 on the warp route, 5 states a
    lane over 29 lanes."""
    plan = ctc_cuda.k1_plan(2 * 70 + 1)
    assert plan == ctc_cuda.K1Plan("warp", 5)
    assert -(-141 // plan.states_per_lane) == 29


def test_k1_block_route_keeps_its_shared_memory_ceiling():
    """The block route takes what the warp route refuses, up to two rows
    per recursion in one block's shared memory."""
    assert ctc_cuda._MAX_S == H100_SMEM // 16 > ctc_cuda.K1_WARP_MAX_S
