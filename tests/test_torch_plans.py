"""The launch plans of K4 (``stft_cuda.k4_plan``: the fft or the dft
route), K1 (``ctc_cuda.k1_plan``: the warp or the block route), K11 and
K12 (``ctc_cuda.k11_plan``, ``k12_plan``: the band or the block route),
and the fft route's twiddles, on the CPU.

Each plan is a pure function of shapes.  Its shared-memory formula is
the twin of the launch's in ``csrc/log_mel.cu`` (``FftLayout``,
``dft_smem_bytes``) and ``csrc/ctc_alpha_beta.cu`` (``band_smem_bytes``);
the card tests hold them equal through the library's queries.  The FFT's
index arithmetic (Stockham passes between two padded rows, the real
split) is modelled here in numpy, step for step as the kernel runs it,
and held to ``np.fft.rfft``; so is the band route's (the state a lane
holds, the edges handed between bands, the lp ring's slots and the
named barriers' generations), its bands run in random orders, and held
to a whole-row loop bit for bit.  No JAX here.
"""

import math

import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# K11 and K12's band route (csrc/ctc_alpha_beta.cu ctc_band_kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,plan", [
    (1, ("band", 1)), (2, ("band", 1)), (31, ("band", 1)), (32, ("band", 1)),
    (33, ("band", 2)), (63, ("band", 2)), (64, ("band", 2)), (65, ("band", 3)),
    (141, ("band", 5)), (255, ("band", 8)), (256, ("band", 8)),
    (257, ("block", 0)), (511, ("block", 0)), (512, ("block", 0)),
    (513, ("block", 0)), (0, ("block", 0))])
@pytest.mark.parametrize("kernel", ["k11", "k12"])
def test_k11_k12_plans_choose_their_route_from_s(kernel, s, plan):
    """S = 1 (no labels), the band edges at 32 and 64 states, bench's S =
    141, the band route's limit of 256 states (8 bands of 32) and the
    block kernel above it."""
    fn = ctc_cuda.k11_plan if kernel == "k11" else ctc_cuda.k12_plan
    assert tuple(fn(s)) == plan
    assert ctc_cuda.BAND_MAX_S == 256


def test_k11_k12_plans_at_the_training_shape():
    """bench.py's L = 70 labels: S = 141 on 5 bands of 32 states; 13
    states of the top band are live."""
    for fn in (ctc_cuda.k11_plan, ctc_cuda.k12_plan):
        assert fn(2 * 70 + 1) == ctc_cuda.BandPlan("band", 5)
    assert 141 - 4 * 32 == 13


def test_band_smem_fits_every_s_the_band_route_admits():
    """At every S from 1 to 256 the band route's warps hold S with no
    band wholly past it, and its shared memory (the launch's formula)
    fits one H100 block; named barriers need 2 per boundary of the 15 a
    block has besides __syncthreads'."""
    for s in range(1, ctc_cuda.BAND_MAX_S + 1):
        warps = ctc_cuda.k11_plan(s).warps
        assert warps * 32 >= s > (warps - 1) * 32
        assert warps <= ctc_cuda.BAND_MAX_WARPS and 2 * (warps - 1) <= 15
        assert ctc_cuda._band_smem_bytes(warps) == warps * (
            5 * 32 * 4 + 8) <= H100_SMEM


@pytest.mark.parametrize("s", [257, 300, 512, 1201])
def test_band_route_refuses_s_above_its_limit(s):
    """Above 256 states (more than 8 bands) the band route is refused
    before any launch; the plans take the block kernel there."""
    lp = torch.zeros((2, 1, s))
    mask = torch.zeros((1, s), dtype=torch.bool)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="band route"):
        ctc_cuda._alphas_route("band", lp, mask, lens)
    with pytest.raises(ValueError, match="band route"):
        ctc_cuda._betas_route("band", lp, mask, lens, lens)
    assert ctc_cuda.k11_plan(s).route == ctc_cuda.k12_plan(s).route == "block"


_NEG = np.float32(-1e30)
_exp32 = np.vectorize(lambda v: np.float32(math.exp(v)), otypes=[np.float32])
_log1p32 = np.vectorize(lambda v: np.float32(math.log1p(v)),
                        otypes=[np.float32])


def _lae(a, b):
    """A log-add in float32, max + log1p(exp(-|a-b|)), each
    transcendental rounded once from libm's double: the same bits for
    the same operands wherever it is called."""
    m = np.maximum(a, b)
    return m + _log1p32(_exp32(-np.abs(a - b)))


def _alpha_rows(lp, skip, lens):
    """The alpha recursion a whole row at a time, as the block route
    runs it → [T, B, S] float32."""
    t_max, b, s = lp.shape
    col = np.arange(s)
    a = np.full((b, s), _NEG, np.float32)
    out = np.empty_like(lp)
    for t in range(t_max):
        if t == 0:
            v = np.where(col <= 1, lp[0], _NEG)
        else:
            am1 = np.concatenate([np.full((b, 1), _NEG), a[:, :-1]], 1)
            am2 = np.concatenate([np.full((b, 2), _NEG), a], 1)[:, :s]
            p = _lae(a, am1)
            p = _lae(p, np.where(skip & (col >= 2), am2, _NEG))
            v = np.where((t < lens)[:, None], np.maximum(p + lp[t], _NEG), a)
        a = v.astype(np.float32)
        out[t] = a
    return out


def _beta_rows(lp, skip, lens, label_lens):
    """The beta recursion a whole row at a time, as the block route
    runs it → [T, B, S] float32."""
    t_max, b, s = lp.shape
    col = np.arange(s)
    last = 2 * label_lens[:, None]
    x = np.full((b, s), _NEG, np.float32)
    out = np.empty_like(lp)
    for t in range(t_max - 1, -1, -1):
        bp1 = np.concatenate([x[:, 1:], np.full((b, 1), _NEG)], 1)
        bp2 = np.concatenate([x, np.full((b, 2), _NEG)], 1)[:, 2:]
        n = _lae(x, bp1)
        n = _lae(n, np.where(skip & (col + 2 < s), bp2, _NEG))
        v = np.maximum(n + lp[t], _NEG)
        init = np.where((col == last) | (col == last - 1), lp[t], _NEG)
        live = lens[:, None]
        x = np.where(live == t + 1, init, np.where(t < live, v, x))
        x = x.astype(np.float32)
        out[t] = x
    return out


def _shfl(v, d):
    """__shfl_up_sync (d > 0) or __shfl_down_sync (d < 0) of a lane
    vector: a lane with no source keeps its own value."""
    out = v.copy()
    if d > 0:
        out[d:] = v[:-d]
    else:
        out[:d] = v[-d:]
    return out


class _NamedBarrier:
    """A named barrier of the two warps beside one band boundary
    (``bar.arrive`` / ``bar.sync`` with a count of 64 threads): the warps
    in its current generation and the generations completed."""

    def __init__(self, owners):
        self.owners = owners
        self.waiting = set()
        self.done = 0

    def arrive(self, k):
        """Warp k arrives → the generation it joined.  Only the two warps
        of the boundary take part, and neither twice in one generation
        (its 32 threads would count twice, and the generation would end
        without the other warp)."""
        assert k in self.owners and k not in self.waiting, (k, self.waiting)
        gen = self.done
        self.waiting.add(k)
        if len(self.waiting) == 2:
            self.waiting.clear()
            self.done += 1
        return gen

    def sync(self, k):
        """``bar.sync``: arrive, then wait (yield False) until the
        generation joined has completed."""
        gen = self.arrive(k)
        while self.done <= gen:
            yield False


def _band_walk(is_alpha, lp, sk, length, last, rng):
    """One utterance of ctc_band_kernel: ceil(S/32) bands of 32 lanes of
    one state, each a generator that yields False where the kernel would
    wait and True after each step, run in a random order by ``rng`` (any
    order the barriers allow) → the rows [T, S] it stores.  Boundary j
    has one edge slot and the named barriers 1+2j ("written") and 2+2j
    ("read")."""
    t_max, s = lp.shape
    warps = -(-s // 32)
    out = np.full((t_max, s), np.nan, np.float32)
    bars = {}
    for j in range(warps - 1):
        bars[1 + 2 * j] = _NamedBarrier((j, j + 1))
        bars[2 + 2 * j] = _NamedBarrier((j, j + 1))
    edges = [None] * (warps - 1)          # [step, (nearer, farther), read]
    prefetch, ring_slots = 4, 5
    lanes = np.arange(32)

    def band(k):
        states = k * 32 + lanes
        inside = states < s
        skip = np.zeros(32, bool)
        skip[inside] = sk[states[inside]]
        gives = k + 1 < warps if is_alpha else k > 0
        takes = k > 0 if is_alpha else k + 1 < warps
        out_edge, in_edge = (k, k - 1) if is_alpha else (k - 1, k)
        ring = [None] * ring_slots

        def fetch(i):
            if i < t_max:
                t = i if is_alpha else t_max - 1 - i
                held = ring[i % ring_slots]
                assert held is None or held[0] == i - ring_slots
                row = np.full(32, _NEG, np.float32)
                row[inside] = lp[t, states[inside]]
                ring[i % ring_slots] = (i, row)

        for i in range(prefetch):
            fetch(i)
        x = np.full(32, _NEG, np.float32)
        for i in range(t_max):
            t = i if is_alpha else t_max - 1 - i
            e1 = e2 = _NEG
            if takes and i > 0:
                yield from bars[1 + 2 * in_edge].sync(k)
                edge = edges[in_edge]
                assert edge[0] == i - 1 and not edge[2]
                e1, e2 = edge[1]
                edge[2] = True
                bars[2 + 2 * in_edge].arrive(k)
            tag, lpr = ring[i % ring_slots]
            assert tag == i
            fetch(i + prefetch)
            # every lane computes the live value, then selects (no branch)
            if is_alpha:
                n1, n2 = _shfl(x, 1), _shfl(x, 2)
                n1[0], n2[0], n2[1] = e1, e2, e1
                r = _lae(x, np.where(states >= 1, n1, _NEG))
                r = _lae(r, np.where((states >= 2) & skip, n2, _NEG))
                start = np.where(states <= 1, lpr, _NEG)
                first = t == 0
            else:
                n1, n2 = _shfl(x, -1), _shfl(x, -2)
                n1[31], n2[31], n2[30] = e1, e2, e1
                r = _lae(x, np.where(states + 1 < s, n1, _NEG))
                r = _lae(r, np.where((states + 2 < s) & skip, n2, _NEG))
                start = np.where((states == last) | (states == last - 1),
                                 lpr, _NEG)
                first = length == t + 1
            live = np.maximum(r + lpr, _NEG)
            x = (start if first else live if t < length else x).astype(
                np.float32)
            out[t, states[inside]] = x[inside]
            if gives and i + 1 < t_max:
                pair = (x[31], x[30]) if is_alpha else (x[0], x[1])
                if i > 0:
                    yield from bars[2 + 2 * out_edge].sync(k)
                # the one slot: step i-1's edge was read before this write
                assert edges[out_edge] is None or edges[out_edge][2]
                edges[out_edge] = [i, pair, False]
                bars[1 + 2 * out_edge].arrive(k)
            yield True
        # the read barrier's last generation: the taker's arrival for T-2
        if gives and t_max >= 2:
            yield from bars[2 + 2 * out_edge].sync(k)

    running = {k: band(k) for k in range(warps)}
    stalled = 0
    while running:
        k = list(running)[rng.integers(len(running))]
        try:
            stalled = 0 if next(running[k]) else stalled + 1
        except StopIteration:
            del running[k]
        assert stalled < 100 * warps, "the bands wait on one another"
    # every generation of every barrier completed, and every edge handed
    # on (T-1 a boundary) was read
    for bar in bars.values():
        assert not bar.waiting and bar.done == max(t_max - 1, 0)
    assert all(e is None or e[2] for e in edges)
    return out


def _band_case(t_max, b, s, seed):
    """Seeded log-probs, skip masks, ragged frame counts (one row of 0
    frames, one of all T) and label counts (one of 0)."""
    rng = np.random.default_rng(seed)
    lp = (rng.standard_normal((t_max, b, s)) * 2 - 3).astype(np.float32)
    skip = rng.random((b, s)) < 0.6
    lens = rng.integers(0, t_max + 1, b).astype(np.int32)
    lens[0], lens[-1] = t_max, 0
    label_lens = rng.integers(0, (s - 1) // 2 + 1, b).astype(np.int32)
    label_lens[0] = (s - 1) // 2
    label_lens[1 % b] = 0
    return lp, skip, lens, label_lens


@pytest.mark.parametrize("t_max,s", [
    (12, 1), (40, 33), (36, 65), (40, 71), (75, 141), (40, 255), (1, 33),
    (2, 64)],
    ids=["S1", "S33", "S65", "S71", "S141", "S255", "T1", "T2-S64"])
@pytest.mark.parametrize("is_alpha", [True, False], ids=["alpha", "beta"])
def test_band_route_model_reproduces_the_whole_row_loop(is_alpha, t_max, s):
    """The band route's index arithmetic (the state each lane holds, the
    edge states handed on, the lp ring's slots) and its hand-off (one
    edge slot and two named barriers a boundary, the read barrier's sync
    after the loop included), its bands run in random orders that the
    barriers allow, against the block route's whole-row loop: bit for
    bit, every barrier generation complete and every edge read before the
    next is written.  Rows of 0 frames, of no labels, L = 0 (S = 1), S
    not a multiple of 32 (a top band of one live state), 8 bands, T of 1
    and 2."""
    b = 4
    lp, skip, lens, label_lens = _band_case(t_max, b, s, seed=t_max * s)
    want = (_alpha_rows(lp, skip, lens) if is_alpha
            else _beta_rows(lp, skip, lens, label_lens))
    for seed in range(2):
        rng = np.random.default_rng(seed)
        got = np.stack([_band_walk(is_alpha, lp[:, i], skip[i], lens[i],
                                   2 * label_lens[i], rng)
                        for i in range(b)], 1)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("is_alpha", [True, False], ids=["alpha", "beta"])
def test_band_route_model_loop_is_the_plain_recursion(is_alpha):
    """The numpy whole-row loop the model is held to computes what the
    port's plain versions compute (their exp and log1p differ by ulps)."""
    lp, skip, lens, label_lens = _band_case(12, 4, 71, seed=5)
    args = [torch.as_tensor(v) for v in (lp, skip, lens, label_lens)]
    if is_alpha:
        got = _alpha_rows(lp, skip, lens)
        want = ctc_cuda.forward_alphas_reference(*args[:3])
    else:
        got = _beta_rows(lp, skip, lens, label_lens)
        want = ctc_cuda.backward_betas_reference(*args)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)
