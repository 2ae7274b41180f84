"""The port's batch ceilings (the kernels that keep every row in one
block's shared memory) and the launch plans of K10b, of the forward
chain (K2, K5, K8a, K9a, K10a) and of the backward chain (K3, K6, K9b),
on the CPU.

``rnn_cuda.run_in_row_slices`` runs a kernel over row slices under its
ceiling; here it is driven with each sliced kernel's plain version and a
small forced ceiling, and must return exactly what one unsliced call
returns.  ``rnn_cuda.k10b_plan`` and ``rnn_cuda.fwd_chain_plan`` must fit
every shape the BLSTM layer sends to K10b and K10a
(``use_in_kernel_proj``) into one H100 block's shared memory, and
``fwd_chain_plan`` must send K2, K5, K8a and K9a to their cluster
routes wherever W_h fits a cluster and to their cooperative routes
elsewhere; ``bwd_chain_plan`` does the same for K3, K6, K9b and K8b, its
byte formula the twin of ``csrc/bwd_chain.cuh``'s; ``stack_chain_plan``
chooses K7's route (the wavefront of per-layer clusters or the
cooperative kernel), its byte formula the twin of
``csrc/lstm_stack.cu``'s.  No JAX here: the plain versions are the port's
own.
"""

import numpy as np
import pytest
import torch

from kaldi_ctc_tpu_torch.ops import gru_cuda, rnn_cuda

T, B, H = 6, 7, 8
LENS = [T, 3, 0, 6, 1, 5, 2]     # ragged, one empty row
CEILING = 4                      # slices of 4 and 3 rows

# H100 SXM: SMs and the opt-in shared memory of one block (bytes)
H100_SMS, H100_SMEM = 132, 232448


def _mat(rng, *shape, scale=1.0):
    return torch.as_tensor((rng.standard_normal(shape) * scale)
                           .astype(np.float32))


def _case(name):
    """(launch, batched operands) of one sliced kernel's plain version:
    ``launch`` takes the batched operands and returns a tuple."""
    rng = np.random.default_rng(len(name))
    lens = torch.tensor(LENS, dtype=torch.int32)
    w = [_mat(rng, H, 4 * H, scale=H ** -0.5) for _ in range(2)]
    g = [_mat(rng, H, 3 * H, scale=H ** -0.5) for _ in range(2)]
    dy = [_mat(rng, T, B, H) for _ in range(2)]
    if name == "K3":
        xp = _mat(rng, T, B, 8 * H)
        y_f, c_f, y_b, c_b = rnn_cuda.bilstm_seq_fwd_reference(xp, *w, lens)
        return (lambda *a: rnn_cuda.bilstm_seq_bwd_dgates_reference(
            *a[:7], *w, a[7]), (*dy, xp, y_f, c_f, y_b, c_b, lens))
    if name == "K5":
        return (lambda xp, ln: rnn_cuda.lstm_seq_fwd_reference(
            xp, w[0], ln, True), (_mat(rng, T, B, 4 * H), lens))
    if name == "K6":
        xp = _mat(rng, T, B, 4 * H)
        y, c = rnn_cuda.lstm_seq_fwd_reference(xp, w[0], lens)
        return (lambda *a: (rnn_cuda.lstm_seq_bwd_dgates_reference(
            *a[:4], w[0], a[4]),), (dy[0], xp, y, c, lens))
    if name == "K7":
        # the streaming server's per-layer route: one layer with carries
        return (lambda xp, ln, h0, c0: rnn_cuda.lstm_stack_fwd_reference(
            xp, [], [w[0]], [], ln, h0, c0),
            (_mat(rng, T, B, 4 * H), lens, _mat(rng, 1, B, H),
             _mat(rng, 1, B, H)))
    if name == "K8a":
        return (lambda xp, ln: gru_cuda.bigru_seq_fwd_reference(
            xp, *g, ln), (_mat(rng, T, B, 6 * H), lens))
    if name == "K8b":
        xp = _mat(rng, T, B, 6 * H)
        y_f, y_b = gru_cuda.bigru_seq_fwd_reference(xp, *g, lens)
        return (lambda *a: gru_cuda.bigru_seq_bwd_dgates_reference(
            *a[:5], *g, a[5]), (*dy, xp, y_f, y_b, lens))
    if name == "K9a":
        return (lambda xp, ln: (gru_cuda.gru_seq_fwd_reference(
            xp, g[0], ln),), (_mat(rng, T, B, 3 * H), lens))
    assert name == "K9b"
    xp = _mat(rng, T, B, 3 * H)
    y = gru_cuda.gru_seq_fwd_reference(xp, g[0], lens, True)
    return (lambda *a: gru_cuda.gru_seq_bwd_dgates_reference(
        *a[:3], g[0], a[3], True), (dy[0], xp, y, lens))


@pytest.mark.parametrize("name", ["K3", "K5", "K6", "K7", "K8a", "K8b",
                                  "K9a", "K9b"])
def test_row_slices_equal_one_unsliced_call(name):
    """Each sliced kernel's plain version run by the wrappers' helper over
    slices of at most 4 of its 7 rows equals the same plain version on
    all 7 rows, exactly: every row's recurrence is independent.  (The CPU
    matmul of a plain version may sum a 1- or 2-row product in another
    order than a 7-row one, so the slices here keep 3 rows or more.)"""
    launch, batched = _case(name)
    want = launch(*batched)
    calls = []

    def counted(*args):
        calls.append(args[0].shape[1])
        return launch(*args)

    got = rnn_cuda.run_in_row_slices(counted, CEILING, *batched)
    assert calls == [4, 3]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g, w), i


def test_row_slices_under_the_ceiling_is_one_call_on_the_same_tensors():
    """At or under the ceiling the helper hands the operands over as they
    are, once: the main path's B = 48 is unchanged, no copy."""
    launch, batched = _case("K3")
    seen = []

    def spy(*args):
        seen.append(args)
        return launch(*args)

    for rows in (B, 1000):
        seen.clear()
        rnn_cuda.run_in_row_slices(spy, rows, *batched)
        assert len(seen) == 1
        assert all(a is b for a, b in zip(seen[0], batched))


def _k10_shapes():
    """Every (D, H) of H <= 320 that use_in_kernel_proj sends to K10b: D
    and 4H multiples of 128, resident weights of at most 8 MiB in f32."""
    return [(d, h) for h in range(32, 321, 32) for d in range(128, 8193, 128)
            if rnn_cuda.use_in_kernel_proj(d, 4 * h)]


def _check_plan(plan, b, d, h):
    c, r = plan.cluster, plan.rows
    assert c in (1, 2, 4, 8, 16), plan
    assert 1 <= r <= max(b, 1), plan
    assert c * -(-h // c) >= h, plan           # the cluster holds every unit
    if plan.gates_tiled:     # gates_tiled_smem of csrc/bilstm_bwd.cu
        assert plan.gate_cols == 64 and d + h <= 426, plan
        assert plan.gates_smem == 4 * (2 * 68 * (d + h) + 64)
    else:
        assert 1 <= plan.gate_cols <= 32 and d + h > 426, plan
        assert plan.gates_smem == 4 * plan.gate_cols * (d + h + 1)
    assert plan.gates_smem <= H100_SMEM and plan.chain_smem <= H100_SMEM
    # the phase-2 CTA's layout (chain_floats of csrc/bilstm_bwd.cu)
    hsz, rp = -(-h // c), -(-r // 4) * 4
    floats = (4 * hsz * h + -(-(2 * c * r * hsz) // 4) * 4 + 4 * hsz * rp
              + 2 * r * hsz + 16 * r * hsz + r)
    assert plan.chain_smem == 4 * floats, plan


@pytest.mark.parametrize("b", [1, 48, 600])
def test_k10b_plan_fits_every_shape_the_rule_admits(b):
    shapes = _k10_shapes()
    assert (256, 128) in shapes and (128, 320) in shapes and \
        (8064, 32) in shapes and (512, 256) in shapes
    assert max(h for _, h in shapes) == 320     # D = 128 only
    for d, h in shapes:
        _check_plan(rnn_cuda.k10b_plan(b, d, h, H100_SMS, H100_SMEM), b, d, h)


@pytest.mark.parametrize("b", [1, 48, 600])
@pytest.mark.parametrize("d,h", [(40, 16), (40, 128), (640, 320), (24, 20),
                                 (100, 100)])
def test_k10b_plan_fits_unaligned_shapes(b, d, h):
    """The wrapper takes any D and H the kernels took before (the card
    tests' unaligned D=40 H=16 among them), not only the rule's."""
    _check_plan(rnn_cuda.k10b_plan(b, d, h, H100_SMS, H100_SMEM), b, d, h)


def test_k10b_plan_at_the_3x128_training_shape():
    """Layers 2-3 of the 3x128 BLSTM at B=48: the tiled phase 1 (rows of
    384 floats); four CTAs of 32 units a cluster (64 KB of W_h each), four
    rows a cluster, 24 clusters; the largest H, 320, needs clusters of 16;
    B=600 fits one block's shared memory in 14 row groups."""
    plan = rnn_cuda.k10b_plan(48, 256, 128, H100_SMS, H100_SMEM)
    assert plan.gates_tiled and (plan.cluster, plan.rows) == (4, 4)
    assert rnn_cuda.k10b_plan(48, 128, 320, H100_SMS, H100_SMEM).cluster == 16
    big = rnn_cuda.k10b_plan(600, 256, 128, H100_SMS, H100_SMEM)
    assert -(-600 // big.rows) == 14


def test_k10b_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="no cluster plan"):
        rnn_cuda.k10b_plan(48, 256, 1024, H100_SMS, H100_SMEM)


def _chain_bytes(c, r, h, size, gates=4):
    """fwd_chain_bytes of csrc/fwd_chain.cuh: W_h's share, two receive
    buffers of h and the CTA's h slice (each 16-byte aligned), then f32
    sums, the cell's state and two buffers of prefetched
    pre-activations, and the lengths."""
    hsz = -(-h // c)

    def a16(n):
        return -(-n // 16) * 16
    return (a16(gates * hsz * h * size) + a16(2 * r * h * size)
            + a16(r * hsz * size) + 4 * r * hsz * (gates + 1 + 2 * gates)
            + 4 * r)


def _check_chain_plan(plan, b, d, h, dtype, dirs, gates=4):
    """A cluster plan of the forward chain: its layout within one block,
    its rows, and K10a's phase 1 (d > 0)."""
    c, r = plan.cluster, plan.rows
    assert plan.route == "cluster", plan
    assert c in (1, 2, 4, 8, 16), plan
    assert 1 <= r <= max(b, 1), plan
    assert c * -(-h // c) >= h, plan           # the cluster holds every unit
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.chain_smem == _chain_bytes(c, r, h, size, gates) \
        <= H100_SMEM, plan
    # R: the fewest rows that put the clusters in one wave on 3/4 of the
    # SMs, unless one more row would not fit shared memory
    want = min(b, -(-b // max(1, H100_SMS * 3 // 4 // (dirs * c))))
    assert r == want or (r < want and _chain_bytes(c, r + 1, h, size, gates)
                         > H100_SMEM), plan
    if d == 0:
        assert plan.proj_cols == 0 and plan.proj_smem == 0
    elif d <= 426:       # gates_tiled_smem(D, 0) of csrc/lstm_gates.cuh
        assert plan.proj_cols == 0 and plan.proj_smem == 4 * (136 * d + 64)
    else:                # gates_smem(cols, D, 0)
        assert 1 <= plan.proj_cols <= 32, plan
        assert plan.proj_smem == 4 * plan.proj_cols * (d + 1) <= H100_SMEM


@pytest.mark.parametrize("b", [1, 48, 600])
def test_fwd_chain_plan_fits_every_shape_the_rule_admits(b):
    """K10a's plan (both directions) at every (D, H) the layer sends it."""
    for d, h in _k10_shapes():
        plan = rnn_cuda.fwd_chain_plan(b, d, h, torch.float32, 2, H100_SMS,
                                       H100_SMEM)
        _check_chain_plan(plan, b, d, h, torch.float32, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
@pytest.mark.parametrize("d,h", [(40, 16), (40, 128), (640, 320), (24, 20),
                                 (100, 100)])
def test_fwd_chain_plan_fits_unaligned_shapes(dtype, b, d, h):
    """K10a takes every D and H that K10b's plan takes, in either dtype."""
    plan = rnn_cuda.fwd_chain_plan(b, d, h, dtype, 2, H100_SMS, H100_SMEM)
    _check_chain_plan(plan, b, d, h, dtype, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
def test_fwd_chain_plan_sends_k5_at_h320_to_clusters_of_16(dtype, b):
    """K5 at the 5x320 models' H: the cluster route in both dtypes, 16
    CTAs of 20 units a cluster, any batch."""
    plan = rnn_cuda.fwd_chain_plan(b, 0, 320, dtype, 1, H100_SMS, H100_SMEM)
    _check_chain_plan(plan, b, 0, 320, dtype, 1)
    assert plan.cluster == 16


@pytest.mark.parametrize("dtype,h,route", [
    (torch.float32, 470, "cluster"),       # f32 W_h share 4 x 30 x 470 x 4
    (torch.float32, 480, "cooperative"),
    (torch.float32, 512, "cooperative"),
    (torch.bfloat16, 640, "cluster"),      # bf16 halves the share
    (torch.bfloat16, 700, "cooperative")])
def test_fwd_chain_plan_picks_k5s_route_from_shapes(dtype, h, route):
    """K5's route is a function of the shapes: the cluster route while one
    row fits beside W_h's share of a cluster of 16, else the cooperative
    kernel (in row slices), which takes any H the reference takes."""
    for b in (1, 48, 600):
        plan = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 1, H100_SMS,
                                       H100_SMEM)
        assert plan.route == route, (b, plan)
        if route == "cluster":
            _check_chain_plan(plan, b, 0, h, dtype, 1)
        else:
            assert plan == ("cooperative", 0, 0, 0, 0, 0)


def test_fwd_chain_plan_at_the_training_shapes():
    """K10a at the 3x128's layers 2-3 at B=48: the tiled phase 1, 24
    clusters of 4 CTAs (32 units, 64 KB of f32 W_h each), 4 rows a
    cluster; K5 at the uni LSTM's H=320 in bf16: 6 clusters of 16, 8 rows
    each; at the 8 s request's B=1 one cluster of 16."""
    k10a = rnn_cuda.fwd_chain_plan(48, 256, 128, torch.float32, 2, H100_SMS,
                                   H100_SMEM)
    assert (k10a.cluster, k10a.rows, k10a.proj_cols) == (4, 4, 0)
    assert 2 * -(-48 // k10a.rows) == 24
    k5 = rnn_cuda.fwd_chain_plan(48, 0, 320, torch.bfloat16, 1, H100_SMS,
                                 H100_SMEM)
    assert (k5.cluster, k5.rows) == (16, 8)
    serve = rnn_cuda.fwd_chain_plan(1, 0, 320, torch.bfloat16, 1, H100_SMS,
                                    H100_SMEM)
    assert (serve.cluster, serve.rows) == (16, 1)


def test_fwd_chain_plan_refuses_what_cannot_fit():
    """K10a has no cooperative route: an H whose W_h fits no cluster, or a
    D whose one W_x column does not fit a block, raises."""
    with pytest.raises(ValueError, match="no cluster plan"):
        rnn_cuda.fwd_chain_plan(48, 256, 1024, torch.float32, 2, H100_SMS,
                                H100_SMEM)
    with pytest.raises(ValueError, match="no projection plan"):
        rnn_cuda.fwd_chain_plan(48, 60000, 32, torch.float32, 2, H100_SMS,
                                H100_SMEM)


@pytest.mark.parametrize("gates", [3, 4])
@pytest.mark.parametrize("c,r,h,size", [(16, 16, 320, 4), (16, 8, 320, 2),
                                        (4, 4, 128, 4), (16, 1, 545, 4),
                                        (2, 3, 20, 2), (16, 45, 320, 4),
                                        (16, 91, 320, 2)])
def test_fwd_chain_bytes_formula_per_gate_count(gates, c, r, h, size):
    """The Python twin of fwd_chain_bytes for the LSTM's 4 and the GRU's 3
    gate columns a unit: gates ceil(H/C) H weights, (gates + 1 + 2 gates)
    f32 words an element; 4 gates is the LSTM's layout (13 words)."""
    assert rnn_cuda._fwd_chain_bytes(c, r, h, size, gates) == _chain_bytes(
        c, r, h, size, gates)
    if gates == 4:
        assert rnn_cuda._fwd_chain_bytes(c, r, h, size) == _chain_bytes(
            c, r, h, size)
    hsz = -(-h // c)
    assert (_chain_bytes(c, r, h, size, 4) - _chain_bytes(c, r, h, size, 3)
            >= hsz * h * size + 4 * 3 * r * hsz - 15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
@pytest.mark.parametrize("h", [128, 320])
def test_fwd_chain_plan_sends_k2_to_clusters(dtype, b, h):
    """K2 (both directions on the hoisted projection) at the 3x128's layer
    1 and the 5x320's layers: the cluster route in both dtypes, clusters
    of 4 (H=128) or 16 (H=320), any batch."""
    plan = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 2, H100_SMS, H100_SMEM)
    _check_chain_plan(plan, b, 0, h, dtype, 2)
    assert plan.cluster == (4 if h == 128 else 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 48, 600])
@pytest.mark.parametrize("h", [128, 320])
def test_fwd_chain_plan_sends_k9a_to_clusters(dtype, b, h):
    """K9a (one GRU direction, 3 gate columns a unit) and K8a (both
    directions) at H=128 and the 5x320's H: the cluster route in both
    dtypes, any batch; three gate columns halve the cluster at H=128 (96
    KB of f32 W_h a CTA at C=2)."""
    for dirs in (1, 2):
        plan = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, dirs, H100_SMS,
                                       H100_SMEM, gates=3)
        _check_chain_plan(plan, b, 0, h, dtype, dirs, gates=3)
        assert plan.cluster == (2 if h == 128 else 16)


@pytest.mark.parametrize("gates,dirs,dtype,h,route", [
    (4, 2, torch.float32, 470, "cluster"),     # K2: K5's limits
    (4, 2, torch.float32, 480, "cooperative"),
    (4, 2, torch.bfloat16, 640, "cluster"),
    (4, 2, torch.bfloat16, 704, "cooperative"),
    (3, 1, torch.float32, 544, "cluster"),     # K9a: 3 x 34 x 544 x 4
    (3, 1, torch.float32, 576, "cooperative"),
    (3, 1, torch.bfloat16, 768, "cluster"),
    (3, 1, torch.bfloat16, 800, "cooperative"),
    (3, 2, torch.float32, 544, "cluster"),     # K8a: K9a's limits
    (3, 2, torch.float32, 576, "cooperative"),
    (3, 2, torch.bfloat16, 768, "cluster"),
    (3, 2, torch.bfloat16, 800, "cooperative")])
def test_fwd_chain_plan_picks_k2_and_k9a_routes_from_shapes(gates, dirs,
                                                            dtype, h, route):
    """K2's, K9a's and K8a's routes are a function of the shapes: the cluster
    route while one row fits beside W_h's share of a cluster of 16, else
    the cooperative kernel, which takes any H the reference takes."""
    for b in (1, 48, 600):
        plan = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, dirs, H100_SMS,
                                       H100_SMEM, gates=gates)
        assert plan.route == route, (b, plan)
        if route == "cluster":
            _check_chain_plan(plan, b, 0, h, dtype, dirs, gates)
        else:
            assert plan == ("cooperative", 0, 0, 0, 0, 0)


def test_fwd_chain_plan_at_k2_and_k9a_training_shapes():
    """At B=48, H=320: K2 and K8a take 6 clusters of 16 with 16 rows each
    (K8a's CTA 131,904 B in f32, 72,384 in bf16), K9a 6 clusters of 16
    with 8 rows each; K2 at the 3x128's layer 1 24 clusters of 4 with 4
    rows; K8a at B=600 packs 45 rows a cluster in f32 and 91 in bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        k2 = rnn_cuda.fwd_chain_plan(48, 0, 320, dtype, 2, H100_SMS,
                                     H100_SMEM)
        assert (k2.cluster, k2.rows) == (16, 16)
        k9a = rnn_cuda.fwd_chain_plan(48, 0, 320, dtype, 1, H100_SMS,
                                      H100_SMEM, gates=3)
        assert (k9a.cluster, k9a.rows) == (16, 8)
        k8a = rnn_cuda.fwd_chain_plan(48, 0, 320, dtype, 2, H100_SMS,
                                      H100_SMEM, gates=3)
        assert (k8a.cluster, k8a.rows) == (16, 16)
        assert k8a.chain_smem == (131904 if dtype == torch.float32
                                  else 72384)
        big = rnn_cuda.fwd_chain_plan(600, 0, 320, dtype, 2, H100_SMS,
                                      H100_SMEM, gates=3)
        assert big.rows == (45 if dtype == torch.float32 else 91)
    layer1 = rnn_cuda.fwd_chain_plan(48, 0, 128, torch.float32, 2, H100_SMS,
                                     H100_SMEM)
    assert (layer1.cluster, layer1.rows) == (4, 4)
    assert 2 * -(-48 // layer1.rows) == 24


@pytest.fixture
def h100(monkeypatch):
    """The wrappers' plan functions on an H100's SM count and shared
    memory, without a card (the kernel source's query is not asked)."""
    for mod in (rnn_cuda, gru_cuda):
        monkeypatch.setattr(mod, "_sm_count", lambda device: H100_SMS)
        monkeypatch.setattr(mod, "_smem_optin",
                            lambda lib, query, device: H100_SMEM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 8, 48, 600])
def test_k2_and_k9a_plans_are_their_cells_chain_plans(h100, dtype, b):
    """``k2_plan``, ``k9a_plan`` and ``k8a_plan`` are fwd_chain_plan with
    the kernel's gate count and directions: at H=320 the cluster route at every batch,
    the serving batch B = 1 included; at an H whose W_h fits no cluster,
    the cooperative route."""
    k2 = rnn_cuda.k2_plan(None, b, 320, dtype, "cuda")
    _check_chain_plan(k2, b, 0, 320, dtype, 2)
    assert k2 == rnn_cuda.fwd_chain_plan(b, 0, 320, dtype, 2, H100_SMS,
                                         H100_SMEM)
    k9a = gru_cuda.k9a_plan(None, b, 320, dtype, "cuda")
    _check_chain_plan(k9a, b, 0, 320, dtype, 1, gates=3)
    assert k9a == rnn_cuda.fwd_chain_plan(b, 0, 320, dtype, 1, H100_SMS,
                                          H100_SMEM, gates=3)
    k8a = gru_cuda.k8a_plan(None, b, 320, dtype, "cuda")
    _check_chain_plan(k8a, b, 0, 320, dtype, 2, gates=3)
    assert k8a == rnn_cuda.fwd_chain_plan(b, 0, 320, dtype, 2, H100_SMS,
                                          H100_SMEM, gates=3)
    assert rnn_cuda.k2_plan(None, b, 704, dtype, "cuda").route \
        == "cooperative"
    for h in (800, 576 if dtype == torch.float32 else 800):
        assert gru_cuda.k9a_plan(None, b, h, dtype, "cuda").route \
            == "cooperative"
        assert gru_cuda.k8a_plan(None, b, h, dtype, "cuda").route \
            == "cooperative"


def test_fwd_chain_plan_k10a_still_refuses_with_either_gate_count():
    """K10a (d > 0) has no cooperative route: where W_h fits no cluster it
    raises, whatever the gate count and batch."""
    for gates in (3, 4):
        for b in (1, 48):
            with pytest.raises(ValueError, match="no cluster plan"):
                rnn_cuda.fwd_chain_plan(b, 256, 1024, torch.float32, 2,
                                        H100_SMS, H100_SMEM, gates=gates)


# ---------------------------------------------------------------------------
# The backward chain's plan (K6, K9b; K10b's phase 2 shares its shape)
# ---------------------------------------------------------------------------


def _bwd_words(gates, pre):
    """bwd_chain_words of csrc/bwd_chain.cuh: the gates' scratch words,
    without the pre-activation in the scratch the gates' x_proj words too,
    the cell's residual words (the LSTM's c[t] and c[prev], the GRU's
    y[prev]) and dy's word, rounded up to 4."""
    n = gates * (1 if pre else 2) + (2 if gates == 4 else 1) + 1
    return (n + 3) // 4 * 4


def _bwd_bytes(c, r, h, gates, words):
    """bwd_chain_floats of csrc/bwd_chain.cuh, in bytes: W_h's share and
    the received partials (each rounded to 4 floats), the rounded dgates
    [gates ceil(H/C)][R to 4], dh and c2, two prefetch buffers, the
    lengths."""
    hsz = -(-h // c)
    rp = -(-r // 4) * 4
    floats = (-(-gates * hsz * h // 4) * 4 + -(-2 * c * r * hsz // 4) * 4
              + gates * hsz * rp + 2 * r * hsz + 2 * words * r * hsz + r)
    return 4 * floats


def _check_bwd_plan(plan, b, h, dirs, gates):
    """A cluster plan of the backward chain: its layout within one block,
    its cluster, its rows and its phase 1."""
    c, r = plan.cluster, plan.rows
    words = _bwd_words(gates, pre=False)
    assert plan.route == "cluster", plan
    assert c in (1, 2, 4, 8, 16), plan
    assert 1 <= r <= max(b, 1), plan
    assert c * -(-h // c) >= h, plan           # the cluster holds every unit
    assert plan.chain_smem == _bwd_bytes(c, r, h, gates, words) <= H100_SMEM
    # C: the smallest power of two whose CTA at one row takes at most
    # half of a block's shared memory, else 16
    assert c == 16 or _bwd_bytes(c, 1, h, gates, words) <= H100_SMEM // 2
    assert c == 1 or _bwd_bytes(c // 2, 1, h, gates, words) > H100_SMEM // 2
    # R: the fewest rows that put the clusters in one wave on 3/4 of the
    # SMs, unless one more row would not fit shared memory
    want = min(b, -(-b // max(1, H100_SMS * 3 // 4 // (dirs * c))))
    assert r == want or (r < want and _bwd_bytes(c, r + 1, h, gates, words)
                         > H100_SMEM), plan
    if dirs == 2:        # K3 and K8b: no phase 1
        assert plan.gate_cols == 0 and plan.gates_smem == 0
    elif h <= 426:       # gates_tiled_smem(0, H) of csrc/lstm_gates.cuh
        assert plan.gate_cols == 0 and plan.gates_smem == 4 * (136 * h + 64)
    else:                # gates_smem(32, 0, H)
        assert plan.gate_cols == 32 and plan.gates_smem == 4 * 32 * (h + 1)
    assert plan.gates_smem <= H100_SMEM


@pytest.mark.parametrize("b", [1, 48, 600])
@pytest.mark.parametrize("gates", [3, 4])
def test_bwd_chain_plan_fits_every_shape(b, gates):
    """bwd_chain_plan at every H from 8 to the cluster route's last, in
    both dtypes, one direction (K6, K9b) and two (K3): a cluster plan that
    fits one H100 block's shared memory at B = 1, 48 and 600, with one
    direction its phase 1 tiled to H = 426 (with two, no phase 1)."""
    last = 464 if gates == 4 else 544
    for h in list(range(8, last + 1, 24)) + [320, 426, 427, last]:
        for dtype in (torch.float32, torch.bfloat16):
            for dirs in (1, 2):
                plan = rnn_cuda.bwd_chain_plan(b, h, dtype, dirs, H100_SMS,
                                               H100_SMEM, gates=gates)
                _check_bwd_plan(plan, b, h, dirs, gates)
                assert plan == rnn_cuda.bwd_chain_plan(
                    b, h, torch.float32, dirs, H100_SMS, H100_SMEM,
                    gates=gates)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gates", [3, 4])
def test_bwd_chain_plan_at_the_training_shape(dtype, gates):
    """K6 and K9b at the 5x320 models' H: clusters of 16 (W_h's share, 4
    or 3 x 20 x 320 f32, is 102 KB or 77 KB) in both dtypes; at B=48 six
    clusters of 8 rows, at B=1 one cluster of one row.  With both
    directions (K3 for four gates) three clusters a direction of 16 rows
    at B=48 (181,824 B a CTA for K3), 26 rows at B=600."""
    for dirs, b, rows in ((1, 48, 8), (1, 1, 1), (2, 48, 16), (2, 1, 1)):
        plan = rnn_cuda.bwd_chain_plan(b, 320, dtype, dirs, H100_SMS,
                                       H100_SMEM, gates=gates)
        _check_bwd_plan(plan, b, 320, dirs, gates)
        assert (plan.cluster, plan.rows, plan.gate_cols) == (16, rows, 0)
    big = rnn_cuda.bwd_chain_plan(600, 320, dtype, 1, H100_SMS, H100_SMEM,
                                  gates=gates)
    assert big.cluster == 16 and big.rows < 48    # more waves of clusters
    if gates == 4:
        k3 = rnn_cuda.bwd_chain_plan(48, 320, dtype, 2, H100_SMS, H100_SMEM)
        assert k3.chain_smem == 181824
        assert rnn_cuda.bwd_chain_plan(600, 320, dtype, 2, H100_SMS,
                                       H100_SMEM).rows == 26


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gates,h,route", [
    (4, 464, "cluster"),             # K6: 4 x 29 x 464 f32 a CTA
    (4, 472, "cooperative"),
    (4, 512, "cooperative"),
    (3, 544, "cluster"),             # K9b: 3 x 34 x 544 f32
    (3, 552, "cooperative"),
    (3, 576, "cooperative"),
    (4, 128, "cluster"),             # K3 at the 3x128's layer 1: C=4
    (3, 128, "cluster")])
def test_bwd_chain_plan_picks_k6_and_k9b_routes_from_shapes(dtype, gates, h,
                                                            route):
    """K6's, K9b's and (four gates, both directions) K3's routes are a
    function of the shapes: the cluster route while one row fits beside
    W_h's f32 share of a cluster of 16 (the same H in either dtype and
    for either number of directions), else the cooperative kernel, which
    takes any H the reference takes, at any batch."""
    for b in (1, 48, 600):
        for dirs in (1, 2):
            plan = rnn_cuda.bwd_chain_plan(b, h, dtype, dirs, H100_SMS,
                                           H100_SMEM, gates=gates)
            assert plan.route == route, (b, dirs, plan)
            if route == "cluster":
                _check_bwd_plan(plan, b, h, dirs, gates)
            else:
                assert plan == ("cooperative", 0, 0, 0, 0, 0)
    if (gates, h) == (4, 128):       # K3 at the 3x128's layer 1, B=48
        k3 = rnn_cuda.bwd_chain_plan(48, h, dtype, 2, H100_SMS, H100_SMEM)
        assert (k3.cluster, k3.rows) == (4, 4)


def test_bwd_chain_plan_refuses_what_cannot_fit():
    """No cluster plan past shared memory: where not one row fits beside
    W_h's share of 16 CTAs the plan is the cooperative route, at any H;
    a dtype with no kernel raises."""
    for gates in (3, 4):
        for h in (1024, 4096):
            assert rnn_cuda.bwd_chain_plan(
                48, h, torch.float32, 1, H100_SMS, H100_SMEM,
                gates=gates).route == "cooperative"
    with pytest.raises(ValueError, match="no kernel"):
        rnn_cuda.bwd_chain_plan(48, 320, torch.float16, 1, H100_SMS,
                                H100_SMEM)


@pytest.mark.parametrize("gates,pre", [(4, True), (4, False), (3, False)])
@pytest.mark.parametrize("c,r,h", [(16, 8, 320), (16, 26, 320), (4, 4, 128),
                                   (16, 16, 320),
                                   (16, 1, 545), (2, 3, 21), (8, 5, 100)])
def test_bwd_chain_bytes_formula_per_gate_count(gates, pre, c, r, h):
    """The Python twin of bwd_chain_floats and bwd_chain_words for K10b's
    four gates on the pre-activation (8 words, the layout K10b had before
    it moved onto the chain), K6's four gates and K9b's three on the
    recurrent sums (12 and 8 words)."""
    words = rnn_cuda._bwd_chain_words(gates, pre)
    assert words == _bwd_words(gates, pre)
    assert words == {(4, True): 8, (4, False): 12, (3, False): 8}[gates, pre]
    assert rnn_cuda._bwd_chain_bytes(c, r, h, gates, words) == _bwd_bytes(
        c, r, h, gates, words)
    if gates == 4 and pre:     # K10b's chain_floats before the move
        hsz, rp = -(-h // c), -(-r // 4) * 4
        floats = (4 * hsz * h + -(-(2 * c * r * hsz) // 4) * 4
                  + 4 * hsz * rp + 2 * r * hsz + 16 * r * hsz + r)
        assert rnn_cuda._bwd_chain_bytes(c, r, h, 4, words) == 4 * floats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 48, 600])
def test_k6_and_k9b_plans_are_their_cells_chain_plans(h100, dtype, b):
    """``k6_plan`` and ``k9b_plan`` are bwd_chain_plan with the kernel's
    gate count and one direction, ``k3_plan`` with four gates and both
    directions: the cluster route at H=320 at every batch, the
    cooperative route at an H whose W_h fits no cluster."""
    k6 = rnn_cuda.k6_plan(None, b, 320, dtype, "cuda")
    assert k6 == rnn_cuda.bwd_chain_plan(b, 320, dtype, 1, H100_SMS,
                                         H100_SMEM)
    _check_bwd_plan(k6, b, 320, 1, 4)
    k9b = gru_cuda.k9b_plan(None, b, 320, dtype, "cuda")
    assert k9b == rnn_cuda.bwd_chain_plan(b, 320, dtype, 1, H100_SMS,
                                          H100_SMEM, gates=3)
    _check_bwd_plan(k9b, b, 320, 1, 3)
    k3 = rnn_cuda.k3_plan(None, b, 320, dtype, "cuda")
    assert k3 == rnn_cuda.bwd_chain_plan(b, 320, dtype, 2, H100_SMS,
                                         H100_SMEM)
    _check_bwd_plan(k3, b, 320, 2, 4)
    assert rnn_cuda.k6_plan(None, b, 512, dtype, "cuda").route \
        == "cooperative"
    assert rnn_cuda.k3_plan(None, b, 512, dtype, "cuda").route \
        == "cooperative"
    assert gru_cuda.k9b_plan(None, b, 576, dtype, "cuda").route \
        == "cooperative"


@pytest.mark.parametrize("b", [1, 48, 600])
def test_k10b_plan_is_the_backward_chain_shape(b):
    """K10b's phase 2 runs the backward chain with both directions on the
    pre-activations (8 words): its cluster and rows are the chain's shape
    for four gates and two directions, the same as before the move (the
    3x128's layers 2-3: 4 CTAs, 4 rows at B=48; 14 row groups at B=600)."""
    plan = rnn_cuda.k10b_plan(b, 256, 128, H100_SMS, H100_SMEM)
    assert (plan.cluster, plan.rows) == rnn_cuda._bwd_chain_shape(
        b, 128, 4, 8, 2, H100_SMS, H100_SMEM)
    assert (plan.cluster, plan.rows) == {1: (4, 1), 48: (4, 4),
                                         600: (4, 43)}[b]
    assert plan.chain_smem == _bwd_bytes(4, plan.rows, 128, 4, 8)


def test_scratch_chunks_of_the_backward_chains():
    """The phase-1 scratch of K6 and K9b holds at most 256 MiB a chunk:
    at B=600, H=320 the 240 steps run in three chunks (K6: 87 steps, 737
    MB in all) or three (K9b: 116); at B=48 in one."""
    mib = 256 << 20
    assert rnn_cuda._K10_SCRATCH_BYTES == mib
    for g, steps, chunks in ((1280, 87, 3), (960, 116, 3)):
        assert rnn_cuda._scratch_steps(240, 600, g) == steps
        assert -(-240 // steps) == chunks
        assert rnn_cuda._scratch_steps(240, 48, g) == 240
    assert 240 * 600 * 1280 * 4 > 2 * mib       # 737 MB
    assert rnn_cuda._scratch_steps(5, 10 ** 7, 1280) == 1   # at least one


# ---------------------------------------------------------------------------
# K8b on the backward chain with two directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,rows,smem", [(1, 1, None), (48, 16, 144704),
                                         (600, 36, 229584)])
def test_k8b_plan_is_the_two_direction_gru_chain(h100, dtype, b, rows, smem):
    """``k8b_plan`` is bwd_chain_plan with three gates and both
    directions: at H=320 the cluster route at every batch, clusters of 16,
    16 rows a cluster at the training batch (three clusters a direction,
    96 CTAs; 144,704 B a CTA), 36 at B=600 in one launch, and no phase 1
    (it reads the sums K8a stored)."""
    plan = gru_cuda.k8b_plan(None, b, 320, dtype, "cuda")
    assert plan == rnn_cuda.bwd_chain_plan(b, 320, dtype, 2, H100_SMS,
                                           H100_SMEM, gates=3)
    _check_bwd_plan(plan, b, 320, 2, 3)
    assert (plan.route, plan.cluster, plan.rows) == ("cluster", 16, rows)
    assert plan.gate_cols == plan.gates_smem == 0
    if smem is not None:
        assert plan.chain_smem == smem


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8b_routes_by_h(h100, dtype):
    """K8b takes its cluster route at every H up to the last whose W_h as
    f32 fits a cluster of 16 with one row (544, as K9b), in either dtype,
    and its cooperative kernel above it (552, and 576 where the f7 checks
    run its ceiling)."""
    for h in list(range(8, 545, 24)) + [320, 426, 427, 544]:
        for b in (1, 48, 600):
            plan = gru_cuda.k8b_plan(None, b, h, dtype, "cuda")
            _check_bwd_plan(plan, b, h, 2, 3)
    for h in (552, 576, 1024):
        for b in (1, 48, 600):
            assert gru_cuda.k8b_plan(None, b, h, dtype, "cuda") == (
                "cooperative", 0, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# K3 and K8b on the recurrent sums K2 and K8a stored
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gates", [4, 3], ids=["lstm", "gru"])
def test_forward_takes_its_cluster_route_wherever_the_backward_does(gates):
    """K3's and K8b's cluster route reads the recurrent sums that K2's
    and K8a's cluster route stored: wherever bwd_chain_plan gives the
    two-direction backward its cluster route, fwd_chain_plan gives the
    forward its own, at every H, batch and dtype, on the H100 and on
    cards with less shared memory a block (163 and 99 KiB); on the H100
    the LSTM's backward stops at H 465 and its forward at 472 in f32, the
    GRU's both at 544."""
    for smem in (H100_SMEM, 166912, 101376):
        for dtype in (torch.float32, torch.bfloat16):
            for h in range(8, 1032, 8):
                for b in (1, 48, 600):
                    bwd = rnn_cuda.bwd_chain_plan(b, h, dtype, 2, H100_SMS,
                                                  smem, gates)
                    fwd = rnn_cuda.fwd_chain_plan(b, 0, h, dtype, 2,
                                                  H100_SMS, smem, gates)
                    if bwd.route == "cluster":
                        assert fwd.route == "cluster", (smem, dtype, h, b)
    last = {4: (465, 472), 3: (544, 544)}[gates]
    for h, route in zip(last, ("cluster", "cluster")):
        assert rnn_cuda.fwd_chain_plan(48, 0, h, torch.float32, 2, H100_SMS,
                                       H100_SMEM, gates).route == route
    assert rnn_cuda.bwd_chain_plan(48, last[0], torch.float32, 2, H100_SMS,
                                   H100_SMEM, gates).route == "cluster"
    assert rnn_cuda.bwd_chain_plan(48, last[0] + 1, torch.float32, 2,
                                   H100_SMS, H100_SMEM,
                                   gates).route == "cooperative"


@pytest.mark.parametrize("mode", ["train", "no_grad", "inference_mode",
                                  "frozen"])
@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_layer_asks_for_the_sums_only_where_a_backward_is_recorded(
        monkeypatch, family, mode):
    """``bilstm_layer`` and ``bigru_layer`` ask their forward (K2, K8a)
    to keep the recurrent sums exactly where autograd records a backward:
    grad mode on and an operand requiring a gradient.  Evaluation under
    ``no_grad`` (cv), serving and decoding under ``inference_mode``, and
    a layer with nothing to differentiate store nothing.  In training the
    backward runs and returns a gradient for every differentiable
    operand (the plain versions here: the sums are None on the CPU)."""
    mod, fwd_name = ((rnn_cuda, "bilstm_seq_fwd") if family == "lstm"
                     else (gru_cuda, "bigru_seq_fwd"))
    layer = rnn_cuda.bilstm_layer if family == "lstm" else gru_cuda.bigru_layer
    gates = 4 if family == "lstm" else 3
    asked = []
    real = getattr(mod, fwd_name)

    def spy(*args, store_sums=False, **kw):
        asked.append(store_sums)
        return real(*args, store_sums=store_sums, **kw)

    monkeypatch.setattr(mod, fwd_name, spy)
    rng = np.random.default_rng(5)
    d, h = 5, 4
    x = _mat(rng, T, B, d)
    leaves = [_mat(rng, d, 2 * gates * h, scale=0.4),
              _mat(rng, 2 * gates * h, scale=0.1),
              _mat(rng, h, gates * h, scale=0.4),
              _mat(rng, h, gates * h, scale=0.4)]
    if mode != "frozen":
        for v in leaves:
            v.requires_grad_(True)
    lens = torch.as_tensor(LENS)
    if mode == "no_grad":
        with torch.no_grad():
            y_f, y_b = layer(x, *leaves, lens)
    elif mode == "inference_mode":
        with torch.inference_mode():
            y_f, y_b = layer(x, *leaves, lens)
    else:
        y_f, y_b = layer(x, *leaves, lens)
    assert asked == [mode == "train"]
    if mode == "train":
        (y_f.float().sum() + 2 * y_b.float().sum()).backward()
        for v in leaves:
            assert v.grad is not None and torch.isfinite(v.grad).all()
    else:
        assert not y_f.requires_grad and not y_b.requires_grad


# ---------------------------------------------------------------------------
# K7: the plan of the wavefront of per-layer clusters
# ---------------------------------------------------------------------------


def _stack_bytes(n_layers, c, r, h, size):
    """stack_chain_bytes of csrc/lstm_stack.cu transcribed from the
    kernel's layout, region by region: W_h's [4 hsz][H] and (L > 1)
    W_x's, recv [2][R][H], (L > 1) x_s [R][H], hl [R][hsz], each in the
    compute dtype and 16-byte aligned; then f32 g_s [R][4 hsz], c_s and
    hf_s [R][hsz], the prefetch words [2][R hsz][4], (L > 1) b_s [4 hsz],
    and the lengths [R]."""
    hsz = -(-h // c)
    regions = [4 * hsz * h, 2 * r * h, r * hsz]
    if n_layers > 1:
        regions += [4 * hsz * h, r * h]
    total = sum(-(-n * size // 16) * 16 for n in regions)
    floats = 4 * r * hsz + r * hsz + r * hsz + 2 * 4 * r * hsz
    if n_layers > 1:
        floats += 4 * hsz
    return total + 4 * floats + 4 * r


def _clusters(c, r):
    """A model of the card's co-resident clusters of c CTAs (one CTA an
    SM): the wrappers ask the kernel source instead."""
    return H100_SMS // c


def _coop_rows(n_layers, h):
    """lstm_stack_max_rows of the cooperative kernel, transcribed: hs =
    ceil(L H / SMs) units a block, W_h (and W_x) columns, the rows of h
    (and of the input), the sums (and projections) and c, all f32."""
    hs = -(-n_layers * h // H100_SMS)
    m = 2 if n_layers > 1 else 1
    fixed = 4 * m * 4 * hs * h
    per_row = 4 * (m * h + m * 4 * hs + hs)
    return max(0, (H100_SMEM - fixed) // per_row)


def _stack_plan(n_layers, b, h, dtype, clusters=_clusters, coop=None):
    return rnn_cuda.stack_chain_plan(
        n_layers, b, h, dtype, H100_SMS, H100_SMEM, clusters,
        _coop_rows(n_layers, h) if coop is None else coop)


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("n_layers,c,r,h", [
    (5, 16, 8, 320), (5, 16, 32, 320), (5, 16, 5, 320), (1, 16, 1, 320),
    (3, 4, 3, 16), (2, 8, 7, 100), (1, 2, 13, 21)])
def test_stack_chain_bytes_formula(size, n_layers, c, r, h):
    """The Python twin of stack_chain_bytes against the transcription of
    the kernel's layout, in both dtypes."""
    assert rnn_cuda._stack_chain_bytes(n_layers, c, r, h, size) == \
        _stack_bytes(n_layers, c, r, h, size)


def test_stack_chain_bytes_at_the_streaming_shape():
    """At 5 x 320, C=16: the forward chain's CTA plus W_x's columns (51,200
    B in bf16, 102,400 in f32) and the input rows (R H of the compute
    dtype), and the stack's own f32 h and bias.  bf16 fits with room at
    R=8 and R=32; f32 does not fit at R=8 (245,472 B > 232,448) and takes
    at most 5 rows a cluster."""
    for size, wx in ((2, 51200), (4, 102400)):
        for r in (8, 32):
            assert rnn_cuda._stack_chain_bytes(5, 16, r, 320, size) == (
                rnn_cuda._fwd_chain_bytes(16, r, 320, size) + wx
                + r * 320 * size + 4 * r * 20 + 4 * 80)
    assert rnn_cuda._stack_chain_bytes(5, 16, 8, 320, 2) == 127392
    assert rnn_cuda._stack_chain_bytes(5, 16, 32, 320, 2) == 201408
    assert rnn_cuda._stack_chain_bytes(5, 16, 8, 320, 4) == 245472 \
        > H100_SMEM
    assert rnn_cuda._stack_chain_bytes(5, 16, 5, 320, 4) <= H100_SMEM \
        < rnn_cuda._stack_chain_bytes(5, 16, 6, 320, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 32, 200])
@pytest.mark.parametrize("n_layers", [1, 5])
def test_stack_chain_plan(dtype, b, n_layers):
    """K7's plan at the streaming stack (5 x 320) and one of its layers:
    clusters of 16 in both dtypes; the shape fits a CTA and is the most
    rows R_max that do; one layer takes any B in one launch, R as the
    forward chain's (the clusters in one wave on 3/4 of the SMs); five
    layers take one group of five clusters a launch (the model's 8
    clusters of 16 hold one), so the cluster route runs B <= R_max in one
    launch (42 rows in bf16, 5 in f32), the cooperative kernel B <= 32,
    and a larger B the cluster route in row slices."""
    itemsize = 4 if dtype == torch.float32 else 2
    plan = _stack_plan(n_layers, b, 320, dtype)
    assert plan.cluster == 16, plan
    assert plan.chain_smem == _stack_bytes(n_layers, 16, plan.rows, 320,
                                           itemsize) <= H100_SMEM
    assert plan.coop_rows == (32 if n_layers == 5 else 162)
    if n_layers == 1:
        assert plan.route == "cluster" and plan.groups == 0
        assert plan.chain_rows == plan.launch_rows == 0
        assert plan.rows == max(1, -(-b // (H100_SMS * 3 // 4 // 16)))
        return
    r_max = 42 if dtype == torch.bfloat16 else 5
    assert _stack_bytes(5, 16, r_max, 320, itemsize) <= H100_SMEM \
        < _stack_bytes(5, 16, r_max + 1, 320, itemsize)
    assert (plan.groups, plan.chain_rows) == (1, r_max)
    assert plan.rows == min(b, r_max)
    route = ("cluster" if b <= r_max
             else "cooperative" if b <= 32 else "cluster")
    assert plan.route == route, plan
    assert plan.launch_rows == (32 if route == "cooperative" else r_max)


def test_stack_chain_plan_groups_follow_the_co_resident_clusters():
    """Above one layer a launch holds clusters(C, R_max) // L groups: two
    layers at 5 co-resident clusters give 2 groups, the rows spread over
    them; fewer clusters than layers leave the cooperative kernel."""
    plan = _stack_plan(2, 8, 320, torch.bfloat16, lambda c, r: 5)
    assert (plan.route, plan.groups, plan.rows) == ("cluster", 2, 4)
    r_max = plan.chain_rows // 2
    assert _stack_bytes(2, 16, r_max, 320, 2) <= H100_SMEM \
        < _stack_bytes(2, 16, r_max + 1, 320, 2)
    plan = _stack_plan(5, 8, 320, torch.bfloat16, lambda c, r: 4)
    assert plan.route == "cooperative" and plan.cluster == 0, plan


def test_stack_chain_plan_refuses_what_cannot_fit():
    """No route where neither fits: a W_h of 4096 units fits no cluster
    and no cooperative block; more layers than the kernels take, or a
    dtype with no kernel, raise.  A one-layer stack whose W_h fits no
    cluster of 16 (f32 H=512) takes the cooperative kernel."""
    with pytest.raises(ValueError, match="neither route"):
        _stack_plan(5, 8, 4096, torch.float32, coop=0)
    with pytest.raises(ValueError, match="no kernel"):
        _stack_plan(17, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        _stack_plan(2, 1, 16, torch.float16)
    plan = _stack_plan(1, 94, 512, torch.float32)
    assert plan.route == "cooperative" and plan.cluster == 0, plan
    assert plan.coop_rows == _coop_rows(1, 512) == 93


@pytest.fixture
def h100_stack(h100, monkeypatch):
    """K7's plan on an H100 without a card: the kernel source's queries
    answered by the models above, and no plan of an earlier case kept."""
    monkeypatch.setattr(rnn_cuda._kernels, "load", lambda *a: None)
    monkeypatch.setattr(rnn_cuda, "_STACK_PLANS", {})

    def ceiling(lib, query, device, *dims):
        if query.startswith("lstm_stack_chain_clusters_"):
            return _clusters(*dims[2:])
        assert query.startswith("lstm_stack_max_rows_"), query
        return _coop_rows(*dims)

    monkeypatch.setattr(rnn_cuda, "_ceiling", ceiling)


def test_lstm_stack_fits_agrees_with_the_plan(h100_stack):
    """``lstm_stack_fits`` (the streaming server's choice between the
    whole stack and one launch per layer) holds exactly where K7's plan
    runs the batch in one launch: the 8-slot tick of the 5 x 320 stack in
    either dtype (bf16 on the cluster route, f32 on the cooperative
    kernel), not 200 slots of two f32 layers, not 17 layers."""
    for dtype in (torch.float32, torch.bfloat16):
        for n_layers in (1, 2, 5):
            for b in (1, 8, 32, 33, 42, 43, 200):
                plan = rnn_cuda.k7_plan(None, n_layers, b, 320, dtype,
                                        "cuda")
                assert plan == _stack_plan(n_layers, b, 320, dtype)
                one = plan.launch_rows == 0 or b <= plan.launch_rows
                assert rnn_cuda.lstm_stack_fits(n_layers, b, 320, dtype,
                                                "cuda") == one
    assert rnn_cuda.lstm_stack_fits(5, 8, 320, torch.bfloat16, "cuda")
    assert rnn_cuda.lstm_stack_fits(5, 8, 320, torch.float32, "cuda")
    assert not rnn_cuda.lstm_stack_fits(5, 4096, 320, torch.float32, "cuda")
    assert not rnn_cuda.lstm_stack_fits(2, 200, 320, torch.float32, "cuda")
    assert not rnn_cuda.lstm_stack_fits(17, 1, 16, torch.float32, "cuda")
    assert rnn_cuda.lstm_stack_fits(1, 200, 320, torch.float32, "cuda")
