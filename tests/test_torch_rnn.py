"""The port's recurrent stacks held to the JAX package's: the plain
versions of K2, K3, K5 and K6 against ``_bilstm_seq_fwd``,
``_bilstm_seq_bwd_dgates``, ``lstm_seq_fwd`` and ``_lstm_seq_bwd_dgates``
in interpret mode, the gradients of ``bilstm_layer`` and
``lstm_sequence`` against JAX's custom VJPs, and ``rnn_forward`` for
every mode against JAX's XLA scan path and (for the BLSTM) its fused
Pallas path in interpret mode.  Parameters and inputs
are made once (JAX init, numpy inputs) and fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.ops import rnn as jrnn
from kaldi_ctc_tpu.ops import rnn_pallas
from kaldi_ctc_tpu_torch.ops import rnn as trnn
from kaldi_ctc_tpu_torch.ops import rnn_cuda
from kaldi_ctc_tpu_torch.params import from_jax_params

T, B, D, H = 12, 3, 10, 16
LENS = np.array([T, 7, 4], np.int32)   # full, partial, short rows

# f32: the same f32 math in another summation order, compounded over T
# steps of a contracting recurrence.
F32_TOL = 1e-5
# bf16: layer outputs are stored in bf16 (ulp 2^-8 near 1) and h enters
# each step rounded to bf16, so a flipped rounding moves later steps by
# about an ulp; the JAX package holds its bf16 Pallas path to its scan
# path at the same 2e-2 (tests/test_rnn_pallas.py).
BF16_TOL = 2e-2

_DT = {"float32": (jnp.float32, torch.float32, F32_TOL),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bilstm_inputs(t, b, h, seed):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((t, b, 8 * h)).astype(np.float32)
    w_f = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    w_b = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return xp, w_f, w_b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [16, 128])   # 128: lane-aligned half views
def test_bilstm_seq_fwd_reference_matches_pallas_interpret(dtype, h):
    jdt, tdt, tol = _DT[dtype]
    xp, w_f, w_b = _bilstm_inputs(T, B, h, seed=h)
    ref = rnn_pallas._bilstm_seq_fwd(
        jnp.asarray(xp, jdt), jnp.asarray(w_f, jdt), jnp.asarray(w_b, jdt),
        jnp.asarray(LENS), interpret=True)
    got = rnn_cuda.bilstm_seq_fwd(
        torch.as_tensor(xp).to(tdt), torch.as_tensor(w_f).to(tdt),
        torch.as_tensor(w_b).to(tdt), torch.as_tensor(LENS))
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=0,
                                   atol=tol, err_msg=name)
    assert rnn_cuda.bilstm_seq_fwd.launches == 0   # CPU: plain version


def _cfgs(mode, bidirectional, dtype, d=D, h=H, layers=2):
    kw = dict(input_dim=d, hidden_dim=h, num_layers=layers, mode=mode,
              bidirectional=bidirectional, compute_dtype=dtype)
    return (jrnn.RnnConfig(implementation="xla", **kw),
            trnn.RnnConfig(**kw))


def _run_both(mode, bidirectional, dtype, seed=0):
    jcfg, tcfg = _cfgs(mode, bidirectional, dtype)
    params = jrnn.init_rnn_params(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((T, B, D)).astype(
        np.float32)
    ref = jrnn.rnn_forward(params, jnp.asarray(x), jcfg, jnp.asarray(LENS))
    got = trnn.rnn_forward(from_jax_params(jax.device_get(params)),
                           torch.as_tensor(x), tcfg, torch.as_tensor(LENS))
    return got, ref


@pytest.mark.parametrize("mode,bidirectional", [
    (trnn.RnnMode.LSTM, True), (trnn.RnnMode.LSTM, False),
    (trnn.RnnMode.GRU, True), (trnn.RnnMode.GRU, False),
    (trnn.RnnMode.RELU, True), (trnn.RnnMode.TANH, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rnn_forward_matches_jax_xla(mode, bidirectional, dtype):
    got, ref = _run_both(mode, bidirectional, dtype)
    assert got.shape == ref.shape
    assert got.dtype == _DT[dtype][1]
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=0,
                               atol=_DT[dtype][2])
    # pad frames are zero in every layer's output
    for row, n in enumerate(LENS):
        assert not got[n:, row].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [16, 128])
def test_rnn_forward_matches_jax_fused_pallas(dtype, h):
    """The BLSTM stack against JAX's fused dispatch (bilstm_layer with
    its Pallas kernels in interpret mode, forced as
    tests/test_rnn_pallas.py forces it)."""
    kw = dict(input_dim=D, hidden_dim=h, num_layers=2,
              mode=jrnn.RnnMode.LSTM, bidirectional=True,
              compute_dtype=dtype)
    jcfg = jrnn.RnnConfig(implementation="pallas", **kw)
    params = jrnn.init_rnn_params(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(1).standard_normal((T, B, D)).astype(
        np.float32)
    orig = rnn_pallas.bilstm_layer
    try:
        rnn_pallas.bilstm_layer = (
            lambda x, wx, b, wf, wb, l, interpret=False,
            compute_dtype="float32":
            orig(x, wx, b, wf, wb, l, True, compute_dtype))
        ref = jrnn.rnn_forward(params, jnp.asarray(x), jcfg,
                               jnp.asarray(LENS))
    finally:
        rnn_pallas.bilstm_layer = orig
    got = trnn.rnn_forward(from_jax_params(jax.device_get(params)),
                           torch.as_tensor(x), trnn.RnnConfig(**kw),
                           torch.as_tensor(LENS))
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=0,
                               atol=_DT[dtype][2])


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_direction_loop_matches_jax(reverse):
    """The plain per-step loop (``_run_direction``) on an LSTM direction,
    the loop the fused path replaces."""
    jcfg, tcfg = _cfgs(trnn.RnnMode.LSTM, True, "float32", layers=1)
    params = jrnn.init_rnn_params(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(2).standard_normal((T, B, D)).astype(
        np.float32)
    ref = jrnn._run_direction(jnp.asarray(x), jnp.asarray(LENS),
                              params[0]["dirs"][1], jcfg, reverse)
    tp = from_jax_params(jax.device_get(params))
    got = trnn._run_direction(torch.as_tensor(x), torch.as_tensor(LENS),
                              tp[0]["dirs"][1], tcfg, reverse)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=F32_TOL)


def test_rnn_forward_without_lens_is_full_length():
    _, tcfg = _cfgs(trnn.RnnMode.LSTM, True, "float32")
    params = trnn.init_rnn_params(tcfg, torch.Generator().manual_seed(0))
    x = torch.randn((T, B, D), generator=torch.Generator().manual_seed(1))
    full = torch.full((B,), T, dtype=torch.int32)
    assert torch.equal(trnn.rnn_forward(params, x, tcfg),
                       trnn.rnn_forward(params, x, tcfg, full))


def test_init_rnn_params_seeded_and_shaped_like_jax():
    jcfg, tcfg = _cfgs(trnn.RnnMode.LSTM, True, "float32")
    a = trnn.init_rnn_params(tcfg, torch.Generator().manual_seed(3))
    b = trnn.init_rnn_params(tcfg, torch.Generator().manual_seed(3))
    j = jrnn.init_rnn_params(jax.random.PRNGKey(0), jcfg)
    for la, lb, lj in zip(a, b, j):
        for da, db, dj in zip(la["dirs"], lb["dirs"], lj["dirs"]):
            for k in ("w_x", "w_h", "b"):
                assert torch.equal(da[k], db[k])
                assert tuple(da[k].shape) == dj[k].shape


def _bwd_inputs(h, dtype, seed):
    """One layer's forward run by the JAX package's Pallas K2 in
    interpret mode, and seeded output cotangents: the operands of K3."""
    jdt, _, _ = _DT[dtype]
    xp, w_f, w_b = _bilstm_inputs(T, B, h, seed)
    rng = np.random.default_rng(seed + 1)
    dy_f, dy_b = (rng.standard_normal((T, B, h)).astype(np.float32)
                  for _ in range(2))
    jx = [jnp.asarray(a, jdt) for a in (xp, w_f, w_b)]
    y_f, c_f, y_b, c_b = rnn_pallas._bilstm_seq_fwd(
        jx[0], jx[1], jx[2], jnp.asarray(LENS), interpret=True)
    return (jnp.asarray(dy_f, jdt), jnp.asarray(dy_b, jdt), jx[0], y_f, c_f,
            y_b, c_b, jx[1], jx[2], jnp.asarray(LENS))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [16, 128])
def test_bilstm_seq_bwd_dgates_reference_matches_pallas_interpret(dtype, h):
    """K3's plain version (what its wrapper runs on a CPU tensor) against
    ``_bilstm_seq_bwd_dgates`` in interpret mode, with short rows."""
    args = _bwd_inputs(h, dtype, seed=h + 3)
    ref = rnn_pallas._bilstm_seq_bwd_dgates(*args, interpret=True)
    targs = [torch.as_tensor(np.array(_np(a))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for a in args[:-1]] + [torch.as_tensor(LENS)]
    before = rnn_cuda.bilstm_seq_bwd_dgates.launches
    got = rnn_cuda.bilstm_seq_bwd_dgates(*targs)
    for name, g, r in zip(("dg_f", "dg_b"), got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=0,
                                   atol=_DT[dtype][2], err_msg=name)
        for row, n in enumerate(LENS):          # zero at pad frames
            assert not g[n:, row].any(), name
    assert rnn_cuda.bilstm_seq_bwd_dgates.launches == before  # CPU: plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [16, 128])
def test_bilstm_layer_grads_match_jax_vjp(dtype, h):
    """``bilstm_layer``'s five gradients and their dtypes against
    ``jax.vjp`` of ``rnn_pallas.bilstm_layer(..., interpret=True)`` under
    one shared cotangent.  bf16: the layer stores y and dgates in bf16,
    so the gradients move by about a bf16 ulp of their largest entries
    (up to ~6 here: 6 * 2^-8 = 0.023 > BF16_TOL only past the largest)."""
    jdt, tdt, _ = _DT[dtype]
    rng = np.random.default_rng(h)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    w_x = (rng.standard_normal((D, 8 * h)) / np.sqrt(D)).astype(np.float32)
    bias = (rng.standard_normal(8 * h) * 0.2).astype(np.float32)
    w_f, w_b = ((rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(
        np.float32) for _ in range(2))
    dy_f, dy_b = (rng.standard_normal((T, B, h)).astype(np.float32)
                  for _ in range(2))
    primals = (x, w_x, bias, w_f, w_b)

    def layer(*p):
        return rnn_pallas.bilstm_layer(*p, jnp.asarray(LENS), True, dtype)

    _, vjp = jax.vjp(layer, *map(jnp.asarray, primals))
    ref = vjp((jnp.asarray(dy_f, jdt), jnp.asarray(dy_b, jdt)))
    leaves = [torch.tensor(a, requires_grad=True) for a in primals]
    y_f, y_b = rnn_cuda.bilstm_layer(*leaves, torch.as_tensor(LENS), dtype)
    assert y_f.dtype == y_b.dtype == tdt
    torch.autograd.backward([y_f, y_b], [torch.as_tensor(dy_f).to(tdt),
                                         torch.as_tensor(dy_b).to(tdt)])
    for name, leaf, r in zip(("dx", "dw_x", "dbias", "dw_h_f", "dw_h_b"),
                             leaves, ref):
        g = leaf.grad
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=0,
                                   atol=_DT[dtype][2], err_msg=name)


def test_bilstm_layer_bf16_grads_of_a_bf16_input():
    """A layer above the first gets its input in bf16: dx comes back in
    x's dtype, the weight gradients in f32 (the master dtype)."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((T, B, 2 * H)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    w = [torch.tensor((rng.standard_normal(s) * 0.1).astype(np.float32),
                      requires_grad=True)
         for s in ((2 * H, 8 * H), (8 * H,), (H, 4 * H), (H, 4 * H))]
    y_f, y_b = rnn_cuda.bilstm_layer(x, *w, torch.as_tensor(LENS),
                                     "bfloat16")
    (y_f.float().sum() + y_b.float().sum()).backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in w)
    for row, n in enumerate(LENS):            # no gradient from pad frames
        assert not x.grad[n:, row].any()


def _uni_inputs(h, seed):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((T, B, 4 * h)).astype(np.float32)
    w = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return xp, w


def _to_torch(a):
    """A JAX array → a torch tensor of the same dtype (f32 or bf16)."""
    t = torch.as_tensor(np.array(_np(a)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("block_t", [None, 1])   # time-blocked, per step
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_seq_fwd_reference_matches_pallas_interpret(dtype, reverse,
                                                         block_t):
    """K5's plain version (what its wrapper runs on a CPU tensor) against
    ``lstm_seq_fwd`` in interpret mode, with short rows."""
    jdt, _, tol = _DT[dtype]
    xp, w = _uni_inputs(H, seed=7)
    ref = rnn_pallas.lstm_seq_fwd(jnp.asarray(xp, jdt), jnp.asarray(w, jdt),
                                  jnp.asarray(LENS), reverse,
                                  interpret=True, block_t=block_t)
    got = rnn_cuda.lstm_seq_fwd(_to_torch(jnp.asarray(xp, jdt)),
                                _to_torch(jnp.asarray(w, jdt)),
                                torch.as_tensor(LENS), reverse)
    for name, g, r in zip(("y", "c_seq"), got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=0,
                                   atol=tol, err_msg=name)
    for row, n in enumerate(LENS):                # y = 0 at pad frames
        assert not got[0][n:, row].any()
    assert rnn_cuda.lstm_seq_fwd.launches == 0    # CPU: plain version


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_seq_bwd_dgates_reference_matches_pallas_interpret(dtype,
                                                                reverse):
    """K6's plain version against ``_lstm_seq_bwd_dgates`` in interpret
    mode, on a forward run by JAX's K5 in interpret mode."""
    jdt, _, tol = _DT[dtype]
    xp, w = _uni_inputs(H, seed=8)
    dy = np.random.default_rng(9).standard_normal((T, B, H)).astype(
        np.float32)
    jxp, jw, jlens = jnp.asarray(xp, jdt), jnp.asarray(w, jdt), \
        jnp.asarray(LENS)
    y, c_seq = rnn_pallas.lstm_seq_fwd(jxp, jw, jlens, reverse,
                                       interpret=True)
    args = (jnp.asarray(dy, jdt), jxp, y, c_seq, jw)
    ref = rnn_pallas._lstm_seq_bwd_dgates(*args, jlens, reverse,
                                          interpret=True)
    before = rnn_cuda.lstm_seq_bwd_dgates.launches
    got = rnn_cuda.lstm_seq_bwd_dgates(*map(_to_torch, args),
                                       torch.as_tensor(LENS), reverse)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=0,
                               atol=tol)
    for row, n in enumerate(LENS):                # zero at pad frames
        assert not got[n:, row].any()
    assert rnn_cuda.lstm_seq_bwd_dgates.launches == before


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_sequence_grads_match_jax_vjp(dtype, reverse):
    """``lstm_sequence``'s x_proj and w_h gradients and their dtypes
    against ``jax.vjp`` of ``rnn_pallas.lstm_sequence(..., interpret=
    True)``: w_h in master f32, x_proj in the compute dtype."""
    jdt, tdt, tol = _DT[dtype]
    xp, w = _uni_inputs(H, seed=10)
    dy = np.random.default_rng(11).standard_normal((T, B, H)).astype(
        np.float32)
    jxp = jnp.asarray(xp, jdt)
    y_ref, vjp = jax.vjp(
        lambda a, b: rnn_pallas.lstm_sequence(a, b, jnp.asarray(LENS),
                                              reverse, True),
        jxp, jnp.asarray(w))
    ref = vjp(jnp.asarray(dy, jdt))
    x_t = _to_torch(jxp).requires_grad_(True)
    w_t = torch.tensor(w, requires_grad=True)
    y = rnn_cuda.lstm_sequence(x_t, w_t, torch.as_tensor(LENS), reverse)
    assert y.dtype == tdt
    np.testing.assert_allclose(y.float().detach().numpy(), _np(y_ref),
                               rtol=0, atol=tol)
    y.backward(torch.as_tensor(dy).to(tdt))
    for name, g, r in (("dx_proj", x_t.grad, ref[0]),
                       ("dw_h", w_t.grad, ref[1])):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=0,
                                   atol=tol, err_msg=name)
