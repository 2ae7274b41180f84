"""The port's GRU recurrences held to the JAX package's: the plain versions
of K9a, K9b, K8a and K8b against ``gru_seq_fwd``, ``_gru_seq_bwd_dgates``,
``_bigru_seq_fwd`` and ``_bigru_seq_bwd_dgates`` in interpret mode (as
tests/test_gru_pallas.py runs them), the gradients of ``gru_sequence`` and
``bigru_layer`` against ``jax.vjp`` of JAX's custom VJPs, and GRU
``rnn_forward`` against JAX's Pallas dispatch.  Inputs are made from a
seed with numpy and fed to both packages; on the CPU every wrapper runs
its plain version and launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.ops import gru_pallas
from kaldi_ctc_tpu.ops import rnn as jrnn
from kaldi_ctc_tpu_torch.ops import gru_cuda
from kaldi_ctc_tpu_torch.ops import rnn as trnn
from kaldi_ctc_tpu_torch.params import from_jax_params

T, B, D = 12, 6, 9
LENS = np.array([T, 9, 5, T, 1, 7], np.int32)   # full, ragged, one frame

# f32: the same f32 math in another summation order, compounded over T
# steps of a contracting recurrence.
F32_TOL = 1e-5
# bf16: layer outputs and dgates are stored in bf16 (ulp 2^-8 near 1) and
# enter the next step's product rounded to bf16, so a flipped rounding
# moves later steps by about an ulp; the JAX package holds its bf16
# Pallas LSTM path to its scan path at the same 2e-2.
BF16_TOL = 2e-2
_DT = {"float32": (jnp.float32, torch.float32, F32_TOL),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
_WRAPPERS = (gru_cuda.gru_seq_fwd, gru_cuda.gru_seq_bwd_dgates,
             gru_cuda.bigru_seq_fwd, gru_cuda.bigru_seq_bwd_dgates)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(a):
    """A JAX array → a torch tensor of the same dtype (f32 or bf16)."""
    t = torch.as_tensor(np.array(_np(a)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _close(got, ref, tol, name):
    assert str(got.dtype).split(".")[-1] == str(ref.dtype), name
    assert tuple(got.shape) == ref.shape, name
    np.testing.assert_allclose(got.detach().float().numpy(), _np(ref), rtol=0,
                               atol=tol, err_msg=name)


def _zero_past_lens(t, name):
    for row, n in enumerate(LENS):
        assert not t[n:, row].any(), name


@pytest.fixture(autouse=True)
def no_launches():
    """Every GRU kernel wrapper takes its plain version on the CPU."""
    for fn in _WRAPPERS:
        fn.launches = 0
    yield
    assert [fn.launches for fn in _WRAPPERS] == [0, 0, 0, 0]


def _inputs(gates, h, dtype, seed):
    """Seeded projection [T, B, gates*H], two recurrent weights [H, 3H]
    and an output cotangent [T, B, H] per direction, in ``dtype``."""
    jdt = _DT[dtype][0]
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((T, B, gates * h)).astype(np.float32)
    ws = [(rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    dys = [rng.standard_normal((T, B, h)).astype(np.float32)
           for _ in range(2)]
    return [jnp.asarray(a, jdt) for a in [xp] + ws + dys]


@pytest.mark.parametrize("h", [16, 128])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_seq_fwd_reference_matches_pallas_interpret(dtype, reverse, h):
    """K9a's plain version (what its wrapper runs on a CPU tensor)."""
    xp, w, _, _, _ = _inputs(3, h, dtype, seed=h)
    ref = gru_pallas.gru_seq_fwd(xp, w, jnp.asarray(LENS), reverse,
                                 interpret=True)
    got = gru_cuda.gru_seq_fwd(_to_torch(xp), _to_torch(w),
                               torch.as_tensor(LENS), reverse)
    _close(got, ref, _DT[dtype][2], "y")
    _zero_past_lens(got, "y")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_seq_bwd_dgates_reference_matches_pallas_interpret(dtype,
                                                               reverse):
    """K9b's dgx and dgh against ``_gru_seq_bwd_dgates`` on JAX's own
    forward (K9a in interpret mode)."""
    xp, w, _, dy, _ = _inputs(3, 16, dtype, seed=3)
    lens = jnp.asarray(LENS)
    y = gru_pallas.gru_seq_fwd(xp, w, lens, reverse, interpret=True)
    ref = gru_pallas._gru_seq_bwd_dgates(dy, xp, y, w, lens, reverse,
                                         interpret=True)
    got = gru_cuda.gru_seq_bwd_dgates(*map(_to_torch, (dy, xp, y, w)),
                                      torch.as_tensor(LENS), reverse)
    for name, g, r in zip(("dgx", "dgh"), got, ref):
        _close(g, r, _DT[dtype][2], name)
        _zero_past_lens(g, name)


@pytest.mark.parametrize("h", [12, 128])   # 128: lane-aligned fused views
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bigru_seq_fwd_reference_matches_pallas_interpret(dtype, h):
    """K8a's plain version against ``_bigru_seq_fwd``."""
    xp, w_f, w_b, _, _ = _inputs(6, h, dtype, seed=h + 1)
    ref = gru_pallas._bigru_seq_fwd(xp, w_f, w_b, jnp.asarray(LENS),
                                    interpret=True)
    got = gru_cuda.bigru_seq_fwd(*map(_to_torch, (xp, w_f, w_b)),
                                 torch.as_tensor(LENS))
    for name, g, r in zip(("y_f", "y_b"), got, ref):
        _close(g, r, _DT[dtype][2], name)
        _zero_past_lens(g, name)


@pytest.mark.parametrize("h", [12, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bigru_seq_bwd_dgates_reference_matches_pallas_interpret(dtype, h):
    """K8b's four outputs against ``_bigru_seq_bwd_dgates`` on JAX's own
    forward (K8a in interpret mode)."""
    xp, w_f, w_b, dy_f, dy_b = _inputs(6, h, dtype, seed=h + 2)
    lens = jnp.asarray(LENS)
    y_f, y_b = gru_pallas._bigru_seq_fwd(xp, w_f, w_b, lens, interpret=True)
    args = (dy_f, dy_b, xp, y_f, y_b, w_f, w_b)
    ref = gru_pallas._bigru_seq_bwd_dgates(*args, lens, interpret=True)
    got = gru_cuda.bigru_seq_bwd_dgates(*map(_to_torch, args),
                                        torch.as_tensor(LENS))
    for name, g, r in zip(("dgx_f", "dgh_f", "dgx_b", "dgh_b"), got, ref):
        _close(g, r, _DT[dtype][2], name)
        _zero_past_lens(g, name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_sequence_grads_match_jax_vjp(dtype, reverse):
    """``gru_sequence``'s output and its x_proj and w_h gradients, with
    their dtypes, against ``jax.vjp`` of ``gru_pallas.gru_sequence(...,
    interpret=True)``: w_h in master f32, x_proj in the compute dtype."""
    jdt, tdt, tol = _DT[dtype]
    xp, _, _, dy, _ = _inputs(3, 16, dtype, seed=5)
    w = (np.random.default_rng(6).standard_normal((16, 48)) / 4).astype(
        np.float32)
    y_ref, vjp = jax.vjp(
        lambda a, b: gru_pallas.gru_sequence(a, b, jnp.asarray(LENS),
                                             reverse, True),
        xp, jnp.asarray(w))
    ref = vjp(dy)
    x_t = _to_torch(xp).requires_grad_(True)
    w_t = torch.tensor(w, requires_grad=True)
    y = gru_cuda.gru_sequence(x_t, w_t, torch.as_tensor(LENS), reverse)
    assert y.dtype == tdt
    _close(y, y_ref, tol, "y")
    y.backward(_to_torch(dy))
    _close(x_t.grad, ref[0], tol, "dx_proj")
    _close(w_t.grad, ref[1], tol, "dw_h")


@pytest.mark.parametrize("h", [12, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bigru_layer_grads_match_jax_vjp(dtype, h):
    """``bigru_layer``'s five gradients (dx, dW_x, db, dW_f, dW_b) and
    their dtypes against ``jax.vjp`` of ``gru_pallas.bigru_layer(...,
    interpret=True)`` under one shared cotangent, all in f32 master
    precision; bf16 rounds y and the dgates at the same sites in both."""
    jdt, tdt, tol = _DT[dtype]
    rng = np.random.default_rng(h + 7)
    primals = (rng.standard_normal((T, B, D)).astype(np.float32),
               (rng.standard_normal((D, 6 * h)) / np.sqrt(D)).astype(
                   np.float32),
               (rng.standard_normal(6 * h) * 0.2).astype(np.float32),
               *((rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(
                   np.float32) for _ in range(2)))
    dy_f, dy_b = (rng.standard_normal((T, B, h)).astype(np.float32)
                  for _ in range(2))

    def layer(*p):
        return gru_pallas.bigru_layer(*p, jnp.asarray(LENS), True, dtype)

    (yf_ref, yb_ref), vjp = jax.vjp(layer, *map(jnp.asarray, primals))
    ref = vjp((jnp.asarray(dy_f, jdt), jnp.asarray(dy_b, jdt)))
    leaves = [torch.tensor(a, requires_grad=True) for a in primals]
    y_f, y_b = gru_cuda.bigru_layer(*leaves, torch.as_tensor(LENS), dtype)
    assert y_f.dtype == y_b.dtype == tdt
    _close(y_f, yf_ref, tol, "y_f")
    _close(y_b, yb_ref, tol, "y_b")
    torch.autograd.backward([y_f, y_b], [torch.as_tensor(dy_f).to(tdt),
                                         torch.as_tensor(dy_b).to(tdt)])
    for name, leaf, r in zip(("dx", "dw_x", "dbias", "dw_h_f", "dw_h_b"),
                             leaves, ref):
        _close(leaf.grad, r, tol, name)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_rnn_forward_matches_jax_pallas_dispatch(dtype, bidirectional,
                                                     monkeypatch):
    """A 2-layer GRU stack against JAX's Pallas dispatch (``bigru_layer``
    for both directions, ``gru_sequence`` per direction), its kernels
    forced into interpret mode as tests/test_gru_pallas.py forces them."""
    kw = dict(input_dim=D, hidden_dim=16, num_layers=2,
              mode=jrnn.RnnMode.GRU, bidirectional=bidirectional,
              compute_dtype=dtype)
    jcfg = jrnn.RnnConfig(implementation="pallas", **kw)
    params = jrnn.init_rnn_params(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(4).standard_normal((T, B, D)).astype(
        np.float32)
    bi, seq = gru_pallas.bigru_layer, gru_pallas.gru_sequence
    monkeypatch.setattr(
        gru_pallas, "bigru_layer",
        lambda x, wx, b, wf, wb, l, interpret=False,
        compute_dtype="float32": bi(x, wx, b, wf, wb, l, True, compute_dtype))
    monkeypatch.setattr(
        gru_pallas, "gru_sequence",
        lambda xp, w, l, reverse=False, interpret=False:
        seq(xp, w, l, reverse, True))
    ref = jrnn.rnn_forward(params, jnp.asarray(x), jcfg, jnp.asarray(LENS))
    got = trnn.rnn_forward(from_jax_params(jax.device_get(params)),
                           torch.as_tensor(x), trnn.RnnConfig(**kw),
                           torch.as_tensor(LENS))
    _close(got, ref, _DT[dtype][2], "y")
    _zero_past_lens(got, "y")
