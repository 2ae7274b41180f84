"""The in-kernel-projection BLSTM route (K10a, K10b) held to the JAX
package on the CPU: the plain versions of K10a and K10b against
``_bilstm_seq_fwd_proj`` and ``_bilstm_seq_bwd_dgates_proj`` in interpret
mode, ``use_in_kernel_proj`` against ``_use_in_kernel_proj``,
``bilstm_layer``'s gradients on that route against ``jax.vjp``, and a
3-layer BLSTM whose layers 2-3 take the route (input 40, 42 targets, the
3x128 recipe model at H=64): ``rnn_forward`` against JAX's fused Pallas
dispatch, three train steps and the eval step against JAX's, and
``/recognize`` against the JAX server.

Where the port runs a kernel's plain version, spies on the wrappers
show which route it took; on the CPU no kernel launches."""

import functools
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.models import acoustic as jacoustic
from kaldi_ctc_tpu.models import init_am_params
from kaldi_ctc_tpu.ops import rnn as jrnn
from kaldi_ctc_tpu.ops import rnn_pallas
from kaldi_ctc_tpu.training import train as jtrain
from kaldi_ctc_tpu_torch.models.acoustic import AmConfig
from kaldi_ctc_tpu_torch.ops import rnn as trnn
from kaldi_ctc_tpu_torch.ops import rnn_cuda
from kaldi_ctc_tpu_torch.params import (from_jax_params, train_state_from_jax,
                                        train_state_to_jax)
from kaldi_ctc_tpu_torch.training import train as ttrain

T, B = 12, 3
LENS = np.array([T, 7, 4], np.int32)   # one full row, two ragged

# f32: the same f32 math in another summation order, compounded over T
# steps of a contracting recurrence.
F32_TOL = 1e-5
# bf16: y, the projection and the dgates are stored in bf16 (ulp 2^-8
# near 1), so a flipped rounding moves later steps by about an ulp; the
# tolerance the port's K2/K3 tests already hold (tests/test_torch_rnn.py).
BF16_TOL = 2e-2

_DT = {"float32": (jnp.float32, torch.float32, F32_TOL),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

# the wrappers of the two routes a BLSTM layer can take
_ROUTES = ("bilstm_seq_fwd", "bilstm_seq_bwd_dgates", "bilstm_seq_fwd_proj",
           "bilstm_seq_bwd_dgates_proj")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(a):
    """A JAX array → a torch tensor of the same dtype (f32 or bf16)."""
    t = torch.as_tensor(np.array(_np(a)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _close(got, ref, tol, name):
    assert str(got.dtype).split(".")[-1] == str(ref.dtype), name
    assert tuple(got.shape) == ref.shape, name
    np.testing.assert_allclose(got.float().detach().numpy(), _np(ref),
                               rtol=0, atol=tol, err_msg=name)


@pytest.fixture
def calls(monkeypatch):
    """Count the calls of each BLSTM route's wrappers (name → count)."""
    seen = dict.fromkeys(_ROUTES, 0)
    for name in _ROUTES:
        def spy(*args, _fn=getattr(rnn_cuda, name), _name=name, **kw):
            seen[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(rnn_cuda, name, spy)
    return seen


def _proj_inputs(d, h, jdt, seed):
    """Seeded K10a operands as JAX arrays: x [T, B, D], w_x [D, 8H] and
    the two w_h [H, 4H] in the compute dtype, the bias [8H] f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, d))
    w_x = rng.standard_normal((d, 8 * h)) / np.sqrt(d)
    bias = rng.standard_normal(8 * h) * 0.2
    w_f, w_b = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)
                for _ in range(2))
    return (jnp.asarray(x, jdt), jnp.asarray(w_x, jdt),
            jnp.asarray(bias, jnp.float32), jnp.asarray(w_f, jdt),
            jnp.asarray(w_b, jdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", [(128, 32), (256, 64)])
def test_bilstm_seq_fwd_proj_reference_matches_pallas_interpret(dtype, d, h):
    """K10a's plain version (what its wrapper runs on a CPU tensor)
    against ``_bilstm_seq_fwd_proj`` in interpret mode, ragged rows."""
    jdt, _, tol = _DT[dtype]
    args = _proj_inputs(d, h, jdt, seed=d + h)
    ref = rnn_pallas._bilstm_seq_fwd_proj(*args, jnp.asarray(LENS),
                                          interpret=True)
    before = rnn_cuda.bilstm_seq_fwd_proj.launches
    got = rnn_cuda.bilstm_seq_fwd_proj(*map(_to_torch, args),
                                       torch.as_tensor(LENS))
    for name, g, r in zip(("y_f", "c_f", "y_b", "c_b"), got, ref):
        _close(g, r, tol, name)
    for row, n in enumerate(LENS):              # y = 0 at pad frames
        assert not got[0][n:, row].any() and not got[2][n:, row].any()
    assert rnn_cuda.bilstm_seq_fwd_proj.launches == before  # CPU: plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", [(128, 32), (256, 64)])
def test_bilstm_seq_bwd_dgates_proj_reference_matches_pallas_interpret(
        dtype, d, h):
    """K10b's plain version against ``_bilstm_seq_bwd_dgates_proj`` in
    interpret mode, on a forward run by JAX's K10a in interpret mode."""
    jdt, _, tol = _DT[dtype]
    x, w_x, bias, w_f, w_b = _proj_inputs(d, h, jdt, seed=d + h + 1)
    lens = jnp.asarray(LENS)
    y_f, c_f, y_b, c_b = rnn_pallas._bilstm_seq_fwd_proj(
        x, w_x, bias, w_f, w_b, lens, interpret=True)
    rng = np.random.default_rng(d + h + 2)
    dy_f, dy_b = (jnp.asarray(rng.standard_normal((T, B, h)), jdt)
                  for _ in range(2))
    args = (dy_f, dy_b, x, y_f, c_f, y_b, c_b, w_x, bias, w_f, w_b)
    ref = rnn_pallas._bilstm_seq_bwd_dgates_proj(*args, lens, interpret=True)
    before = rnn_cuda.bilstm_seq_bwd_dgates_proj.launches
    got = rnn_cuda.bilstm_seq_bwd_dgates_proj(*map(_to_torch, args),
                                              torch.as_tensor(LENS))
    for name, g, r in zip(("dg_f", "dg_b"), got, ref):
        _close(g, r, tol, name)
        for row, n in enumerate(LENS):          # zero at pad frames
            assert not g[n:, row].any(), name
    assert rnn_cuda.bilstm_seq_bwd_dgates_proj.launches == before


@pytest.mark.parametrize("d,g4,dtype,want", [
    (40, 512, "float32", False),      # the 3x128's layer 1: D unaligned
    (640, 1280, "float32", False),    # the flagship's layers 2-5: 13.1 MB
    (256, 512, "float32", True),      # the 3x128's layers 2-3: 2 MiB
    (512, 1024, "float32", True),     # exactly 8 MiB
    (256, 512, "bfloat16", False),    # never in bf16
    (128, 96, "float32", False),      # 4H unaligned
    (8064, 128, "float32", True),     # the widest input at H=32
    (8192, 128, "float32", False),    # one lane-row past 8 MiB
])
def test_use_in_kernel_proj_matches_jax(monkeypatch, d, g4, dtype, want):
    monkeypatch.delenv("KCTPU_RNN_PROJ", raising=False)
    assert rnn_pallas._use_in_kernel_proj(d, g4, _DT[dtype][0]) == want
    assert rnn_cuda.use_in_kernel_proj(d, g4, _DT[dtype][1]) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", [(128, 32), (256, 64)])
def test_bilstm_layer_grads_on_proj_route_match_jax_vjp(dtype, d, h, calls,
                                                        monkeypatch):
    """``bilstm_layer``'s outputs and five gradients against ``jax.vjp``
    of ``rnn_pallas.bilstm_layer(..., interpret=True)`` at aligned
    shapes: in f32 both take K10a/K10b, in bf16 both the hoisted route.
    The tolerance scales with each gradient's largest entry (up to ~20
    for dw_x here, summed over T*B frames)."""
    monkeypatch.delenv("KCTPU_RNN_PROJ", raising=False)
    jdt, tdt, tol = _DT[dtype]
    rng = np.random.default_rng(d * h)
    primals = (rng.standard_normal((T, B, d)).astype(np.float32),
               (rng.standard_normal((d, 8 * h)) / np.sqrt(d)).astype(
                   np.float32),
               (rng.standard_normal(8 * h) * 0.2).astype(np.float32),
               *((rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(
                   np.float32) for _ in range(2)))
    dy = [rng.standard_normal((T, B, h)).astype(np.float32)
          for _ in range(2)]

    def layer(*p):
        return rnn_pallas.bilstm_layer(*p, jnp.asarray(LENS), True, dtype)

    y_ref, vjp = jax.vjp(layer, *map(jnp.asarray, primals))
    ref = vjp(tuple(jnp.asarray(c, jdt) for c in dy))
    leaves = [torch.tensor(a, requires_grad=True) for a in primals]
    ys = rnn_cuda.bilstm_layer(*leaves, torch.as_tensor(LENS), dtype)
    torch.autograd.backward(ys, [torch.as_tensor(c).to(tdt) for c in dy])
    k10 = dtype == "float32"
    assert calls == {"bilstm_seq_fwd": int(not k10),
                     "bilstm_seq_bwd_dgates": int(not k10),
                     "bilstm_seq_fwd_proj": int(k10),
                     "bilstm_seq_bwd_dgates_proj": int(k10)}
    for name, g, r in zip(("y_f", "y_b"), ys, y_ref):
        _close(g, r, tol, name)
    for name, leaf, r in zip(("dx", "dw_x", "dbias", "dw_h_f", "dw_h_b"),
                             leaves, ref):
        scale = max(float(jnp.abs(r).max()), 1.0)
        _close(leaf.grad, r, tol * scale, name)


# The 3-layer model: input 40, 42 targets as recipes/medium and
# recipes/hard, H=64 so that layers 2-3 (D=128, 4H=256) are aligned.
MODEL = dict(input_dim=40, num_targets=42, hidden_dim=64, num_layers=3,
             mode=jrnn.RnnMode.LSTM, bidirectional=True)
MB, MT, ML = 4, 20, 4


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's fused Pallas dispatch on the CPU: its BLSTM
    layer with interpret=True (as tests/test_rnn_pallas.py forces it),
    and every ``AmConfig.rnn`` built with implementation="pallas"."""
    monkeypatch.delenv("KCTPU_RNN_PROJ", raising=False)
    orig = rnn_pallas.bilstm_layer
    monkeypatch.setattr(
        rnn_pallas, "bilstm_layer",
        lambda x, wx, b, wf, wb, l, interpret=False, compute_dtype="float32":
        orig(x, wx, b, wf, wb, l, True, compute_dtype))
    monkeypatch.setattr(jacoustic, "RnnConfig",
                        functools.partial(jrnn.RnnConfig,
                                          implementation="pallas"))


def _model_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((MB, MT, 40)).astype(np.float32),
            "labels": rng.integers(1, 42, (MB, ML)).astype(np.int32),
            "input_lens": np.array([MT, 17, 12, 3], np.int32),
            "label_lens": np.array([4, 3, 2, 2], np.int32)}


def test_proj_model_rnn_forward_matches_jax_fused_pallas(jax_fused, calls):
    jcfg = jacoustic.AmConfig(**MODEL).rnn
    params = jrnn.init_rnn_params(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(4).standard_normal((T, B, 40)).astype(
        np.float32)
    ref = jrnn.rnn_forward(params, jnp.asarray(x), jcfg, jnp.asarray(LENS))
    got = trnn.rnn_forward(from_jax_params(jax.device_get(params)),
                           torch.as_tensor(x), AmConfig(**MODEL).rnn,
                           torch.as_tensor(LENS))
    # layer 1 (D=40) on K2, layers 2-3 (D=128) on K10a
    assert calls["bilstm_seq_fwd"] == 1 and calls["bilstm_seq_fwd_proj"] == 2
    _close(got, ref, F32_TOL, "y")


def test_proj_model_train_and_eval_steps_match_jax(jax_fused, calls):
    """Three ``build_train_step`` steps (momentum 0.9, as the recipes set
    it) and then the eval step, both packages from the JAX package's
    initial state; JAX runs its fused dispatch (K2/K3 for layer 1,
    K10a/K10b for layers 2-3, in interpret mode), the port the plain
    versions on the same route.  Tolerances as tests/test_torch_train.py
    holds the flagship's f32 steps: (loss rtol, grad-norm rtol, params
    atol, velocity atol)."""
    loss_tol, norm_tol, param_tol, velocity_tol = 1e-6, 1e-5, 1e-5, 5e-5
    jcfg = jacoustic.AmConfig(**MODEL)
    tcfg = AmConfig.from_dict(jcfg.to_dict())
    opts = dict(momentum=0.9, initial_learning_rate=1e-2,
                final_learning_rate=1e-3, num_steps=10)
    jstate = jtrain.init_train_state(init_am_params(jax.random.PRNGKey(0),
                                                    jcfg))
    tstate = train_state_from_jax(jax.device_get(jstate))
    jstep = jtrain.make_train_step(jcfg, jtrain.TrainOptions(**opts))
    tstep = ttrain.build_train_step(tcfg, ttrain.TrainOptions(**opts))
    batch = _model_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss_total"]),
                                   float(jm["loss_total"]), rtol=loss_tol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=norm_tol)
        np.testing.assert_array_equal(tm["hyp_ids"].numpy(),
                                      np.asarray(jm["hyp_ids"]))
        got = train_state_to_jax(tstate)
        for name, tol in (("params", param_tol),
                          ("velocity", velocity_tol)):
            for g, r in zip(jax.tree_util.tree_leaves(got[name]),
                            jax.tree_util.tree_leaves(getattr(jstate,
                                                              name))):
                np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                           atol=tol, err_msg=f"{name} {i}")
    # per step: layer 1 on K2/K3, layers 2-3 on K10a/K10b
    assert calls == {"bilstm_seq_fwd": 3, "bilstm_seq_bwd_dgates": 3,
                     "bilstm_seq_fwd_proj": 6,
                     "bilstm_seq_bwd_dgates_proj": 6}
    jm = jtrain.make_eval_step(jcfg)(jstate.params, jbatch)
    tm = ttrain.make_eval_step(tcfg)(tstate.params, batch)
    np.testing.assert_allclose(float(tm["loss_total"]),
                               float(jm["loss_total"]), rtol=loss_tol)
    np.testing.assert_array_equal(tm["hyp_ids"].numpy(),
                                  np.asarray(jm["hyp_ids"]))
    assert calls["bilstm_seq_fwd_proj"] == 8
    assert calls["bilstm_seq_bwd_dgates_proj"] == 6   # no backward in eval


def _pcm(seconds, seed):
    """tests/test_serve.py's generator: band-limited-ish noise."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(int(16000 * seconds)))
    x = (x - x.mean()) / (np.abs(x).max() + 1e-6)
    return (x * 20000).astype("<i2")


def test_proj_model_recognize_matches_jax_server(tmp_path, calls):
    """An ``init_model`` directory of the 3-layer model (f32): the port's
    CLI server on the CPU serving its JAX-written artifact answers
    /recognize with the JAX engine's labels, through K2 for layer 1 and
    K10a for layers 2-3, and scores identical features as JAX does."""
    from kaldi_ctc_tpu.cli import init_model, serve as jserve
    from kaldi_ctc_tpu.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    exp = str(tmp_path / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "42",
                     "--hidden-dim", "64", "--num-layers", "3",
                     "--bidirectional", "1", "--dir", exp])
    jeng = jserve.Engine(jserve.parse_args(["--dir", exp]))
    path = str(tmp_path / "final.npz")
    save_inference_artifact(path, jeng.params, jeng.cfg, priors=jeng.priors)
    httpd, teng = tserve.make_server(tserve.parse_args(
        ["--model", path, "--device", "cpu", "--port", "0"]))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        for seconds, seed in ((1.2, 0), (0.7, 3)):
            pcm = _pcm(seconds, seed)
            jf = jeng.feats_for(pcm.astype(np.float32))
            for got, ref in zip(teng.score_utt(torch.as_tensor(jf)),
                                jeng._score_utt(jf)):
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
            before = dict(calls)
            conn = http.client.HTTPConnection("127.0.0.1",
                                              httpd.server_address[1],
                                              timeout=120)
            conn.request("POST", "/recognize", body=pcm.tobytes())
            resp = conn.getresponse()
            out = json.loads(resp.read().decode())
            conn.close()
            want = jeng.recognize(pcm.astype(np.float32))
            assert resp.status == 200 and out["labels"] == want["labels"]
            assert out["num_frames"] == want["num_frames"]
            assert (calls["bilstm_seq_fwd"] - before["bilstm_seq_fwd"],
                    calls["bilstm_seq_fwd_proj"]
                    - before["bilstm_seq_fwd_proj"]) == (1, 2)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
