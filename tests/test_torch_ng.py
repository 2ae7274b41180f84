"""Online natural-gradient SGD in the port held to the JAX package on the
CPU: ``ng_init``, ``ng_precondition`` over updated and skipped calls and
the re-orthogonalisation branch, ``ng_affine_update``, the
``affine_type="natural"`` train step with and without an FT front in f32
and bf16, NG checkpoints crossing between the packages both ways, and
``train_ctc --affine-type natural`` from one JAX-written checkpoint.

Eigenvector signs, and the basis inside repeated eigenvalues (the first
call has d = rho = eps throughout), are arbitrary in both packages'
``eigh``, so W is compared sign-free, as W^T W, beside rho, d, t, gamma
and the preconditioned rows and gradients."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.models import acoustic as jam
from kaldi_ctc_tpu.training import natural_gradient as jng
from kaldi_ctc_tpu.training import train as jtrain
from kaldi_ctc_tpu_torch.models import acoustic as tam
from kaldi_ctc_tpu_torch.params import (train_state_from_jax,
                                        train_state_to_jax, tree_flatten)
from kaldi_ctc_tpu_torch.training import natural_gradient as tng
from kaldi_ctc_tpu_torch.training import train as ttrain

from tests.test_torch_train_cli import (DIM, HIDDEN, LAYERS, TARGETS,
                                        _argv, _assert_records_equal,
                                        _final_leaves, _records, _write_set)

# the JAX functions under jit (their options static): one compile each
J_PRECONDITION = jax.jit(jng.ng_precondition, static_argnums=2)
J_AFFINE_UPDATE = jax.jit(jng.ng_affine_update, static_argnums=4)
# One preconditioner call: the same f32 maths in another order (XLA's
# eigh and LAPACK's): x_bar and gamma to 1e-5 relative to the rows'
# largest entry, W^T W, d and rho relative to their largest entry.
NG_RTOL = 1e-4


def _state_close(t_state, j_state, rtol=NG_RTOL):
    jw = np.asarray(j_state.w)
    tw = t_state.w.numpy()
    gram_j, gram_t = jw.T @ jw, tw.T @ tw
    np.testing.assert_allclose(gram_t, gram_j, rtol=0,
                               atol=rtol * np.abs(gram_j).max())
    for f in ("rho", "d"):
        r = np.asarray(getattr(j_state, f))
        np.testing.assert_allclose(getattr(t_state, f).numpy(), r, rtol=0,
                                   atol=rtol * np.abs(r).max())
    assert t_state.t.dtype == torch.int32
    assert int(t_state.t) == int(j_state.t)


@pytest.mark.parametrize("dim,rank,alpha", [(12, 5, 4.0), (6, 30, 2.0)])
def test_ng_init_matches_jax(dim, rank, alpha):
    j = jng.ng_init(dim, rank, alpha)
    t = tng.ng_init(dim, rank, alpha)
    for f in j._fields:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tng.ng_init(1, 3)


@pytest.mark.parametrize("update_period", [1, 4])
def test_ng_precondition_matches_jax(update_period):
    """14 calls on rows of unequal variance: the first 10 always update,
    then with update_period 4 the calls at t = 10, 11 are skipped (only t
    advances) and t = 12 updates."""
    rng = np.random.default_rng(0)
    dim, rank, n = 12, 5, 40
    opts = dict(rank_in=rank, rank_out=rank, update_period=update_period,
                num_samples_history=50.0)
    js, ts = jng.ng_init(dim, rank), tng.ng_init(dim, rank)
    scale = np.linspace(0.1, 3.0, dim).astype(np.float32)
    for call in range(14):
        x = rng.standard_normal((n, dim)).astype(np.float32) * scale
        jx, jg, js_new = J_PRECONDITION(js, jnp.asarray(x),
                                        jng.NgOptions(**opts))
        tx, tg, ts_new = tng.ng_precondition(ts, torch.as_tensor(x),
                                             tng.NgOptions(**opts))
        jx = np.asarray(jx)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                                   atol=1e-5 * np.abs(jx).max())
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-5)
        _state_close(ts_new, js_new)
        skipped = call >= 10 and call % update_period != 0
        assert torch.equal(ts_new.w, ts.w) == skipped
        js, ts = js_new, ts_new


def test_ng_precondition_reorthogonalises():
    """The first call from a fresh state has C_t's smallest eigenvalues at
    the eps floor (~1e-21) beside the data's (~1): the ill-conditioned
    branch re-orthogonalises R = E^{-1/2} W, in both packages, to rows
    orthonormal within f32 rounding, and the two agree sign-free."""
    rng = np.random.default_rng(1)
    dim, rank = 10, 4
    x = rng.standard_normal((64, dim)).astype(np.float32)
    x[:, 0] *= 30.0
    opts = dict(rank_in=rank, rank_out=rank)
    _, _, js = J_PRECONDITION(jng.ng_init(dim, rank), jnp.asarray(x),
                              jng.NgOptions(**opts))
    _, _, ts = tng.ng_precondition(tng.ng_init(dim, rank),
                                   torch.as_tensor(x), tng.NgOptions(**opts))
    _state_close(ts, js)
    for w, d, rho in ((np.asarray(js.w), np.asarray(js.d), float(js.rho)),
                      (ts.w.numpy(), ts.d.numpy(), float(ts.rho))):
        beta = rho * 5.0 + 4.0 * d.sum() / dim
        e = 1.0 / (beta / d + 1.0)
        r = w / np.sqrt(e)[:, None]
        np.testing.assert_allclose(r @ r.T, np.eye(rank), atol=1e-4)


def test_ng_affine_update_matches_jax():
    rng = np.random.default_rng(2)
    n, d_in, d_out = 50, 9, 7
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    dy = rng.standard_normal((n, d_out)).astype(np.float32)
    opts = dict(rank_in=4, rank_out=3)
    ji, jo = jng.ng_init(d_in + 1, 4), jng.ng_init(d_out, 3)
    ti, to = tng.ng_init(d_in + 1, 4), tng.ng_init(d_out, 3)
    for _ in range(3):
        jw, jb, ji, jo = J_AFFINE_UPDATE(ji, jo, jnp.asarray(x),
                                         jnp.asarray(dy),
                                         jng.NgOptions(**opts))
        tw, tb, ti, to = tng.ng_affine_update(ti, to, torch.as_tensor(x),
                                              torch.as_tensor(dy),
                                              tng.NgOptions(**opts))
        for a, b in ((tw, jw), (tb, jb)):
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-4 * np.abs(b).max())
        _state_close(ti, ji)
        _state_close(to, jo)
    # a bf16 input row is taken at its f32 value, as JAX's promotion does
    xb = torch.as_tensor(x).to(torch.bfloat16)
    a = tng.ng_affine_update(ti, to, xb, torch.as_tensor(dy),
                             tng.NgOptions(**opts))[0]
    b = tng.ng_affine_update(ti, to, xb.float(), torch.as_tensor(dy),
                             tng.NgOptions(**opts))[0]
    assert torch.equal(a, b)


B, T, L = 4, 20, 4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((B, T, 8)).astype(np.float32),
            "labels": rng.integers(1, 8, (B, L)).astype(np.int32),
            "input_lens": np.array([T, 17, 12, 3], np.int32),
            "label_lens": np.array([4, 3, 2, 2], np.int32)}


def _cfgs(dtype, front):
    base = dict(input_dim=8, num_targets=8, hidden_dim=16, num_layers=2,
                compute_dtype=dtype, param_stddev=0.3)
    if front:
        base.update(front_affine_dim=6, front_nonlin="pnorm", front_group=2)
    return jam.AmConfig(**base), tam.AmConfig(**base)


NG_OPTS = dict(initial_learning_rate=1e-2, final_learning_rate=1e-3,
               num_steps=10, momentum=0.9, affine_type="natural",
               ng_rank_in=4, ng_rank_out=3)
# Three natural steps from one JAX state, (loss rtol, params atol,
# preconditioner rtol).  f32: another summation order, eigh's included
# (parameters ~5e-6 after 3 steps at lr 1e-2).  bf16: the forward rounds
# at the same sites, but JAX's scan rounds the recurrent cotangent to bf16
# at every step (tests/test_torch_train.py), and the NG factors are built
# from those gradients: parameters drift ~5e-4, the preconditioners' W^T
# W ~5e-3 of its largest entry.
NG_STEP_TOLS = {"float32": (1e-5, 5e-5, 5e-3),
                "bfloat16": (2e-4, 2e-3, 5e-2)}


@pytest.mark.parametrize("front", [False, True], ids=["out", "front_out"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_natural_train_steps_match_jax(dtype, front):
    jcfg, tcfg = _cfgs(dtype, front)
    jstate = jtrain.init_train_state(
        jam.init_am_params(jax.random.PRNGKey(0), jcfg),
        jtrain.TrainOptions(**NG_OPTS))
    tstate = train_state_from_jax(jax.device_get(jstate))
    assert sorted(tstate.ng) == (["front", "out"] if front else ["out"])
    jstep = jax.jit(jtrain.build_train_step(jcfg,
                                            jtrain.TrainOptions(**NG_OPTS)))
    tstep = ttrain.build_train_step(tcfg, ttrain.TrainOptions(**NG_OPTS))
    loss_rtol, param_atol, ng_rtol = NG_STEP_TOLS[dtype]
    batch = _batch()
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss_total"]),
                                   float(jm["loss_total"]),
                                   rtol=1e-6 if i == 0 else loss_rtol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=10 * loss_rtol)
    got = train_state_to_jax(tstate)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=param_atol)
    for name in jstate.ng:
        for side in ("in", "out"):
            _state_close(tstate.ng[name][side], jstate.ng[name][side],
                         ng_rtol)
            assert int(tstate.ng[name][side].t) == 3


def test_ng_checkpoints_cross_both_ways(tmp_path):
    """A mid-run NG state written by either package restores in the other
    leaf for leaf (w, rho, d f32, t int32, in the JAX leaf order), and the
    next natural step from it agrees."""
    from kaldi_ctc_tpu.training import checkpoint as jck
    from kaldi_ctc_tpu_torch.training import checkpoint as tck

    jcfg, tcfg = _cfgs("float32", True)
    jopts = jtrain.TrainOptions(**NG_OPTS)
    topts = ttrain.TrainOptions(**NG_OPTS)
    jstate = jtrain.init_train_state(
        jam.init_am_params(jax.random.PRNGKey(1), jcfg), jopts)
    jstep = jax.jit(jtrain.build_train_step(jcfg, jopts))
    batch = _batch(1)
    for _ in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    like = ttrain.init_train_state(tam.init_am_params(tcfg), topts)
    jck.save_checkpoint(str(tmp_path / "jax"), 2, jstate)
    tstate, meta = tck.restore_checkpoint(str(tmp_path / "jax"), like)
    jleaves = jax.tree_util.tree_leaves(jax.device_get(jstate))
    tleaves = tree_flatten(tstate)
    assert len(tleaves) == len(jleaves) == meta["num_leaves"]
    for a, b in zip(tleaves, jleaves):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(tstate.ng["out"]["in"], tng.NgState)
    assert tstate.ng["front"]["out"].t.dtype == torch.int32
    # the port's state back into the JAX package
    tck.save_checkpoint(str(tmp_path / "port"), 2, tstate)
    back, _ = jck.restore_checkpoint(str(tmp_path / "port"), jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jleaves):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    _, jm = jstep(back, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = ttrain.build_train_step(tcfg, topts)(tstate, batch)
    np.testing.assert_allclose(float(tm["loss_total"]),
                               float(jm["loss_total"]), rtol=1e-6)


@pytest.fixture(scope="module")
def ng_data(tmp_path_factory):
    """test_torch_train_cli's training set and a JAX-written initial
    checkpoint holding the natural-gradient states."""
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("ng")
    _write_set(d, "train", 16, 0)
    cfg = jam.AmConfig(input_dim=DIM, num_targets=TARGETS, hidden_dim=HIDDEN,
                       num_layers=LAYERS)
    state = jtrain.init_train_state(
        jam.init_am_params(jax.random.PRNGKey(3), cfg),
        jtrain.TrainOptions(affine_type="natural", ng_rank_in=4,
                            ng_rank_out=3))
    save_checkpoint(str(d / f"init{LAYERS}" / "checkpoints"), 0, state,
                    extra={"epoch": 0, "num_layers": LAYERS})
    return d


def test_train_ctc_natural_matches_jax(ng_data, tmp_path):
    """train_ctc --affine-type natural (ranks 4 / 3) in both packages from
    one JAX checkpoint: the per-step records and the final checkpoint, its
    NG leaves included, agree (f32, test_torch_train_cli's tolerances;
    the preconditioners' W is compared sign-free)."""
    from kaldi_ctc_tpu.cli import train_ctc as jax_cli
    from kaldi_ctc_tpu_torch.cli import train_ctc as port_cli

    argv = _argv(ng_data, epochs=3, extra=[
        "--affine-type", "natural", "--ng-rank-in", "4", "--ng-rank-out",
        "3", "--momentum", "0.9"])
    dirs = {}
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(str(ng_data / f"init{LAYERS}"), dirs[pkg])
        cli.main(argv + ["--dir", dirs[pkg]] + dev)
    _assert_records_equal(_records(dirs["port"]), _records(dirs["jax"]))
    (jl, jm), (pl, pm) = _final_leaves(dirs["jax"]), _final_leaves(
        dirs["port"])
    assert pm == jm and len(pl) == len(jl)
    n_params = jm["num_param_leaves"]
    # params, velocity, step; then per NG state w, rho, d, t
    for a, b in zip(pl[:2 * n_params + 1], jl[:2 * n_params + 1]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-5 * max(
            1.0, float(np.abs(b).max())))
    ng = list(zip(pl[2 * n_params + 1:], jl[2 * n_params + 1:]))
    assert len(ng) == 8
    for i in range(0, 8, 4):
        (tw, jw), (tr, jr), (td, jd), (tt, jt) = ng[i:i + 4]
        np.testing.assert_allclose(tw.T @ tw, jw.T @ jw, rtol=0,
                                   atol=5e-3 * np.abs(jw.T @ jw).max())
        np.testing.assert_allclose(td, jd, rtol=0,
                                   atol=5e-3 * np.abs(jd).max())
        np.testing.assert_allclose(tr, jr, rtol=5e-3)
        assert tt.dtype == jt.dtype == np.int32 and tt == jt == 6
    assert os.path.exists(os.path.join(dirs["port"], "model_config.json"))
