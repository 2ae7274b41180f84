"""The port's training step (``kaldi_ctc_tpu_torch/training/train.py``)
held to the JAX package's on the CPU: the lr schedule, the clip, three
steps of ``build_train_step`` on the tiny flagship, on its
unidirectional variant and on both with GRU layers, from the JAX
package's initial state (f32 and bf16, momentum 0 and 0.9), the
non-finite guard, and the eval step with its accuracy.

JAX's train step on the CPU runs its ``lax.scan`` RNN and its XLA CTC;
the port runs the plain versions of K2, K3 and K1 (BLSTM), K5, K6 and K1
(unidirectional LSTM), K8a, K8b and K1 (BiGRU) or K9a, K9b and K1
(unidirectional GRU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from kaldi_ctc_tpu.models import init_am_params
from kaldi_ctc_tpu.ops.rnn import RnnMode
from kaldi_ctc_tpu.training import train as jtrain
from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, am_param_shapes
from kaldi_ctc_tpu_torch.params import (from_jax_params, train_state_from_jax,
                                        train_state_to_jax, tree_flatten)
from kaldi_ctc_tpu_torch.training import train as ttrain

B, T, L = 4, 20, 4
# A warmup and a short decay so that lr moves in 3 steps, and an lr large
# enough that a gradient difference shows in the parameters.
OPTS = dict(initial_learning_rate=1e-2, final_learning_rate=1e-3,
            num_steps=10, warmup_steps=2)
# Per compute dtype: (loss rtol, grad_norm rtol, params atol, velocity
# atol).  The velocity holds gradient sums of up to ~10.
# f32: the same f32 maths in another summation order; params after
#   3 steps agree to ~2e-7 (lr * gradient ~1e-2), held at 1e-5, and
#   gradient sums to ~1.3e-5 (a few f32 ulps of 10), held at 5e-5.
# bf16: the forward rounds at the same sites in both (losses agree to
#   ~1e-7), but JAX's scan path also rounds the recurrent-weight
#   cotangent to bf16 at every step of its autodiff, where K3's
#   contract keeps dh and dW_h in f32: params drift ~2e-5 and
#   gradient sums ~1.8e-3 (a bf16 ulp of 0.5) after 3 steps.
TOLS = {"float32": (1e-6, 1e-5, 1e-5, 5e-5),
        "bfloat16": (1e-5, 1e-4, 1e-4, 5e-3)}
# The GRU stacks: f32 as above.  bf16: JAX's scan also rounds the h
# cotangent to bf16 at every step (the cast of h before the recurrent
# product), where K8b's and K9b's contract carries dh in f32, so the
# BiGRU's gradient sums of ~0.5 drift by up to ~1.3 bf16 ulps (5e-3).
GRU_TOLS = {"float32": TOLS["float32"],
            "bfloat16": TOLS["bfloat16"][:3] + (1e-2,)}


def _batch(seed=0):
    cfg = _flagship_cfg(tiny=True)
    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((B, T, cfg.input_dim)).astype(
                np.float32),
            "labels": rng.integers(1, cfg.num_targets, (B, L)).astype(
                np.int32),
            # full, partial, short and too short for its labels
            "input_lens": np.array([T, 17, 12, 3], np.int32),
            "label_lens": np.array([4, 3, 2, 2], np.int32)}


def _cfgs(dtype="float32", bidirectional=True, mode=RnnMode.LSTM):
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True), compute_dtype=dtype,
                               bidirectional=bidirectional, mode=mode)
    return jcfg, AmConfig.from_dict(jcfg.to_dict())


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("warmup", [0, 3])
def test_exponential_lr_matches_jax(warmup):
    kw = dict(initial_learning_rate=5e-4, final_learning_rate=1e-5,
              num_steps=7, warmup_steps=warmup)
    for step in range(12):
        ref = jtrain.exponential_lr(jtrain.TrainOptions(**kw),
                                    jnp.asarray(step, jnp.int32))
        got = ttrain.exponential_lr(ttrain.TrainOptions(**kw),
                                    torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [0.0, 3.0])
def test_clip_tree_matches_jax(clip_norm):
    rng = np.random.default_rng(1)
    tree = {"a": (rng.standard_normal((5, 3)) * 4).astype(np.float32),
            "b": [(rng.standard_normal(7) * 8).astype(np.float32)]}
    kw = dict(clip_elementwise=5.0, clip_norm=clip_norm)
    ref = jtrain._clip_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                            jtrain.TrainOptions(**kw))
    got = ttrain._clip_tree(from_jax_params(tree), ttrain.TrainOptions(**kw))
    for g, r in zip(_leaves(train_state_to_jax(
            ttrain.TrainState(got, got, torch.tensor(0)))["params"]),
            _leaves(ref)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(dtype, momentum):
    _check_train_steps(dtype, momentum, bidirectional=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uni_train_steps_match_jax(dtype):
    """The unidirectional variant (bench.py's streaming config) through
    the plain versions of K5, K6 and K1."""
    _check_train_steps(dtype, 0.9, bidirectional=False)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_train_steps_match_jax(dtype, bidirectional):
    """The tiny flagship with GRU layers, bi (the plain versions of K8a,
    K8b) and uni (K9a, K9b), and K1."""
    _check_train_steps(dtype, 0.9, bidirectional, RnnMode.GRU)


def _check_train_steps(dtype, momentum, bidirectional, mode=RnnMode.LSTM):
    loss_tol, norm_tol, param_tol, velocity_tol = (
        GRU_TOLS if mode == RnnMode.GRU else TOLS)[dtype]
    jcfg, tcfg = _cfgs(dtype, bidirectional, mode)
    jstate = jtrain.init_train_state(init_am_params(jax.random.PRNGKey(0),
                                                    jcfg))
    tstate = train_state_from_jax(jax.device_get(jstate))
    jstep = jtrain.make_train_step(jcfg, jtrain.TrainOptions(
        momentum=momentum, **OPTS))
    tstep = ttrain.build_train_step(tcfg, ttrain.TrainOptions(
        momentum=momentum, **OPTS))
    batch = _batch()
    for _ in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss_total"]),
                                   float(jm["loss_total"]), rtol=loss_tol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=norm_tol)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert bool(tm["finite"]) and bool(jm["finite"])
        assert int(tm["num_frames"]) == int(jm["num_frames"])
        np.testing.assert_array_equal(tm["hyp_ids"].numpy(),
                                      np.asarray(jm["hyp_ids"]))
        np.testing.assert_array_equal(tm["hyp_lens"].numpy(),
                                      np.asarray(jm["hyp_lens"]))
        got = train_state_to_jax(tstate)
        assert int(got["step"]) == int(jstate.step)
        for name, tol in (("params", param_tol),
                          ("velocity", velocity_tol)):
            for g, r in zip(_leaves(got[name]),
                            _leaves(getattr(jstate, name))):
                assert g.dtype == np.float32
                np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                           atol=tol, err_msg=name)


def test_nonfinite_batch_leaves_state_unchanged():
    """A NaN in the features poisons the gradient (its row's loss is
    masked to 0 as infeasible, but 0 * NaN activations reach the weight
    gradients): the step reports finite=False and keeps params and
    velocity (momentum on)."""
    _, tcfg = _cfgs()
    jstate = jtrain.init_train_state(init_am_params(jax.random.PRNGKey(0),
                                                    _cfgs()[0]))
    step = ttrain.build_train_step(tcfg, ttrain.TrainOptions(momentum=0.9,
                                                             **OPTS))
    state, _ = step(train_state_from_jax(jax.device_get(jstate)), _batch())
    bad = _batch(1)
    bad["feats"][1, 3, 2] = np.nan
    new, m = step(state, bad)
    assert not bool(m["finite"])
    assert not np.isfinite(float(m["grad_norm"]))
    for name in ("params", "velocity"):
        for a, b in zip(_leaves(train_state_to_jax(new)[name]),
                        _leaves(train_state_to_jax(state)[name])):
            np.testing.assert_array_equal(a, b)
    assert int(new.step) == int(state.step) + 1


def test_eval_step_and_accuracy_match_jax():
    _check_eval_step(bidirectional=True)


def test_uni_eval_step_matches_jax():
    _check_eval_step(bidirectional=False)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_gru_eval_step_matches_jax(bidirectional):
    _check_eval_step(bidirectional, RnnMode.GRU)


def _check_eval_step(bidirectional, mode=RnnMode.LSTM):
    jcfg, tcfg = _cfgs(bidirectional=bidirectional, mode=mode)
    jparams = init_am_params(jax.random.PRNGKey(3), jcfg)
    batch = _batch(2)
    jm = jtrain.make_eval_step(jcfg)(jparams, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    tm = ttrain.make_eval_step(tcfg)(
        from_jax_params(jax.device_get(jparams)), batch)
    np.testing.assert_allclose(float(tm["loss_total"]),
                               float(jm["loss_total"]), rtol=1e-6)
    assert int(tm["num_frames"]) == int(jm["num_frames"])
    np.testing.assert_array_equal(tm["hyp_ids"].numpy(),
                                  np.asarray(jm["hyp_ids"]))
    args = (batch["labels"], batch["label_lens"])
    assert ttrain.accuracy_from_outputs(tm, *args) == \
        jtrain.accuracy_from_outputs(jm, *args)


def test_train_state_converts_both_ways():
    _check_train_state_round_trip(bidirectional=True)


def test_uni_train_state_converts_both_ways():
    """A unidirectional tree (one direction per layer) carries across
    as it is: same leaves, same order, same shapes."""
    _check_train_state_round_trip(bidirectional=False)


def _check_train_state_round_trip(bidirectional):
    jcfg, tcfg = _cfgs(bidirectional=bidirectional)
    jstate = jtrain.init_train_state(init_am_params(jax.random.PRNGKey(0),
                                                    jcfg))
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    back = jtrain.TrainState(**train_state_to_jax(
        train_state_from_jax(jax.device_get(jstate))))
    assert int(back.step) == 7
    for a, b in zip(_leaves((back.params, back.velocity)),
                    _leaves((jstate.params, jstate.velocity))):
        np.testing.assert_array_equal(a, np.asarray(b))
    tparams = train_state_from_jax(jax.device_get(jstate)).params
    shapes = am_param_shapes(tcfg)
    assert all(len(layer["dirs"]) == (2 if bidirectional else 1)
               for layer in tparams["rnn"])
    assert [tuple(t.shape) for t in tree_flatten(tparams)] == \
        [tuple(s) for s in tree_flatten(shapes)]


def test_unported_training_options_raise():
    """The options once refused now run: ``affine_type="natural"`` gives
    the JAX package's NG state tree (the same leaves, shapes and dtypes,
    the counter int32) and a step that advances it; a dropout step draws
    its mask from the step number, the same mask for the same step."""
    jcfg, tcfg = _cfgs()
    opts = dict(affine_type="natural", ng_rank_in=5, ng_rank_out=4)
    jparams = init_am_params(jax.random.PRNGKey(0), jcfg)
    jstate = jtrain.init_train_state(jparams, jtrain.TrainOptions(**opts))
    params = from_jax_params(jax.device_get(jparams))
    state = ttrain.init_train_state(params, ttrain.TrainOptions(**opts))
    jleaves = _leaves(jstate.ng)
    assert [(tuple(t.shape), t.numpy().dtype) for t in tree_flatten(
        state.ng)] == [(j.shape, j.dtype) for j in jleaves]
    step = ttrain.build_train_step(tcfg, ttrain.TrainOptions(**opts))
    new, m = step(state, _batch())
    assert bool(m["finite"]) and int(new.ng["out"]["in"].t) == 1
    assert ttrain.dropout_mask(7, 0.9, (4, 3), "cpu").equal(
        ttrain.dropout_mask(7, 0.9, (4, 3), "cpu"))
    step = ttrain.build_train_step(dataclasses.replace(tcfg, dropout=0.1),
                                   ttrain.TrainOptions())
    a, _ = step(ttrain.init_train_state(params), _batch())
    b, _ = step(ttrain.init_train_state(params), _batch())
    assert all(x.equal(y) for x, y in zip(tree_flatten(a.params),
                                          tree_flatten(b.params)))
