"""The port's acoustic model, score preparation, parameter trees,
artifacts and checkpoints held to the JAX package's: one JAX init feeds
both packages; artifacts and checkpoint directories cross in both
directions with every leaf in its place (hazard F3)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.decoding.scores import acoustic_scores as j_scores
from kaldi_ctc_tpu.models import acoustic as jam
from kaldi_ctc_tpu.models import artifact as jart
from kaldi_ctc_tpu_torch.decoding.scores import acoustic_scores
from kaldi_ctc_tpu_torch.models import acoustic as tam
from kaldi_ctc_tpu_torch.models import artifact as tart
from kaldi_ctc_tpu_torch.params import (from_jax_params, to_jax_params,
                                        tree_flatten, tree_unflatten)

T, B = 14, 3
LENS = np.array([T, 9, 5], np.int32)
# logits: f32 sums in another order (1e-5); in bf16 the layer outputs
# are stored in bf16, so a flipped rounding moves a logit by ~an ulp of
# the output affine's inputs (the JAX package's 2e-2 bf16 tolerance).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# gradients, relative to each leaf's largest entry: f32 as TOL; in bf16
# JAX's scan RNN rounds the recurrent-weight cotangent to bf16 at every
# step, where the fused layer keeps dh and dW_h in f32, so dW_h moves by
# up to ~1% of its largest entry (the JAX package's 2e-2 bf16 tolerance).
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfg(dtype="float32", **kw):
    base = dict(input_dim=8, num_targets=7, hidden_dim=16, num_layers=2,
                compute_dtype=dtype)
    base.update(kw)
    return jam.AmConfig(**base), tam.AmConfig(**base)


def _jax_params(jcfg, seed=0):
    return jax.device_get(jam.init_am_params(jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_am_forward_matches_jax(dtype, bidirectional):
    jcfg, tcfg = _cfg(dtype, bidirectional=bidirectional)
    params = _jax_params(jcfg)
    feats = np.random.default_rng(0).standard_normal(
        (B, T, jcfg.input_dim)).astype(np.float32)
    ref = jam.am_forward(params, jnp.asarray(feats), jcfg,
                         input_lens=jnp.asarray(LENS))
    got = tam.am_forward(from_jax_params(params), torch.as_tensor(feats),
                         tcfg, input_lens=torch.as_tensor(LENS))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL[dtype])


def _bf16_exact(g: torch.Tensor) -> bool:
    return torch.equal(g.to(torch.bfloat16).float(), g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_am_forward_grads_match_jax_vjp(dtype):
    """Every parameter's gradient through the BLSTM model under one
    shared cotangent on the logits, against ``jax.vjp`` of JAX's
    ``am_forward`` (its scan RNN on the CPU).  Under bf16 the output
    affine's weight gradient is rounded to bf16 in both packages (the
    VJP of the cast to the compute dtype), while the BLSTM weight
    gradients come out of the fused layer in f32, unrounded."""
    jcfg, tcfg = _cfg(dtype)
    params = _jax_params(jcfg)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((B, T, jcfg.input_dim)).astype(np.float32)
    cot = rng.standard_normal((B, T, jcfg.num_targets)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p: jam.am_forward(p, jnp.asarray(feats), jcfg,
                                 input_lens=jnp.asarray(LENS)),
        jax.tree_util.tree_map(jnp.asarray, params))
    (ref,) = vjp(jnp.asarray(cot))
    tparams = from_jax_params(params)
    leaves = [p.requires_grad_(True) for p in tree_flatten(tparams)]
    logits = tam.am_forward(tree_unflatten(tparams, leaves),
                            torch.as_tensor(feats), tcfg,
                            input_lens=torch.as_tensor(LENS))
    logits.backward(torch.as_tensor(cot))
    grads = tree_unflatten(tparams, [p.grad for p in leaves])
    for g, r in zip(tree_flatten(grads), jax.tree_util.tree_leaves(ref)):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(r).max())
    assert _bf16_exact(grads["out_w"]) == (dtype == "bfloat16")
    assert _bf16_exact(torch.as_tensor(np.asarray(ref["out_w"]))) == (
        dtype == "bfloat16")
    for layer in grads["rnn"]:
        for d in layer["dirs"]:
            assert not _bf16_exact(d["w_h"]) and not _bf16_exact(d["w_x"])


@pytest.mark.parametrize("priors,threshold", [(None, 0.98), ("default", 0.5),
                                              ("default", 1.0)])
def test_acoustic_scores_match_jax(priors, threshold):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 5)).astype(np.float32) * 3
    logits[0, :4, 0] += 8.0   # confident blanks: forced frames
    pri = tam.default_priors(5) if priors else None
    got_s, got_k = acoustic_scores(torch.as_tensor(logits), priors=pri,
                                   acoustic_scale=0.7,
                                   blank_threshold=threshold)
    ref_s, ref_k = j_scores(jnp.asarray(logits), priors=pri,
                            acoustic_scale=0.7, blank_threshold=threshold)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    # forced frames are exactly 0 / -1e30 (F4: never -inf)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-6,
                               atol=1e-5)
    assert np.isfinite(got_s.numpy()).all()
    if threshold == 0.5:
        assert got_k.any()
        assert float(got_s.min()) < -1e29


def test_acoustic_scores_floor_is_tiny():
    logits = torch.tensor([[[0.0, -200.0, 200.0]]])
    sc, _ = acoustic_scores(logits, blank_threshold=1.0)
    assert np.isclose(float(sc[0, 0, 0]),
                      np.log(np.finfo(np.float32).tiny))
    assert np.isfinite(sc.numpy()).all()


def test_tree_flatten_order_is_jax_order():
    jcfg, _ = _cfg()
    params = _jax_params(jcfg)
    jleaves = jax.tree_util.tree_leaves(params)
    tleaves = tree_flatten(params)
    assert len(jleaves) == len(tleaves)
    assert all(a is b for a, b in zip(jleaves, tleaves))
    rebuilt = tree_unflatten(params, tleaves)
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(params)
    with pytest.raises(ValueError):
        tree_unflatten(params, tleaves[:-1])


def test_param_shapes_match_jax_init():
    jcfg, tcfg = _cfg()
    shapes = tree_flatten(tam.am_param_shapes(tcfg))
    leaves = jax.tree_util.tree_leaves(_jax_params(jcfg))
    assert [tuple(s) for s in shapes] == [l.shape for l in leaves]


def _assert_trees_equal(port_tree, jax_tree):
    """Leaf by leaf, addressed by path — not by flatten position."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = port_tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_jax_artifact_loads_in_port(tmp_path, bidirectional):
    # unidirectional: w_x of layers >= 1 and w_h share a shape (F3)
    jcfg, tcfg = _cfg(num_layers=3, bidirectional=bidirectional)
    params = _jax_params(jcfg, seed=4)
    path = str(tmp_path / "j.npz")
    jart.save_inference_artifact(path, params, jcfg,
                                 priors=jam.default_priors(7))
    got, cfg, priors = tart.load_inference_artifact(path)
    assert cfg == tcfg
    np.testing.assert_array_equal(priors, jam.default_priors(7))
    _assert_trees_equal(got, params)


def test_port_artifact_loads_in_jax(tmp_path):
    jcfg, tcfg = _cfg(num_layers=3, compute_dtype="bfloat16")
    params = tam.init_am_params(tcfg, torch.Generator().manual_seed(5))
    path = str(tmp_path / "t.npz")
    tart.save_inference_artifact(path, params, tcfg)
    jparams, cfg, priors = jart.load_inference_artifact(path)
    assert cfg == jcfg and priors is None
    _assert_trees_equal(params, jax.device_get(jparams))
    # and back through the JAX writer
    path2 = str(tmp_path / "t2.npz")
    jart.save_inference_artifact(path2, jparams, cfg)
    back, _, _ = tart.load_inference_artifact(path2)
    for a, b in zip(tree_flatten(back), tree_flatten(params)):
        assert torch.equal(a, b)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), to_jax_params(params),
        jax.device_get(jparams)))


def test_artifact_with_wrong_leaves_is_refused(tmp_path):
    jcfg, _ = _cfg()
    params = _jax_params(jcfg)
    path = str(tmp_path / "bad.npz")
    # config says 3 layers, leaves are for 2
    jart.save_inference_artifact(path, params,
                                 dataclasses.replace(jcfg, num_layers=3))
    with pytest.raises(ValueError):
        tart.load_inference_artifact(path)


def test_jax_init_model_dir_restores_in_port(tmp_path):
    from kaldi_ctc_tpu.cli import init_model
    from kaldi_ctc_tpu.training.checkpoint import restore_params as j_restore
    from kaldi_ctc_tpu_torch.training.checkpoint import (latest_step,
                                                         read_meta)
    exp = str(tmp_path / "exp")
    init_model.main(["--input-dim", "8", "--num-targets", "6",
                     "--hidden-dim", "8", "--num-layers", "2",
                     "--seed", "3", "--dir", exp])
    params, cfg, priors, meta = tart.load_acoustic_model(dir=exp)
    with open(f"{exp}/model_config.json") as f:
        jcfg = jam.AmConfig.from_dict(json.load(f))
    jparams, jmeta = j_restore(f"{exp}/checkpoints", jam.init_am_params(
        jax.random.PRNGKey(0), jcfg))
    assert cfg.to_dict() == jcfg.to_dict()
    assert meta == jmeta and latest_step(f"{exp}/checkpoints") == 0
    assert read_meta(f"{exp}/checkpoints")["extra"]["num_layers"] == 2
    np.testing.assert_array_equal(priors, jam.default_priors(6))
    _assert_trees_equal(params, jax.device_get(jparams))


def test_config_round_trip_and_output_lens():
    jcfg, tcfg = _cfg(compute_dtype="bfloat16", dropout=0.1)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tam.AmConfig.from_dict(jcfg.to_dict()) == tcfg
    assert tcfg.output_lens(37) == 37
    ds2 = tam.AmConfig(input_dim=8, num_targets=5, conv_layers=2)
    assert ds2.output_lens(37) == jam.AmConfig(
        input_dim=8, num_targets=5, conv_layers=2).output_lens(37) == 19


@pytest.mark.parametrize("extra", [dict(splice_left=1),
                                   dict(front_affine_dim=16),
                                   dict(conv_layers=1)])
def test_unported_model_families_raise(extra):
    """Splicing, the FT front and the DS2 conv front, once refused, now
    build the JAX package's parameter tree: the same leaves in the same
    order with the same shapes and the same RNN input width; a DS2 front
    combined with splicing or the FT front raises ValueError in both."""
    jcfg, tcfg = _cfg(**extra)
    jleaves = jax.tree_util.tree_leaves(_jax_params(jcfg))
    tleaves = tree_flatten(tam.init_am_params(
        tcfg, torch.Generator().manual_seed(0)))
    assert [tuple(t.shape) for t in tleaves] == [r.shape for r in jleaves]
    assert tcfg.rnn == tam.AmConfig.from_dict(jcfg.to_dict()).rnn
    assert tcfg.rnn.input_dim == jcfg.rnn.input_dim
    for bad in (dict(conv_layers=1, splice_left=1),
                dict(conv_layers=1, front_affine_dim=4)):
        jbad, tbad = _cfg(**bad)
        for c in (jbad, tbad):
            with pytest.raises(ValueError, match="DS2 conv front"):
                c.rnn


def test_dropout_in_training_raises():
    """Dropout acts only where a mask is given (training): without one
    the forward is the eval forward; with one, kept units are scaled by
    1 / (1 - p) and dropped ones zeroed before the output affine."""
    _, tcfg = _cfg(dropout=0.2)
    params = tam.init_am_params(tcfg, torch.Generator().manual_seed(0))
    feats = torch.randn((1, 4, 8), generator=torch.Generator().manual_seed(1))
    eval_out = tam.am_forward(params, feats, tcfg)
    assert eval_out.shape == (1, 4, 7)
    ones = torch.ones((4, 1, 32), dtype=torch.bool)
    assert torch.equal(tam.am_forward(params, feats, tcfg,
                                      dropout_mask=~ones), params["out_b"]
                       .expand(1, 4, 7))
    got = tam.am_forward(params, feats, tcfg, dropout_mask=ones)
    np.testing.assert_allclose(got.numpy(), (
        eval_out - params["out_b"]).numpy() / 0.8 + params["out_b"].numpy(),
        rtol=1e-5, atol=1e-6)
