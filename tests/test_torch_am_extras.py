"""The acoustic model's extras in the port held to the JAX package on the
CPU: the DS2 conv front (2 layers, 4 channels, time strides 2 and 1,
seq-norm on and off, ragged batches holding the copied F1 mask), input
splicing, the FT front with each of its five nonlinearities, dropout
with JAX's mask supplied, in f32 and bf16, forward and gradients; the
dropout train step with JAX's masks; ``init_model`` with the extras'
flags, its directory loaded by both packages; and the FT-front stream
against the JAX streaming recognizer and against the offline forward.

Both packages start from one JAX parameter tree (``init_model``'s draws
differ, ROADMAP §3).  The weights are drawn at stddev 0.3, not the
default 0.02, so that every layer moves the logits."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.models import acoustic as jam
from kaldi_ctc_tpu.training import train as jtrain
from kaldi_ctc_tpu_torch.models import acoustic as tam
from kaldi_ctc_tpu_torch.params import (from_jax_params, train_state_from_jax,
                                        train_state_to_jax, tree_flatten,
                                        tree_unflatten)
from kaldi_ctc_tpu_torch.training import train as ttrain

T, B = 12, 3
# ragged: a full row, one of odd length (its strided tail frame reads
# padding) and a short one
LENS = np.array([T, 9, 5], np.int32)
# logits, absolute: f32 sums in another order (the convs' too: cuDNN's
# and XLA's CPU convolutions); bf16: the stack's outputs are stored in
# bf16 in both, a flipped rounding moves a logit by ~an ulp of the output
# affine's inputs (tests/test_torch_model.py's TOL)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# gradients relative to each leaf's largest entry (test_torch_model's
# GRAD_TOL): in bf16 JAX's scan rounds the recurrent cotangent to bf16 at
# every step, where the port's layer keeps it in f32
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DS2 = dict(conv_layers=2, conv_channels=4)
EXTRAS = {
    "ds2_stride2": DS2,
    "ds2_stride1": dict(DS2, conv_time_stride=1),
    "ds2_no_norm": dict(DS2, conv_norm="none"),
    "splice": dict(splice_left=2, splice_right=1),
    "ft_relu": dict(front_affine_dim=6),
    "ft_tanh": dict(front_affine_dim=6, front_nonlin="tanh"),
    "ft_sigmoid": dict(front_affine_dim=6, front_nonlin="sigmoid"),
    "ft_pnorm": dict(front_affine_dim=6, front_nonlin="pnorm",
                     front_group=2),
    "ft_maxout": dict(front_affine_dim=6, front_nonlin="maxout",
                      front_group=3),
    "splice_ft": dict(splice_left=1, splice_right=1, front_affine_dim=6,
                      front_nonlin="pnorm", front_group=2),
    "dropout": dict(dropout=0.3),
}


def _cfg(dtype="float32", **kw):
    base = dict(input_dim=8, num_targets=7, hidden_dim=8, num_layers=1,
                compute_dtype=dtype, param_stddev=0.3)
    base.update(kw)
    return jam.AmConfig(**base), tam.AmConfig(**base)


def _jax_params(jcfg, seed=0):
    return jax.device_get(jam.init_am_params(jax.random.PRNGKey(seed), jcfg))


def _feats(seed=0, t=T):
    return np.random.default_rng(seed).standard_normal(
        (B, t, 8)).astype(np.float32)


def _jax_mask(key, jcfg, t=T):
    """JAX's dropout keep mask of ``am_forward(dropout_key=key)``, time
    major [T', B, H*dirs]."""
    shape = (jcfg.output_lens(t), B, jcfg.rnn.output_dim)
    return jax.random.bernoulli(key, 1.0 - jcfg.dropout, shape)


def _jax_forward_vjp(params, feats, jcfg, lens, key, cot):
    """JAX's logits and, with a cotangent, its parameter gradients
    (``jax.vjp``), under one jit: one compile per configuration."""
    def fwd(p):
        return jam.am_forward(p, jnp.asarray(feats), jcfg,
                              input_lens=None if lens is None
                              else jnp.asarray(lens), dropout_key=key)

    if cot is None:
        return np.asarray(jax.jit(fwd)(params)), None
    out, grads = jax.jit(lambda p, c: (fwd(p), jax.vjp(fwd, p)[1](c)[0]))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g)
                             for g in jax.tree_util.tree_leaves(grads)]


def _check_extra(name, dtype, lens, grads=True):
    jcfg, tcfg = _cfg(dtype, **EXTRAS[name])
    params = _jax_params(jcfg)
    feats = _feats(1)
    t_out = jcfg.output_lens(T)
    cot = (np.random.default_rng(1).standard_normal(
        (B, t_out, jcfg.num_targets)).astype(np.float32) if grads else None)
    key = jax.random.PRNGKey(6) if jcfg.dropout else None
    ref, ref_grads = _jax_forward_vjp(params, feats, jcfg, lens, key, cot)
    mask = (None if key is None else
            torch.as_tensor(np.array(_jax_mask(key, jcfg))))
    tparams = from_jax_params(params)
    leaves = [p.requires_grad_(grads) for p in tree_flatten(tparams)]
    logits = tam.am_forward(tree_unflatten(tparams, leaves),
                            torch.as_tensor(feats), tcfg,
                            input_lens=None if lens is None
                            else torch.as_tensor(lens), dropout_mask=mask)
    assert logits.dtype == torch.float32 and logits.shape == ref.shape
    assert logits.shape[1] == t_out
    assert np.abs(ref).max() > 0.1        # the weights move the logits
    np.testing.assert_allclose(logits.detach().numpy(), ref, rtol=0,
                               atol=TOL[dtype])
    if not grads:
        return
    logits.backward(torch.as_tensor(cot))
    assert len(ref_grads) == len(leaves)
    for p, r in zip(leaves, ref_grads):
        assert p.grad.dtype == torch.float32 and p.grad.shape == r.shape
        # floor 1: under seq-norm conv_b's exact gradient is 0 (the norm
        # subtracts the mean), both packages' are rounding noise ~1e-6
        # beside the other leaves' gradients of order 1
        np.testing.assert_allclose(
            p.grad.numpy(), r, rtol=0,
            atol=GRAD_TOL[dtype] * max(np.abs(r).max(), 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_am_forward_extras_match_jax(name, dtype):
    """The logits of a ragged batch and every parameter's gradient (the
    conv kernels, norm gains and biases and the front's weights included)
    under one shared cotangent, against JAX's forward and ``jax.vjp``."""
    _check_extra(name, dtype, LENS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ds2_stride1", "ds2_stride2",
                                  "ds2_no_norm", "splice"])
def test_am_forward_extras_without_lens_match_jax(name, dtype):
    """No lens: the conv front's unmasked branch (the moments over every
    frame, the biased variance) and splicing clamped at T-1."""
    _check_extra(name, dtype, None, grads=False)


def test_ds2_seq_norm_copies_the_jax_mask():
    """F1: on a strided layer the seq-norm masks the post-stride frames
    with the pre-stride lens.  The port copies it: on the ragged batch it
    equals JAX's forward, and there the copied mask matters (each short
    row differs from that row run alone at its own length, where no
    padding is read), so a fix in the port alone would fail the
    comparison above."""
    jcfg, tcfg = _cfg(**DS2)
    params = _jax_params(jcfg)
    feats = _feats(2)
    tp = from_jax_params(params)
    batch = tam.am_forward(tp, torch.as_tensor(feats), tcfg,
                           input_lens=torch.as_tensor(LENS))
    ref = np.asarray(jam.am_forward(params, jnp.asarray(feats), jcfg,
                                    input_lens=jnp.asarray(LENS)))
    np.testing.assert_allclose(batch.numpy(), ref, rtol=0, atol=TOL[
        "float32"])
    for row in (1, 2):
        n = int(LENS[row])
        alone = tam.am_forward(tp, torch.as_tensor(feats[row:row + 1, :n]),
                               tcfg, input_lens=torch.as_tensor(LENS[row:
                                                                     row + 1]))
        n_out = tcfg.output_lens(n)
        assert np.abs(alone[0].numpy()
                      - batch[row, :n_out].numpy()).max() > 1e-3
    # the full row reads no padding: the same alone as in the batch
    alone = tam.am_forward(tp, torch.as_tensor(feats[:1]), tcfg,
                           input_lens=torch.as_tensor(LENS[:1]))
    np.testing.assert_allclose(alone[0].numpy(), batch[0].numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", ["ds2", "ft_pnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_train_steps_match_jax(dtype, extra):
    """Three train steps with dropout 0.3 (momentum 0.9) from one JAX
    state, with JAX's masks (bernoulli(fold_in(PRNGKey(0), step)))
    supplied through the port's one draw function.  f32: another
    summation order; bf16: the first step's loss equals JAX's to f32
    rounding (the same bf16 sites, the divisor bf16(0.7) as JAX's weakly
    typed scalar), later steps drift as test_torch_train's bf16 steps do,
    by JAX's bf16 rounding of the recurrent cotangent, here on weights of
    stddev 0.3 (loss 2e-4, parameters 1e-3)."""
    kw = dict(dropout=0.3, **(DS2 if extra == "ds2" else
                              EXTRAS["ft_pnorm"]))
    jcfg, tcfg = _cfg(dtype, **kw)
    opts = dict(initial_learning_rate=1e-2, final_learning_rate=1e-3,
                num_steps=10, momentum=0.9)
    rng = np.random.default_rng(3)
    batch = {"feats": _feats(3, 20)[:B],
             "labels": rng.integers(1, 7, (B, 3)).astype(np.int32),
             "input_lens": np.array([20, 15, 12], np.int32),
             "label_lens": np.array([3, 2, 3], np.int32)}
    jstate = jtrain.init_train_state(_jax_params(jcfg))
    tstate = train_state_from_jax(jstate)
    jstep = jax.jit(jtrain.build_train_step(jcfg, jtrain.TrainOptions(**opts)))
    tstep = ttrain.build_train_step(tcfg, ttrain.TrainOptions(**opts))
    draws = []

    def jax_mask(step, keep, shape, device):
        draws.append(step)
        return torch.as_tensor(np.array(jax.random.bernoulli(
            jax.random.fold_in(jax.random.PRNGKey(0), step), keep, shape)))

    loss_rtol, param_atol = ((1e-5, 1e-5) if dtype == "float32"
                             else (2e-4, 1e-3))
    orig = ttrain.dropout_mask
    ttrain.dropout_mask = jax_mask
    try:
        for i in range(3):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            tstate, tm = tstep(tstate, batch)
            rtol = 1e-6 if i == 0 else loss_rtol
            np.testing.assert_allclose(float(tm["loss_total"]),
                                       float(jm["loss_total"]), rtol=rtol)
    finally:
        ttrain.dropout_mask = orig
    assert draws == [0, 1, 2]
    got = train_state_to_jax(tstate)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=param_atol)


def _stream_labels(rec, feats, chunk):
    for i in range(0, feats.shape[0], chunk):
        rec.process(feats[i:i + chunk])
    return rec.finalize()


def _greedy(logits):
    out, last = [], 0
    for lab in logits.argmax(-1).tolist():
        if lab != 0 and lab != last:
            out.append(int(lab))
        last = lab
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ft_front_stream_matches_jax_and_offline(dtype):
    """A uni LSTM with an FT front streamed in chunks of 5: with relu (the
    one front the JAX streaming recognizer applies) its labels equal the
    JAX streaming recognizer's and, as with every nonlinearity (pnorm
    group 2 here), the port's offline greedy labels; the batched
    recognizer's too."""
    from kaldi_ctc_tpu.decoding import streaming as jstreaming
    from kaldi_ctc_tpu_torch.decoding import streaming as tstreaming

    feats = (_feats(4, 30) * 2.0)
    for extra in (EXTRAS["ft_relu"], EXTRAS["ft_pnorm"]):
        jcfg, tcfg = _cfg(dtype, bidirectional=False, **extra)
        params = _jax_params(jcfg)
        tp = from_jax_params(params)
        for row in range(B):
            x = feats[row]
            got = _stream_labels(tstreaming.StreamingRecognizer(tp, tcfg),
                                 x, 5)
            offline = tam.am_forward(tp, torch.as_tensor(x[None]), tcfg)[0]
            assert got == _greedy(offline)
            if "front_nonlin" not in extra:       # relu
                want = _stream_labels(jstreaming.StreamingRecognizer(
                    params, jcfg), x, 5)
                assert got == want
            assert len(got) > 0
        rec = tstreaming.BatchStreamingRecognizer(tp, tcfg, B, 10)
        for i in range(0, 30, 10):
            rec.process(feats[:, i:i + 10], [10] * B)
        for row in range(B):
            offline = tam.am_forward(tp, torch.as_tensor(feats[row][None]),
                                     tcfg)[0]
            assert rec.finalize(row) == _greedy(offline)


@pytest.mark.parametrize("flags", [
    ["--conv-layers", "2", "--conv-channels", "4", "--conv-time-stride",
     "1"],
    ["--splice-left", "2", "--splice-right", "2"],
    ["--front-affine-dim", "6"],
], ids=["ds2", "splice", "ft"])
def test_init_model_extras_load_in_both_packages(tmp_path, flags):
    """``init_model`` with the extras' flags in both packages: each
    directory's config is the other's, and each package loads both
    directories (the same tree of leaves and shapes) and computes the
    same logits from them."""
    from kaldi_ctc_tpu.cli import init_model as jinit
    from kaldi_ctc_tpu.models.artifact import load_acoustic_model as jload
    from kaldi_ctc_tpu_torch.cli import init_model as tinit
    from kaldi_ctc_tpu_torch.models.artifact import (load_acoustic_model
                                                     as tload)

    argv = ["--input-dim", "8", "--num-targets", "7", "--hidden-dim", "8",
            "--num-layers", "2", "--param-stddev", "0.3"] + flags
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jinit.main(argv + ["--dir", dirs["jax"]])
    tinit.main(argv + ["--dir", dirs["port"]])
    cfgs = []
    for d in dirs.values():
        with open(f"{d}/model_config.json") as f:
            cfgs.append(json.load(f))
    assert cfgs[0] == cfgs[1]
    feats = _feats(5)
    for d in dirs.values():
        jp, jcfg, jpri, _ = jload(None, d)
        tp, tcfg, tpri, _ = tload(None, d)
        np.testing.assert_array_equal(jpri, tpri)
        assert [tuple(t.shape) for t in tree_flatten(tp)] == [
            a.shape for a in jax.tree_util.tree_leaves(jp)]
        ref = jam.am_forward(jp, jnp.asarray(feats), jcfg,
                             input_lens=jnp.asarray(LENS))
        got = tam.am_forward(tp, torch.as_tensor(feats), tcfg,
                             input_lens=torch.as_tensor(LENS))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL["float32"])


def test_ds2_with_splicing_or_ft_refused():
    """A DS2 front with splicing or the FT front, and splicing or a conv
    front in streaming, raise ValueError as in the JAX package."""
    from kaldi_ctc_tpu_torch.decoding import streaming as tstreaming

    for bad in (dict(conv_layers=1, splice_left=1),
                dict(conv_layers=1, front_affine_dim=4)):
        _, tcfg = _cfg(**bad)
        with pytest.raises(ValueError, match="DS2 conv front"):
            tam.init_am_params(tcfg)
    for extra, msg in ((dict(splice_left=1), "splicing"),
                       (dict(conv_layers=1), "conv front")):
        _, tcfg = _cfg(bidirectional=False, **extra)
        params = tam.init_am_params(tcfg)
        with pytest.raises(ValueError, match=msg):
            tstreaming.StreamingRecognizer(params, tcfg)
    _, tcfg = _cfg(front_affine_dim=4, front_nonlin="softplus")
    with pytest.raises(ValueError, match="front_nonlin"):
        tam.init_am_params(tcfg)
    # "batch" is deepspeech.pytorch's DS2 norm (tests/test_torch_ds2.py)
    tcfg = dataclasses.replace(_cfg()[1], conv_layers=1, conv_norm="layer")
    with pytest.raises(ValueError, match="conv_norm"):
        tam.init_am_params(tcfg)
