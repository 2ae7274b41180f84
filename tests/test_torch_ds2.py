"""DeepSpeech2 as deepspeech.pytorch builds it, on the port: the batch
norms' conv front, the summed directions, the normed bias-free output and
the running statistics, held to the benchmark's plain reference
(``asrbench/families/deepspeech2.py``) at a test size on the CPU; the
checkpoint and model-file round trip through ``init_model``,
``train_ctc``, ``copy_model`` and ``decode_ctc``; and the BLSTM plans at
the H100's numbers, where H = 1024 takes K2's and K3's wide route and
every other width keeps its route.

The size: 2 recurrent layers of 16 units, 2 convolutions of 4 channels
over 24 bins, 7 targets, a ragged batch of 3 (25, 14 and 7 frames),
weights from the family's seeded PyTorch-default init.  The reference is
f32 plain torch, the port runs its plain kernels on the CPU: the same
arithmetic in another order (the conv front through F.conv2d either way,
F.batch_norm against the reference's sums), so 2e-6 on logits of O(1)
(a few f32 ulps, compounded through 2 layers and 4 norms), and the
gradients to 1e-5 of the largest one's scale."""

import json
import os

import numpy as np
import pytest
import torch

from asrbench import reference as ref
from asrbench import weights
from asrbench.families import deepspeech2 as ds2
from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig, am_forward,
                                                 am_param_shapes,
                                                 init_norm_stats)
from kaldi_ctc_tpu_torch.ops import rnn_cuda
from kaldi_ctc_tpu_torch.params import tree_flatten, tree_unflatten
from kaldi_ctc_tpu_torch.training import (TrainOptions, build_train_step,
                                          init_train_state, make_eval_step)

LOGIT_TOL = 2e-6
GRAD_RTOL = 1e-5
STATS_TOL = 1e-6
CFG = {"family": "deepspeech2", "input_dim": 24, "num_targets": 7,
       "hidden_dim": 16, "num_layers": 2, "conv_channels": 4,
       "compute_dtype": "float32", "blank_prior": 9.0}
LENS = [25, 14, 7]
LABEL_LENS = [5, 3, 1]
SEED = 2147483701


def _am():
    return AmConfig.from_dict(ds2.model_file_config(CFG))


def _leaves(seed=SEED):
    return weights.make_params(CFG, seed, "cpu")


def _batch(t=25, seed=3):
    rng = np.random.default_rng(seed)
    feats = np.zeros((3, t, CFG["input_dim"]), np.float32)
    for i, n in enumerate(LENS):
        feats[i, :n] = rng.standard_normal((n, CFG["input_dim"]))
    labels = np.zeros((3, max(LABEL_LENS)), np.int32)
    for i, n in enumerate(LABEL_LENS):
        labels[i, :n] = rng.integers(1, CFG["num_targets"], n)
    return {"feats": feats, "labels": labels,
            "input_lens": np.asarray(LENS, np.int32),
            "label_lens": np.asarray(LABEL_LENS, np.int32)}


def _stats_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("mean", "var"):
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=0,
                                       atol=STATS_TOL)


def _logits_close(port, refl, lens):
    """port [B, T', A] against the reference's [T', B, A] on each row's
    valid frames."""
    out = ds2.output_lens(CFG, torch.as_tensor(lens))
    for i, n in enumerate(out.tolist()):
        np.testing.assert_allclose(port[i, :n].detach().numpy(),
                                   refl[:n, i].detach().numpy(), rtol=0,
                                   atol=LOGIT_TOL)


def test_the_family_names_the_ports_leaves():
    """The family's leaves are the port's tree in its flatten order: the
    harness's checkpoints and captures number them alike."""
    shapes = [tuple(s) for s in tree_flatten(am_param_shapes(_am()))]
    assert shapes == [s for _, s in ds2.param_shapes(CFG)]
    assert _am().norm_widths() == ds2.norm_widths(CFG) == [4, 4, 16, 16]
    assert "out_b" not in am_param_shapes(_am())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_equal_the_reference(train):
    """Training mode (the batch's statistics over the valid frames) and
    eval mode (running statistics that a step moved away from 0 and 1)."""
    leaves = _leaves()
    am = _am()
    params = tree_unflatten(am_param_shapes(am), leaves)
    tree = weights.unflatten(CFG, leaves)
    b = _batch()
    feats, lens = torch.as_tensor(b["feats"]), torch.as_tensor(LENS)
    stats = init_norm_stats(am)
    if not train:
        moved = []
        am_forward(params, feats, am, lens, stats=stats, new_stats=moved)
        stats = moved
    with ref.precision():
        want = ds2.forward(tree, feats, lens, CFG, stats=stats, train=train)
    got = am_forward(params, feats, am, lens, stats=stats,
                     new_stats=[] if train else None)
    _logits_close(got, want, LENS)


def test_train_step_equals_the_reference():
    """One build_train_step: the loss per frame, every leaf's gradient as
    the update applied it (±5 clip, lr(0)), and the running statistics
    after it, against the reference's step on the same batch."""
    leaves = _leaves()
    am = _am()
    opts = TrainOptions(initial_learning_rate=1e-3,
                        final_learning_rate=1e-4, num_steps=10)
    state = init_train_state(tree_unflatten(am_param_shapes(am), leaves),
                             opts, init_norm_stats(am))
    b = _batch()
    new, m = build_train_step(am, opts)(state, b)
    rows = [(b["feats"][i, :n], b["labels"][i, :k])
            for i, (n, k) in enumerate(zip(LENS, LABEL_LENS))]
    out = ref.sgd_steps(leaves, [rows], CFG, 1e-3, 1e-4, 10)
    assert float(m["loss_per_frame"]) == pytest.approx(
        out["loss_per_frame"][0], rel=1e-6)
    lr = float(m["lr"])
    got = [(a - c) / lr for a, c in zip(leaves, tree_flatten(new.params))]
    want = [(a - c) / lr for a, c in zip(leaves, out["params"][0])]
    scale = max(float(w.abs().max()) for w in want)
    for name, g, w in zip(weights.leaf_names(CFG), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    moved = []
    tree = weights.unflatten(CFG, leaves)
    with ref.precision():
        ds2.forward(tree, torch.as_tensor(b["feats"]), torch.as_tensor(LENS),
                    CFG, stats=init_norm_stats(am), update=moved)
    _stats_close(new.stats, moved)
    assert int(new.step) == 1


def test_padding_does_not_move_a_batch():
    """The batch padded to 25 and to 40 frames: the same logits on the
    valid frames and the same moved statistics, in training mode and in
    the eval step (deepspeech.pytorch's would move: its statistics count
    the pad frames)."""
    am = _am()
    params = tree_unflatten(am_param_shapes(am), _leaves())
    outs = []
    for t in (25, 40):
        b = _batch(t)
        moved = []
        lg = am_forward(params, torch.as_tensor(b["feats"]), am,
                        torch.as_tensor(LENS), stats=init_norm_stats(am),
                        new_stats=moved)
        ev = make_eval_step(am)(params, b, stats=moved)
        outs.append((lg, moved, ev))
    (a, sa, ea), (b_, sb, eb) = outs
    _logits_close(b_, a.transpose(0, 1), LENS)
    _stats_close(sa, sb)
    assert float(ea["loss_total"]) == pytest.approx(float(eb["loss_total"]),
                                                    rel=1e-6)


def test_a_batch_norm_model_needs_its_statistics():
    am = _am()
    params = tree_unflatten(am_param_shapes(am), _leaves())
    with pytest.raises(ValueError, match="running statistics"):
        am_forward(params, torch.zeros(1, 9, CFG["input_dim"]), am)


def test_lost_statistics_raise_but_at_step_0(tmp_path):
    """A checkpoint without running statistics restores fresh ones only
    at step 0 (initial weights from a tool that knows no batch norm); a
    later one, and a model file without them, raise."""
    from kaldi_ctc_tpu_torch.models.artifact import (load_norm_stats,
                                                     save_inference_artifact)
    from kaldi_ctc_tpu_torch.training.checkpoint import (restore_norm_stats,
                                                         restore_train_state,
                                                         save_checkpoint)
    am = _am()
    params = tree_unflatten(am_param_shapes(am), _leaves())
    ckpt = str(tmp_path / "checkpoints")
    for step in (0, 3):
        save_checkpoint(ckpt, step, init_train_state(params))
    like = init_train_state(params, stats=init_norm_stats(am))
    state, meta = restore_train_state(ckpt, like, 0)
    assert meta["step"] == 0
    _stats_close(state.stats, init_norm_stats(am))
    _stats_close(restore_norm_stats(ckpt, am, 0), init_norm_stats(am))
    with pytest.raises(ValueError, match="running statistics"):
        restore_train_state(ckpt, like, 3)
    with pytest.raises(ValueError, match="running statistics"):
        restore_norm_stats(ckpt, am, 3)
    model = str(tmp_path / "final.npz")
    save_inference_artifact(model, params, am)
    with pytest.raises(ValueError, match="running statistics"):
        load_norm_stats(am, model=model)


def test_other_models_write_their_files_as_before():
    """DS2 is a value of an existing field, so every other model's config
    file keeps the JAX package's keys, and DS2's round-trips; "batch"
    without the conv front is refused."""
    plain = AmConfig(input_dim=40, num_targets=72, conv_layers=2)
    assert set(plain.to_dict()) == set(_am().to_dict())
    assert not plain.deepspeech and plain.norm_widths() == []
    assert AmConfig.from_dict(_am().to_dict()) == _am()
    with pytest.raises(ValueError, match="conv front"):
        AmConfig(input_dim=40, num_targets=72, conv_norm="batch").rnn


def _write_data(d, n, seed):
    from kaldi_ctc_tpu_torch.utils import kaldi_io

    rng = np.random.default_rng(seed)
    with kaldi_io.MatrixWriter(f"ark:{d}/feats.ark") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/ali.ark") as aw:
        for i in range(n):
            frames = int(rng.integers(16, 30))
            fw[f"u{i:02d}"] = rng.standard_normal(
                (frames, CFG["input_dim"])).astype(np.float32)
            pdfs = rng.integers(0, CFG["num_targets"] - 1, 3)
            aw[f"u{i:02d}"] = np.repeat(pdfs, -(-frames // 3))[:frames] \
                .astype(np.int32)


def test_checkpoint_and_model_file_round_trip(tmp_path):
    """init_model writes fresh running statistics with the weights;
    train_ctc resumes from them, moves them and checkpoints them;
    copy_model puts them in the model file; decode_ctc from the directory
    and from the file gives the same labels and the same logits, which
    the trained statistics (not fresh ones) produce."""
    from kaldi_ctc_tpu_torch.cli import (copy_model, decode_ctc, init_model,
                                         nnet_compute, train_ctc)
    from kaldi_ctc_tpu_torch.models.artifact import (load_acoustic_model,
                                                     load_norm_stats)
    from kaldi_ctc_tpu_torch.utils import kaldi_io

    _write_data(tmp_path, 8, 5)
    exp = str(tmp_path / "exp")
    flags = ["--num-targets", "7", "--hidden-dim", "16", "--num-layers",
             "2", "--conv-layers", "2", "--conv-channels", "4",
             "--conv-norm", "batch"]
    init_model.main(["--dir", exp, "--input-dim", "24", "--seed", "1"]
                    + flags)
    fresh = load_norm_stats(_am(), dir=exp)
    assert all(bool((s["var"] == 1).all()) for s in fresh)
    train_ctc.main(["--feats", f"ark:{tmp_path}/feats.ark", "--ali",
                    f"ark:{tmp_path}/ali.ark", "--minibatch-size", "4",
                    "--epochs", "1", "--initial-learning-rate", "1e-2",
                    "--final-learning-rate", "1e-3", "--resume", "--dir",
                    exp, "--device", "cpu"] + flags)
    params, cfg, _, meta = load_acoustic_model(dir=exp)
    assert meta["step"] == 2 and cfg == _am()
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        timing = [r for r in map(json.loads, f) if r["event"] == "timing"]
    # 4 batch norms a step (2 convs, layer 2's input, the output), 2 steps
    assert sum(r["counters"].get("train.norm_layers", 0)
               for r in timing) == 8
    stats = load_norm_stats(cfg, dir=exp)
    assert not all(bool((s["var"] == 1).all()) for s in stats)
    model = str(tmp_path / "final.npz")
    copy_model.main(["--dir", exp, "--output", model])
    for s, t in zip(load_norm_stats(cfg, model=model), stats):
        assert torch.equal(s["mean"], t["mean"])
        assert torch.equal(s["var"], t["var"])
    hyps, logits = {}, {}
    for src in (["--dir", exp], ["--model", model]):
        out = str(tmp_path / f"hyp{len(hyps)}.txt")
        decode_ctc.main(["--feats", f"ark:{tmp_path}/feats.ark", "--method",
                         "greedy", "--device", "cpu", "--output", out] + src)
        with open(out) as f:
            hyps[src[0]] = f.read()
        ark = str(tmp_path / f"lg{len(logits)}.ark")
        nnet_compute.main(["--feats", f"ark:{tmp_path}/feats.ark", "--what",
                           "logits", "--output", f"ark:{ark}", "--device",
                           "cpu"] + src)
        logits[src[0]] = dict(kaldi_io.SequentialMatrixReader(f"ark:{ark}"))
    assert hyps["--dir"] == hyps["--model"]
    for k, v in logits["--dir"].items():
        np.testing.assert_array_equal(v, logits["--model"][k])
    with kaldi_io.SequentialMatrixReader(
            f"ark:{tmp_path}/feats.ark") as feats:
        key, x = next(iter(feats))
    lens = torch.as_tensor([x.shape[0]])
    want = am_forward(params, torch.as_tensor(x)[None], cfg, lens,
                      stats=stats)[0].numpy()
    np.testing.assert_allclose(logits["--dir"][key], want, rtol=0,
                               atol=1e-5)
    stale = am_forward(params, torch.as_tensor(x)[None], cfg, lens,
                       stats=fresh)[0].numpy()
    assert np.abs(stale - want).max() > 1e-3


@pytest.mark.parametrize("ref_w,hyp_w", [(9, 13), (13, 9), (9, 0)])
def test_batched_distances_equal_the_full_table(ref_w, hyp_w):
    """The training accuracy's distances (``batch_edit_distance``, a row
    at a time for the whole batch, over the side whose longest sequence
    is shorter) equal the full Levenshtein table's on ragged pairs, empty
    ones included, with hypotheses longer than the references (the
    untrained DS2 model's run to hundreds of labels), shorter, and all
    empty (a CTC model early in training emits blanks)."""
    from kaldi_ctc_tpu_torch.utils.edit_distance import (
        batch_edit_distance, edit_distance, edit_distance_stats)

    rng = np.random.default_rng(11)
    b = 40
    refs = rng.integers(1, 5, (b, ref_w))
    hyps = rng.integers(1, 5, (b, max(hyp_w, 1)))
    rl, hl = rng.integers(0, ref_w + 1, b), rng.integers(0, hyp_w + 1, b)
    got, lens = batch_edit_distance(refs, rl, hyps, hl)
    for i in range(b):
        r, h = list(refs[i, :rl[i]]), list(hyps[i, :hl[i]])
        want = (edit_distance_stats(r, h)["distance"] if r and h
                else len(r) + len(h))
        assert got[i] == want == edit_distance(r, h), i
    assert lens.tolist() == rl.tolist()


H100_SMS, H100_OPTIN = 132, 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_route_where_w_h_fits_no_block(dtype):
    """At H = 1024 neither K2's nor K3's cluster or cooperative kernel
    fits an H100 (W_h of both directions, 32 MiB, is more than the
    shared memory of all its SMs): both plans take the wide route, 128
    blocks of 512 threads on tiles of 64 rows (their shared memory is the
    sources' own, ``bilstm_wide_fwd_smem`` and ``bilstm_wide_bwd_smem``)."""
    fwd = rnn_cuda.bilstm_fwd_plan(64, 1024, dtype, H100_SMS, H100_OPTIN)
    bwd = rnn_cuda.bilstm_bwd_plan(64, 1024, dtype, H100_SMS, H100_OPTIN)
    assert fwd == rnn_cuda.FwdChainPlan("wide", 0, 64, 0, 0, 0)
    assert bwd == rnn_cuda.BwdChainPlan("wide", 0, 0, 0, 64, 0)
    assert not rnn_cuda._bilstm_coop_fits(64, 1024, H100_SMS, H100_OPTIN)
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.bilstm_fwd_plan(64, 1100, dtype, H100_SMS, H100_OPTIN)


@pytest.mark.parametrize("h,b,fwd,bwd", [
    (320, 48, (16, 16, 161344), (16, 16, 181824)),
    (320, 64, (16, 22, 183448), (16, 22, 212248)),
    (128, 48, (4, 4, 76816), (4, 4, 85008)),
    (128, 64, (4, 6, 82456), (4, 6, 95768))])
def test_other_widths_keep_their_routes(h, b, fwd, bwd):
    """The benchmark's widths (H = 320 at B = 48, the 3x128's H = 128)
    and B = 64 keep the cluster routes and launch shapes they had before
    the wide route (f32)."""
    f = rnn_cuda.bilstm_fwd_plan(b, h, torch.float32, H100_SMS, H100_OPTIN)
    k = rnn_cuda.bilstm_bwd_plan(b, h, torch.float32, H100_SMS, H100_OPTIN)
    assert f == rnn_cuda.FwdChainPlan("cluster", *fwd, 0, 0)
    assert k == rnn_cuda.BwdChainPlan("cluster", 0, 0, *bwd)
    assert f == rnn_cuda.fwd_chain_plan(b, 0, h, torch.float32, 2, H100_SMS,
                                        H100_OPTIN)


@pytest.mark.parametrize("h,b", [(512, 48), (700, 3), (950, 3)])
def test_cooperative_routes_stay_where_they_fit(h, b):
    """Between the cluster routes and the wide one the cooperative
    kernels keep the layers they take."""
    assert rnn_cuda.bilstm_fwd_plan(b, h, torch.float32, H100_SMS,
                                    H100_OPTIN).route == "cooperative"
    assert rnn_cuda.bilstm_bwd_plan(b, h, torch.float32, H100_SMS,
                                    H100_OPTIN).route == "cooperative"


def test_wide_layouts_hold_w_h():
    """The wide route's weight layouts, read back as the kernels index
    them: the forward's column 4 jj + q of block blk at (lane l, term j)
    is W_h[l + 32 j, q H + 16 blk + jj]; the backward's row c of block
    blk at kk is W_h[16 blk + kk, c]; zeros past H."""
    h = 40
    w_f, w_b = torch.randn(h, 4 * h), torch.randn(h, 4 * h)
    wp = rnn_cuda._wide_weights(w_f, w_b)
    # bilstm_wide_bwd_cols(40): 4H = 160 in 8 slices of two 16-column chunks
    wq = rnn_cuda._wide_rows(w_f, w_b, 256)
    assert wp.shape == (2, 3, 32, 2, 64)
    assert wq.shape == (2, 3, 256, 16)
    for d, w in enumerate((w_f, w_b)):
        for blk in range(3):
            for jj in range(16):
                u = 16 * blk + jj
                for q in range(4):
                    col = wp[d, blk, :, :, 4 * jj + q]     # [lane, term]
                    for k in range(32 * 2):
                        want = w[k, q * h + u] if k < h and u < h else 0.0
                        assert float(col[k % 32, k // 32]) == float(want)
                row = wq[d, blk, :, jj]
                want = (w[u] if u < h else torch.zeros(4 * h))
                assert torch.equal(row[:4 * h], want)
                assert not row[4 * h:].any()
