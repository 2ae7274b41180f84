"""The port's train_ctc against the JAX package's, from one initial
checkpoint: the per-step records of metrics.jsonl, the cv records, the
Accuracy lines and the final checkpoint's leaves; --lr-warmup-steps,
--nonfinite-action, --resume mid-epoch and layer-wise growth; the flags
that raise before any file is written; and the one-process stand-in of
``parallel``.

``init_model``'s draws differ between the packages (ROADMAP §3), so each
run starts from a checkpoint the JAX package wrote (``--resume``).  The
model is tiny: a 2x24 BLSTM over 8-dim features, 6 targets, 16 training
utterances in minibatches of 8."""

import json
import logging
import os
import shutil

import numpy as np
import pytest

# f32 on the CPU: the same sums in another order (XLA's fused step against
# torch's eager ops), compounded over a dozen SGD steps with momentum
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LR_RTOL = 1e-6
# the final checkpoint: parameters to 1e-5 absolute; the momentum leaves
# hold sums of gradients (up to ~50 here), so 1e-5 of their largest value
LEAF_ATOL = 1e-5
HIDDEN, LAYERS, DIM, TARGETS = 24, 2, 8, 6


def _write_set(d, name, n, seed, inf_utt=None):
    from kaldi_ctc_tpu.utils import kaldi_io

    rng = np.random.default_rng(seed)
    with kaldi_io.MatrixWriter(f"ark:{d}/{name}_feats.ark") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/{name}_ali.ark") as aw:
        for i in range(n):
            k = int(rng.integers(2, 5))
            pdfs = rng.integers(0, TARGETS - 1, k)
            feats = rng.standard_normal((6 * k, DIM)).astype(np.float32) * .1
            for j, p in enumerate(pdfs):
                feats[6 * j:6 * (j + 1), (p + 1) % DIM] += 2.0
            if i == inf_utt:
                feats[3, 2] = np.inf
            fw[f"{name}{i:02d}"] = feats
            aw[f"{name}{i:02d}"] = np.repeat(pdfs, 6).astype(np.int32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Train, valid and poisoned-train sets, and the JAX package's initial
    checkpoints of the 2-layer model and of a 1-layer one (growth)."""
    import jax

    from kaldi_ctc_tpu.models import AmConfig, init_am_params
    from kaldi_ctc_tpu.training import init_train_state
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("train")
    _write_set(d, "train", 16, 0)
    _write_set(d, "valid", 8, 1)
    _write_set(d, "inf", 16, 0, inf_utt=5)
    for layers in (1, LAYERS):
        cfg = AmConfig(input_dim=DIM, num_targets=TARGETS, hidden_dim=HIDDEN,
                       num_layers=layers)
        state = init_train_state(init_am_params(jax.random.PRNGKey(3), cfg))
        save_checkpoint(str(d / f"init{layers}" / "checkpoints"), 0, state,
                        extra={"epoch": 0, "num_layers": layers})
    return d


def _argv(d, name="train", epochs=3, extra=()):
    return ["--feats", f"ark:{d}/{name}_feats.ark", "--ali",
            f"ark:{d}/{name}_ali.ark", "--num-targets", str(TARGETS),
            "--hidden-dim", str(HIDDEN), "--num-layers", str(LAYERS),
            "--epochs", str(epochs), "--minibatch-size", "8",
            "--initial-learning-rate", "1e-2", "--final-learning-rate",
            "1e-3", "--resume"] + list(extra)


def _train(data, tmp_path, argv, init=LAYERS):
    """Both packages' train_ctc on copies of the initial checkpoint →
    {pkg: experiment dir}."""
    from kaldi_ctc_tpu.cli import train_ctc as jax_cli
    from kaldi_ctc_tpu_torch.cli import train_ctc as port_cli

    dirs = {}
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        exp = str(tmp_path / pkg)
        shutil.copytree(str(data / f"init{init}"), exp)
        cli.main(argv + ["--dir", exp] + dev)
        dirs[pkg] = exp
    return dirs


def _records(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("t")
    return recs


def _assert_records_equal(got, want):
    assert [(r["event"], r.get("step")) for r in got] == \
        [(r["event"], r.get("step")) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k == "loss_per_frame":
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL)
            elif k == "grad_norm":
                np.testing.assert_allclose(g[k], v, rtol=GRAD_RTOL)
            elif k == "lr":
                np.testing.assert_allclose(g[k], v, rtol=LR_RTOL)
            else:
                assert g[k] == v, (k, g, w)


def _final_leaves(exp):
    ckpt = os.path.join(exp, "checkpoints")
    step = max(int(n.split("_")[1]) for n in os.listdir(ckpt)
               if n.startswith("step_") and not n.endswith(".tmp"))
    with np.load(os.path.join(ckpt, f"step_{step}", "arrays.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    with open(os.path.join(ckpt, f"step_{step}", "meta.json")) as f:
        return leaves, json.load(f)


@pytest.mark.parametrize("extra", [
    [],
    ["--momentum", "0.9", "--lr-warmup-steps", "3", "--valid-feats",
     "ark:{d}/valid_feats.ark", "--valid-ali", "ark:{d}/valid_ali.ark",
     "--cv-period", "1", "--checkpoint-period", "4"],
], ids=["sgd", "momentum_warmup_cv"])
def test_train_ctc_equal_jax(data, tmp_path, extra, capfd):
    extra = [x.format(d=data) for x in extra]
    epochs = 6 if extra else 3
    dirs = _train(data, tmp_path, _argv(data, epochs=epochs, extra=extra))
    want, got = _records(dirs["jax"]), _records(dirs["port"])
    _assert_records_equal(got, want)
    steps = [r for r in got if r["event"] == "train_step"]
    assert len(steps) == 2 * epochs
    assert sum(r["event"] == "accuracy" for r in got) == epochs
    if extra:
        assert [r["step"] for r in got if r["event"] == "valid"] == [10]
        # the warmup ramp: lr(step) = lr_i * decay * (step + 1) / 3
        assert steps[0]["lr"] < steps[1]["lr"] < steps[2]["lr"]
    lines = [line for line in capfd.readouterr().err.splitlines()
             if "Accuracy = " in line]
    assert len(lines) == 2 * epochs
    assert lines[:epochs] == lines[epochs:]
    (jl, jm), (pl, pm) = _final_leaves(dirs["jax"]), _final_leaves(
        dirs["port"])
    assert pm == jm and len(pl) == len(jl)
    n_params = jm["num_param_leaves"]
    for i, (a, b) in enumerate(zip(pl, jl)):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = 1.0 if i < n_params else max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=LEAF_ATOL * scale)
    with open(os.path.join(dirs["port"], "model_config.json")) as f, \
            open(os.path.join(dirs["jax"], "model_config.json")) as g:
        assert json.load(f) == json.load(g)


def test_train_ctc_nonfinite_skip_and_abort(data, tmp_path):
    """One utterance with an inf feature: skip logs the same
    skipped_nonfinite steps in both packages; abort raises in both."""
    dirs = _train(data, tmp_path / "skip", _argv(
        data, name="inf", extra=["--nonfinite-action", "skip"]))
    want, got = _records(dirs["jax"]), _records(dirs["port"])
    _assert_records_equal(got, want)
    skipped = [r["step"] for r in got if r["event"] == "skipped_nonfinite"]
    assert len(skipped) == 3      # the poisoned utterance, once an epoch
    from kaldi_ctc_tpu.cli import train_ctc as jax_cli
    from kaldi_ctc_tpu_torch.cli import train_ctc as port_cli
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        exp = str(tmp_path / f"abort_{pkg}")
        shutil.copytree(str(data / f"init{LAYERS}"), exp)
        with pytest.raises(RuntimeError, match="non-finite"):
            cli.main(_argv(data, name="inf") + ["--dir", exp] + dev)


def test_train_ctc_resume_mid_epoch(data, tmp_path):
    """A run cut after its mid-epoch checkpoint (step 3: epoch 1, batch 1)
    and resumed gives the uninterrupted run's records in both packages."""
    argv = _argv(data, epochs=3, extra=["--checkpoint-period", "3"])
    full = _train(data, tmp_path / "full", argv)
    cut = _train(data, tmp_path / "cut", argv)
    for pkg, exp in cut.items():
        ckpt = os.path.join(exp, "checkpoints")
        for n in os.listdir(ckpt):
            if int(n.split("_")[1]) > 3:
                shutil.rmtree(os.path.join(ckpt, n))
        with open(os.path.join(ckpt, "step_3", "meta.json")) as f:
            assert json.load(f)["extra"]["epoch_step"] == 1
    from kaldi_ctc_tpu.cli import train_ctc as jax_cli
    from kaldi_ctc_tpu_torch.cli import train_ctc as port_cli
    # metrics.jsonl is appended to on --resume: the resumed run's records
    # follow the first run's
    before = {pkg: len(_records(exp)) for pkg, exp in cut.items()}
    jax_cli.main(argv + ["--dir", cut["jax"]])
    port_cli.main(argv + ["--dir", cut["port"], "--device", "cpu"])
    for pkg in ("jax", "port"):
        resumed = [r for r in _records(cut[pkg])[before[pkg]:]
                   if r["event"] == "train_step"]
        whole = [r for r in _records(full[pkg])
                 if r["event"] == "train_step" and r["step"] > 3]
        assert [r["step"] for r in resumed] == [4, 5, 6]
        _assert_records_equal(resumed, whole)
    _assert_records_equal(_records(cut["port"]), _records(cut["jax"]))


def test_train_ctc_growth(data, tmp_path, caplog):
    """--start-layers 1 --num-layers 3 --add-layers-period 3: both
    packages grow at steps 3 and 6, checkpoint the grown model with a zero
    velocity, and agree up to the first growth (the new layer's draws
    differ between the packages)."""
    argv = _argv(data, epochs=4, extra=[
        "--start-layers", "1", "--add-layers-period", "3",
        "--checkpoint-period", "3", "--momentum", "0.9"])
    argv[argv.index("--num-layers") + 1] = "3"
    with caplog.at_level(logging.INFO):
        dirs = _train(data, tmp_path, argv, init=1)
    grew = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("grew RNN stack")]
    assert grew == ["grew RNN stack to 2 layers at step 3",
                    "grew RNN stack to 3 layers at step 6"] * 2
    want, got = _records(dirs["jax"]), _records(dirs["port"])
    _assert_records_equal([r for r in got if r["step"] <= 3],
                          [r for r in want if r["step"] <= 3])
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import init_train_state
    from kaldi_ctc_tpu_torch.training.checkpoint import restore_checkpoint
    for pkg, exp in dirs.items():
        with open(os.path.join(exp, "model_config.json")) as f:
            assert json.load(f)["num_layers"] == 3
        _, meta = _final_leaves(exp)
        assert meta["extra"]["num_layers"] == 3
        cfg = AmConfig(input_dim=DIM, num_targets=TARGETS, hidden_dim=HIDDEN,
                       num_layers=2)
        from kaldi_ctc_tpu_torch.models import init_am_params
        like = init_train_state(init_am_params(cfg))
        state, meta = restore_checkpoint(os.path.join(exp, "checkpoints"),
                                         like, step=3)
        assert meta["extra"]["num_layers"] == 2
        assert all(float(v.abs().max()) == 0.0
                   for v in tree_flatten(state.velocity))


@pytest.mark.parametrize("flags,item", [
    (["--realign-epochs", "1"], "item 13"),
    (["--affine-type", "natural"], "item 13"),
    (["--dropout", "0.1"], "item 12"),
    (["--splice-left", "2"], "item 12"),
    (["--front-affine-dim", "16"], "item 12"),
    (["--conv-layers", "1"], "item 12"),
])
def test_train_ctc_unported_flags_raise_before_writing(data, tmp_path, flags,
                                                        item):
    from kaldi_ctc_tpu_torch.cli import train_ctc

    exp = tmp_path / "exp"
    with pytest.raises(NotImplementedError, match=item):
        train_ctc.main(_argv(data) + flags + ["--dir", str(exp),
                                              "--device", "cpu"])
    assert not exp.exists()


def test_train_ctc_profile_trace_on_cpu(data, tmp_path):
    """--profile 1 and --profile-dir: the torch.profiler trace is written
    and closed."""
    from kaldi_ctc_tpu_torch.cli import train_ctc

    trace = tmp_path / "trace"
    exp = tmp_path / "exp"
    shutil.copytree(str(data / f"init{LAYERS}"), str(exp))
    train_ctc.main(_argv(data, epochs=1) + [
        "--dir", str(exp), "--device", "cpu", "--profile", "1",
        "--profile-dir", str(trace)])
    assert any(n.endswith(".json") or n.endswith(".json.gz")
               for n in os.listdir(trace))


@pytest.mark.parametrize("env,item", [
    ({"WORLD_SIZE": "2"}, "item 14"),
    ({"NUM_PROCESSES": "4"}, "item 14"),
    ({"COORDINATOR_ADDRESS": "localhost:1234"}, "item 14"),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1234"}, "item 14"),
    ({"WORLD_SIZE": "1", "NUM_PROCESSES": "1"}, None),
])
def test_init_distributed_stand_in(monkeypatch, env, item):
    from kaldi_ctc_tpu_torch import parallel
    from kaldi_ctc_tpu_torch.parallel import distributed

    for name in ("WORLD_SIZE", "NUM_PROCESSES", "COORDINATOR_ADDRESS",
                 "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if item:
        with pytest.raises(NotImplementedError, match=item):
            distributed.init_distributed()
        return
    distributed.init_distributed()
    assert distributed.is_primary() and distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.host_shard([1, 2, 3]) == [1, 2, 3]
    dev = parallel.make_mesh("cpu")
    batch = parallel.shard_batch({"x": np.arange(3, dtype=np.int32)}, dev)
    assert batch["x"].device == dev and batch["x"].tolist() == [0, 1, 2]
