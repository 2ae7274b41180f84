"""Multi-process training on the CPU (gloo) held to the JAX package's
one-device step on the global batch: a 2-rank step with momentum,
NG-SGD and dropout, a 2x2 data x model step, the eval step's sums,
``launch --num-processes 2 -- train_ctc`` against the JAX step on the
global batches SPMD forms (metrics.jsonl counts included), realignment's
gathered priors, layer growth on every rank, ``dryrun_multichip(4)`` and
the NCCL device check.

Each multi-process case spawns fresh processes on a free port
(``parallel.dryrun.spawn``, or the launcher), with a time limit on the
whole run, so that a hung rendezvous fails one test.  JAX is imported
inside the tests only: the spawned ranks import this module and must not
load it."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_train_cli import (DIM, HIDDEN, LAYERS, TARGETS,
                                        _final_leaves, _records, _write_set)

# f32 on the CPU: the ranks' sums added in another order than XLA's one
# sum over the global batch, compounded over two SGD steps
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
# NG-SGD: the preconditioners' eigh (XLA's against LAPACK's) on the same
# rows, as tests/test_torch_ng.py's f32 train steps
NG_PARAM_ATOL = 5e-5
SPAWN_TIMEOUT = 120

CFG = dict(input_dim=8, num_targets=6, hidden_dim=16, num_layers=2)
B, T, LMAX = 8, 16, 3


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    # several ranks, and several test workers, share the CPU
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _global_batch(seed=4):
    rng = np.random.default_rng(seed)
    return {
        "feats": rng.standard_normal((B, T, CFG["input_dim"])).astype(
            np.float32),
        "labels": rng.integers(1, CFG["num_targets"], (B, LMAX)).astype(
            np.int32),
        "input_lens": np.array([16, 14, 12, 16, 9, 16, 11, 13], np.int32),
        "label_lens": np.array([3, 2, 3, 1, 3, 2, 3, 3], np.int32)}


def _step_rank(payload):
    """One rank: the step(s) on this rank's rows of the global batch from
    the JAX package's initial parameters → per-step metrics, the whole
    parameters and the NG states."""
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.parallel import make_mesh
    from kaldi_ctc_tpu_torch.params import from_jax_params, to_jax_params
    from kaldi_ctc_tpu_torch.training import train as ttrain

    mesh = make_mesh(data=payload["data"], model=payload["model"])
    cfg = AmConfig(**payload["cfg"])
    opts = ttrain.TrainOptions(**payload["opts"])
    masks = payload["masks"]
    if masks is not None:
        def jax_masks(step, keep, shape, device):
            assert tuple(shape) == masks[step].shape
            return torch.as_tensor(masks[step], device=device)
        ttrain.dropout_mask = jax_masks
    state = ttrain.init_train_state(from_jax_params(payload["params"]), opts)
    state = ttrain.shard_train_state(state, cfg, mesh)
    rows = B // mesh.data
    mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    batch = {k: v[mine] for k, v in payload["batch"].items()}
    step = ttrain.make_train_step(cfg, opts, mesh)
    metrics = []
    for _ in range(payload["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in (
            "loss_total", "loss_per_frame", "num_frames", "grad_norm")})
    out = {"metrics": metrics, "params": to_jax_params(
        ttrain.whole_params(state.params, cfg, mesh)),
        "hyp_ids": m["hyp_ids"].numpy(), "hyp_lens": m["hyp_lens"].numpy()}
    if state.ng:
        out["ng_d"] = {k: v["out"].d.numpy() for k, v in state.ng.items()}
    eval_out = ttrain.make_eval_step(cfg, mesh)(state.params, batch)
    out["eval"] = (float(eval_out["loss_total"]),
                   int(eval_out["num_frames"]))
    return out


def _jax_reference(kind, steps):
    import jax
    import jax.numpy as jnp

    from kaldi_ctc_tpu.models import AmConfig, init_am_params
    from kaldi_ctc_tpu.training import train as jtrain

    extra = {"dropout": 0.3} if kind == "dropout" else {}
    jcfg = AmConfig(**CFG, **extra)
    opts = dict(initial_learning_rate=1e-2, final_learning_rate=1e-3,
                num_steps=10, momentum=0.9)
    if kind == "natural":
        # ranks below the dims: at the default ranks the first call's
        # eigenbasis is degenerate, and LAPACK's and XLA's eigh pick
        # other bases (tests/test_torch_ng.py's options)
        opts.update(affine_type="natural", ng_rank_in=4, ng_rank_out=3)
    params = init_am_params(jax.random.PRNGKey(4), jcfg)
    masks = None
    if kind == "dropout":
        shape = (T, B, 2 * CFG["hidden_dim"])
        masks = {s: np.array(jax.random.bernoulli(
            jax.random.fold_in(jax.random.PRNGKey(0), s), 0.7, shape))
            for s in range(steps)}
    batch = _global_batch()
    jopts = jtrain.TrainOptions(**opts)
    state = jtrain.init_train_state(params, jopts)
    step = jax.jit(jtrain.build_train_step(jcfg, jopts))
    metrics = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append(m)
    ev = jtrain.make_eval_step(jcfg)(state.params, {
        k: jnp.asarray(v) for k, v in batch.items()})
    payload = {"cfg": dict(CFG, **extra), "opts": opts,
               "params": jax.tree_util.tree_map(np.asarray, params),
               "batch": batch, "masks": masks, "steps": steps}
    return payload, state, metrics, ev


@pytest.mark.parametrize("kind,data,model", [
    ("momentum", 2, 1), ("natural", 2, 1), ("dropout", 2, 1),
    ("momentum", 2, 2), ("natural", 2, 2)])
def test_step_equals_jax_one_device(kind, data, model):
    """n ranks (2 data, or 2 data x 2 model with the split leaves stored
    as slices) take two steps on their rows; each rank's loss, frames and
    grad norm equal the JAX one-device step's on the global batch, the
    whole parameters too (every rank's bit for bit equal to rank 0's),
    and with NG-SGD the preconditioners' states."""
    import jax

    from kaldi_ctc_tpu_torch.parallel.dryrun import spawn

    payload, jstate, jmetrics, _ = _jax_reference(kind, steps=2)
    payload.update(data=data, model=model)
    ranks = spawn(f"{__name__}:_step_rank", data * model, payload,
                  timeout=SPAWN_TIMEOUT)
    atol = NG_PARAM_ATOL if kind == "natural" else PARAM_ATOL
    want = jax.tree_util.tree_leaves(jstate.params)
    for r, got in enumerate(ranks):
        for g, w in zip(got["metrics"], jmetrics):
            np.testing.assert_allclose(g["loss_total"],
                                       float(w["loss_total"]),
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["loss_per_frame"],
                                       float(w["loss_per_frame"]),
                                       rtol=LOSS_RTOL)
            assert g["num_frames"] == int(w["num_frames"])
            np.testing.assert_allclose(g["grad_norm"],
                                       float(w["grad_norm"]), rtol=GRAD_RTOL)
        leaves = jax.tree_util.tree_leaves(got["params"])
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
        for a, b in zip(leaves, jax.tree_util.tree_leaves(
                ranks[0]["params"])):
            np.testing.assert_array_equal(a, b)
        if kind == "natural":
            d = np.asarray(jstate.ng["out"]["out"].d)
            np.testing.assert_allclose(got["ng_d"]["out"], d, rtol=0,
                                       atol=1e-4 * np.abs(d).max())
            np.testing.assert_array_equal(got["ng_d"]["out"],
                                          ranks[0]["ng_d"]["out"])
    # each rank greedy-decodes its own rows
    rows = B // data
    assert ranks[0]["hyp_ids"].shape[0] == rows


def test_eval_step_sums_equal_jax():
    """A 2-rank eval step's loss_total and num_frames are the global
    batch's, as the JAX eval step computes them on one device."""
    from kaldi_ctc_tpu_torch.parallel.dryrun import spawn

    payload, _, _, jev = _jax_reference("momentum", steps=1)
    payload.update(data=2, model=1)
    ranks = spawn(f"{__name__}:_step_rank", 2, payload,
                  timeout=SPAWN_TIMEOUT)
    for got in ranks:
        loss, frames = got["eval"]
        np.testing.assert_allclose(loss, float(jev["loss_total"]),
                                   rtol=LOSS_RTOL)
        assert frames == int(jev["num_frames"])
    assert ranks[0]["eval"] == ranks[1]["eval"]


def _grow_rank(payload):
    from kaldi_ctc_tpu_torch.models import AmConfig, grow_rnn_layer
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.parallel.dryrun import _same_on_every_rank
    from kaldi_ctc_tpu_torch.cli.train_ctc import initial_params

    cfg = AmConfig(**dict(CFG, num_layers=1))
    params = initial_params(cfg, 0, "cpu")
    new, cfg = grow_rnn_layer(params, cfg, torch.Generator().manual_seed(
        payload["seed"] + 100 + cfg.num_layers - 1))
    values = np.concatenate([x.numpy().ravel() for x in tree_flatten(new)])
    _same_on_every_rank(values.astype(np.float64), "grown parameters")
    return cfg.num_layers


def test_growth_same_on_every_rank():
    """train_ctc's initial draw and layer growth, seeded alike on every
    rank, leave every rank with the same parameters."""
    from kaldi_ctc_tpu_torch.parallel.dryrun import spawn

    assert spawn(f"{__name__}:_grow_rank", 2, {"seed": 7},
                 timeout=SPAWN_TIMEOUT) == [2, 2]


# --- launch -- train_ctc ----------------------------------------------------

@pytest.fixture(scope="module")
def launch_data(tmp_path_factory):
    """Train and valid sets and the JAX package's initial checkpoint of
    test_torch_train_cli's 2x24 BLSTM."""
    import jax

    from kaldi_ctc_tpu.models import AmConfig, init_am_params
    from kaldi_ctc_tpu.training import init_train_state
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("launch")
    _write_set(d, "train", 16, 0)
    _write_set(d, "valid", 8, 1)
    cfg = AmConfig(input_dim=DIM, num_targets=TARGETS, hidden_dim=HIDDEN,
                   num_layers=LAYERS)
    state = init_train_state(init_am_params(jax.random.PRNGKey(3), cfg))
    save_checkpoint(str(d / "init" / "checkpoints"), 0, state,
                    extra={"epoch": 0, "num_layers": LAYERS})
    return d


def _launch(d, exp, epochs, extra=()):
    shutil.copytree(str(d / "init"), str(exp))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in sys.path if p))
    proc = subprocess.run(
        [sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.launch",
         "--num-processes", "2", "--",
         sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.train_ctc",
         "--feats", f"ark:{d}/train_feats.ark",
         "--ali", f"ark:{d}/train_ali.ark", "--num-targets", str(TARGETS),
         "--hidden-dim", str(HIDDEN), "--num-layers", str(LAYERS),
         "--epochs", str(epochs), "--minibatch-size", "8",
         "--initial-learning-rate", "1e-2", "--final-learning-rate",
         "1e-3", "--momentum", "0.9", "--resume", "--dir", str(exp),
         "--device", "cpu"] + list(extra),
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def _spmd_batches(d, name, seed, epoch, n=2, host_mb=4):
    """The global batches JAX's SPMD forms: each process's EgsPipeline
    batch over its host_shard at the global fixed shape, concatenated in
    process order."""
    from kaldi_ctc_tpu.data import EgsPipeline, load_examples
    from kaldi_ctc_tpu.data.egs import example_ok

    exs = [e for e in load_examples(f"ark:{d}/{name}_feats.ark",
                                    f"ark:{d}/{name}_ali.ark")
           if example_ok(e, 2000)]
    exs = exs[:(len(exs) // n) * n]
    fixed = (max(e.num_frames for e in exs), max(e.num_labels for e in exs))
    pipes = [EgsPipeline(exs[i::n], minibatch_size=host_mb, seed=seed,
                         fixed_shape=fixed) for i in range(n)]
    out = []
    for parts in zip(*(p.epoch(epoch) for p in pipes)):
        for p in parts:
            p.pop("keys")
        out.append({k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})
    return out, [e for i in range(n) for e in exs[i::n]]


def _jax_train(d, epochs, until_epoch=None):
    """The JAX step over the SPMD global batches from the initial
    checkpoint → (state, per-step (metrics, batch), per-epoch batches)."""
    import jax
    import jax.numpy as jnp

    from kaldi_ctc_tpu.models import AmConfig, init_am_params
    from kaldi_ctc_tpu.training import train as jtrain

    cfg = AmConfig(input_dim=DIM, num_targets=TARGETS, hidden_dim=HIDDEN,
                   num_layers=LAYERS)
    opts = jtrain.TrainOptions(initial_learning_rate=1e-2,
                               final_learning_rate=1e-3,
                               num_steps=2 * epochs, momentum=0.9)
    state = jtrain.init_train_state(init_am_params(jax.random.PRNGKey(3),
                                                   cfg))
    step = jax.jit(jtrain.build_train_step(cfg, opts))
    steps = []
    for epoch in range(epochs if until_epoch is None else until_epoch):
        batches, _ = _spmd_batches(d, "train", 0, epoch)
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            steps.append((m, b))
    return cfg, state, steps


def test_launch_train_ctc_equals_jax_spmd(launch_data, tmp_path):
    """launch --num-processes 2 -- train_ctc --device cpu (gloo): the
    final checkpoint, written by rank 0 alone, equals the JAX step run on
    the global batches SPMD forms; metrics.jsonl holds one record a step
    with the global batch's frames, loss and grad norm, rank 0's own rows'
    accuracy, the per-epoch Accuracy over both ranks' rows, and the cv
    pass over the sharded valid set at step 10."""
    import jax
    import jax.numpy as jnp

    from kaldi_ctc_tpu.training import train as jtrain
    from kaldi_ctc_tpu.utils.edit_distance import batch_edit_distance

    d, exp, epochs = launch_data, tmp_path / "exp", 5
    err = _launch(d, exp, epochs, [
        "--valid-feats", f"ark:{d}/valid_feats.ark", "--valid-ali",
        f"ark:{d}/valid_ali.ark", "--cv-period", "1"])
    assert "done (secondary process): 10 steps" in err
    cfg, jstate, steps = _jax_train(d, epochs)
    recs = _records(str(exp))
    train = [r for r in recs if r["event"] == "train_step"]
    assert [r["step"] for r in train] == list(range(1, 2 * epochs + 1))
    for r, (m, b) in zip(train, steps):
        assert r["num_frames"] == int(b["input_lens"].sum())
        np.testing.assert_allclose(r["loss_per_frame"],
                                   float(m["loss_per_frame"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], float(m["grad_norm"]),
                                   rtol=GRAD_RTOL)
        dist, ref = batch_edit_distance(
            b["labels"][:4], b["label_lens"][:4],
            np.asarray(m["hyp_ids"])[:4], np.asarray(m["hyp_lens"])[:4])
        assert r["accuracy"] == pytest.approx(
            1.0 - dist.sum() / max(ref.sum(), 1), abs=1e-12)
    accs = [r for r in recs if r["event"] == "accuracy"]
    assert len(accs) == epochs
    for e, r in enumerate(accs):
        tot = np.zeros(2)
        for m, b in steps[2 * e:2 * e + 2]:
            dist, ref = batch_edit_distance(
                b["labels"], b["label_lens"], np.asarray(m["hyp_ids"]),
                np.asarray(m["hyp_lens"]))
            tot += (dist.sum(), ref.sum())
        assert r["accuracy"] == pytest.approx(1 - tot[0] / tot[1],
                                              abs=1e-12)
    valid = [r for r in recs if r["event"] == "valid"]
    assert [r["step"] for r in valid] == [10]
    vbatches, _ = _spmd_batches(d, "valid", 1000, 0)
    ev = jtrain.make_eval_step(cfg)
    loss = frames = 0.0
    for b in vbatches:
        out = ev(jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
        loss += float(out["loss_total"])
        frames += int(out["num_frames"])
    np.testing.assert_allclose(valid[0]["loss_per_frame"], loss / frames,
                               rtol=LOSS_RTOL)
    leaves, meta = _final_leaves(str(exp))
    assert meta["step"] == 2 * epochs and meta["extra"]["final"]
    want = jax.tree_util.tree_leaves(jstate)
    n_params = meta["num_param_leaves"]
    assert len(leaves) == len(want)
    for i, (a, b) in enumerate(zip(leaves, want)):
        scale = 1.0 if i < n_params else max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL * scale)


def test_launch_realign_gathers_priors(launch_data, tmp_path):
    """--realign-epochs 1 under two ranks: each rank aligns its shard,
    the shards are cut to the smaller kept size and the occupancy counts
    summed over both, so priors.npy (rank 0's) holds the global priors,
    as the JAX realignment computes them from each shard with the
    parameters after epoch 0; each rank persists its own relabeled set."""
    from kaldi_ctc_tpu.training.realign import realign_examples

    d, exp = launch_data, tmp_path / "exp"
    _launch(d, exp, 2, ["--realign-epochs", "1"])
    cfg, jstate, _ = _jax_train(d, 2, until_epoch=1)
    _, exs = _spmd_batches(d, "train", 0, 0)
    shards = [exs[:8], exs[8:]]
    kept, counts = [], []
    for shard in shards:
        k, _, stats = realign_examples(shard, jstate.params, cfg)
        kept.append(k)
        counts.append(stats["counts_by_key"])
    n = min(len(k) for k in kept)
    total = sum(counts[i][e.key] for i in range(2) for e in kept[i][:n])
    want = np.maximum((total / total.sum()).astype(np.float32), 1e-15)
    np.testing.assert_allclose(np.load(exp / "priors.npy"), want, rtol=1e-6)
    labels = []
    for i in range(2):
        with open(exp / f"realign_labels.host{i}.json") as f:
            saved = json.load(f)
        assert saved["epoch"] == 1 and len(saved["labels"]) == n
        assert set(saved["labels"]) == {e.key for e in kept[i][:n]}
        labels.append(set(saved["labels"]))
    assert not labels[0] & labels[1]
    realign = [r for r in _records(str(exp)) if r["event"] == "realign"]
    assert len(realign) == 1


def test_dryrun_multichip_four_ranks():
    """dryrun_multichip(4): a 2x2 mesh's flagship and DS2 steps, the
    realignment gathers and the scoring forward, every rank's values
    finite and equal to rank 0's."""
    from kaldi_ctc_tpu_torch.parallel.dryrun import dryrun_multichip

    ranks = dryrun_multichip(4, timeout=SPAWN_TIMEOUT)
    assert len(ranks) == 4
    assert all(np.isfinite(r["scores_sum"]) for r in ranks)
    assert ranks[0]["counts"].sum() > 0


def test_nccl_device_check_raises(monkeypatch):
    """More ranks on this machine than cards raise, naming both counts,
    before any rendezvous: nothing falls back to gloo or to the CPU."""
    from kaldi_ctc_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 processes on this machine "
                       "but 1 CUDA device"):
        distributed.init_distributed("localhost:1", 2, 1, device="cuda")
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_device("cuda", 5, 4) == torch.device("cuda", 1)
    assert distributed.rank_device("cpu", 5, 8) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 CUDA device"):
        distributed.rank_device("cuda", 0, 1)


def test_mesh_layout_and_sharding_rules():
    """make_mesh's size checks (the JAX package's) and param_sharding's
    rule: with tensor_parallel the last axis of w_x, w_h, b, out_w and
    out_b, every other leaf replicated."""
    from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, am_param_shapes
    from kaldi_ctc_tpu_torch.parallel import (data_sharding, make_mesh,
                                              param_sharding, replicated)

    with pytest.raises(ValueError, match="not divisible by model=2"):
        make_mesh(model=2, devices=["cpu"])
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        make_mesh(data=2, devices=["cpu"])
    with pytest.raises(ValueError, match="a process drives one device"):
        make_mesh(devices=["cpu", "cpu"])
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    assert data_sharding(mesh) == 0 and replicated(mesh) is None
    for extra in ({"front_affine_dim": 4},
                  {"conv_layers": 1, "conv_channels": 2}):
        shapes = am_param_shapes(AmConfig(**CFG, **extra))
        assert all(v is None for v in _leaves(param_sharding(mesh, shapes)))
        tp = param_sharding(mesh, shapes, tensor_parallel=True)
        assert tp["out_w"] == 1 and tp["out_b"] == 0
        assert tp["rnn"][0]["dirs"][1] == {"w_x": 1, "w_h": 1, "b": 0}
        if "conv" in tp:
            assert tp["conv"][0] == {k: None for k in tp["conv"][0]}
        else:
            assert tp["front_w"] is None and tp["front_b"] is None


def _leaves(tree):
    """The leaves of a tree of dicts and lists, None included."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]

