"""Model families: the 'google' family gives the benchmark's two cells
what the harness gave them before families were files (values recorded
from the harness of that commit), a family's tree is the one the
program's checkpoints and model files hold, and a family added to a copy
of the benchmark as files only runs a whole training run on the CPU."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from asrbench import cells, flops, reference as ref, traffic as tr, weights
from asrbench.drivers import train as drv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "asrbench")
DATA = os.path.join(BENCH, "tests", "data")
FAMILY = os.path.join(DATA, "families", "ds2front.py")


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


RECORDED = _load(DATA, "google_recorded.json")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ds2front(monkeypatch):
    """The test family, as ``families.of`` would find it in a copy of
    the benchmark that holds its file."""
    spec = importlib.util.spec_from_file_location(
        "asrbench.families.ds2front", FAMILY)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "asrbench.families.ds2front", mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["blstm5x320.train", "bigru5x320.train"])
def test_command_as_recorded(name):
    cell = cells.find_cell(cells.load_benchmark(ROOT), ROOT, name)
    cmd = drv._command(cell, RECORDED["command_seed"], "/RUN", "cuda")
    assert [w.replace(sys.executable, "PY").replace(ROOT, "ROOT")
            for w in cmd] == RECORDED["commands"][name]


@pytest.mark.parametrize("family", ["google", "ds2front"])
def test_the_harness_starts_the_program_before_torch(family):
    """What a training run works out before it starts the program (the
    command, the schedule, the warm-up steps) loads no torch: the
    program's own import of it is the one a run's set-up pays."""
    cfg = ("asrbench/configs/blstm5x320.json" if family == "google"
           else "asrbench/tests/data/tiny_ds2.json")
    code = (
        "import importlib.util, json, sys\n"
        "sys.path.insert(0, %r)\n"
        "spec = importlib.util.spec_from_file_location("
        "'asrbench.families.ds2front', %r)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['asrbench.families.ds2front'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "from asrbench import cells, traffic as tr\n"
        "from asrbench.drivers import train as drv\n"
        "cfg = json.load(open(%r))\n"
        "t = json.load(open(%r))\n"
        "cell = cells.Cell('c', 1, 'c', cfg, 't', t, 'p', [], [], {}, '')\n"
        "pool = tr.train_pool(t, 3, 'train')\n"
        "drv.warm_steps(cell, 3, pool)\n"
        "drv._command(cell, 3, '/RUN', 'cuda')\n"
        "print('torch' in sys.modules)\n") % (
            ROOT, FAMILY, os.path.join(ROOT, cfg),
            os.path.join(DATA, "tiny_train_fs1.json"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["False"]


@pytest.mark.parametrize("config", ["blstm5x320", "bigru5x320"])
def test_leaves_and_flops_as_recorded(config):
    """Each leaf's name and shape, and its sum of squares and its dot
    with a ramp (equal to f32 rounding: another CPU's random normals may
    round the last bit otherwise)."""
    cfg = _load(BENCH, "configs", config + ".json")
    leaves = weights.make_params(cfg, RECORDED["command_seed"], "cpu")
    names = weights.leaf_names(cfg)
    assert len(leaves) == len(RECORDED["leaves"][config])
    for name, t, (r_name, r_shape, sq, dot) in zip(
            names, leaves, RECORDED["leaves"][config]):
        assert (name, list(t.shape)) == (r_name, r_shape)
        x = t.double().flatten()
        ramp = torch.linspace(-1.0, 1.0, x.numel(), dtype=torch.float64)
        assert float((x * x).sum()) == pytest.approx(sq, rel=1e-6)
        assert float((x * ramp).sum()) == pytest.approx(
            dot, rel=1e-5, abs=1e-6 * sq ** 0.5)
    again = weights.flatten(weights.unflatten(cfg, leaves))
    assert len(again) == len(leaves)
    assert all(a is b for a, b in zip(again, leaves))
    assert [flops.forward_flops_per_frame(cfg),
            flops.train_flops_per_frame(cfg),
            flops.recurrent_work(cfg, [700, 233, 1], True),
            flops.recurrent_work(cfg, [700], False)] == \
        RECORDED["flops"][config]


@pytest.mark.parametrize("config", ["tiny_lstm", "tiny_gru"])
def test_reference_steps_as_recorded(config, one_thread):
    """The reference's three losses per frame at a test size, on the
    cell's rules (equal to f32 rounding across CPUs; the card runs
    compare the cells' own digit for digit)."""
    cfg = _load(DATA, config + ".json")
    t = _load(DATA, "tiny_train.json")
    cell = cells.Cell("t", 1, config, cfg, "tiny_train", t, "", [], [], {},
                      BENCH)
    seed = RECORDED["command_seed"]
    f = t["train_flags"]
    pool = tr.train_pool(t, seed, "train")
    batches = drv.step_rows(cell, seed, pool, drv.schedule(cell, seed, pool,
                                                           3))
    out = ref.sgd_steps(weights.make_params(cfg, seed, "cpu"), batches, cfg,
                        float(f["initial-learning-rate"]),
                        float(f["final-learning-rate"]),
                        drv.num_steps(cell, pool))
    assert out["loss_per_frame"] == pytest.approx(
        RECORDED["losses"][config], rel=1e-6)


@pytest.mark.parametrize("config", [
    os.path.join(BENCH, "configs", "blstm5x320.json"),
    os.path.join(BENCH, "configs", "bigru5x320.json"),
    os.path.join(DATA, "tiny_ds2.json")])
def test_checkpoint_loads_with_the_ports_shapes(config, ds2front, tmp_path):
    """The hook's checkpoint of a family's leaves restores into the
    port's own template of the model the family's model-file config
    names, leaf for leaf."""
    from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig,
                                                     am_param_shapes,
                                                     init_am_params)
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import init_train_state
    from kaldi_ctc_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)

    from asrbench import families

    cfg = _load(config)
    am = AmConfig.from_dict(families.of(cfg).model_file_config(cfg))
    shapes = [tuple(s) for s in tree_flatten(am_param_shapes(am))]
    assert shapes == [tuple(s) for _, s in weights.param_shapes(cfg)]
    leaves = weights.make_params(cfg, 5, "cpu")
    save_checkpoint(str(tmp_path), 0,
                    init_train_state(weights.unflatten(cfg, leaves)))
    like = init_train_state(init_am_params(am))
    state, _ = restore_checkpoint(str(tmp_path), like)
    got = tree_flatten(state.params)
    assert [tuple(t.shape) for t in got] == shapes
    assert all(torch.equal(a, b) for a, b in zip(got, leaves))


def test_ds2front_reference_front(ds2front):
    """The test family's lengths, stride and counts by hand: 40 bins
    become 20, then 10, times 4 channels; 9 frames become 5."""
    cfg = _load(DATA, "tiny_ds2.json")
    assert ds2front.time_stride(cfg) == 2
    assert ds2front._stack_cfg(cfg)["input_dim"] == 40
    assert ds2front.output_lens(cfg, torch.tensor([9, 10])).tolist() == [5, 5]
    tree = weights.unflatten(cfg, weights.make_params(cfg, 3, "cpu"))
    lg = ref.logits(tree, torch.randn(2, 9, 40), torch.tensor([9, 4]), cfg)
    assert lg.shape == (5, 2, 72)
    # conv 1: 20 bins x 2*11*41*1*4 a frame pair; conv 2: 10 x 2*11*21*4*4
    # a frame pair; the stack and output a frame pair
    stack = ds2front.google.forward_flops_per_frame(
        ds2front._stack_cfg(cfg))
    assert ds2front.forward_flops_per_frame(cfg) == pytest.approx(
        (20 * 2 * 11 * 41 * 4 + 10 * 2 * 11 * 21 * 4 * 4 + stack) / 2)
    assert flops.recurrent_work(cfg, [10, 3], True) == \
        ds2front.google.recurrent_work(ds2front._stack_cfg(cfg), [5, 2], True)


def test_a_configuration_names_a_family_with_a_file(tmp_path):
    bench = cells.load_benchmark(ROOT)
    cfg = _load(BENCH, "configs", "blstm5x320.json")
    (tmp_path / "asrbench" / "configs").mkdir(parents=True)
    shutil.copy(os.path.join(BENCH, "configs", "bigru5x320.json"),
                tmp_path / "asrbench" / "configs")
    for family, ok in (("google", True), ("ds2front", False)):
        (tmp_path / "asrbench" / "configs" / "blstm5x320.json").write_text(
            json.dumps(dict(cfg, family=family)))
        faults = cells.validate(bench, str(tmp_path))
        assert (faults == []) == ok, faults
        assert ok or faults == ["config blstm5x320: no family 'ds2front'"]


def _family_run(tmp_path, fault):
    """A copy of the benchmark with a configuration of the test family,
    a traffic mix and a limits file added as files, and entries added to
    BENCHMARK.json; one run of the new cell from the copy, the look for
    a card skipped, on the CPU → the result line."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "asrbench"
    shutil.copy(FAMILY, b / "families" / "ds2front.py")
    shutil.copy(os.path.join(DATA, "tiny_ds2.json"),
                b / "configs" / "tiny_ds2.json")
    shutil.copy(os.path.join(DATA, "tiny_train_fs1.json"),
                b / "traffic" / "tiny_train_fs1.json")
    shutil.copy(b / "limits" / "blstm5x320.train.json",
                b / "limits" / "tiny_ds2.train.json")
    bench = cells.load_benchmark(ROOT)
    bench["configs"].append({"name": "tiny_ds2", "source": "a test",
                             "file": "asrbench/configs/tiny_ds2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_ds2.train", "config": "tiny_ds2",
                               "traffic": "tiny_train_fs1", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "blstm5x320.train" in m.get("workloads", []):
            m["workloads"].append("tiny_ds2.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        "from asrbench import cells, run\n"
        "root = sys.argv[1]\n"
        "cell = cells.find_cell(cells.load_benchmark(root), root,"
        " 'tiny_ds2.train')\n"
        "out = cells.driver_for(cell).run(cell, 20261, 2.0, False,"
        " time.monotonic(), device='cpu', fault=sys.argv[2] or None)\n"
        "print(json.dumps(run.result_line(cell, out, False, 1)))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", code, str(root), fault or ""],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_a_family_added_as_files_only_runs(tmp_path, fault):
    line = _family_run(tmp_path, fault)
    assert line["attempted"] > 0
    assert line["correct"] == (fault is None), line["checks"]
