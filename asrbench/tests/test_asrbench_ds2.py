"""The deepspeech2 family and its cell ``ds2blstm5x1024.train``: the
cell's command, leaves and operation counts as recorded when the family
was written (``data/ds2_recorded.json``), the reference's losses at a
test size, the cell found and validated, and a run of a test-size cell
of the family on the CPU that is ``correct`` and fails under the
half-batch fault."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from asrbench import cells, flops, reference as ref, traffic as tr, weights
from asrbench.drivers import train as drv
from asrbench.families import deepspeech2 as ds2

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "asrbench")
DATA = os.path.join(BENCH, "tests", "data")
CELL = "ds2blstm5x1024.train"


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


RECORDED = _load(DATA, "ds2_recorded.json")


def _cell():
    return cells.find_cell(cells.load_benchmark(ROOT), ROOT, CELL)


def test_the_cell_is_found_and_valid():
    """The cell reads its configuration, traffic and limits by name, on
    one chip, with the two end-to-end metrics and all six per-layer
    ones, and its kernels' layers are the four the readers charge."""
    assert cells.validate(cells.load_benchmark(ROOT), ROOT) == []
    cell = _cell()
    assert cell.chips == 1 and cell.config["family"] == "deepspeech2"
    assert cell.traffic["kind"] == "train"
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "train.step_interval_p50_ms", "train.mfu_pct",
        "rnn.roofline_pct.train", "device.idle_pct.train",
        "front.roofline_pct.train", "norm.roofline_pct.train"]
    assert set(cell.limits) == {"batches_differ", "loss1_rel", "loss_rel",
                                "grad1_rel", "change3_rel"}
    layers = cells.kernel_layers()
    assert set(layers) == {"recurrent stack", "conv front", "batch norm"}
    # no pattern of the new layers charges a recurrent kernel or a GEMM
    for name in ("bilstm_wide_chain_fwd_kernel", "bilstm_xp_chain_kernel",
                 "void_cutlass::Kernel2_cutlass_80_simt_sgemm_256x128_8x4",
                 "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"):
        for layer in ("conv front", "batch norm"):
            assert not any(p in name for p in layers[layer]), (name, layer)


def test_command_as_recorded():
    cmd = drv._command(_cell(), RECORDED["command_seed"], "/RUN", "cuda")
    assert [w.replace(sys.executable, "PY").replace(ROOT, "ROOT")
            for w in cmd] == RECORDED["command"]


def test_leaves_and_flops_as_recorded():
    """The full-size configuration's leaves (86.6 M parameters) and its
    operation counts; the test size's drawn leaves (sums of squares and
    dots with a ramp, equal to f32 rounding across CPUs)."""
    cfg = _cell().config
    shapes = weights.param_shapes(cfg)
    assert len(shapes) == RECORDED["num_leaves"]
    assert sum(int(torch.Size(s).numel()) for _, s in shapes) == \
        RECORDED["num_params"]
    assert [flops.forward_flops_per_frame(cfg),
            flops.train_flops_per_frame(cfg),
            flops.recurrent_work(cfg, [1500, 701, 1], True),
            flops.recurrent_work(cfg, [1500], False),
            ds2.layer_work(cfg, "conv front", [1500, 701, 1], True),
            ds2.layer_work(cfg, "batch norm", [1500, 701, 1], True)] == \
        RECORDED["flops"]
    tiny = _load(DATA, "tiny_ds2bn.json")
    leaves = weights.make_params(tiny, RECORDED["command_seed"], "cpu")
    for name, t, (r_name, r_shape, sq, dot) in zip(
            weights.leaf_names(tiny), leaves, RECORDED["tiny_leaves"]):
        assert (name, list(t.shape)) == (r_name, r_shape)
        x = t.double().flatten()
        ramp = torch.linspace(-1.0, 1.0, x.numel(), dtype=torch.float64)
        assert float((x * x).sum()) == pytest.approx(sq, rel=1e-6)
        assert float((x * ramp).sum()) == pytest.approx(
            dot, rel=1e-5, abs=1e-6 * sq ** 0.5)


def test_counts_by_hand():
    """The stride and lengths, and the forward's operations a frame from
    the widths: conv 1 at 81 bins x 32 channels x 41 x 11 taps, conv 2
    at 41 x 32 x 32 x 21 x 11, half the frames; 5 summed BLSTM layers
    (1,312 inputs, then 1,024) and the output at the logit rate."""
    cfg = _cell().config
    assert ds2.time_stride(cfg) == 2
    assert ds2.output_lens(cfg, torch.tensor([1500, 701, 1])).tolist() == \
        [750, 351, 1]
    conv = (81 * 2 * 41 * 11 * 32 + 41 * 2 * 21 * 11 * 32 * 32) / 2
    h = 1024
    rnn = 2 * (2 * 1312 * 4 * h + 2 * h * 4 * h) + 4 * 2 * (
        2 * h * 4 * h + 2 * h * 4 * h)
    assert ds2.forward_flops_per_frame(cfg) == pytest.approx(
        conv + (rnn + 2 * h * 29) / 2)


def test_reference_steps_as_recorded():
    """The reference's three losses per frame at the test size, on the
    rules' batches (equal to f32 rounding across CPUs)."""
    cfg = _load(DATA, "tiny_ds2bn.json")
    t = _load(DATA, "tiny_train_ds2.json")
    cell = cells.Cell("t", 1, "tiny_ds2bn", cfg, "tiny_train_ds2", t, "",
                      [], [], {}, BENCH)
    seed = RECORDED["command_seed"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pool = tr.train_pool(t, seed, "train")
        batches = drv.step_rows(cell, seed, pool,
                                drv.schedule(cell, seed, pool, 3))
        out = ref.sgd_steps(weights.make_params(cfg, seed, "cpu"), batches,
                            cfg, 5e-4, 1e-5, drv.num_steps(cell, pool))
    finally:
        torch.set_num_threads(n)
    assert out["loss_per_frame"] == pytest.approx(RECORDED["tiny_losses"],
                                                  rel=1e-6)


def _tiny_run(tmp_path, fault):
    """A copy of the benchmark with a test-size cell of the family (its
    configuration, traffic and limits as files, entries in
    BENCHMARK.json); one run of it on the CPU → the result line."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "asrbench"
    shutil.copy(os.path.join(DATA, "tiny_ds2bn.json"),
                b / "configs" / "tiny_ds2bn.json")
    shutil.copy(os.path.join(DATA, "tiny_train_ds2.json"),
                b / "traffic" / "tiny_train_ds2.json")
    shutil.copy(b / "limits" / f"{CELL}.json",
                b / "limits" / "tiny_ds2bn.train.json")
    bench = cells.load_benchmark(ROOT)
    bench["configs"].append({"name": "tiny_ds2bn", "source": "a test",
                             "file": "asrbench/configs/tiny_ds2bn.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_ds2bn.train",
                               "config": "tiny_ds2bn",
                               "traffic": "tiny_train_ds2", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny_ds2bn.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        "from asrbench import cells, run\n"
        "root = sys.argv[1]\n"
        "cell = cells.find_cell(cells.load_benchmark(root), root,"
        " 'tiny_ds2bn.train')\n"
        "out = cells.driver_for(cell).run(cell, 20263, 2.0, False,"
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
def test_a_test_size_run_is_correct_and_the_fault_is_not(tmp_path, fault):
    line = _tiny_run(tmp_path, fault)
    assert line["attempted"] > 0
    assert line["correct"] == (fault is None), line["checks"]
