"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole, since the port's name starts with the JAX
package's), and, in the reference and the inputs it is judged on,
nothing of the program either."""

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "asrbench")
JAX = {"jax", "jaxlib", "flax", "kaldi_ctc_tpu"}
# the reference, and the makers of everything it is handed
INDEPENDENT = ("reference", "weights", "traffic", "batches", "flops",
               "checks", "featgen")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    return sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                            recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    assert _sources()
    for path in _sources():
        bad = _top_imports(path) & JAX
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for name in INDEPENDENT:
        path = os.path.join(BENCH, name + ".py")
        assert "kaldi_ctc_tpu_torch" not in _top_imports(path), path
    code = ("import sys; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import asrbench.{n}\n" for n in INDEPENDENT)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('kaldi_ctc_tpu_torch', 'kaldi_ctc_tpu', 'jax')]\n"
              "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_refuses_a_process_that_holds_jax():
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    saved = dict(sys.modules)
    try:
        sys.modules["kaldi_ctc_tpu_torch_x"] = object()
        assert "kaldi_ctc_tpu_torch_x" not in run.forbidden_modules()
        sys.modules["kaldi_ctc_tpu.cli"] = object()
        sys.modules["jax.numpy"] = object()
        assert run.forbidden_modules() == ["jax.numpy", "kaldi_ctc_tpu.cli"]
    finally:
        for k in ("kaldi_ctc_tpu_torch_x", "kaldi_ctc_tpu.cli", "jax.numpy"):
            if k not in saved:
                sys.modules.pop(k, None)


def test_run_without_the_program_fails_with_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and asrbench/: the run
    exits non-zero and prints no result line."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "asrbench/run.py", "--workload",
                        "blstm5x320.train", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
