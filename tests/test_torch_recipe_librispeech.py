"""The port's librispeech_ctc recipe end to end on the CPU: its
``make_synth_data.py`` at a small size, then its ``run.sh`` on that
corpus in bash with ``device=cpu`` at its smallest knobs, which exits 0
and writes what its stages promise."""

import json
import os
import subprocess
import sys

from tests.test_torch_recipe_runs import RECIPES, run_recipe


def test_librispeech_recipe_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path / "ls"
    r = subprocess.run(
        [sys.executable, os.path.join(RECIPES, "librispeech_ctc",
                                      "make_synth_data.py"),
         "--out", str(out), "--train-utts", "6", "--test-utts", "2",
         "--vocab", "60", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    printed = json.loads(r.stdout.strip().splitlines()[-1])
    assert printed["num_targets"] == 21
    exp = tmp_path / "exp"
    run_recipe("librispeech_ctc", {
        "data": f"{out}/data", "ali": f"{out}/ali", "graph": f"{out}/graph",
        "exp": str(exp), "num_targets": "21", "epochs": "4",
        "hidden_dim": "8", "num_layers": "1", "num_archives": "2",
        "minibatch_size": "4", "lr_initial": "0.1", "lr_final": "0.1",
        "wfst_beam": "4", "lattice_beam": "1"})
    for name in ("egs/egs.scp", "egs/diagnostic.ark", "model_config.json",
                 "priors.npy", "hyps.test_clean.txt",
                 "lat.test_clean.ark.txt", "best_hyps.test_clean.txt",
                 "wer.test_clean.json", "accuracy.log"):
        assert (exp / name).exists(), name
    best = json.loads((exp / "wer.test_clean.json").read_text(
    ).strip().splitlines()[-1])
    assert "best_wer" in best
