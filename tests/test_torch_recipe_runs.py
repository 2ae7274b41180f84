"""One run of the port's tiny and hard ``run.sh`` in bash with
``device=cpu`` at their smallest knobs: each exits 0 and writes the files
its stages promise.  The hard recipe's device stages run under
``pyrun`` (devwatch, probing the CPU) and its host stages under
``hostrun``.  A high learning rate drives the small models to blank-heavy
posteriors within a few steps, so the lattices stay small."""

import json
import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(ROOT, "kaldi_ctc_tpu_torch", "recipes")
# the smallest knobs of each run.sh (the high learning rates drive the
# small models to blank-heavy posteriors within a few steps)
SMALL = {
    "tiny": {"epochs": "20"},
    "medium": {"vocab": "50", "train_utts": "4", "test_utts": "2",
               "hidden_dim": "8", "num_layers": "1", "epochs": "4",
               "minibatch_size": "4", "realign_epochs": "",
               "lr_initial": "0.1", "lr_final": "0.1", "wfst_beam": "4",
               "lattice_beam": "1"},
    "hard": {"vocab": "50", "train_utts": "6", "test_utts": "2",
             "hidden_dim": "8", "num_layers": "1", "epochs": "4",
             "minibatch_size": "4", "lr_initial": "0.1", "lr_final": "0.1",
             "wfst_beam": "4", "lattice_beam": "1"},
}


def run_recipe(name, env_extra, timeout=300):
    """``bash kaldi_ctc_tpu_torch/recipes/<name>/run.sh`` with
    ``device=cpu`` and ``env_extra`` → the completed process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(device="cpu", OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run(["bash", os.path.join(RECIPES, name, "run.sh")],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r


def _exist(base, names):
    missing = [n for n in names if not os.path.exists(os.path.join(base, n))]
    assert not missing, missing


@pytest.mark.parametrize("name", ["tiny", "hard"])
def test_run_sh_on_the_cpu(name, tmp_path):
    work = str(tmp_path / "work")
    r = run_recipe(name, {"work": work, **SMALL[name]})
    if name == "tiny":
        _exist(work, ["data/feats.ark", "data/ali.ark", "data/text",
                      "egs.ark", "egs.scp", "exp/model_config.json",
                      "exp/metrics.jsonl", "exp/priors.npy",
                      "exp/accuracy.log", "hyps.txt"])
        assert "tiny recipe done" in r.stdout
        assert '"label_error_rate"' in r.stdout
    else:
        _exist(work, ["data.json", "data/.done", "data/egs/.done",
                      "data/egs/egs.scp", "graph/TLG.fst",
                      "graph/TLG.fst.words.txt", "baseline.s0/decode.json",
                      "baseline.s0/hyps.test.txt",
                      "baseline.s0/lat.test.ark.txt",
                      "baseline.s0/wer_sweep.json",
                      "baseline.s0/best_hyps.test.txt"])
        with open(os.path.join(work, "baseline.s0", "wer_ci.json")) as f:
            ci = json.load(f)
        assert ci["n_utts"] == 2 and ci["missing_hyps"] == 0
