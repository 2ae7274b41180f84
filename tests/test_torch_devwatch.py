"""The port's devwatch launcher, the five cases of tests/test_devwatch.py:
pass-through, exit-code propagation, exit 66 for a wedged device init,
exit 65 at once for a probe that fails (the default ``cuda`` probe on a
machine without a card), and exit 2 without a module; and the medium
recipe, whose ``pyrun`` runs each device stage under devwatch with the
stage's ``--device``, in bash with ``device=cpu`` at its smallest
knobs."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs devwatch with torch.cuda.init blocked forever: the probe of the
# default device hangs inside CUDA initialisation, as a wedged driver does
WEDGE = ("import sys, threading, torch\n"
         "torch.cuda.init = lambda: threading.Event().wait()\n"
         "from kaldi_ctc_tpu_torch.cli import devwatch\n"
         "sys.exit(devwatch.main(sys.argv[1:]))\n")


def _run(args, env_extra=None, timeout=120, code=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    head = (["-c", code] if code
            else ["-m", "kaldi_ctc_tpu_torch.cli.devwatch"])
    return subprocess.run([sys.executable] + head + args,
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_passthrough_stdout_and_exit_zero():
    r = _run(["kaldi_ctc_tpu_torch.cli.decode_ctc", "--device", "cpu",
              "--help"])
    assert r.returncode == 0, r.stderr
    assert "--dir" in r.stdout and "--device" in r.stdout


def test_propagates_failure_exit_code():
    r = _run(["kaldi_ctc_tpu_torch.cli.compute_prob", "--device=cpu",
              "--dir", "/nonexistent-kctpu-test-dir"])
    assert r.returncode not in (0, 65, 66)


def test_wedged_device_init_exits_66():
    r = _run(["kaldi_ctc_tpu_torch.cli.model_info", "--help"],
             env_extra={"KCTPU_DEVICE_TIMEOUT": "1"}, timeout=55,
             code=WEDGE)
    assert r.returncode == 66, r.stderr
    assert "wedged" in r.stderr and "cuda" in r.stderr
    assert "--dir" not in r.stdout


def test_deterministic_probe_failure_exits_65_fast():
    # no card here: the default cuda probe fails at once, is NOT taken
    # for a wedge, and the CLI does not run on another device
    r = _run(["kaldi_ctc_tpu_torch.cli.model_info", "--help"],
             env_extra={"KCTPU_DEVICE_TIMEOUT": "60"},
             timeout=55)  # must come back well before the 60s "wedge"
    assert r.returncode == 65, r.stderr
    assert "not a wedge" in r.stderr
    assert "--dir" not in r.stdout


def test_usage_error_without_module():
    r = _run([])
    assert r.returncode == 2


def test_medium_recipe_runs_its_device_stages_under_devwatch(tmp_path):
    from tests.test_torch_recipe_runs import SMALL, run_recipe

    work = tmp_path / "work"
    run_recipe("medium", {"work": str(work), **SMALL["medium"]})
    for name in ("data.json", "train_prob.json", "decode.json", "wer.json",
                 "wer_mbr.json", "graph/TLG.fst", "exp/hyps.test.txt",
                 "exp/lat.test.ark.txt", "exp/best_hyps.test.txt",
                 "exp/mbr_hyps.test.txt", "exp/accuracy.log"):
        assert (work / name).exists(), name
    assert "wer_mbr" in (work / "wer_mbr.json").read_text()
