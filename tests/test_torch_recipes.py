"""The port's recipes (``kaldi_ctc_tpu_torch/recipes/``) against the
frozen JAX ones (``recipes/``): each ``make_data.py`` writes the same
corpus byte for byte; the medium chain (egs → train from one JAX-written
initial checkpoint → compute_prob → make-tlg → WFST lattice decode →
score_lattices → MBR) gives equal outputs through both packages, or, where
a near-tie flips a word, best-path costs within DECODE_RTOL; generate_report
(the tiny recipe's stage 5) writes the same accuracy.log and report.tex;
``wer_ci.py`` and ``summarize_ablation.py`` print the same lines."""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "kaldi_ctc_tpu_torch", "recipes")
JAX = os.path.join(ROOT, "recipes")
# tests/test_torch_recipe.py's rule for decode parity: a hypothesis that
# differs is a near-tie the forward's tolerance flips when the best-path
# costs agree this well
DECODE_RTOL = 1e-3


def _script(path, argv, monkeypatch):
    """Run a recipe script as ``__main__`` with ``argv`` → its stdout."""
    monkeypatch.setattr(sys, "argv", [path] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
    return buf.getvalue()


def _same_tree(a, b):
    """Every file under ``a`` equals its twin under ``b`` byte for byte."""
    names = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


@pytest.mark.parametrize("recipe,argv", [
    ("tiny", ["--num-utts", "10", "--seed", "3"]),
    ("medium", ["--vocab", "200", "--train-utts", "6", "--test-utts", "3",
                "--seed", "1"]),
    ("hard", ["--vocab", "200", "--train-utts", "6", "--test-utts", "3",
              "--coart", "3"]),
])
def test_make_data_byte_identical(recipe, argv, tmp_path, monkeypatch):
    flag = "--dir" if recipe == "tiny" else "--out"
    out = {}
    for tag, base in (("jax", JAX), ("port", PORT)):
        out[tag] = _script(os.path.join(base, recipe, "make_data.py"),
                           argv + [flag, str(tmp_path / tag)], monkeypatch)
    assert out["port"].replace(str(tmp_path / "port"), "X") == \
        out["jax"].replace(str(tmp_path / "jax"), "X")
    names = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert any(n.endswith("feats.ark") for n in names)
    assert any(n.endswith("ali.ark") for n in names)


@pytest.fixture(scope="module")
def medium_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("medium")
    old = sys.argv
    sys.argv = ["make_data.py", "--out", str(d), "--vocab", "200",
                "--train-utts", "24", "--test-utts", "3"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_path(os.path.join(PORT, "medium", "make_data.py"),
                           run_name="__main__")
    except SystemExit as e:
        assert not e.code
    finally:
        sys.argv = old
    return d


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _medium_chain(pkg, work, data, device):
    """Stages 1-5 of the medium run.sh with ``pkg``'s CLIs at a small
    model and 2 epochs → (compute_prob JSON, decode JSON, WER sweep
    lines, MBR hyps)."""
    import importlib
    cli = {name: importlib.import_module(f"{pkg}.cli.{name}")
           for name in ("prepare_egs", "train_ctc", "compute_prob",
                        "graph_tool", "decode_ctc", "score_lattices",
                        "lattice_tool")}
    egs = f"{work}/egs"
    os.makedirs(egs, exist_ok=True)
    _stdout(cli["prepare_egs"].main, [
        "get", "--feats", f"ark:{data}/train/feats.ark", "--ali",
        f"ark:{data}/train/ali.ark", "--max-allow-frames", "2100",
        "--output", f"ark,scp:{egs}/egs.1.ark,{egs}/egs.1.scp",
        "--num-archives", "1"])
    _stdout(cli["prepare_egs"].main, [
        "sort", "--egs", f"ark:{egs}/egs.1.ark", "--output",
        f"ark,scp:{egs}/sorted.1.ark,{egs}/egs.scp"])
    _stdout(cli["train_ctc"].main, [
        "--egs", f"scp:{egs}/egs.scp", "--num-targets", "42",
        "--hidden-dim", "32", "--num-layers", "2", "--bidirectional", "1",
        "--epochs", "2", "--minibatch-size", "8",
        "--frame-subsampling-factor", "3", "--initial-learning-rate",
        "1e-3", "--final-learning-rate", "1e-4", "--momentum", "0.9",
        "--clip-gradient", "5.0", "--dir", f"{work}/exp",
        "--checkpoint-period", "200", "--resume"] + device)
    prob = _last_json(_stdout(cli["compute_prob"].main, [
        "--egs", f"ark:{egs}/sorted.1.ark", "--dir", f"{work}/exp",
        "--frame-subsampling-factor", "3"] + device))
    _stdout(cli["graph_tool"].main, [
        "make-tlg", "--lexicon", f"{data}/lexicon.txt", "--arpa",
        f"{data}/lm.arpa", "--phones", f"{data}/phones.txt", "--output",
        f"{work}/TLG.fst"])
    dec = _last_json(_stdout(cli["decode_ctc"].main, [
        "--feats", f"ark:{data}/test/feats.ark", "--dir", f"{work}/exp",
        "--method", "wfst", "--graph", f"{work}/TLG.fst", "--words",
        f"{work}/TLG.fst.words.txt", "--wfst-beam", "10", "--max-active",
        "300", "--lattice", f"{work}/lat.ark.txt", "--lattice-beam", "3",
        "--determinize", "1", "--blank-threshold", "0.98",
        "--frame-subsampling-factor", "3", "--text", f"{data}/test/text",
        "--output", f"{work}/hyps.txt"] + device))
    sweep = _stdout(cli["score_lattices"].main, [
        "--lattices", f"{work}/lat.ark.txt", "--text", f"{data}/test/text",
        "--words", f"{work}/TLG.fst.words.txt", "--compact", "1",
        "--min-lmwt", "5", "--max-lmwt", "15", "--output",
        f"{work}/best_hyps.txt"])
    _stdout(cli["lattice_tool"].main, [
        "mbr", "--lattices", f"{work}/lat.ark.txt", "--compact", "1",
        "--words", f"{work}/TLG.fst.words.txt", "--output",
        f"{work}/mbr.txt"])
    with open(f"{work}/mbr.txt") as f:
        mbr = f.read()
    return prob, dec, sweep, mbr


def _best_costs(work, data):
    """The port's best-path cost per test utterance through ``work``'s
    model and graph, as decode_ctc scores it."""
    import torch

    from kaldi_ctc_tpu_torch.data import frame_subsample
    from kaldi_ctc_tpu_torch.decoding.scores import acoustic_scores
    from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst, decode_best_path
    from kaldi_ctc_tpu_torch.models import am_forward
    from kaldi_ctc_tpu_torch.models.artifact import load_acoustic_model
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    params, cfg, priors, _ = load_acoustic_model(dir=f"{work}/exp")
    graph = NativeFst.load(f"{work}/TLG.fst")
    out = {}
    for key, feats in SequentialMatrixReader(f"ark:{data}/test/feats.ark"):
        feats = frame_subsample(np.asarray(feats, np.float32), 3)
        with torch.no_grad():
            logits = am_forward(params, torch.as_tensor(feats)[None], cfg)
            scores, _ = acoustic_scores(logits, priors=priors,
                                        blank_threshold=1.0)
        out[key] = float(decode_best_path(graph, scores[0].numpy())[2])
    return out


@pytest.fixture
def one_thread():
    """torch on one thread: the small models gain nothing from more, and
    the test workers run side by side."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_medium_chain_equal_jax(medium_data, tmp_path, one_thread):
    import jax

    from kaldi_ctc_tpu.models import AmConfig, init_am_params
    from kaldi_ctc_tpu.training import init_train_state
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint

    # a peaky initial model (stddev 0.3): near-flat posteriors would fill
    # the lattices with every label sequence
    cfg = AmConfig(input_dim=40, num_targets=42, hidden_dim=32,
                   num_layers=2, param_stddev=0.3)
    init = init_train_state(init_am_params(jax.random.PRNGKey(0), cfg))
    res = {}
    for pkg, tag, device in (("kaldi_ctc_tpu", "jax", []),
                             ("kaldi_ctc_tpu_torch", "port",
                              ["--device", "cpu"])):
        work = tmp_path / tag
        save_checkpoint(str(work / "exp" / "checkpoints"), 0, init,
                        extra={"epoch": 0, "num_layers": 2})
        res[tag] = _medium_chain(pkg, work, medium_data, device)
    (pprob, pdec, psweep, pmbr), (jprob, jdec, jsweep, jmbr) = (
        res["port"], res["jax"])
    np.testing.assert_allclose(pprob["loss_per_frame"],
                               jprob["loss_per_frame"], rtol=1e-4)
    assert (tmp_path / "port" / "TLG.fst").read_bytes() == \
        (tmp_path / "jax" / "TLG.fst").read_bytes()
    with open(tmp_path / "jax" / "hyps.txt") as f:
        want = dict(line.split(None, 1) for line in f)
    with open(tmp_path / "port" / "hyps.txt") as f:
        got = dict(line.split(None, 1) for line in f)
    assert sorted(got) == sorted(want) and len(got) == 3
    differ = [k for k in want if got[k] != want[k]]
    if differ:
        pc = _best_costs(tmp_path / "port", medium_data)
        jc = _best_costs(tmp_path / "jax", medium_data)
        for k in differ:
            np.testing.assert_allclose(pc[k], jc[k], rtol=DECODE_RTOL)
    else:
        drop = ("rtf", "seconds", "audio_seconds")
        assert {k: v for k, v in pdec.items() if k not in drop} == \
            {k: v for k, v in jdec.items() if k not in drop}
        assert psweep == jsweep
        assert pmbr == jmbr
    assert pmbr.strip() and psweep.strip()


def test_generate_report_equal_jax(tmp_path, monkeypatch):
    """The tiny recipe's stage 5 on one metrics.jsonl (a truncated last
    record included): equal accuracy.log, report.tex and printed lines."""
    from kaldi_ctc_tpu.cli import generate_report as jcli
    from kaldi_ctc_tpu_torch.cli import generate_report as pcli

    rng = np.random.default_rng(0)
    lines = []
    for step in range(1, 251):
        lines.append(json.dumps({
            "event": "train_step", "step": step,
            "loss_per_frame": float(rng.random() * 3),
            "accuracy": float(rng.random()), "lr": 1e-3 / step}))
        if step % 50 == 0:
            lines.append(json.dumps({"event": "valid", "step": step,
                                     "accuracy": float(rng.random())}))
    lines.append('{"event": "train_st')
    out = {}
    for tag, cli in (("jax", jcli), ("port", pcli)):
        d = tmp_path / tag
        d.mkdir()
        (d / "metrics.jsonl").write_text("\n".join(lines) + "\n")
        text = _stdout(cli.main, ["--dir", str(d), "--latex"])
        out[tag] = (text.replace(str(d), "X"), (d / "accuracy.log").read_text(),
                    (d / "report.tex").read_text())
    assert out["port"] == out["jax"]
    assert len(out["port"][1].splitlines()) > 100


def test_wer_ci_and_summarize_ablation_equal_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    work = tmp_path / "work"
    (work / "data" / "test").mkdir(parents=True)
    refs = {f"t{i:02d}": [f"w{x}" for x in rng.integers(0, 9, 6)]
            for i in range(12)}
    (work / "data" / "test" / "text").write_text("".join(
        f"{k} {' '.join(v)}\n" for k, v in refs.items()))
    (work / "data.json").write_text(json.dumps({
        "vocab": 9, "train_utts": 30, "test_utts": 12, "train_hours": 0.1,
        "test_hours": 0.01, "frame_acc_nearest": 0.5, "knobs": {}}))
    for arm in ("baseline", "bf16", "ng"):
        for seed in (0, 1):
            exp = work / f"{arm}.s{seed}"
            exp.mkdir()
            hyps = []
            for k, v in refs.items():
                if arm == "ng" and k == "t03":
                    continue    # a missing hypothesis: full deletion
                h = [w if rng.random() > 0.2 + 0.1 * (arm == "bf16")
                     else "wX" for w in v]
                hyps.append(f"{k} {' '.join(h)}\n")
            (exp / "best_hyps.test.txt").write_text("".join(hyps))
            (exp / "metrics.jsonl").write_text(json.dumps(
                {"event": "accuracy", "accuracy": 0.9 + 0.01 * seed}) + "\n")
            outs = {}
            for tag, base in (("jax", JAX), ("port", PORT)):
                outs[tag] = _script(
                    os.path.join(base, "hard", "wer_ci.py"),
                    [str(work / "data" / "test" / "text"),
                     str(exp / "best_hyps.test.txt"), "300"], monkeypatch)
            assert outs["port"] == outs["jax"]
            (exp / "wer_ci.json").write_text(outs["port"])
    outs = {}
    for tag, base in (("jax", JAX), ("port", PORT)):
        monkeypatch.setattr(sys, "argv", ["summarize_ablation.py",
                                          str(work)])
        mod = runpy.run_path(os.path.join(base, "hard",
                                          "summarize_ablation.py"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod["main"](str(work)) == 0
        outs[tag] = buf.getvalue()
    assert outs["port"] == outs["jax"]
    assert "Paired comparisons" in outs["port"]
