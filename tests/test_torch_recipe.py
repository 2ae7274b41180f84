"""Stages 0-4 of recipes/tiny/run.sh through the port's CLIs, beside the
same stages through the JAX package's, in a temporary directory:
make_data.py → prepare_egs get / info → train_ctc → adjust_priors →
decode_ctc (beam, priors).  Both trainings start from one initial
checkpoint the JAX package wrote (``init_model``'s draws differ between
the packages), and the two hyps.txt must be equal; where a near-tie flips
a label, the two decodes' best-path scores agree within DECODE_RTOL.

The recipe trains 600 epochs of one 24-utterance step each; here 60, so
that both packages' runs take seconds on the CPU.  The equality of the
chain does not depend on the count: each step is held to the JAX step in
tests/test_torch_train_cli.py."""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 60
# PR 15's rule for decode parity: a hypothesis that differs is a near-tie
# the forward's tolerance flips when the best-path scores agree this well
DECODE_RTOL = 1e-3


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _chain(pkg, work, data, device):
    """Stages 1-4 of recipes/tiny/run.sh with ``pkg``'s CLIs → the
    decode's score line."""
    import importlib
    cli = {name: importlib.import_module(f"{pkg}.cli.{name}")
           for name in ("prepare_egs", "train_ctc", "adjust_priors",
                        "decode_ctc")}
    _stdout(cli["prepare_egs"].main, [
        "get", "--feats", f"ark:{data}/feats.ark", "--ali",
        f"ark:{data}/ali.ark", "--output",
        f"ark,scp:{work}/egs.ark,{work}/egs.scp"])
    info = json.loads(_stdout(cli["prepare_egs"].main, [
        "info", "--egs", f"ark:{work}/egs.ark"]))
    assert info["num_examples"] == 24
    _stdout(cli["train_ctc"].main, [
        "--egs", f"scp:{work}/egs.scp", "--num-targets", "6",
        "--hidden-dim", "24", "--num-layers", "2",
        "--epochs", str(EPOCHS), "--minibatch-size", "24",
        "--initial-learning-rate", "1.5e-2", "--final-learning-rate",
        "1.5e-3", "--momentum", "0.9", "--dir", f"{work}/exp",
        "--checkpoint-period", "100", "--resume"] + device)
    _stdout(cli["adjust_priors"].main, [
        "--dir", f"{work}/exp", "--feats", f"ark:{data}/feats.ark"] + device)
    line = _stdout(cli["decode_ctc"].main, [
        "--feats", f"ark:{data}/feats.ark", "--dir", f"{work}/exp",
        "--method", "beam", "--use-priors", "1", "--blank-threshold", "1.0",
        "--text", f"{data}/text", "--output", f"{work}/hyps.txt"] + device)
    return json.loads(line.strip().splitlines()[-1])


def _beam_scores(work, data):
    """The port's prefix-beam scores over ``work``'s model, as decode_ctc
    decodes (priors, no blank threshold) → {key: score}."""
    import torch

    from kaldi_ctc_tpu_torch.decoding import (acoustic_scores,
                                              prefix_beam_search)
    from kaldi_ctc_tpu_torch.models import am_forward
    from kaldi_ctc_tpu_torch.models.artifact import load_acoustic_model
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    params, cfg, priors, _ = load_acoustic_model(dir=f"{work}/exp")
    out = {}
    for key, feats in SequentialMatrixReader(f"ark:{data}/feats.ark"):
        with torch.no_grad():
            logits = am_forward(params, torch.as_tensor(feats)[None], cfg)
            scores, _ = acoustic_scores(logits, priors=priors,
                                        blank_threshold=1.0)
        out[key] = float(prefix_beam_search(
            scores, torch.as_tensor([feats.shape[0]]))[2][0])
    return out


def test_tiny_recipe_stages_0_to_4_through_the_port(tmp_path, monkeypatch):
    import jax

    from kaldi_ctc_tpu.models import AmConfig, init_am_params
    from kaldi_ctc_tpu.training import init_train_state
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint

    data = tmp_path / "data"
    monkeypatch.setattr(sys, "argv", ["make_data.py", "--dir", str(data)])
    runpy.run_path(os.path.join(ROOT, "recipes", "tiny", "make_data.py"),
                   run_name="__main__")
    cfg = AmConfig(input_dim=8, num_targets=6, hidden_dim=24, num_layers=2)
    init = init_train_state(init_am_params(jax.random.PRNGKey(0), cfg))
    score = {}
    for pkg, tag, device in (("kaldi_ctc_tpu", "jax", []),
                             ("kaldi_ctc_tpu_torch", "port",
                              ["--device", "cpu"])):
        work = tmp_path / tag
        save_checkpoint(str(work / "exp" / "checkpoints"), 0, init,
                        extra={"epoch": 0, "num_layers": 2})
        score[tag] = _chain(pkg, work, data, device)
    with open(tmp_path / "jax" / "hyps.txt") as f:
        want = dict(line.split(None, 1) for line in f)
    with open(tmp_path / "port" / "hyps.txt") as f:
        got = dict(line.split(None, 1) for line in f)
    assert sorted(got) == sorted(want) and len(got) == 24
    differ = [k for k in want if got[k] != want[k]]
    if differ:
        jax_scores = _beam_scores(tmp_path / "jax", data)
        port_scores = _beam_scores(tmp_path / "port", data)
        for k in differ:
            np.testing.assert_allclose(port_scores[k], jax_scores[k],
                                       rtol=DECODE_RTOL)
    else:
        assert score["port"] == {**score["jax"], "rtf": score["port"]["rtf"]}
    assert sum(len(v.split()) > 0 for v in got.values()) >= 12
    np.testing.assert_allclose(
        np.load(tmp_path / "port" / "exp" / "priors.npy"),
        np.load(tmp_path / "jax" / "exp" / "priors.npy"), rtol=0, atol=1e-5)
