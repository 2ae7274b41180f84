"""The port's compute_prob, adjust_priors and decode_stream against the
JAX package's on one model directory and one feature archive: the same
JSON lines, priors and hypotheses."""

import contextlib
import io
import json
import logging
import os
import shutil

import numpy as np
import pytest

# f32 forwards on the CPU in another summation order: compute_prob's loss
# per frame relative, adjust_priors' averaged posteriors absolute
PROB_RTOL = 1e-5
POST_ATOL = 1e-6
DIM, TARGETS = 8, 6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX init_model directories (2x16 BLSTM and 2x16 uni LSTM, large
    weights for clear frames), 10 utterances with pdf alignments,
    transition-id alignments and per-frame symbol ids, two speakers' CMVN,
    a transition model, an egs archive and label references."""
    from kaldi_ctc_tpu.cli import init_model, prepare_egs
    from kaldi_ctc_tpu.features.cmvn import acc_cmvn_stats
    from kaldi_ctc_tpu.utils import kaldi_io
    from tests.test_transition_model import _make_mono_ctc_model

    d = tmp_path_factory.mktemp("eval")
    for name, bi in (("exp", "1"), ("exp_uni", "0")):
        init_model.main(["--input-dim", str(DIM), "--num-targets",
                         str(TARGETS), "--hidden-dim", "16", "--num-layers",
                         "2", "--param-stddev", "0.5", "--bidirectional", bi,
                         "--dir", str(d / name), "--seed", "2"])
    rng = np.random.default_rng(7)
    feats, spk = {}, {}
    with kaldi_io.MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/ali.ark") as aw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/tid.ark") as tw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/frames.ark") as sw:
        for i in range(10):
            key = f"u{i}"
            t = int(rng.integers(30, 140))
            feats[key] = (rng.standard_normal((t, DIM)) * 2 + .5).astype(
                np.float32)
            spk[key] = f"s{i % 2}"
            fw[key] = feats[key]
            pdfs = np.repeat(rng.integers(0, 3, t // 6 + 1), 6)[:t]
            aw[key] = pdfs.astype(np.int32)
            tw[key] = (2 * pdfs + 1 + np.arange(t) % 2).astype(np.int32)
            sw[key] = np.where(np.arange(t) % 3 == 0, 0,
                               pdfs + 1).astype(np.int32)
    with kaldi_io.MatrixWriter(f"ark:{d}/cmvn.ark") as w:
        for s in ("s0", "s1"):
            w[s] = sum(acc_cmvn_stats(v) for k, v in feats.items()
                       if spk[k] == s)
    (d / "utt2spk").write_text("".join(f"{k} {s}\n" for k, s in spk.items()))
    (d / "final.mdl").write_bytes(_make_mono_ctc_model(3).read())
    (d / "labels.txt").write_text("".join(
        f"u{i} {' '.join(str(rng.integers(1, TARGETS)) for _ in range(5))}\n"
        for i in range(10)))
    prepare_egs.main(["get", "--feats", f"scp:{d}/feats.scp", "--ali",
                      f"ark:{d}/ali.ark", "--output", f"ark:{d}/egs.ark"])
    return d


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("flags", [
    ["--egs", "ark:{d}/egs.ark", "--minibatch-size", "3"],
    ["--feats", "scp:{d}/feats.scp", "--ali", "ark:{d}/ali.ark", "--cmvn",
     "ark:{d}/cmvn.ark", "--utt2spk", "{d}/utt2spk",
     "--frame-subsampling-factor", "2", "--max-allow-frames", "60"],
], ids=["egs", "feats_cmvn_fs2"])
def test_compute_prob_equal_jax(setup, flags, capfd):
    from kaldi_ctc_tpu.cli import compute_prob as jax_cli
    from kaldi_ctc_tpu_torch.cli import compute_prob as port_cli

    argv = [x.format(d=setup) for x in flags] + ["--dir", f"{setup}/exp"]
    want = json.loads(_stdout(jax_cli.main, argv).strip().splitlines()[-1])
    got = json.loads(_stdout(port_cli.main, argv + ["--device", "cpu"]
                             ).strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got.pop("loss_per_frame"),
                               want.pop("loss_per_frame"), rtol=PROB_RTOL)
    assert got == want and got["num_utts"] >= 4
    lines = [line for line in capfd.readouterr().err.splitlines()
             if "Accuracy = " in line]
    assert len(lines) == 2 and lines[0] == lines[1]


def test_eval_step_zero_frame_row_loss_equal_jax(setup):
    """F8: a row with input_lens 0 gets the loss of frame 0 (nonzero) in
    both packages' eval step, the one compute_prob and train_ctc's cv run
    (their 2L+1 <= T filter never forms such a row from data)."""
    import jax.numpy as jnp
    import torch

    from kaldi_ctc_tpu.models.artifact import load_acoustic_model as jax_load
    from kaldi_ctc_tpu.training import make_eval_step as jax_eval
    from kaldi_ctc_tpu_torch.models.artifact import load_acoustic_model
    from kaldi_ctc_tpu_torch.training import make_eval_step

    rng = np.random.default_rng(3)
    batch = {"feats": rng.standard_normal((3, 20, DIM)).astype(np.float32),
             "labels": np.asarray([[1, 2, 0], [0, 0, 0], [3, 0, 0]],
                                  np.int32),
             "input_lens": np.asarray([20, 0, 0], np.int32),
             "label_lens": np.asarray([2, 0, 1], np.int32)}
    jp, jcfg, _, _ = jax_load(dir=f"{setup}/exp")
    tp, tcfg, _, _ = load_acoustic_model(dir=f"{setup}/exp")
    for rows in ([0, 1, 2], [1], [2]):
        sub = {k: v[rows] for k, v in batch.items()}
        want = float(jax_eval(jcfg)(jp, {k: jnp.asarray(v)
                                         for k, v in sub.items()})
                     ["loss_total"])
        got = float(make_eval_step(tcfg)(tp, {k: torch.as_tensor(v)
                                              for k, v in sub.items()})
                    ["loss_total"])
        assert want > 0.1
        np.testing.assert_allclose(got, want, rtol=PROB_RTOL)


PRIOR_CASES = {
    "counts": (["--ali", "ark:{d}/ali.ark"], 0.0),
    "counts_tid": (["--ali", "ark:{d}/tid.ark", "--trans-model",
                    "{d}/final.mdl"], 0.0),
    "counts_raw": (["--ali", "ark:{d}/ali.ark", "--raw-labels", "1"], 0.0),
    "counts_frames": (["--ali", "ark:{d}/frames.ark", "--frame-labels",
                       "1"], 0.0),
    "const": (["--google-prior-const", "7"], 0.0),
    "posteriors": (["--feats", "scp:{d}/feats.scp", "--minibatch-size",
                    "3"], POST_ATOL),
    "posteriors_cmvn": (["--feats", "scp:{d}/feats.scp", "--cmvn",
                         "ark:{d}/cmvn.ark", "--utt2spk", "{d}/utt2spk",
                         "--frame-subsampling-factor", "3", "--max-utts",
                         "7", "--max-allow-frames", "40"], POST_ATOL),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_adjust_priors_equal_jax(setup, tmp_path, case, caplog):
    """Each route writes the same priors.npy (counts exactly, posteriors
    within POST_ATOL) and, over an existing prior vector, the same
    diagnostics."""
    from kaldi_ctc_tpu.cli import adjust_priors as jax_cli
    from kaldi_ctc_tpu_torch.cli import adjust_priors as port_cli

    flags, atol = PRIOR_CASES[case]
    flags = [x.format(d=setup) for x in flags]
    priors, logs = {}, {}
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        exp = str(tmp_path / pkg)
        shutil.copytree(f"{setup}/exp", exp)
        np.save(os.path.join(exp, "priors.npy"),
                np.linspace(1.0, 2.0, TARGETS).astype(np.float32))
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cli.main(flags + ["--dir", exp] + dev)
        logs[pkg] = [r.getMessage() for r in caplog.records
                     if r.name == "adjust_priors"
                     and not r.getMessage().startswith("wrote")]
        priors[pkg] = np.load(os.path.join(exp, "priors.npy"))
    assert priors["port"].dtype == priors["jax"].dtype
    np.testing.assert_allclose(priors["port"], priors["jax"], rtol=0,
                               atol=atol)
    if atol == 0.0:
        assert logs["port"] == logs["jax"]
    else:
        assert len(logs["port"]) == len(logs["jax"]) == 3
    # normalized, except the constant route's ones with prior[0] = 7
    total = 7.0 + (TARGETS - 1) if case == "const" else 1.0
    np.testing.assert_allclose(float(priors["port"].sum()), total,
                               rtol=1e-5)


@pytest.mark.parametrize("flags", [
    [],
    ["--use-priors", "1", "--chunk-frames", "7", "--cmvn",
     "ark:{d}/cmvn.ark", "--utt2spk", "{d}/utt2spk"],
], ids=["plain", "priors_cmvn"])
def test_decode_stream_equal_jax(setup, tmp_path, flags):
    """decode_stream on the uni LSTM: the same hypotheses and the same
    LER numbers in both packages (rtf and latency are timings)."""
    from kaldi_ctc_tpu.cli import decode_stream as jax_cli
    from kaldi_ctc_tpu_torch.cli import decode_stream as port_cli

    exp = f"{setup}/exp_uni"
    np.save(os.path.join(exp, "priors.npy"),
            np.linspace(2.0, 1.0, TARGETS).astype(np.float32))
    argv = ["--feats", f"scp:{setup}/feats.scp", "--dir", exp, "--text",
            f"{setup}/labels.txt"] + [x.format(d=setup) for x in flags]
    out = {}
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        hyp = str(tmp_path / f"{pkg}.txt")
        line = _stdout(cli.main, argv + ["--output", hyp] + dev)
        score = json.loads(line.strip().splitlines()[-1])
        for k in ("rtf", "median_chunk_latency_ms"):
            assert score.pop(k) > 0
        with open(hyp) as f:
            out[pkg] = (f.read(), score)
    assert out["port"] == out["jax"]
    hyps = out["port"][0].splitlines()
    assert len(hyps) == 10
    assert sum(len(line.split()) > 1 for line in hyps) >= 5
