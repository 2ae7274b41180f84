"""The port's ``make_synth_data.py`` against the frozen
``recipes/librispeech_ctc/make_synth_data.py`` at a small size: the same
WAVs, transcripts, lexicon, LM, phones and alignments byte for byte,
uncompressed MFCCs of those WAVs through both compute_feats CLIs within
the MFCC tolerance of tests/test_torch_features.py, the scripts' own
compressed feature archives and CMVN stats within one quantization step,
and the same CTC graph and words."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_features import FEAT_TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--train-utts", "6", "--test-utts", "2", "--vocab", "60"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Both scripts' corpora, made side by side → (jax dir, port dir,
    {tag: printed JSON})."""
    base = tmp_path_factory.mktemp("synth")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, os.path.join(
                ROOT, "recipes", "librispeech_ctc", "make_synth_data.py"),
             "--out", str(base / "jax")] + ARGS,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env),
        "port": subprocess.Popen(
            [sys.executable, os.path.join(
                ROOT, "kaldi_ctc_tpu_torch", "recipes", "librispeech_ctc",
                "make_synth_data.py"),
             "--out", str(base / "port"), "--device", "cpu"] + ARGS,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)}
    printed = {}
    for tag, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (tag, err[-3000:])
        printed[tag] = json.loads(out.strip().splitlines()[-1])
    return base / "jax", base / "port", printed


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _assert_feats_close(jd, pd):
    """The two feature archives are Kaldi-compressed (one byte a value,
    three ranges a column): MFCCs within FEAT_TOL before compression agree
    after it within one quantization step of their column, at most the
    column's range / 63.  The CMVN stats of two speakers sum those
    features: equal counts, and means and second moments within the same
    steps."""
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    want = dict(SequentialMatrixReader(f"scp:{jd}/feats.scp"))
    got = dict(SequentialMatrixReader(f"scp:{pd}/feats.scp"))
    assert sorted(got) == sorted(want) and got
    step = {}
    for k in want:
        w = want[k]
        step[k] = (w.max(0) - w.min(0)) / 63 + FEAT_TOL * max(
            1.0, float(np.abs(w).max()))
        assert got[k].shape == w.shape
        assert (np.abs(got[k] - w) <= step[k]).all(), k
    spk = dict(line.split() for line in open(f"{jd}/utt2spk"))
    want = dict(SequentialMatrixReader(f"scp:{jd}/cmvn.scp"))
    got = dict(SequentialMatrixReader(f"scp:{pd}/cmvn.scp"))
    assert sorted(got) == sorted(want) and got
    for s, w in want.items():
        g = got[s]
        n = w[0, -1]
        assert g[0, -1] == n > 0
        tol = np.max([step[k].max(0) for k in spk if spk[k] == s], 0)
        big = np.max([np.abs(d).max(0) for k, d in dict(
            SequentialMatrixReader(f"scp:{jd}/feats.scp")).items()
            if spk[k] == s], 0)
        assert (np.abs(g[0, :-1] - w[0, :-1]) / n <= tol).all()
        assert (np.abs(g[1, :-1] - w[1, :-1]) / n
                <= tol * (2 * big + tol)).all()


def test_make_synth_data_equal_jax(corpora):
    from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst

    jd, pd, printed = corpora
    names = _files(jd)
    assert names == _files(pd)
    assert sum(n.endswith(".wav") for n in names) == 8
    for tag, d in (("jax", jd), ("port", pd)):
        printed[tag] = {k: str(v).replace(str(d), "OUT")
                        for k, v in printed[tag].items()}
    assert printed["port"] == printed["jax"]
    for n in names:
        got, want = (pd / n).read_bytes(), (jd / n).read_bytes()
        if n.endswith("wav.scp"):
            got = got.replace(str(pd).encode(), b"OUT")
            want = want.replace(str(jd).encode(), b"OUT")
        if n.endswith((".wav", "wav.scp", "text", "utt2spk", "lexicon.txt",
                       "lm.arpa", "phones.txt", "ali.pdf.ark",
                       "words.txt", "CTC.fst")):
            assert got == want, n
    for split in ("train", "test_clean"):
        _assert_feats_close(f"{jd}/data/{split}", f"{pd}/data/{split}")
    g = NativeFst.load(str(pd / "graph" / "CTC.fst")).to_arrays()
    w = NativeFst.load(str(jd / "graph" / "CTC.fst")).to_arrays()
    assert g[0] == w[0]
    for a, b in zip(g[1:], w[1:]):
        np.testing.assert_array_equal(a, b)


def test_compute_feats_uncompressed_on_the_corpus_equal_jax(corpora,
                                                            tmp_path):
    """The corpus' WAVs through both packages' compute_feats with
    ``--compress 0``: MFCC-hires within FEAT_TOL, absolute errors scaled
    by the matrix's largest value as tests/test_torch_pipeline.py scales
    them (the loud two-formant tones put c0 above 100)."""
    import contextlib
    import io

    from kaldi_ctc_tpu.cli import compute_feats as jcli
    from kaldi_ctc_tpu_torch.cli import compute_feats as pcli
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    _, pd, _ = corpora
    out = {}
    for tag, cli, extra in (("jax", jcli, []),
                            ("port", pcli, ["--device", "cpu"])):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--wav-scp", f"{pd}/data/test_clean/wav.scp", "--type",
                      "mfcc", "--config", "hires", "--compress", "0",
                      "--out", f"ark:{tmp_path}/{tag}.ark"] + extra)
        out[tag] = dict(SequentialMatrixReader(f"ark:{tmp_path}/{tag}.ark"))
    assert sorted(out["port"]) == sorted(out["jax"]) and len(out["jax"]) == 2
    for k, want in out["jax"].items():
        np.testing.assert_allclose(
            out["port"][k], want, rtol=FEAT_TOL,
            atol=FEAT_TOL * max(1.0, float(np.abs(want).max())))
