"""CTC Viterbi alignment and in-loop realignment in the port held to the
JAX package on the CPU: ``ctc_viterbi_align`` (ragged rows, zero labels,
infeasible rows, repeated labels), ``realign_examples`` (its
bookkeeping: kept and dropped keys, relabeled sequences, counts), the
``align_ctc`` CLI (``--frame-labels``, ``--ctm`` and the summary line),
and ``train_ctc --realign-epochs`` from one JAX-written checkpoint,
resumed runs included.

Frame labels are compared exactly: the inputs hold no near-ties (the
logits are drawn at scale 3, or come from a model whose weights are
drawn at stddev 0.5)."""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.models import acoustic as jam
from kaldi_ctc_tpu.ops import ctc as jctc
from kaldi_ctc_tpu_torch.ops import ctc as tctc
from kaldi_ctc_tpu_torch.params import from_jax_params

from tests.test_torch_train_cli import (DIM, HIDDEN, LAYERS, TARGETS,
                                        _argv, _records, _write_set)

# path log-probs: the same f32 sums of log-softmax values, in the same
# order, from log-softmaxes that differ in the last bits
LP_RTOL = 1e-6


def _align_case(seed):
    """Logits [6, 15, 6] and labels: full and ragged rows, repeated labels
    (row 1), one label repeated throughout (row 2), a row of 4 frames for
    3 labels, an empty label row (4) and one frame for one label (5);
    row 3 of seed 1 is infeasible (3 repeats of one label need 5 frames)."""
    rng = np.random.default_rng(seed)
    b, t, a, l = 6, 15, 6, 5
    logits = (rng.standard_normal((b, t, a)) * 3).astype(np.float32)
    labels = rng.integers(1, a, (b, l)).astype(np.int32)
    labels[1, 1] = labels[1, 0]
    labels[2, :] = 3
    if seed == 1:
        labels[3, :3] = 2
    input_lens = np.array([15, 12, 15, 4, 9, 1], np.int32)
    label_lens = np.array([5, 4, 5, 3, 0, 1], np.int32)
    return logits, labels, input_lens, label_lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_viterbi_align_matches_jax(seed):
    args = _align_case(seed)
    ref = [np.asarray(r) for r in jctc.ctc_viterbi_align(
        *(jnp.asarray(a) for a in args))]
    got = [g.numpy() for g in tctc.ctc_viterbi_align(
        *(torch.as_tensor(a) for a in args))]
    assert got[0].dtype == np.int32 and got[0].shape == ref[0].shape
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], rtol=LP_RTOL)
    if seed == 1:
        # the infeasible row: no path, log 0 as -1e30 (F4), all blank
        assert not got[2][3] and got[1][3] < -1e29
        assert (got[0][3] == 0).all()
    assert got[2][[0, 1, 2, 4, 5]].all()
    # a feasible row's labels collapse back to its label sequence
    logits, labels, input_lens, label_lens = args
    for row in np.flatnonzero(got[2]):
        fl = got[0][row, :input_lens[row]]
        runs = fl[np.concatenate([[True], np.diff(fl) != 0])]
        assert runs[runs != 0].tolist() == labels[
            row, :label_lens[row]].tolist()
        assert (got[0][row, input_lens[row]:] == 0).all()


def test_ctc_viterbi_align_path_is_the_best_path():
    """The returned path is the best one: its score and the returned
    log-prob equal the maximum over every frame labelling that collapses
    to the labels (brute force over 4^6 labellings)."""
    import itertools
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((1, 6, 4)) * 2).astype(np.float32)
    labels = np.array([[1, 3]], np.int32)
    lens, llens = np.array([6], np.int32), np.array([2], np.int32)
    fl, lp, ok = tctc.ctc_viterbi_align(*(torch.as_tensor(a) for a in (
        logits, labels, lens, llens)))
    logp = torch.log_softmax(torch.as_tensor(logits[0]), -1).numpy()
    best = -np.inf
    for path in itertools.product(range(4), repeat=6):
        p = np.asarray(path)
        runs = p[np.concatenate([[True], np.diff(p) != 0])]
        if runs[runs != 0].tolist() == [1, 3]:
            best = max(best, float(logp[np.arange(6), p].sum()))
    assert bool(ok[0])
    np.testing.assert_allclose(float(lp[0]), best, rtol=1e-6)
    np.testing.assert_allclose(
        float(logp[np.arange(6), fl[0].numpy()].sum()), best, rtol=1e-6)


def _examples(n=16, seed=0):
    from kaldi_ctc_tpu.data import CtcExample
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 5))
        labels = rng.integers(1, TARGETS, k).astype(np.int32)
        t = int(rng.integers(max(2 * k - 2, 1), 6 * k + 1))
        feats = rng.standard_normal((t, DIM)).astype(np.float32)
        out.append(CtcExample(f"utt{i:02d}", feats, labels))
    return out


@pytest.mark.parametrize("conv", [0, 1], ids=["blstm", "ds2_stride2"])
def test_realign_examples_matches_jax(conv):
    """The same model (stddev 0.5; with a stride-2 conv layer the logit
    rate halves and more rows are infeasible) realigns 16 utterances in
    minibatches of 5 in both packages: the same kept and dropped keys,
    relabeled sequences, occupancy counts and mean path log-prob."""
    from kaldi_ctc_tpu.training.realign import realign_examples as jrealign
    from kaldi_ctc_tpu_torch.data import CtcExample
    from kaldi_ctc_tpu_torch.models import AmConfig
    from kaldi_ctc_tpu_torch.training.realign import (
        parse_realign_epochs, realign_examples)

    kw = dict(input_dim=DIM, num_targets=TARGETS, hidden_dim=8,
              num_layers=1, param_stddev=0.5, conv_layers=conv,
              conv_channels=2)
    jcfg = jam.AmConfig(**kw)
    params = jax.device_get(jam.init_am_params(jax.random.PRNGKey(2),
                                               jcfg))
    exs = _examples()
    j_kept, j_counts, j_stats = jrealign(exs, params, jcfg,
                                         minibatch_size=5)
    t_exs = [CtcExample(e.key, e.feats, e.labels) for e in exs]
    t_kept, t_counts, t_stats = realign_examples(
        t_exs, from_jax_params(params), AmConfig(**kw), minibatch_size=5)
    assert [e.key for e in t_kept] == [e.key for e in j_kept]
    assert 0 < len(t_kept) < len(exs) or conv == 0
    for a, b in zip(t_kept, j_kept):
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.labels.dtype == np.int32 and a.feats is not None
    np.testing.assert_array_equal(t_counts, j_counts)
    assert t_counts.dtype == np.float64
    for k in ("aligned", "dropped", "dropped_keys"):
        assert t_stats[k] == j_stats[k]
    assert sorted(t_stats["counts_by_key"]) == sorted(j_stats["counts_by_key"])
    for k, v in j_stats["counts_by_key"].items():
        np.testing.assert_array_equal(t_stats["counts_by_key"][k], v)
    np.testing.assert_allclose(t_stats["avg_logprob_per_frame"],
                               j_stats["avg_logprob_per_frame"],
                               rtol=LP_RTOL)
    assert parse_realign_epochs("2, 4,") == frozenset({2, 4})
    assert parse_realign_epochs("") == frozenset()


@pytest.fixture(scope="module")
def align_data(tmp_path_factory):
    """test_torch_train_cli's sets, a JAX model directory (init_model at
    stddev 0.5) and the JAX package's initial training checkpoint."""
    from kaldi_ctc_tpu.cli import init_model
    from kaldi_ctc_tpu.training import init_train_state
    from kaldi_ctc_tpu.training.checkpoint import save_checkpoint
    from kaldi_ctc_tpu.utils import kaldi_io

    d = tmp_path_factory.mktemp("align")
    _write_set(d, "train", 16, 0)
    _write_set(d, "valid", 8, 1)
    init_model.main(["--dir", str(d / "model"), "--input-dim", str(DIM),
                     "--num-targets", str(TARGETS), "--hidden-dim", "8",
                     "--num-layers", "2", "--param-stddev", "0.5"])
    # shifted label sequences of the valid set, one of them too long for
    # its frames, one with an out-of-range id
    with kaldi_io.IntVectorWriter(f"ark,t:{d}/labels.txt") as w:
        for key, ali in kaldi_io.SequentialIntVectorReader(
                f"ark:{d}/valid_ali.ark"):
            runs = ali[np.concatenate([[True], np.diff(ali) != 0])] + 1
            w[key] = runs.astype(np.int32)
        w["valid00"] = np.arange(1, TARGETS).repeat(5).astype(np.int32)
        w["valid01"] = np.array([1, TARGETS], np.int32)
    cfg = jam.AmConfig(input_dim=DIM, num_targets=TARGETS, hidden_dim=HIDDEN,
                       num_layers=LAYERS)
    state = init_train_state(jam.init_am_params(jax.random.PRNGKey(3), cfg))
    save_checkpoint(str(d / f"init{LAYERS}" / "checkpoints"), 0, state,
                    extra={"epoch": 0, "num_layers": LAYERS})
    return d


@pytest.mark.parametrize("labels", ["ali", "labels"])
def test_align_ctc_matches_jax(align_data, tmp_path, labels):
    """align_ctc with --frame-labels and --ctm in both packages on one
    model directory: equal frame-label archives, CTMs and summaries
    (``--labels`` holds an infeasible and an out-of-range utterance)."""
    from kaldi_ctc_tpu.cli import align_ctc as jcli
    from kaldi_ctc_tpu.utils import kaldi_io
    from kaldi_ctc_tpu_torch.cli import align_ctc as tcli

    d = align_data
    src = (["--ali", f"ark:{d}/valid_ali.ark"] if labels == "ali"
           else ["--labels", f"ark:{d}/labels.txt"])
    out = {}
    for pkg, cli, dev in (("jax", jcli, []),
                          ("port", tcli, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--feats", f"ark:{d}/valid_feats.ark", "--dir",
                      str(d / "model"), "--frame-labels",
                      f"ark:{tmp_path}/{pkg}.ark", "--ctm",
                      f"{tmp_path}/{pkg}.ctm", "--minibatch-size", "3",
                      "--frame-shift", "0.03"] + src + dev)
        out[pkg] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                    dict(kaldi_io.SequentialIntVectorReader(
                        f"ark:{tmp_path}/{pkg}.ark")),
                    open(f"{tmp_path}/{pkg}.ctm").read())
    (js, jfl, jctm), (ts, tfl, tctm) = out["jax"], out["port"]
    assert ts["aligned"] == js["aligned"] and ts["failed"] == js["failed"]
    assert ts["aligned"] > 0
    if labels == "labels":
        assert ts["failed"] == 1 and ts["aligned"] == 6
    np.testing.assert_allclose(ts["avg_logprob_per_frame"],
                               js["avg_logprob_per_frame"], rtol=LP_RTOL)
    assert sorted(tfl) == sorted(jfl)
    for k in jfl:
        np.testing.assert_array_equal(tfl[k], jfl[k])
    assert tctm == jctm and tctm.count("\n") > 0
    from kaldi_ctc_tpu_torch.cli import align_ctc
    assert align_ctc.parse_args([]).device == "cuda"


def _realign_records(exp):
    """metrics.jsonl with the realign records' mean log-prob set apart."""
    recs, lps = [], []
    for r in _records(exp):
        if r["event"] == "realign":
            lps.append(r.pop("avg_logprob_per_frame"))
        recs.append(r)
    return recs, lps


def _records_close(got, want):
    assert [(r["event"], r.get("step")) for r in got] == \
        [(r["event"], r.get("step")) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-4)
            else:
                assert g[k] == v, (k, g, w)


def test_train_ctc_realign_matches_jax(align_data, tmp_path):
    """train_ctc --realign-epochs 1 (3 epochs) in both packages from one
    JAX checkpoint: equal records (the realign record's counts, the lr of
    the recomputed decay horizon), priors.npy and persisted labels; then
    a run cut after its epoch-1 checkpoint and resumed reapplies the
    persisted realignment and ends where the uninterrupted run ends."""
    from kaldi_ctc_tpu.cli import train_ctc as jax_cli
    from kaldi_ctc_tpu_torch.cli import train_ctc as port_cli

    d = align_data
    argv = _argv(d, epochs=3, extra=["--realign-epochs", "1",
                                     "--momentum", "0.9"])
    runs = {}
    for tag in ("full", "cut"):
        for pkg, cli, dev in (("jax", jax_cli, []),
                              ("port", port_cli, ["--device", "cpu"])):
            exp = str(tmp_path / f"{tag}_{pkg}")
            shutil.copytree(str(d / f"init{LAYERS}"), exp)
            if tag == "cut":
                # train 1 epoch, then resume for 3: the realign epoch
                # fires in the resumed run
                first = list(argv)
                first[first.index("--epochs") + 1] = "1"
                cli.main(first + ["--dir", exp] + dev)
            cli.main(argv + ["--dir", exp] + dev)
            runs[(tag, pkg)] = exp
    (jrec, jlp), (trec, tlp) = (_realign_records(runs[("full", p)])
                                for p in ("jax", "port"))
    _records_close(trec, jrec)
    np.testing.assert_allclose(tlp, jlp, rtol=LP_RTOL)
    realign = [r for r in trec if r["event"] == "realign"]
    assert len(realign) == 1 and realign[0]["epoch"] == 1
    assert realign[0]["aligned"] + realign[0]["dropped"] == 16
    for name in ("priors.npy",):
        np.testing.assert_allclose(
            np.load(os.path.join(runs[("full", "port")], name)),
            np.load(os.path.join(runs[("full", "jax")], name)),
            rtol=0, atol=0)
    with open(os.path.join(runs[("full", "port")],
                           "realign_labels.host0.json")) as f, \
            open(os.path.join(runs[("full", "jax")],
                              "realign_labels.host0.json")) as g:
        assert json.load(f) == json.load(g)
    # the run resumed at the realign epoch with no persisted labels
    # (re-aligned with the restored params): the same in both packages
    (jrec, jlp), (trec, tlp) = (_realign_records(runs[("cut", p)])
                                for p in ("jax", "port"))
    _records_close(trec, jrec)
    np.testing.assert_allclose(tlp, jlp, rtol=LP_RTOL)
    # a resume past the realign epoch reapplies the persisted labels
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        more = list(argv)
        more[more.index("--epochs") + 1] = "4"
        cli.main(more + ["--dir", runs[("full", pkg)]] + dev)
    (jrec, _), (trec, _) = (_realign_records(runs[("full", p)])
                            for p in ("jax", "port"))
    _records_close(trec, jrec)
    assert sum(r["event"] == "realign" for r in trec) == 1
