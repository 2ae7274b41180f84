"""The port's egs pipeline and prepare_egs against the JAX package's: the
same seeded examples through ``EgsPipeline.epoch`` give the same batches
bit for bit, ``Prefetcher`` keeps order and re-raises, ``load_examples``
reads the same examples, and every prepare_egs subcommand writes the same
bytes (or prints the same line) in both packages."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from tests.test_transition_model import _make_mono_ctc_model

# add_deltas sums its filter taps in another order in torch than in XLA's
# einsum: that archive is compared as features at this relative tolerance
# rather than as bytes (every other get case is byte for byte)
FEATS_TOL = 1e-5


def _examples(pkg, n=40, dim=5, seed=0):
    """Seeded CtcExamples of 8-120 frames and 1-30 labels (some too long
    for their frames, so the filters drop them)."""
    import importlib
    egs = importlib.import_module(f"{pkg}.data.egs")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.integers(8, 121))
        out.append(egs.CtcExample(
            f"utt{i:03d}",
            rng.standard_normal((t, dim)).astype(np.float32),
            rng.integers(1, 9, int(rng.integers(1, 31))).astype(np.int32)))
    return out


@pytest.mark.parametrize("kw", [
    {},
    {"frame_subsampling_factor": 3},
    {"fixed_shape": (130, 40)},
    {"time_stride": 2},
    {"frame_subsampling_factor": 3, "fixed_shape": (60, 40),
     "time_stride": 2, "minibatch_size": 5, "sort_window": 7},
], ids=["plain", "fs3", "fixed", "stride2", "all"])
def test_egs_pipeline_epochs_equal_jax(kw):
    from kaldi_ctc_tpu.data import EgsPipeline as JaxPipeline
    from kaldi_ctc_tpu_torch.data import EgsPipeline

    kw = {"minibatch_size": 6, "seed": 3, **kw}
    jp = JaxPipeline(_examples("kaldi_ctc_tpu"), **kw)
    tp = EgsPipeline(_examples("kaldi_ctc_tpu_torch"), **kw)
    n_batches = 0
    for epoch in range(3):
        want = list(jp.epoch(epoch))
        got = list(tp.epoch(epoch))
        assert len(got) == len(want) > 0
        assert tp.num_skipped == jp.num_skipped
        for g, w in zip(got, want):
            assert list(g["keys"]) == list(w["keys"])
            assert sorted(g) == sorted(w)
            for k in w:
                if k == "keys":
                    continue
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
        n_batches += len(got)
    assert n_batches >= 3


def test_prefetcher_keeps_order_and_reraises():
    from kaldi_ctc_tpu_torch.data import Prefetcher

    assert list(Prefetcher(iter(range(50)), depth=3)) == list(range(50))

    def broken():
        yield 1
        yield 2
        raise ValueError("producer failed")

    it = Prefetcher(broken())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="producer failed"):
        next(it)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Features, pdf alignments, transition-id alignments, CMVN stats of
    two speakers, transcripts and a lexicon, an LDA matrix, per-speaker
    affine transforms and online ivectors for 12 utterances, a
    1-state-per-phone transition model of 3 phones and a triphone tree."""
    from kaldi_ctc_tpu.features.cmvn import acc_cmvn_stats
    from kaldi_ctc_tpu.utils import kaldi_io
    from kaldi_ctc_tpu.utils.tree import CE, SE, TE, ContextDependency, \
        write_tree

    d = tmp_path_factory.mktemp("egs")
    rng = np.random.default_rng(5)
    feats, spk = {}, {}
    words = ["ab", "c", "de"]
    lex = {"ab": "p1 p2", "c": "p3", "de": "p2 p1"}
    with kaldi_io.MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/ali.ark") as aw, \
            kaldi_io.IntVectorWriter(f"ark:{d}/tid.ark") as tw, \
            kaldi_io.MatrixWriter(f"ark:{d}/ivec.ark") as iw:
        for i in range(12):
            key = f"utt{i:02d}"
            t = int(rng.integers(20, 70))
            feats[key] = (rng.standard_normal((t, 6)) * 3 + 1).astype(
                np.float32)
            spk[key] = f"s{i % 2}"
            fw[key] = feats[key]
            pdfs = np.repeat(rng.integers(0, 3, t // 5 + 1), 5)[:t]
            aw[key] = pdfs.astype(np.int32)
            # tid = 2 * pdf + 1 or 2: the mono model's self-loop/forward
            tw[key] = (2 * pdfs + 1 + (np.arange(t) % 2)).astype(np.int32)
            if i != 3:   # one utterance without ivectors
                iw[key] = rng.standard_normal(
                    ((t + 9) // 10, 3)).astype(np.float32)
    with kaldi_io.MatrixWriter(f"ark:{d}/cmvn.ark") as w:
        for s in ("s0", "s1"):
            w[s] = sum(acc_cmvn_stats(v) for k, v in feats.items()
                       if spk[k] == s)
    with kaldi_io.MatrixWriter(f"ark:{d}/trans.ark") as w:
        w["s0"] = rng.standard_normal((6, 7)).astype(np.float32)
    kaldi_io.write_matrix(str(d / "lda.mat"),
                          rng.standard_normal((8, 6 * 3)).astype(np.float32))
    (d / "utt2spk").write_text("".join(f"{k} {s}\n" for k, s in spk.items()))
    (d / "text").write_text("".join(
        f"utt{i:02d} {words[i % 3]} {words[(i + 1) % 3]}"
        + (" oov" if i == 7 else "") + "\n" for i in range(12)))
    (d / "lexicon.txt").write_text("".join(f"{w} {p}\n"
                                           for w, p in lex.items()))
    (d / "phones.txt").write_text("p1 1\np2 2\np3 3\n")
    (d / "final.mdl").write_bytes(_make_mono_ctc_model(3).read())
    # a triphone tree over the 3 phones that answers no window with p3 in
    # the centre and p2 on its right ("c de")
    write_tree(str(d / "tree"), ContextDependency(3, 1, TE(1, [
        None, SE(2, [2], CE(1), CE(0)), SE(0, [1], CE(3), CE(2)),
        TE(2, [CE(4), CE(5), None, CE(6)])])))
    return d


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _both(tmp_path, argv_of):
    """Run both packages' prepare_egs on ``argv_of(out_prefix)`` → the two
    outputs' (prefix, stdout)."""
    from kaldi_ctc_tpu.cli import prepare_egs as jax_cli
    from kaldi_ctc_tpu_torch.cli import prepare_egs as port_cli

    out = {}
    for tag, cli in (("jax", jax_cli), ("port", port_cli)):
        prefix = str(tmp_path / tag)
        out[tag] = (prefix, _run(cli.main, argv_of(prefix)))
    return out


def _egs(spec):
    from kaldi_ctc_tpu_torch.data.egs_io import SequentialEgsReader
    return list(SequentialEgsReader(spec))


def _assert_same_archive(a, b, exact=True):
    if exact:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        return
    ea, eb = _egs(f"ark:{a}"), _egs(f"ark:{b}")
    assert [e.key for e in ea] == [e.key for e in eb] and ea
    for x, y in zip(ea, eb):
        np.testing.assert_array_equal(x.labels, y.labels)
        np.testing.assert_allclose(x.feats, y.feats, rtol=0,
                                   atol=FEATS_TOL * max(
                                       1.0, float(np.abs(y.feats).max())))


# case → (alignment archive or None for the flat-start route, extra
# flags, whether the archives must be equal byte for byte)
GET_CASES = {
    "ali": ("ali", [], True),
    "ali_cmvn": ("ali", ["--cmvn", "ark:{d}/cmvn.ark", "--utt2spk",
                         "{d}/utt2spk", "--compress", "0"], True),
    "tid": ("tid", ["--trans-model", "{d}/final.mdl"], True),
    "deltas": ("ali", ["--add-deltas", "2", "--compress", "0"], False),
    "lda": ("ali", ["--splice-left", "1", "--splice-right", "1",
                    "--transform", "{d}/lda.mat", "--compress", "0"], True),
    "fmllr": ("ali", ["--transforms", "ark:{d}/trans.ark", "--utt2spk",
                      "{d}/utt2spk", "--compress", "0"], True),
    "ivectors": ("ali", ["--online-ivectors", "ark:{d}/ivec.ark"], True),
    "const": ("ali", ["--const-feat-dim", "2", "--max-allow-frames", "50"],
              True),
    "split": ("ali", ["--num-archives", "3", "--random", "1", "--seed", "4"],
              True),
    "flat": (None, ["--text", "{d}/text", "--lexicon", "{d}/lexicon.txt",
                    "--cmvn", "ark:{d}/cmvn.ark"], True),
    "flat_phones": (None, ["--text", "{d}/text", "--lexicon",
                           "{d}/lexicon.txt", "--phones", "{d}/phones.txt"],
                    True),
    # context-dependent targets: the tree's pdfs + 1, and the utterances
    # with a context the tree does not answer skipped as OOV
    "flat_tree": (None, ["--text", "{d}/text", "--lexicon",
                         "{d}/lexicon.txt", "--phones", "{d}/phones.txt",
                         "--tree", "{d}/tree", "--cmvn", "ark:{d}/cmvn.ark"],
                  True),
}


@pytest.mark.parametrize("case", sorted(GET_CASES))
def test_prepare_egs_get_equal_jax(data, tmp_path, case):
    ali, extra, exact = GET_CASES[case]
    extra = [x.format(d=data) for x in extra]
    if ali:
        extra += ["--ali", f"ark:{data}/{ali}.ark"]
    split = "--num-archives" in extra

    def argv(prefix):
        out = (f"ark:{prefix}.JOB.ark" if split else f"ark:{prefix}.ark")
        return ["get", "--feats", f"scp:{data}/feats.scp", "--output",
                out] + extra

    out = _both(tmp_path, argv)
    names = ([f".{j}.ark" for j in (1, 2, 3)] if split else [".ark"])
    for suffix in names:
        _assert_same_archive(out["jax"][0] + suffix, out["port"][0] + suffix,
                             exact)
    assert sum(len(_egs(f"ark:{out['port'][0]}{s}")) for s in names) >= 6


@pytest.fixture(scope="module")
def egs_ark(data, tmp_path_factory):
    """One archive from the JAX package's prepare_egs get."""
    from kaldi_ctc_tpu.cli import prepare_egs

    path = str(tmp_path_factory.mktemp("src") / "egs.ark")
    _run(prepare_egs.main, ["get", "--feats", f"scp:{data}/feats.scp",
                            "--ali", f"ark:{data}/ali.ark", "--output",
                            f"ark:{path}"])
    return path


SUB_CASES = {
    "copy": ["copy", "--num-archives", "2", "--random", "1", "--seed", "2"],
    "sort": ["sort"],
    "sort_window": ["sort", "--window", "3"],
    "shuffle": ["shuffle", "--buffer-size", "4", "--seed", "9",
                "--frame-subsampling-factor", "3", "--frame-shift", "1"],
    "subset": ["subset", "--n", "5"],
    "perturb": ["perturb", "--noise-scale", "0.2", "--seed", "1"],
    "relabel": ["relabel", "--ali", "ark:{d}/ali.ark"],
    "relabel_frames": ["relabel", "--ali", "ark:{d}/ali.ark",
                       "--frame-labels", "1"],
}


@pytest.mark.parametrize("case", sorted(SUB_CASES))
def test_prepare_egs_subcommands_equal_jax(data, egs_ark, tmp_path, case):
    cmd = [x.format(d=data) for x in SUB_CASES[case]]
    split = "--num-archives" in cmd
    out = _both(tmp_path, lambda prefix: cmd[:1] + [
        "--egs", f"ark:{egs_ark}", "--output",
        f"ark:{prefix}.JOB.ark" if split else f"ark:{prefix}.ark"] + cmd[1:])
    for suffix in ([".1.ark", ".2.ark"] if split else [".ark"]):
        _assert_same_archive(out["jax"][0] + suffix, out["port"][0] + suffix)


def test_prepare_egs_info_equal_jax(egs_ark, tmp_path):
    out = _both(tmp_path, lambda prefix: ["info", "--egs", f"ark:{egs_ark}"])
    assert out["port"][1] == out["jax"][1]
    assert json.loads(out["port"][1])["num_examples"] >= 6


def test_load_examples_equal_jax(data):
    """feats + alignments with CMVN, and transition-id alignments through
    a transition model: the same examples in both packages."""
    from kaldi_ctc_tpu.data import load_examples as jax_load
    from kaldi_ctc_tpu.utils.transition_model import read_transition_model
    from kaldi_ctc_tpu_torch.data import load_examples

    u2s = dict(line.split() for line in open(f"{data}/utt2spk"))
    tid = np.asarray(read_transition_model(
        f"{data}/final.mdl").tid_to_pdf(), np.int32)
    for kw in ({"ali_rspecifier": f"ark:{data}/ali.ark",
                "cmvn_rspecifier": f"ark:{data}/cmvn.ark", "utt2spk": u2s},
               {"ali_rspecifier": f"ark:{data}/tid.ark", "tid_to_pdf": tid},
               {"ali_rspecifier": f"ark:{data}/ali.ark", "collapse": False}):
        want = list(jax_load(f"scp:{data}/feats.scp", **kw))
        got = list(load_examples(f"scp:{data}/feats.scp", **kw))
        assert [e.key for e in got] == [e.key for e in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.labels, w.labels)
            np.testing.assert_allclose(g.feats, w.feats, rtol=0, atol=1e-6)
    assert os.path.exists(f"{data}/feats.scp")
