"""The port's decision trees against the JAX package's: ``write_tree`` /
``read_tree`` in Kaldi's binary format across the packages,
``labels_to_pdfs``, ``acc_tree_stats`` and its .npz files,
``cluster_phones`` / ``build_tree`` and the ``tree_tool`` CLI (byte-equal
trees), ``context_expand`` (equal FST arrays for N=1 and N=3), and the
flat-start triphone pipeline of tests/test_tree.py on the port's CLIs
with ``--device cpu``."""

import contextlib
import io
import json

import numpy as np
import pytest

INF = np.float32(np.inf)


def _trees(pkg):
    """Mono, handmade triphone and mixed trees built with ``pkg``'s
    node constructors."""
    import importlib
    t = importlib.import_module(f"{pkg}.utils.tree")
    tri = t.ContextDependency(N=3, P=1, root=t.TE(1, [None] + [
        t.SE(2, [2], t.CE((p - 1) * 2 + 1), t.CE((p - 1) * 2))
        for p in range(1, 6)]))
    mixed = t.ContextDependency(3, 1, t.SE(0, [1, 3], t.CE(7), t.TE(1, [
        None, t.CE(0), t.SE(-1, [0], t.CE(1), t.CE(2))])))
    return {"mono": t.mono_tree(6), "mono2": t.mono_tree(3, 2),
            "triphone": tri, "mixed": mixed}


@pytest.mark.parametrize("name", ["mono", "mono2", "triphone", "mixed"])
def test_write_tree_bytes_equal_and_cross_read(name, tmp_path):
    from kaldi_ctc_tpu.utils import tree as jt
    from kaldi_ctc_tpu_torch.utils import tree as pt

    jtree, ptree = _trees("kaldi_ctc_tpu")[name], _trees(
        "kaldi_ctc_tpu_torch")[name]
    jb, pb = io.BytesIO(), io.BytesIO()
    jt.write_tree(jb, jtree)
    pt.write_tree(pb, ptree)
    assert pb.getvalue() == jb.getvalue()
    (tmp_path / "jax.tree").write_bytes(jb.getvalue())
    (tmp_path / "port.tree").write_bytes(pb.getvalue())
    back = pt.read_tree(str(tmp_path / "jax.tree"))
    assert (back.N, back.P, back.root) == (jtree.N, jtree.P, jtree.root)
    back = jt.read_tree(str(tmp_path / "port.tree"))
    assert (back.N, back.P, back.root) == (ptree.N, ptree.P, ptree.root)
    assert ptree.num_pdfs == jtree.num_pdfs


def test_labels_to_pdfs_equal_jax():
    from kaldi_ctc_tpu.decoding.context import labels_to_pdfs as jl
    from kaldi_ctc_tpu_torch.decoding.context import labels_to_pdfs as pl

    rng = np.random.default_rng(0)
    for name in ("mono", "triphone", "mixed"):
        jtree = _trees("kaldi_ctc_tpu")[name]
        ptree = _trees("kaldi_ctc_tpu_torch")[name]
        hi = 7 if name == "mono" else 6
        for _ in range(20):
            phones = rng.integers(1, hi, int(rng.integers(1, 9))).astype(
                np.int32)
            try:
                want = jl(phones, jtree)
            except ValueError:
                with pytest.raises(ValueError):
                    pl(phones, ptree)
                continue
            got = pl(phones, ptree)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _utts(n=60, num_phones=6, dim=4, seed=0):
    """Seeded (feats, phones[, starts]) utterances whose means depend on
    the phone and its right neighbour, so splits on context pay."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((num_phones + 1, num_phones + 1, dim)) * 3
    out = []
    for i in range(n):
        seq = rng.integers(1, num_phones + 1, int(rng.integers(2, 7)))
        spans = rng.integers(2, 6, seq.shape[0])
        phones = np.repeat(seq, spans).astype(np.int32)
        nxt = np.repeat(np.append(seq[1:], 0), spans)
        feats = (means[phones, nxt] + rng.standard_normal(
            (phones.shape[0], dim))).astype(np.float32)
        if i % 5 == 0:
            starts = np.zeros(phones.shape[0], bool)
            starts[np.cumsum(spans) - spans] = True
            out.append((feats, phones, starts))
        else:
            out.append((feats, phones))
    return out


def _assert_stats_equal(got, want):
    assert list(got) == list(want)
    for e in want:
        assert got[e].count == want[e].count
        np.testing.assert_array_equal(got[e].sum, want[e].sum)
        np.testing.assert_array_equal(got[e].sumsq, want[e].sumsq)


@pytest.mark.parametrize("kw", [{}, {"ci_phones": [1]}, {"N": 1, "P": 0}])
def test_acc_tree_stats_equal_jax_and_npz_cross_load(kw, tmp_path):
    from kaldi_ctc_tpu.utils import tree_build as jb
    from kaldi_ctc_tpu_torch.utils import tree_build as pb

    want = jb.acc_tree_stats(_utts(), **kw)
    got = pb.acc_tree_stats(_utts(), **kw)
    _assert_stats_equal(got, want)
    jb.save_tree_stats(str(tmp_path / "jax.npz"), want)
    pb.save_tree_stats(str(tmp_path / "port.npz"), got)
    # each package reads the other's file as it reads its own
    loaded = jb.load_tree_stats(str(tmp_path / "jax.npz"))
    assert sorted(loaded) == sorted(want)
    _assert_stats_equal(pb.load_tree_stats(str(tmp_path / "jax.npz")),
                        loaded)
    _assert_stats_equal(jb.load_tree_stats(str(tmp_path / "port.npz")),
                        loaded)
    half = pb.sum_tree_stats([pb.acc_tree_stats(_utts()[:30], **kw),
                              pb.acc_tree_stats(_utts()[30:], **kw)])
    _assert_stats_equal(half, jb.sum_tree_stats(
        [jb.acc_tree_stats(_utts()[:30], **kw),
         jb.acc_tree_stats(_utts()[30:], **kw)]))


@pytest.mark.parametrize("kw", [
    {"max_leaves": 10},
    {"max_leaves": 14, "cluster_thresh": 40.0},
    {"thresh": 25.0, "num_phones": 8},
], ids=["leaves", "cluster", "thresh"])
def test_build_tree_bytes_equal_jax(kw):
    from kaldi_ctc_tpu.utils import tree as jt
    from kaldi_ctc_tpu.utils import tree_build as jb
    from kaldi_ctc_tpu_torch.utils import tree as pt
    from kaldi_ctc_tpu_torch.utils import tree_build as pb

    roots = [(True, True, [p]) for p in range(1, 7)]
    out = {}
    for tag, t, b in (("jax", jt, jb), ("port", pt, pb)):
        stats = b.acc_tree_stats(_utts())
        qs = b.cluster_phones(stats, [[p] for p in range(1, 7)])
        tree = b.build_tree(stats, qs, roots, **kw)
        buf = io.BytesIO()
        t.write_tree(buf, tree)
        out[tag] = (qs, buf.getvalue(), tree.num_pdfs)
    assert out["port"] == out["jax"]
    assert out["port"][2] > 6


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_tree_tool_chain_equal_jax(tmp_path):
    """acc-stats → sum-stats → questions → build → info through both
    packages' tree_tool: equal stats, questions and info, byte-equal
    trees."""
    from kaldi_ctc_tpu.cli import tree_tool as jcli
    from kaldi_ctc_tpu.utils import kaldi_io
    from kaldi_ctc_tpu.utils.tree_build import load_tree_stats
    from kaldi_ctc_tpu_torch.cli import tree_tool as pcli

    with kaldi_io.MatrixWriter(f"ark:{tmp_path}/feats.ark") as fw, \
            kaldi_io.IntVectorWriter(f"ark:{tmp_path}/ali.ark") as aw:
        for i, u in enumerate(_utts()):
            fw[f"u{i:03d}"] = u[0]
            aw[f"u{i:03d}"] = u[1]
    (tmp_path / "roots.int").write_text(
        "shared split 1 2\nnot-shared split 3\nshared not-split 4\n"
        "shared split 5 6\n")
    res = {}
    for tag, cli in (("jax", jcli), ("port", pcli)):
        d = tmp_path / tag
        d.mkdir()
        _stdout(cli.main, ["acc-stats", "--feats", f"ark:{tmp_path}/feats.ark",
                           "--ali", f"ark:{tmp_path}/ali.ark",
                           "--ci-phones", "4", "--output", f"{d}/a.npz"])
        _stdout(cli.main, ["acc-stats", "--feats", f"ark:{tmp_path}/feats.ark",
                           "--ali", f"ark:{tmp_path}/ali.ark",
                           "--subsample", "1", "--output", f"{d}/b.npz"])
        _stdout(cli.main, ["sum-stats", f"{d}/a.npz", f"{d}/b.npz",
                           "--output", f"{d}/sum.npz"])
        _stdout(cli.main, ["questions", "--stats", f"{d}/sum.npz",
                           "--output", f"{d}/questions.int"])
        for name, extra in (("tree", ["--max-leaves", "9"]),
                            ("tree_roots", ["--roots", f"{tmp_path}/roots.int",
                                            "--cluster-thresh", "30"])):
            _stdout(cli.main, ["build", "--stats", f"{d}/sum.npz",
                               "--questions", f"{d}/questions.int",
                               "--output", f"{d}/{name}"] + extra)
        info = _stdout(cli.main, ["info", "--tree", f"{d}/tree"])
        res[tag] = (d, json.loads(info.strip().splitlines()[-1]))
    jd, pd = res["jax"][0], res["port"][0]
    assert res["port"][1] == res["jax"][1]
    assert res["port"][1]["num_pdfs"] > 6
    for name in ("questions.int", "tree", "tree_roots"):
        assert (pd / name).read_bytes() == (jd / name).read_bytes(), name
    _assert_stats_equal(load_tree_stats(f"{pd}/sum.npz"),
                        load_tree_stats(f"{jd}/sum.npz"))


def _lg(pkg, phones_per_word, seed=0):
    """A phone:word acceptor of random word paths over ``pkg``'s
    NativeFst: loops, branches, a final weight."""
    import importlib
    wfst = importlib.import_module(f"{pkg}.decoding.wfst")
    rng = np.random.default_rng(seed)
    arcs, weights = [], []
    n = 1
    for w in range(1, 5):
        prev = 0
        pron = rng.integers(1, 6, phones_per_word)
        for j, p in enumerate(pron):
            dst = 0 if j == len(pron) - 1 else n
            if dst:
                n += 1
            arcs.append([prev, int(p), w if j == 0 else 0, dst])
            weights.append(float(rng.random()))
            prev = dst
    arcs.append([0, 0, 0, n])
    weights.append(0.5)
    finals = np.full(n + 1, INF, np.float32)
    finals[n] = 0.25
    return wfst.NativeFst.from_arrays(
        0, n + 1, np.asarray(arcs, np.int32),
        np.asarray(weights, np.float32), finals)


@pytest.mark.parametrize("name,ppw", [("mono", 3), ("triphone", 3),
                                      ("triphone", 1), ("mixed", 2)])
def test_context_expand_arrays_equal_jax(name, ppw):
    from kaldi_ctc_tpu.decoding.context import context_expand as jce
    from kaldi_ctc_tpu_torch.decoding.context import context_expand as pce

    jtree = _trees("kaldi_ctc_tpu")[name]
    ptree = _trees("kaldi_ctc_tpu_torch")[name]
    if name == "mixed":
        # the mixed tree answers only some windows: both raise alike
        try:
            want = jce(_lg("kaldi_ctc_tpu", ppw), jtree).to_arrays()
        except ValueError:
            with pytest.raises(ValueError):
                pce(_lg("kaldi_ctc_tpu_torch", ppw), ptree)
            return
    else:
        want = jce(_lg("kaldi_ctc_tpu", ppw), jtree).to_arrays()
    got = pce(_lg("kaldi_ctc_tpu_torch", ppw), ptree).to_arrays()
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert want[1].shape[0] > 4


ARPA = """\\data\\
ngram 1=5

\\1-grams:
-0.5 <s>
-0.5 </s>
-0.5 ab
-0.5 c
-0.8 de

\\end\\
"""


@pytest.fixture
def one_thread():
    """torch on one thread: the small models gain nothing from more, and
    the test workers run side by side."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flat_start_triphone_pipeline_on_the_port(tmp_path, one_thread):
    """tests/test_tree.py's flat start with context-dependent targets on
    the port's CLIs (``--device cpu``): transcripts + lexicon + triphone
    tree → egs → train → triphone TLG → word decode."""
    from kaldi_ctc_tpu_torch.cli import (decode_ctc, graph_tool, prepare_egs,
                                         train_ctc)
    from kaldi_ctc_tpu_torch.decoding.context import labels_to_pdfs
    from kaldi_ctc_tpu_torch.utils import kaldi_io
    from kaldi_ctc_tpu_torch.utils.tree import write_tree

    lexicon = {"ab": ["p1", "p2"], "c": ["p3"], "de": ["p4", "p5"]}
    phone_ids = {"p1": 1, "p2": 2, "p3": 3, "p4": 4, "p5": 5}
    tree = _trees("kaldi_ctc_tpu_torch")["triphone"]
    tree_path = tmp_path / "tree"
    write_tree(str(tree_path), tree)
    lex_path = tmp_path / "lexicon.txt"
    lex_path.write_text("\n".join(
        f"{w} {' '.join(ps)}" for w, ps in lexicon.items()) + "\n")
    phones_path = tmp_path / "phones.txt"
    phones_path.write_text("\n".join(
        f"{p} {i}" for p, i in phone_ids.items()) + "\n")
    arpa_path = tmp_path / "lm.arpa"
    arpa_path.write_text(ARPA)

    rng = np.random.default_rng(3)
    words_list = list(lexicon)
    fark = tmp_path / "feats.ark"
    lines = []
    D = 12
    with kaldi_io.MatrixWriter(f"ark:{fark}") as fw:
        for i in range(16):
            ws = []
            for _ in range(int(rng.integers(1, 4))):
                w = words_list[int(rng.integers(3))]
                while ws and w == ws[-1]:
                    w = words_list[int(rng.integers(3))]
                ws.append(w)
            phones = [phone_ids[p] for w in ws for p in lexicon[w]]
            labels = labels_to_pdfs(np.asarray(phones), tree)
            span = 8
            t = len(labels) * span
            feats = rng.standard_normal((t, D)).astype(np.float32) * 0.1
            for j, lab in enumerate(labels):
                feats[j * span:(j + 1) * span, int(lab) % D] += 2.0
            fw[f"utt{i}"] = feats
            lines.append(f"utt{i} {' '.join(ws)}")
    text_path = tmp_path / "text"
    text_path.write_text("\n".join(lines) + "\n")

    egs = tmp_path / "egs.ark"
    prepare_egs.main([
        "get", "--feats", f"ark:{fark}", "--text", str(text_path),
        "--lexicon", str(lex_path), "--phones", str(phones_path),
        "--tree", str(tree_path), "--output", f"ark:{egs}"])

    exp = str(tmp_path / "exp_tri")
    train_ctc.main([
        "--egs", f"ark:{egs}", "--num-targets", "11",
        "--hidden-dim", "24", "--num-layers", "2",
        "--epochs", "300", "--minibatch-size", "16",
        "--initial-learning-rate", "3e-2", "--final-learning-rate", "3e-3",
        "--momentum", "0.9", "--dir", exp, "--checkpoint-period", "100",
        "--device", "cpu"])

    tlg = str(tmp_path / "TLG.fst")
    graph_tool.main([
        "make-tlg", "--lexicon", str(lex_path), "--arpa", str(arpa_path),
        "--phones", str(phones_path), "--tree", str(tree_path),
        "--output", tlg])

    out = _stdout(decode_ctc.main, [
        "--feats", f"ark:{fark}", "--dir", exp,
        "--method", "wfst", "--graph", tlg,
        "--words", tlg + ".words.txt",
        "--use-priors", "0", "--blank-threshold", "0.98",
        "--text", str(text_path), "--minibatch-size", "8",
        "--device", "cpu"])
    result = json.loads(out.strip().splitlines()[-1])
    assert result["label_error_rate"] < 0.1, result
