"""The port's graph and LM builders against the JAX package's:
``build_tlg`` on a synthetic language (with and without determinize,
push, silence and a triphone tree) gives equal FST arrays and tables;
every ``graph_tool`` and ``lm_tool`` subcommand writes byte-equal FSTs and
tables, equal const-ARPA arrays and equal JSON; ``dump_lg`` writes the
same LG; and ``synth_lang`` is bit-identical."""

import contextlib
import io
import json
import os
import runpy

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 150


def _lang(pkg, **kw):
    import importlib
    synth = importlib.import_module(f"{pkg}.data.synth_lang")
    return synth.make_language(**{"vocab": VOCAB, "seed": 0, **kw})


def _tree(pkg, num_phones):
    """A triphone tree over ``num_phones`` phones that splits each centre
    phone on whether its right neighbour is in the lower half."""
    import importlib
    t = importlib.import_module(f"{pkg}.utils.tree")
    low = list(range(1, num_phones // 2 + 1))
    return t.ContextDependency(N=3, P=1, root=t.TE(1, [None] + [
        t.SE(2, low, t.CE(2 * (p - 1) + 1), t.CE(2 * (p - 1)))
        for p in range(1, num_phones + 1)]))


@pytest.mark.parametrize("kw", [
    {},
    {"determinize": False},
    {"push": False},
    {"sil_phone": "p01", "sil_prob": 0.3},
    {"tree": True},
    {"tree": True, "determinize": False},
], ids=["det_push", "nodet", "nopush", "sil", "tree", "tree_nodet"])
def test_build_tlg_equal_jax(kw):
    import io as _io

    from kaldi_ctc_tpu.decoding.graph import build_tlg as jbuild
    from kaldi_ctc_tpu.lm import parse_arpa as jparse
    from kaldi_ctc_tpu_torch.decoding.graph import build_tlg as pbuild
    from kaldi_ctc_tpu_torch.lm import parse_arpa as pparse

    out = {}
    for tag, pkg, build, parse in (
            ("jax", "kaldi_ctc_tpu", jbuild, jparse),
            ("port", "kaldi_ctc_tpu_torch", pbuild, pparse)):
        lang = _lang(pkg, num_phones=12)
        args = dict(kw)
        if args.pop("tree", False):
            args["tree"] = _tree(pkg, lang.num_phones)
        timings = {}
        tlg, words, phones = build(
            lang.lexicon, parse(_io.StringIO(lang.arpa_text)),
            timings=timings, **args)
        out[tag] = (tlg.to_arrays(), words, phones, sorted(timings))
    (pstart, *parrs), pwords, pphones, pstages = out["port"]
    (jstart, *jarrs), jwords, jphones, jstages = out["jax"]
    assert pstart == jstart
    for g, w in zip(parrs, jarrs):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (pwords, pphones, pstages) == (jwords, jphones, jstages)
    assert parrs[0].shape[0] > 1000


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def lang_dir(tmp_path_factory):
    """lexicon.txt, lm.arpa, phones.txt, a tree and a text of the
    synthetic language, written with the JAX package."""
    from kaldi_ctc_tpu.utils.tree import write_tree

    d = tmp_path_factory.mktemp("lang")
    lang = _lang("kaldi_ctc_tpu", num_phones=12)
    (d / "lexicon.txt").write_text("".join(
        w + " " + " ".join(p) + "\n" for w, p in lang.lexicon))
    (d / "lm.arpa").write_text(lang.arpa_text)
    (d / "phones.txt").write_text("<eps> 0\n" + "".join(
        f"p{i:02d} {i}\n" for i in range(1, lang.num_phones + 1)))
    write_tree(str(d / "tree"), _tree("kaldi_ctc_tpu", lang.num_phones))
    rng = np.random.default_rng(1)
    (d / "text").write_text("".join(
        f"u{i} " + " ".join(lang.words[w] for w in lang.sample_sentence(
            rng, 3, 9)) + " zzz_oov\n" * (i == 2) + "\n" * (i != 2)
        for i in range(6)))
    return d


# subcommand → argv (``{d}``: the language dir, ``{o}``: this package's
# output dir, ``{j}``: the JAX package's) and the files it writes
GRAPH_CASES = {
    "make_tlg": (["make-tlg", "--lexicon", "{d}/lexicon.txt", "--arpa",
                  "{d}/lm.arpa", "--phones", "{d}/phones.txt", "--output",
                  "{o}/TLG.fst"],
                 ["TLG.fst", "TLG.fst.words.txt", "TLG.fst.phones.txt"]),
    "make_tlg_tree": (["make-tlg", "--lexicon", "{d}/lexicon.txt", "--arpa",
                       "{d}/lm.arpa", "--phones", "{d}/phones.txt",
                       "--tree", "{d}/tree", "--output", "{o}/CTC.fst",
                       "--write-words", "{o}/words.txt", "--write-phones",
                       "{o}/phones.txt"],
                      ["CTC.fst", "words.txt", "phones.txt"]),
    "make_tlg_nodet_sil": (["make-tlg", "--lexicon", "{d}/lexicon.txt",
                            "--arpa", "{d}/lm.arpa", "--sil-phone", "p01",
                            "--determinize", "0", "--push", "0",
                            "--output", "{o}/LG.fst"],
                           ["LG.fst", "LG.fst.words.txt",
                            "LG.fst.phones.txt"]),
}
FST_CASES = {
    "make_ctc": ["make-ctc", "--graph", "{j}/LG.fst", "--output",
                 "{o}/ctc.fst"],
    "determinize": ["determinize", "--graph", "{j}/LGd.fst", "--output",
                    "{o}/det.fst"],
    "minimize": ["minimize", "--graph", "{j}/det.fst", "--output",
                 "{o}/min.fst"],
    "push": ["push", "--graph", "{j}/min.fst", "--output", "{o}/push.fst"],
    "connect": ["connect", "--graph", "{j}/LG.fst", "--output",
                "{o}/conn.fst"],
    "compose": ["compose", "--a", "{j}/L.fst", "--b", "{j}/G.fst",
                "--output", "{o}/LG2.fst"],
}
INFO_CASES = {
    "info": ["info", "--graph", "{j}/TLG.fst"],
    "info_stochastic": ["info", "--graph", "{j}/LG.fst",
                        "--check-stochastic", "1"],
    "info_ctc_stochastic": ["info", "--graph", "{j}/TLG.fst",
                            "--check-stochastic", "1"],
}


def _run_both(cli_name, argv, lang_dir, tmp_path):
    """Run ``cli_name`` of both packages on ``argv`` → {tag: (dir,
    stdout)}; the JAX package runs first, so ``{j}`` names its outputs."""
    import importlib

    out = {}
    for tag, pkg in (("jax", "kaldi_ctc_tpu"), ("port", "kaldi_ctc_tpu_torch")):
        cli = importlib.import_module(f"{pkg}.cli.{cli_name}")
        o = tmp_path / tag
        o.mkdir(exist_ok=True)
        fmt = [a.format(d=lang_dir, o=o, j=tmp_path / "jax") for a in argv]
        out[tag] = (o, _stdout(cli.main, fmt))
    return out


@pytest.fixture(scope="module")
def graphs(lang_dir, tmp_path_factory):
    """The JAX package's LG.fst, TLG.fst, L.fst, G.fst, their composition
    and its determinized and minimized forms, as inputs of the per-FST
    subcommands."""
    from kaldi_ctc_tpu.cli import graph_tool, lm_tool
    from kaldi_ctc_tpu.data.synth_lang import make_language
    from kaldi_ctc_tpu.decoding.wfst import NativeFst
    from kaldi_ctc_tpu.lm.lexicon import (add_lex_disambig,
                                          lexicon_to_fst_arrays)

    j = tmp_path_factory.mktemp("graphs")
    for args in GRAPH_CASES["make_tlg"][0], GRAPH_CASES[
            "make_tlg_nodet_sil"][0]:
        _stdout(graph_tool.main, [a.format(d=lang_dir, o=j) for a in args])
    lang = make_language(vocab=VOCAB, num_phones=12, seed=0)
    lexicon, _ = add_lex_disambig(lang.lexicon)
    start, n, arcs, w, fin, _, words = lexicon_to_fst_arrays(
        lexicon, phone_to_id={f"p{i:02d}": i for i in range(1, 13)},
        sil_phone=None, sil_prob=0.5)
    NativeFst.from_arrays(start, n, arcs, w, fin).write(f"{j}/L.fst")
    (j / "L.words.txt").write_text("".join(
        f"{w} {i}\n" for w, i in sorted(words.items(), key=lambda x: x[1])))
    _stdout(lm_tool.main, ["arpa-to-fst", "--arpa", f"{lang_dir}/lm.arpa",
                           "--words", f"{j}/L.words.txt", "--output",
                           f"{j}/G.fst"])
    # L with its disambiguation symbols ∘ G: determinize-star's input
    _stdout(graph_tool.main, ["compose", "--a", f"{j}/L.fst", "--b",
                              f"{j}/G.fst", "--output", f"{j}/LGd.fst"])
    _stdout(graph_tool.main, ["determinize", "--graph", f"{j}/LGd.fst",
                              "--output", f"{j}/det.fst"])
    _stdout(graph_tool.main, ["minimize", "--graph", f"{j}/det.fst",
                              "--output", f"{j}/min.fst"])
    return j


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_tool_make_tlg_files_equal_jax(case, lang_dir, tmp_path):
    argv, files = GRAPH_CASES[case]
    out = _run_both("graph_tool", argv, lang_dir, tmp_path)
    for name in files:
        assert ((out["port"][0] / name).read_bytes()
                == (out["jax"][0] / name).read_bytes()), name
    assert (out["port"][0] / files[0]).stat().st_size > 10_000


@pytest.mark.parametrize("case", sorted(FST_CASES))
def test_graph_tool_fst_ops_files_equal_jax(case, graphs, lang_dir,
                                            tmp_path):
    import shutil
    argv = FST_CASES[case]
    for f in os.listdir(graphs):
        shutil.copy(graphs / f, tmp_path / f)
    out = {}
    import importlib
    for tag, pkg in (("jax", "kaldi_ctc_tpu"), ("port", "kaldi_ctc_tpu_torch")):
        cli = importlib.import_module(f"{pkg}.cli.graph_tool")
        o = tmp_path / tag
        o.mkdir()
        _stdout(cli.main, [a.format(j=graphs, o=o) for a in argv])
        out[tag] = o
    name = os.path.basename(argv[-1])
    assert (out["port"] / name).read_bytes() == (out["jax"] / name).read_bytes()
    assert (out["port"] / name).stat().st_size > 1000


@pytest.mark.parametrize("case", sorted(INFO_CASES))
def test_graph_tool_info_json_equal_jax(case, graphs, tmp_path):
    import importlib
    lines = {}
    for tag, pkg in (("jax", "kaldi_ctc_tpu"), ("port", "kaldi_ctc_tpu_torch")):
        cli = importlib.import_module(f"{pkg}.cli.graph_tool")
        out = _stdout(cli.main, [a.format(j=graphs) for a in INFO_CASES[case]])
        lines[tag] = json.loads(out.strip().splitlines()[-1])
    assert lines["port"] == lines["jax"]
    assert lines["port"]["num_arcs"] > 1000


LM_CASES = {
    "arpa_to_fst": (["arpa-to-fst", "--arpa", "{d}/lm.arpa", "--output",
                     "{o}/G.fst"], ["G.fst", "G.fst.words.txt"]),
    "arpa_to_fst_words": (["arpa-to-fst", "--arpa", "{d}/lm.arpa", "--words",
                           "{j}/G.fst.words.txt", "--output", "{o}/G2.fst",
                           "--write-words", "{o}/w2.txt"],
                          ["G2.fst", "w2.txt"]),
    "compile_const": (["compile-const", "--arpa", "{d}/lm.arpa", "--output",
                       "{o}/G.carpa.npz"], ["G.carpa.npz"]),
    "perplexity": (["perplexity", "--arpa", "{d}/lm.arpa", "--text",
                    "{d}/text"], []),
    "perplexity_const": (["perplexity", "--const-arpa", "{j}/G.carpa.npz",
                          "--text", "{d}/text"], []),
}


def test_lm_tool_subcommands_equal_jax(lang_dir, tmp_path):
    """Every lm_tool subcommand, in order (the later cases read the JAX
    package's earlier outputs): byte-equal FSTs and tables, equal
    const-ARPA arrays, equal perplexity JSON."""
    for case in ("arpa_to_fst", "arpa_to_fst_words", "compile_const",
                 "perplexity", "perplexity_const"):
        argv, files = LM_CASES[case]
        out = _run_both("lm_tool", argv, lang_dir, tmp_path)
        for name in files:
            got, want = out["port"][0] / name, out["jax"][0] / name
            if name.endswith(".npz"):
                with np.load(got) as g, np.load(want) as w:
                    assert sorted(g.files) == sorted(w.files)
                    for k in w.files:
                        assert g[k].dtype == w[k].dtype, k
                        np.testing.assert_array_equal(g[k], w[k])
            else:
                assert got.read_bytes() == want.read_bytes(), name
        if case.startswith("perplexity"):
            port = json.loads(out["port"][1].strip().splitlines()[-1])
            jax = json.loads(out["jax"][1].strip().splitlines()[-1])
            assert port == jax and port["num_utts"] == 6


def test_dump_lg_equal_jax(tmp_path, monkeypatch):
    """tools/dump_lg.py and the port's ``python -m
    kaldi_ctc_tpu_torch.tools.dump_lg``: the same LG bytes and the same
    printed line but for the seconds."""
    import tempfile

    from kaldi_ctc_tpu.decoding.wfst import NativeFst
    from kaldi_ctc_tpu_torch.tools import dump_lg

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    write = NativeFst.write
    # the JAX tool writes under /tmp: its file goes to jax_dir instead
    monkeypatch.setattr(NativeFst, "write", lambda self, path: write(
        self, str(jax_dir / os.path.basename(path))))
    jax_main = runpy.run_path(os.path.join(ROOT, "tools", "dump_lg.py"))[
        "main"]
    lines = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(VOCAB, 1)
        dump_lg.main(VOCAB, 1)
    lines = buf.getvalue().strip().splitlines()
    name = f"lg_v{VOCAB}.fst"
    assert ((tmp_path / name).read_bytes()
            == (jax_dir / name).read_bytes())

    def counts(line):
        return line.split(" front_s=")[0]

    assert counts(lines[1]) == counts(lines[0])
    assert lines[1].endswith(f"-> {tmp_path / name}")
    assert "LG states=" in lines[1]


@pytest.mark.parametrize("kw", [{}, {"num_phones": 20}, {"num_phones": 71},
                                {"vocab": 300, "seed": 4}])
def test_synth_lang_bit_identical(kw):
    from kaldi_ctc_tpu.data import synth_lang as js
    from kaldi_ctc_tpu_torch.data import synth_lang as ps

    want, got = _lang("kaldi_ctc_tpu", **kw), _lang("kaldi_ctc_tpu_torch",
                                                     **kw)
    assert got.words == want.words and got.lexicon == want.lexicon
    assert got.arpa_text == want.arpa_text
    assert got.num_phones == want.num_phones
    for g, w in zip(got.prons, want.prons):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.uni_p, want.uni_p)
    for table in ("bi", "tri"):
        g, w = getattr(got, table), getattr(want, table)
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k][0], w[k][0])
            np.testing.assert_array_equal(g[k][1], w[k][1])
    rj, rp = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(5):
        sent = got.sample_sentence(rp)
        assert sent == want.sample_sentence(rj)
        phones = np.concatenate([got.prons[w] for w in sent])
        post = ps.synth_posteriors(phones, got.num_phones, rp)
        ref = js.synth_posteriors(phones, want.num_phones, rj)
        assert post.dtype == ref.dtype
        np.testing.assert_array_equal(post, ref)
        hyp = rp.integers(0, 9, int(rp.integers(0, 12))).tolist()
        rj.integers(0, 9, int(rj.integers(0, 12)))
        assert ps.edit_distance(sent, hyp) == js.edit_distance(sent, hyp)
    assert ps.edit_distance([], [1, 2]) == js.edit_distance([], [1, 2]) == 2
