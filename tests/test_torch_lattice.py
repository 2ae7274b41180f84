"""The lattice chain of the port held to the JAX package's on the CPU:
``decode_lattice`` and ``determinize_lattice_pruned`` on seeded score
rows over a word-loop graph, the text and binary archives read across
the packages, push/minimize, MBR, word alignment, LM rescoring and ARPA /
const-ARPA scoring; then ``decode_ctc --lattice [--determinize 1]``,
``score_lattices`` and every ``lattice_tool`` subcommand run by both
packages' CLIs on one JAX-written model directory and graph.

Both packages run the same host code over the same native library
sources, so the archives they write from the same inputs are identical,
byte for byte.  decode_ctc's lattices come from each package's own
forward (XLA's against torch's f32 sums, ~1e-6 apart), so there the
structure and the best paths are equal and the weights agree to
WEIGHT_RTOL.  The fixtures are built here."""

import contextlib
import io
import json

import numpy as np
import pytest

from tests.test_torch_cli import ARPA, LEXICON, PHONE_IDS, setup  # noqa: F401

# decode_ctc's lattice weights: sums of up to ~60 frames' scores, each
# from the two packages' f32 forwards (~1e-6 apart), printed to 6
# significant digits, so a last printed digit may differ
WEIGHT_RTOL, WEIGHT_ATOL = 2e-5, 1e-5
LATTICE_FLAGS = ["--lattice-beam", "3", "--max-active", "200"]


def _word_loop(pkg, n_words=3):
    """A CTC graph over a word loop: word l = label l (tests/test_cli_e2e)."""
    arcs, weights = [], []
    for lab in range(1, n_words + 1):
        arcs += [[0, lab, lab, lab], [lab, lab, 0, lab], [lab, 0, 0, 0]]
        weights += [1.0, 0.0, 0.0]
    finals = np.full(n_words + 1, np.inf, np.float32)
    finals[0] = 0.0
    return pkg.NativeFst.from_arrays(
        0, n_words + 1, np.asarray(arcs, np.int32),
        np.asarray(weights, np.float32), finals).make_ctc_graph()


def _rows(seed=3, n=4):
    rng = np.random.default_rng(seed)
    return [(f"u{i}", (rng.standard_normal((int(rng.integers(8, 20)), 4))
                       * 2).astype(np.float32)) for i in range(n)]


def _pkgs():
    from kaldi_ctc_tpu.decoding import det_lattice as jdet
    from kaldi_ctc_tpu.decoding import lattice as jlat
    from kaldi_ctc_tpu.decoding import wfst as jwfst
    from kaldi_ctc_tpu_torch.decoding import det_lattice as tdet
    from kaldi_ctc_tpu_torch.decoding import lattice as tlat
    from kaldi_ctc_tpu_torch.decoding import wfst as twfst
    return {"jax": (jwfst, jlat, jdet), "port": (twfst, tlat, tdet)}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Each package's raw and determinized archives of the seeded rows."""
    d = tmp_path_factory.mktemp("lat")
    out = {}
    for who, (wfst, lat, det) in _pkgs().items():
        graph = _word_loop(wfst)
        raw, clat = d / f"{who}_raw.txt", d / f"{who}_det.txt"
        with open(raw, "w") as fr, open(clat, "w") as fc:
            for key, rows in _rows():
                la = lat.decode_lattice(graph, rows, lattice_beam=8.0)
                lat.write_lattice_text(fr, key, la)
                det.write_compact_lattice_text(
                    fc, key, det.determinize_lattice_pruned(la, det_beam=8.0))
        out[who] = (raw, clat)
    return out


@pytest.mark.parametrize("kind", ["raw", "det"])
def test_decode_and_determinize_identical_archives(archives, kind):
    i = 0 if kind == "raw" else 1
    port, jax_ = archives["port"][i].read_text(), archives["jax"][i].read_text()
    assert port == jax_ and port.count("\n\n") == 4


@pytest.mark.parametrize("compact", [0, 1])
def test_binary_and_text_round_trips(archives, tmp_path, compact):
    """Text → each package's binary writer → the other's reader → text:
    the same archive, both ways."""
    from kaldi_ctc_tpu.decoding import lattice_binary as jbin
    from kaldi_ctc_tpu_torch.decoding import lattice_binary as tbin

    src = str(archives["jax"][compact])
    text = archives["jax"][compact].read_text()
    for writer, reader in ((tbin, jbin), (jbin, tbin)):
        path = str(tmp_path / "bin.ark")
        read = (writer.read_compact_lattice_ark if compact
                else writer.read_lattice_ark)
        cls = (writer.BinaryCompactLatticeWriter if compact
               else writer.BinaryLatticeWriter)
        with cls(path) as w:
            for key, la in read(src):
                w.write(key, la)
        assert reader._sniff_binary(path)
        back = (reader.read_compact_lattice_ark if compact
                else reader.read_lattice_ark)
        buf = io.StringIO()
        write = (_pkgs()["jax"][2].write_compact_lattice_text if compact
                 else _pkgs()["jax"][1].write_lattice_text)
        for key, la in back(path):
            write(buf, key, la)
        assert buf.getvalue() == text


def _compact_ops(pkg):
    if pkg == "jax":
        from kaldi_ctc_tpu.decoding import det_lattice as det
        from kaldi_ctc_tpu.decoding import lattice_ops as ops
        from kaldi_ctc_tpu.decoding import mbr
    else:
        from kaldi_ctc_tpu_torch.decoding import det_lattice as det
        from kaldi_ctc_tpu_torch.decoding import lattice_ops as ops
        from kaldi_ctc_tpu_torch.decoding import mbr
    return det, ops, mbr


def test_push_minimize_and_mbr_equal(archives):
    """lattice_ops' push and minimize write the same archives; MBR's
    one-best, its risk, the sausage bins and times are the same."""
    out = {}
    for who in ("jax", "port"):
        det, ops, mbr = _compact_ops(who)
        buf, res = io.StringIO(), []
        for key, clat in det.read_compact_lattice_text_ark(
                str(archives["jax"][1])):
            pushed = ops.push_compact_lattice_weights(
                ops.push_compact_lattice_strings(clat))
            det.write_compact_lattice_text(buf, key, pushed)
            det.write_compact_lattice_text(
                buf, key, ops.minimize_compact_lattice(clat))
            m = mbr.MinimumBayesRisk(clat)
            res.append((m.one_best, m.bayes_risk, m.sausage, m.times,
                        m.one_best_times, m.one_best_confidences,
                        mbr.compact_lattice_state_times(clat)))
        out[who] = (buf.getvalue(), res)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]


@pytest.fixture(scope="module")
def cli_lattices(setup, tmp_path_factory):  # noqa: F811
    """The JAX decode_ctc's raw and compact archives over
    test_torch_cli's model directory and TLG, and a bigram ARPA over its
    words with its const-ARPA form."""
    from kaldi_ctc_tpu.cli import decode_ctc
    from kaldi_ctc_tpu.lm import parse_arpa
    from kaldi_ctc_tpu.lm.const_arpa import compile_const_arpa

    d, exp, tlg = setup
    out = tmp_path_factory.mktemp("clis")
    base = ["--feats", f"scp:{d}/feats.scp", "--dir", exp, "--method",
            "wfst", "--graph", tlg, "--use-priors", "0"] + LATTICE_FLAGS
    paths = {}
    for det in (0, 1):
        paths[det] = str(out / f"lat{det}.txt")
        with contextlib.redirect_stdout(io.StringIO()):
            decode_ctc.main(base + ["--lattice", paths[det],
                                    "--determinize", str(det)])
    arpa = out / "bigram.arpa"
    arpa.write_text(_bigram_arpa(list(LEXICON)))
    compile_const_arpa(parse_arpa(str(arpa))).save(str(out / "lm.npz"))
    return d, exp, tlg, paths, out


def _bigram_arpa(words, seed=5):
    """A seeded bigram ARPA over ``words``."""
    rng = np.random.default_rng(seed)
    vocab = ["<s>", "</s>"] + words
    uni = [f"{-rng.uniform(0.3, 1.5):.4f} {w} {-rng.uniform(0.1, 0.5):.4f}"
           if w != "</s>" else f"{-rng.uniform(0.3, 1.5):.4f} {w}"
           for w in vocab]
    bi = [f"{-rng.uniform(0.1, 1.0):.4f} {a} {b}"
          for a in ["<s>"] + words for b in words + ["</s>"]
          if rng.random() < 0.7]
    return ("\\data\\\n" f"ngram 1={len(uni)}\n" f"ngram 2={len(bi)}\n\n"
            "\\1-grams:\n" + "\n".join(uni) + "\n\n\\2-grams:\n"
            + "\n".join(bi) + "\n\n\\end\\\n")


def test_arpa_and_const_arpa_scores_equal(cli_lattices):
    """parse_arpa, sentence_logprob, the G acceptor's arrays and the
    const-ARPA trie score alike in both packages, and const-ARPA equals
    the ARPA model."""
    from kaldi_ctc_tpu import lm as jlm
    from kaldi_ctc_tpu.lm import const_arpa as jconst
    from kaldi_ctc_tpu_torch import lm as tlm
    from kaldi_ctc_tpu_torch.lm import const_arpa as tconst

    *_, out = cli_lattices
    path = str(out / "bigram.arpa")
    jm, tm = jlm.parse_arpa(path), tlm.parse_arpa(path)
    tc = tconst.ConstArpaLm.load(str(out / "lm.npz"))
    jc = jconst.compile_const_arpa(jm)
    rng = np.random.default_rng(0)
    words = list(LEXICON) + ["oov"]
    for _ in range(20):
        sent = [words[i] for i in rng.integers(0, len(words), 4)]
        want = jlm.sentence_logprob(jm, sent)
        assert tlm.sentence_logprob(tm, sent) == want
        # the trie stores f32 log-probabilities
        assert tlm.sentence_logprob(tc, sent) == pytest.approx(want,
                                                               abs=1e-5)
        for h in ((), ("<s>",), (sent[0],)):
            assert tc.logprob(sent[1], h) == jc.logprob(sent[1], h)
    syms = {w: i + 1 for i, w in enumerate(words[:-1])}
    for a, b in zip(jlm.arpa_to_fst_arrays(jm, syms),
                    tlm.arpa_to_fst_arrays(tm, syms)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_word_align_and_rescore_equal(cli_lattices):
    """word_align_lattice_lexicon and lmrescore_compact (ARPA and
    const-ARPA) give the same archives in both packages."""
    from kaldi_ctc_tpu.decoding import rescore as jres
    from kaldi_ctc_tpu.decoding import word_align as jwa
    from kaldi_ctc_tpu.lm import parse_arpa as jparse
    from kaldi_ctc_tpu_torch.decoding import rescore as tres
    from kaldi_ctc_tpu_torch.decoding import word_align as twa
    from kaldi_ctc_tpu_torch.lm import parse_arpa as tparse
    from kaldi_ctc_tpu_torch.lm.const_arpa import ConstArpaLm

    d, exp, tlg, paths, out = cli_lattices
    from kaldi_ctc_tpu_torch.utils.kaldi_io import read_symbol_table
    word_ids = read_symbol_table(tlg + ".words.txt", invert=True)
    syms = {i: w for w, i in word_ids.items()}
    prons = {word_ids[w]: [tuple(PHONE_IDS[p] for p in ps)]
             for w, ps in LEXICON.items()}
    res = {}
    for who, wa, rs, lm in (
            ("jax", jwa, jres, jparse(str(out / "bigram.arpa"))),
            ("port", twa, tres, tparse(str(out / "bigram.arpa"))),
            ("port_const", twa, tres,
             ConstArpaLm.load(str(out / "lm.npz")))):
        det = _compact_ops("port" if who != "jax" else "jax")[0]
        buf = io.StringIO()
        for key, clat in det.read_compact_lattice_text_ark(paths[1]):
            det.write_compact_lattice_text(
                buf, key, wa.word_align_lattice_lexicon(clat, prons))
            det.write_compact_lattice_text(
                buf, key, rs.lmrescore_compact(clat, lm, syms, lm_scale=0.5))
        res[who] = buf.getvalue()
    assert res["port"] == res["jax"]
    assert _weights_close(res["port_const"], res["jax"])


def _weights_close(a: str, b: str, rtol=0.0, atol=1e-5) -> bool:
    """Two text archives with the same tokens but weights within
    atol + rtol * |weight|."""
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        xs, ys = x.split(","), y.split(",")
        if len(xs) != len(ys) or not all(
                abs(float(p) - float(q)) <= atol + rtol * abs(float(q))
                for p, q in zip(xs[:2], ys[:2])) or xs[2:] != ys[2:]:
            return False
    return True


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _word_sequences(clat, margin):
    """{word sequence: cost} of every path of a CompactLattice within
    ``margin`` of its best path (total graph + acoustic cost)."""
    inf = float("inf")
    beta = [clat.final_graph_cost[s] + clat.final_acoustic_cost[s]
            for s in range(clat.num_states)]
    cost = [g + a for g, a in zip(clat.arc_graph_cost,
                                  clat.arc_acoustic_cost)]
    changed = True
    while changed:          # acyclic: settles within num_states passes
        changed = False
        for i in range(clat.num_arcs):
            v = cost[i] + beta[clat.arc_to[i]]
            if v < beta[clat.arc_from[i]]:
                beta[clat.arc_from[i]], changed = v, True
    limit = beta[clat.start] + margin
    out_arcs = [[] for _ in range(clat.num_states)]
    for i in range(clat.num_arcs):
        out_arcs[clat.arc_from[i]].append(i)
    seqs, stack = {}, [(clat.start, 0.0, ())]
    while stack:
        s, g, words = stack.pop()
        if g + beta[s] > limit:
            continue
        fin = clat.final_graph_cost[s] + clat.final_acoustic_cost[s]
        if fin < inf and g + fin <= limit:
            seqs[words] = min(seqs.get(words, inf), g + fin)
        for i in out_arcs[s]:
            w = clat.arc_word[i]
            stack.append((clat.arc_to[i], g + cost[i],
                          words + ((w,) if w else ())))
        assert len(stack) < 100000
    return seqs


def test_decode_ctc_lattices_match_jax(cli_lattices, tmp_path):
    """The port's decode_ctc --lattice (raw, then --determinize 1) on the
    same directory and graph as the JAX CLI's archives.  Raw: the same
    keys, states, arcs and labels, weights within WEIGHT_RTOL and
    WEIGHT_ATOL.  Determinized: pruning at --lattice-beam keeps or drops a
    word sequence whose cost lies at the beam's edge by the last bits of
    its weight, so the two packages' lattices hold the same word
    sequences within a third of the beam of the best path, each at the
    same cost within the tolerances.  Both: the same best paths and the
    same printed hypotheses."""
    from kaldi_ctc_tpu.decoding.det_lattice import \
        read_compact_lattice_text_ark as jread_c
    from kaldi_ctc_tpu.decoding.lattice import read_lattice_text_ark as jread
    from kaldi_ctc_tpu_torch.cli import decode_ctc

    d, exp, tlg, paths, _ = cli_lattices
    hyps = {}
    for det in (0, 1):
        mine = str(tmp_path / f"lat{det}.txt")
        hyps[det] = _run(decode_ctc.main, [
            "--feats", f"scp:{d}/feats.scp", "--dir", exp, "--method",
            "wfst", "--graph", tlg, "--use-priors", "0", "--device", "cpu",
            "--lattice", mine, "--determinize", str(det)] + LATTICE_FLAGS)
        read = jread_c if det else jread
        want = dict(read(paths[det]))
        got = dict(read(mine))
        assert sorted(got) == sorted(want) and len(got) == 8
        for key in want:
            assert list(got[key].best_path()[0]) == list(
                want[key].best_path()[0])
        if not det:
            with open(mine) as f, open(paths[det]) as g:
                assert _weights_close(f.read(), g.read(), WEIGHT_RTOL,
                                      WEIGHT_ATOL)
            continue
        beam = float(LATTICE_FLAGS[1])
        for key in want:
            ws, gs = (_word_sequences(want[key], beam / 3),
                      _word_sequences(got[key], beam / 3))
            assert sorted(gs) == sorted(ws) and ws
            for words, c in ws.items():
                assert abs(gs[words] - c) <= WEIGHT_ATOL + WEIGHT_RTOL * abs(c)
    assert hyps[0] == hyps[1]


def _tool_argv(cmd, lats, out, tlg, d):
    words = tlg + ".words.txt"
    o = str(out)
    return {
        "copy": ["copy", "--lattices", lats[0], "--output", o],
        "copy-binary": ["copy", "--lattices", lats[0], "--output", o,
                        "--binary", "1"],
        "scale": ["scale", "--lattices", lats[0], "--output", o,
                  "--acoustic-scale", "0.5", "--lm-scale", "2"],
        "prune": ["prune", "--lattices", lats[0], "--output", o,
                  "--beam", "2"],
        "best-path": ["best-path", "--lattices", lats[1], "--compact", "1",
                      "--words", words, "--output", o],
        "determinize": ["determinize", "--lattices", lats[0], "--output", o,
                        "--det-beam", "3"],
        "info": ["info", "--lattices", lats[0]],
        "mbr": ["mbr", "--lattices", lats[1], "--words", words, "--output",
                o, "--sausage", o + ".saus", "--ctm", o + ".ctm"],
        "nbest": ["nbest", "--lattices", lats[0], "--n", "3", "--output", o],
        "post": ["post", "--lattices", lats[0], "--output", o],
        "align-words": ["align-words", "--lattices", lats[1], "--output", o,
                        "--lexicon", str(d / "lexicon.txt"), "--words",
                        words, "--phones", str(d / "phones.txt")],
        "push": ["push", "--lattices", lats[1], "--output", o],
        "minimize": ["minimize", "--lattices", lats[1], "--output", o],
        "lmrescore": ["lmrescore", "--lattices", lats[1], "--arpa",
                      str(lats[2] / "bigram.arpa"), "--words", words,
                      "--lm-scale", "0.5", "--output", o],
        "lmrescore-const": ["lmrescore", "--lattices", lats[1],
                            "--const-arpa", str(lats[2] / "lm.npz"),
                            "--words", words, "--lm-scale", "0.5",
                            "--output", o],
    }[cmd]


@pytest.mark.parametrize("cmd", [
    "copy", "copy-binary", "scale", "prune", "best-path", "determinize",
    "info", "mbr", "nbest", "post", "align-words", "push", "minimize",
    "lmrescore", "lmrescore-const"])
def test_lattice_tool_matches_jax(cli_lattices, tmp_path, cmd):
    """Each lattice_tool subcommand of the port on the JAX CLI's archives
    writes (and prints) what the JAX CLI does."""
    from kaldi_ctc_tpu.cli import lattice_tool as jtool
    from kaldi_ctc_tpu_torch.cli import lattice_tool as ttool

    d, exp, tlg, paths, out = cli_lattices
    lats = (paths[0], paths[1], out)
    got = {}
    for who, tool in (("jax", jtool), ("port", ttool)):
        o = tmp_path / f"{who}.out"
        printed = _run(tool.main, _tool_argv(cmd, lats, o, tlg, d))
        files = [o.read_bytes() if o.exists() else b""]
        for ext in (".saus", ".ctm"):
            extra = tmp_path / f"{who}.out{ext}"
            files.append(extra.read_bytes() if extra.exists() else b"")
        got[who] = (printed, files)
    assert got["port"] == got["jax"]
    assert any(got["port"][1]) or got["port"][0]


def test_score_lattices_matches_jax(cli_lattices, tmp_path):
    """score_lattices' lm-weight sweep over raw and compact archives: the
    same JSON lines and best hypotheses from both packages."""
    from kaldi_ctc_tpu.cli import score_lattices as jscore
    from kaldi_ctc_tpu_torch.cli import score_lattices as tscore

    d, exp, tlg, paths, _ = cli_lattices
    for compact in (0, 1):
        got = {}
        for who, tool in (("jax", jscore), ("port", tscore)):
            o = tmp_path / f"{who}{compact}.txt"
            printed = _run(tool.main, [
                "--lattices", paths[compact], "--text",
                str(d / "words_ref.txt"), "--words", tlg + ".words.txt",
                "--acoustic-scale", "10", "--min-lmwt", "1", "--max-lmwt",
                "4", "--compact", str(compact), "--output", str(o)])
            got[who] = (printed, o.read_text())
        assert got["port"] == got["jax"]
        assert "best_wer" in json.loads(got["port"][0].splitlines()[-1])
