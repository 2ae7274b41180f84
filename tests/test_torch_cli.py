"""The port's decoding CLIs against the JAX package's on one experiment
directory, one feature archive and one TLG graph: decode_ctc's three
methods, nnet_compute's three outputs, serve's --graph words on
/recognize and at a stream's end, Kaldi archives across the two packages,
and the flags the port does not run yet."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

# nnet_compute: a 2-layer f32 model on identical features; f32 sums in
# another order (XLA's and torch's matmuls and scans).
NNET_TOL = 1e-5
# The label error rate is a ratio of integers; rtf is the only timing.
LER_TOL = 1e-6

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
LEXICON = {"ab": ["p1", "p2"], "c": ["p3"], "de": ["p4", "p5"]}
PHONE_IDS = {"p1": 1, "p2": 2, "p3": 3, "p4": 4, "p5": 5}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JAX init_model directory (8-dim input, 6 targets, 2x16 BLSTM),
    8 utterances of <= 60 frames in ark,scp with two speakers' CMVN, label
    and word references, and a TLG from a 3-word lexicon made by JAX's
    graph_tool make-tlg (tests/test_make_tlg.py's)."""
    from kaldi_ctc_tpu.cli import graph_tool, init_model
    from kaldi_ctc_tpu.features.cmvn import acc_cmvn_stats
    from kaldi_ctc_tpu.utils import kaldi_io

    d = tmp_path_factory.mktemp("cli")
    exp = str(d / "exp")
    init_model.main(["--input-dim", "8", "--num-targets", "6",
                     "--hidden-dim", "16", "--num-layers", "2",
                     "--param-stddev", "0.5", "--dir", exp, "--seed", "1"])
    rng = np.random.default_rng(0)
    feats, spk = {}, {}
    for i in range(8):
        feats[f"utt{i}"] = (rng.standard_normal(
            (int(rng.integers(20, 61)), 8)) * 2.0 + 0.5).astype(np.float32)
        spk[f"utt{i}"] = f"s{i % 2}"
    with kaldi_io.MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as w:
        for k, v in feats.items():
            w[k] = v
    with kaldi_io.MatrixWriter(f"ark:{d}/cmvn.ark") as w:
        for s in ("s0", "s1"):
            w[s] = sum(acc_cmvn_stats(v) for k, v in feats.items()
                       if spk[k] == s)
    (d / "utt2spk").write_text("".join(f"{k} {s}\n" for k, s in spk.items()))
    words = list(LEXICON)
    (d / "labels.txt").write_text("".join(
        f"utt{i} {' '.join(str(rng.integers(1, 6)) for _ in range(4))}\n"
        for i in range(8)))
    (d / "words_ref.txt").write_text("".join(
        f"utt{i} {words[i % 3]} {words[(i + 1) % 3]}\n" for i in range(8)))

    (d / "lexicon.txt").write_text("".join(
        f"{w} {' '.join(ps)}\n" for w, ps in LEXICON.items()))
    (d / "lm.arpa").write_text(ARPA)
    (d / "phones.txt").write_text("".join(
        f"{p} {i}\n" for p, i in PHONE_IDS.items()))
    tlg = str(d / "TLG.fst")
    graph_tool.main(["make-tlg", "--lexicon", str(d / "lexicon.txt"),
                     "--arpa", str(d / "lm.arpa"), "--phones",
                     str(d / "phones.txt"), "--output", tlg])
    return d, exp, tlg


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("method", ["greedy", "beam", "wfst"])
def test_decode_ctc_matches_jax(setup, method):
    """Both packages' decode_ctc print identical hypothesis files and the
    same error-rate line (LER_TOL), most hypotheses non-empty."""
    from kaldi_ctc_tpu.cli import decode_ctc as jdecode
    from kaldi_ctc_tpu_torch.cli import decode_ctc as tdecode

    d, exp, tlg = setup
    flags = ["--feats", f"scp:{d}/feats.scp", "--dir", exp,
             "--cmvn", f"ark:{d}/cmvn.ark", "--utt2spk", str(d / "utt2spk"),
             "--method", method, "--minibatch-size", "3"]
    if method == "wfst":
        flags += ["--graph", tlg, "--words", tlg + ".words.txt",
                  "--use-priors", "0", "--text", str(d / "words_ref.txt")]
    else:
        flags += ["--text", str(d / "labels.txt")]
    if method == "greedy":
        flags += ["--use-priors", "0"]
    outs = {}
    for who, main, extra in (("jax", jdecode.main, []),
                             ("port", tdecode.main, ["--device", "cpu"])):
        path = str(d / f"{who}_{method}.txt")
        line = _run(main, flags + ["--output", path] + extra)
        with open(path) as f:
            outs[who] = (f.read(), json.loads(line.strip().splitlines()[-1]))
    assert outs["port"][0] == outs["jax"][0]
    hyps = [line.split()[1:] for line in outs["port"][0].splitlines()]
    assert len(hyps) == 8 and sum(1 for h in hyps if h) >= 6, hyps
    if method == "wfst":
        assert set(w for h in hyps for w in h) <= set(LEXICON)
    got, want = outs["port"][1], outs["jax"][1]
    assert (got["errors"], got["ref_tokens"]) == (want["errors"],
                                                  want["ref_tokens"])
    assert abs(got["label_error_rate"] - want["label_error_rate"]) <= LER_TOL


@pytest.mark.parametrize("what", ["logits", "log-post", "post"])
def test_nnet_compute_matches_jax(setup, what):
    from kaldi_ctc_tpu.cli import nnet_compute as jnnet
    from kaldi_ctc_tpu_torch.cli import nnet_compute as tnnet
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    d, exp, _ = setup
    flags = ["--feats", f"scp:{d}/feats.scp", "--dir", exp,
             "--cmvn", f"ark:{d}/cmvn.ark", "--utt2spk", str(d / "utt2spk"),
             "--what", what, "--minibatch-size", "5"]
    jnnet.main(flags + ["--output", f"ark:{d}/j_{what}.ark"])
    tnnet.main(flags + ["--output", f"ark,scp:{d}/t_{what}.ark,"
                        f"{d}/t_{what}.scp", "--device", "cpu"])
    want = dict(SequentialMatrixReader(f"ark:{d}/j_{what}.ark"))
    got = dict(SequentialMatrixReader(f"scp:{d}/t_{what}.scp"))
    assert list(got) == list(want) and len(got) == 8
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=NNET_TOL)
        if what == "post":
            np.testing.assert_allclose(got[k].sum(-1), 1.0, atol=1e-5)


def _pcm(seconds, seed):
    """tests/test_serve.py's generator: band-limited-ish noise."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(int(16000 * seconds))).astype(
        np.float32)
    return (x - x.mean()) / (np.abs(x).max() + 1e-6) * 20000


def test_serve_graph_words_match_jax(tmp_path):
    """serve --graph --words with a Kaldi-archive --cmvn: the port's
    /recognize and /stream end words equal the JAX Engine's on the same
    audio, and a stream's words equal its /recognize words."""
    from kaldi_ctc_tpu.cli import init_model
    from kaldi_ctc_tpu.cli import serve as jserve
    from kaldi_ctc_tpu.features.cmvn import acc_cmvn_stats
    from kaldi_ctc_tpu_torch.cli import serve as tserve
    from kaldi_ctc_tpu_torch.decoding.wfst import NativeFst
    from kaldi_ctc_tpu_torch.utils.kaldi_io import MatrixWriter

    exp = str(tmp_path / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "6",
                     "--hidden-dim", "16", "--num-layers", "2",
                     "--bidirectional", "0", "--param-stddev", "0.5",
                     "--dir", exp])
    arcs, weights = [], []
    for lab in range(1, 6):
        arcs.append([0, lab, lab, lab]); weights.append(1.0)
        arcs.append([lab, lab, 0, lab]); weights.append(0.0)
        arcs.append([lab, 0, 0, 0]); weights.append(0.0)
    finals = np.full(6, np.inf, np.float32)
    finals[0] = 0.0
    gpath = str(tmp_path / "ctc.fst")
    NativeFst.from_arrays(0, 6, np.asarray(arcs, np.int32),
                          np.asarray(weights, np.float32),
                          finals).make_ctc_graph().write(gpath)
    (tmp_path / "words.txt").write_text(
        "".join(f"w{i} {i}\n" for i in range(6)))
    x = _pcm(1.0, 3)

    flags = ["--dir", exp, "--use-priors", "0", "--graph", gpath,
             "--words", str(tmp_path / "words.txt"), "--max-streams", "2",
             "--chunk-frames", "5"]
    plain = tserve.Engine(tserve.parse_args(flags + ["--device", "cpu"]))
    with MatrixWriter(f"ark:{tmp_path}/cmvn.ark") as w:
        w["global"] = acc_cmvn_stats(plain.feats_for(x).numpy())
    flags += ["--cmvn", f"ark:{tmp_path}/cmvn.ark"]
    jeng = jserve.Engine(jserve.parse_args(flags))
    teng = tserve.Engine(tserve.parse_args(flags + ["--device", "cpu"]))
    np.testing.assert_array_equal(teng.cmvn_stats, jeng.cmvn_stats)

    def stream(eng, x):
        slot = eng.stream_start()
        eng.stream_chunk(slot, x[:5000])
        eng.stream_chunk(slot, x[5000:])
        return eng.stream_end(slot)

    want, got = jeng.recognize(x), teng.recognize(x)
    assert got["words"] and got["words"] == want["words"]
    assert got["text"] == want["text"] and got["labels"] == want["labels"]
    s_want, s_got = stream(jeng, x), stream(teng, x)
    assert s_got["words"] == s_want["words"] == got["words"]
    assert s_got["text"] == s_want["text"]


def test_kaldi_archives_cross_packages(tmp_path):
    """Archives written by either package's kaldi_io read back identically
    in the other: float and compressed matrices, int vectors and text,
    through ark,scp pairs and random access."""
    from kaldi_ctc_tpu.utils import kaldi_io as jio
    from kaldi_ctc_tpu_torch.utils import kaldi_io as tio

    rng = np.random.default_rng(5)
    mats = {f"k{i}": rng.standard_normal((7 + i, 5)).astype(np.float32)
            for i in range(3)}
    ints = {f"k{i}": rng.integers(0, 50, 4 + i).astype(np.int32)
            for i in range(3)}
    for writer, reader, tag in ((tio, jio, "t"), (jio, tio, "j")):
        for compress in (False, True):
            base = f"{tmp_path}/{tag}{int(compress)}"
            with writer.MatrixWriter(f"ark,scp:{base}.ark,{base}.scp",
                                     compress=compress) as w:
                for k, v in mats.items():
                    w[k] = v
            back = dict(reader.SequentialMatrixReader(f"scp:{base}.scp"))
            mine = dict(writer.SequentialMatrixReader(f"ark:{base}.ark"))
            ra = reader.RandomAccessMatrixReader(f"scp:{base}.scp")
            for k, v in mats.items():
                np.testing.assert_array_equal(back[k], mine[k])
                np.testing.assert_array_equal(ra[k], mine[k])
                if not compress:
                    np.testing.assert_array_equal(back[k], v)
        with writer.IntVectorWriter(f"ark,t:{tmp_path}/{tag}.ali") as w:
            for k, v in ints.items():
                w[k] = v
        back = dict(reader.SequentialIntVectorReader(
            f"ark:{tmp_path}/{tag}.ali"))
        for k, v in ints.items():
            np.testing.assert_array_equal(back[k], v)
    (tmp_path / "words.txt").write_text("<eps> 0\nab 1\nc 2\n")
    assert tio.read_symbol_table(str(tmp_path / "words.txt")) == \
        jio.read_symbol_table(str(tmp_path / "words.txt"))


def test_unported_flags_raise(setup, tmp_path):
    """--lattice writes a raw lattice archive and --determinize 1 a
    compact one, whose best paths are the hypotheses printed (the flags
    raised before the lattice chain was ported); the FT, DS2 and
    splicing model types initialise, and a DS2 front with splicing raises
    ValueError before init_model writes a file; decode_ctc and nnet_compute default to the card and raise
    without one."""
    from kaldi_ctc_tpu_torch.cli import decode_ctc, init_model, nnet_compute
    from kaldi_ctc_tpu_torch.decoding.det_lattice import \
        read_compact_lattice_text_ark
    from kaldi_ctc_tpu_torch.decoding.lattice import read_lattice_text_ark

    d, exp, tlg = setup
    # a narrow lattice beam: the random model's lattices stay small
    base = ["--feats", f"scp:{d}/feats.scp", "--dir", exp, "--device", "cpu",
            "--method", "wfst", "--graph", tlg, "--use-priors", "0",
            "--lattice-beam", "3", "--max-active", "200"]
    for det in (0, 1):
        lat, hyp = tmp_path / f"lat{det}.ark", tmp_path / f"hyp{det}.txt"
        decode_ctc.main(base + ["--lattice", str(lat), "--determinize",
                                str(det), "--output", str(hyp)])
        reader = (read_compact_lattice_text_ark if det
                  else read_lattice_text_ark)
        lats = dict(reader(str(lat)))
        hyps = {line.split()[0]: [int(w) for w in line.split()[1:]]
                for line in hyp.read_text().splitlines()}
        assert lats and set(lats) <= set(hyps)
        for key, la in lats.items():
            assert list(la.best_path()[0]) == hyps[key]
    for extra in (["--front-affine-dim", "16"], ["--conv-layers", "1"],
                  ["--splice-left", "2"]):
        # the model types of ROADMAP item 12 now initialise
        out = tmp_path / extra[0].strip("-")
        init_model.main(["--dir", str(out), "--input-dim", "8",
                         "--num-targets", "6", "--hidden-dim", "8",
                         "--num-layers", "1"] + extra)
        with open(out / "model_config.json") as f:
            assert json.load(f)[extra[0][2:].replace("-", "_")] == int(
                extra[1])
    out = tmp_path / "ds2_splice"
    with pytest.raises(ValueError, match="DS2 conv front"):
        init_model.main(["--dir", str(out), "--input-dim", "8",
                         "--num-targets", "6", "--conv-layers", "1",
                         "--splice-left", "2"])
    assert not out.exists()
    assert decode_ctc.parse_args(["--feats", "x"]).device == "cuda"
    assert nnet_compute.parse_args(["--output", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        for main, argv in ((decode_ctc.main, ["--feats", "x"]),
                           (nnet_compute.main, ["--feats", "x",
                                                "--output", "ark:x"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv + ["--dir", exp])
