"""The decoders and the native loader of the port against the JAX
package: prefix beam search and greedy decoding on seeded log-probs, the
WFST graph files and best-path decoding through the port's own build of
``native/``, where that build goes, and checkpoints across the two
packages."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = np.float32(np.inf)

# Prefix beam scores: the same f32 logaddexp and logsumexp steps in
# another library (XLA's and torch's log1p/exp), summed over <= 30 frames.
BEAM_SCORE_TOL = 1e-5
# Best-path costs: one native library, two loaders, the same inputs.
WFST_COST_TOL = 1e-5


def _log_probs(seed, b=3, t=30, a=7, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, a)).astype(np.float32) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    if ties:
        # multiples of 0.5: many equal candidates in every top-k
        lp = np.round(lp * 2.0) / 2.0
    return lp.astype(np.float32)


def _both_beams(lp, lens, **kw):
    from kaldi_ctc_tpu.decoding.prefix_beam import prefix_beam_search as jpb
    from kaldi_ctc_tpu_torch.decoding import prefix_beam_search as tpb

    want = [np.asarray(v) for v in jpb(jnp.asarray(lp), jnp.asarray(lens),
                                       **kw)]
    got = [v.numpy() for v in tpb(torch.from_numpy(lp),
                                  torch.from_numpy(lens), **kw)]
    return want, got


@pytest.mark.parametrize("case", [
    dict(seed=0, beam=4, max_len=0),
    dict(seed=1, beam=4, max_len=5),
    dict(seed=2, beam=8, max_len=0),
    dict(seed=3, beam=8, max_len=5),
    dict(seed=4, beam=8, max_len=0, ties=True),
    dict(seed=5, beam=4, max_len=5, ties=True),
    dict(seed=6, beam=8, max_len=0, lens=(30, 0, 11)),
])
def test_prefix_beam_matches_jax(case):
    """Labels and lengths exact, scores within BEAM_SCORE_TOL: ragged
    lengths, both beams and label caps, tie-heavy log-probs (the stable
    top-k) and a row of length 0."""
    lp = _log_probs(case["seed"], ties=case.get("ties", False))
    lens = np.asarray(case.get("lens", (30, 17, 5)), np.int32)
    want, got = _both_beams(lp, lens, beam=case["beam"],
                            max_len=case["max_len"])
    np.testing.assert_array_equal(got[1], want[1])
    for j, n in enumerate(want[1]):
        np.testing.assert_array_equal(got[0][j, :n], want[0][j, :n])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=BEAM_SCORE_TOL)
    if case.get("ties"):
        assert (np.diff(np.sort(lp, -1), axis=-1) == 0).any()


def test_prefix_beam_hash_wraps_like_uint32():
    """The rolling hashes in int64 equal JAX's uint32 arithmetic with
    wrap-around, at both multipliers and at the top of the range."""
    from kaldi_ctc_tpu_torch.decoding.prefix_beam import (_HASH_MULT,
                                                          _HASH_MULT2,
                                                          _hash_step)

    rng = np.random.default_rng(7)
    h = np.concatenate([rng.integers(0, 2 ** 32, 1000, dtype=np.uint64),
                        [0, 2 ** 32 - 1]]).astype(np.uint32)
    tok = rng.integers(0, 1000, h.shape[0]).astype(np.uint32)
    for mult in (_HASH_MULT, _HASH_MULT2):
        want = np.asarray(jnp.asarray(h) * jnp.uint32(mult)
                          + jnp.asarray(tok) + jnp.uint32(1))
        got = _hash_step(torch.from_numpy(h.astype(np.int64)), mult,
                         torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_greedy_matches_jax():
    from kaldi_ctc_tpu.decoding import greedy_decode as jgreedy
    from kaldi_ctc_tpu_torch.decoding import greedy_decode as tgreedy

    lp = _log_probs(8, b=4, t=40, a=6, ties=True)
    lens = np.asarray([40, 23, 0, 1], np.int32)
    want = [np.asarray(v) for v in jgreedy(jnp.asarray(lp),
                                           jnp.asarray(lens))]
    got = [v.numpy() for v in tgreedy(torch.from_numpy(lp),
                                      torch.from_numpy(lens))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def _word_loop(fst_cls, labels=5):
    """Word-loop CTC graph, words = labels 1..``labels``
    (tests/test_serve.py's)."""
    arcs, weights = [], []
    for lab in range(1, labels + 1):
        arcs.append([0, lab, lab, lab]); weights.append(1.0)
        arcs.append([lab, lab, 0, lab]); weights.append(0.0)
        arcs.append([lab, 0, 0, 0]); weights.append(0.0)
    finals = np.full(labels + 1, INF, np.float32)
    finals[0] = 0.0
    return fst_cls.from_arrays(0, labels + 1, np.asarray(arcs, np.int32),
                               np.asarray(weights, np.float32),
                               finals).make_ctc_graph()


def _painted(frame_labels, cols, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(-5.0, 1.0, (len(frame_labels), cols)).astype(np.float32)
    for t, lab in enumerate(frame_labels):
        s[t, lab] = 5.0
    return s


def test_wfst_files_and_best_path_match_jax(tmp_path):
    """Graphs written by either package's NativeFst load in the other;
    decode_best_path and decode_best_path_batch equal JAX's on the same
    painted scores: words and alignment exact, cost within
    WFST_COST_TOL."""
    from kaldi_ctc_tpu.decoding import wfst as jw
    from kaldi_ctc_tpu_torch.decoding import wfst as tw

    port_path, jax_path = str(tmp_path / "port.fst"), str(tmp_path / "j.fst")
    _word_loop(tw.NativeFst).write(port_path)
    _word_loop(jw.NativeFst).write(jax_path)
    with open(port_path, "rb") as f, open(jax_path, "rb") as g:
        assert f.read() == g.read()
    tg, jg = jw.NativeFst.load(port_path), tw.NativeFst.load(jax_path)
    for a, b in ((tg, tw.NativeFst.load(port_path)),
                 (jg, jw.NativeFst.load(jax_path))):
        assert (a.num_states, a.num_arcs, a.start) == (
            b.num_states, b.num_arcs, b.start)
        for x, y in zip(a.to_arrays(), b.to_arrays()):
            np.testing.assert_array_equal(x, y)

    utts = [[0, 3, 3, 0, 5, 5, 0, 2, 0], [1, 1, 0, 0, 4, 0, 4, 4],
            [0, 0, 0], [2, 0, 2, 2, 0, 1, 3, 5, 5, 0]]
    scores = [_painted(u, 6, seed=i) for i, u in enumerate(utts)]
    for s in scores:
        want = jw.decode_best_path(tg, s)
        got = tw.decode_best_path(jg, s)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert abs(got[2] - want[2]) <= WFST_COST_TOL
        assert got[3] == want[3]
    want = jw.decode_best_path_batch(tg, scores, num_threads=2)
    got = tw.decode_best_path_batch(jg, scores, num_threads=2)
    assert len(got) == len(want) == len(utts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert abs(g[2] - w[2]) <= WFST_COST_TOL and g[3] == w[3]
    assert [list(map(int, g[0])) for g in got][0] == [3, 5, 2]


def _jax_decoding_files():
    """The JAX package's decoding/ files, less its own library, which its
    loader (``make -C native``) may be building in another test worker."""
    return set(os.listdir(os.path.join(ROOT, "kaldi_ctc_tpu", "decoding"))
               ) - {"libctc_native.so", "libctc_native.so.buildinfo"}


def test_loader_builds_under_build(tmp_path, monkeypatch):
    """A fresh build goes to the port's build root, keyed by the sources,
    and writes nothing into the JAX package; the library loads."""
    import ctypes

    from kaldi_ctc_tpu_torch.decoding import wfst

    assert wfst.BUILD_DIR == os.path.join(ROOT, "build", "native")
    assert os.path.dirname(wfst.library_path()) == wfst.BUILD_DIR
    before = _jax_decoding_files()
    monkeypatch.setattr(wfst, "BUILD_DIR", str(tmp_path / "build"))
    path = wfst.ensure_built()
    assert os.path.dirname(path) == str(tmp_path / "build")
    assert os.path.basename(path).startswith("libctc_native-")
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), ".lock"])
    assert _jax_decoding_files() == before
    lib = ctypes.CDLL(path)
    assert wfst._declare(lib).ctcn_fst_num_states


def test_loader_rebuilds_when_a_source_changes(tmp_path, monkeypatch):
    """The key covers every source and header of native/ (det_lattice.*
    included): changing one gives a new library path and a build; an
    unchanged key reuses the library."""
    from kaldi_ctc_tpu_torch.decoding import wfst

    native = tmp_path / "native"
    shutil.copytree(os.path.join(ROOT, "native"), native)
    monkeypatch.setattr(wfst, "NATIVE_DIR", str(native))
    monkeypatch.setattr(wfst, "BUILD_DIR", str(tmp_path / "build"))
    built = []

    def fake_compile(out):
        built.append(out)
        open(out, "w").close()

    monkeypatch.setattr(wfst, "_compile", fake_compile)
    first = wfst.ensure_built()
    assert wfst.ensure_built() == first and built == [first]
    paths = {first}
    for name in ("det_lattice.h", "det_lattice.cc", "statemap.h", "api.cc"):
        with open(native / name, "a") as f:
            f.write("\n// changed\n")
        path = wfst.ensure_built()
        assert path not in paths and built[-1] == path
        paths.add(path)
    assert len(built) == 5


def test_loader_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from kaldi_ctc_tpu_torch.decoding import wfst

    native = tmp_path / "native"
    shutil.copytree(os.path.join(ROOT, "native"), native)
    with open(native / "api.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(wfst, "NATIVE_DIR", str(native))
    monkeypatch.setattr(wfst, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(wfst, "SRCS", ("api.cc",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        wfst.ensure_built()
    assert os.listdir(tmp_path / "build") == [".lock"]


def _leaves(path):
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def _assert_same_leaves(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_restore(writer, tmp_path):
    """An init_model directory of either package restores in the other's
    restore_checkpoint leaf for leaf, with the same meta."""
    from kaldi_ctc_tpu.cli import init_model as jinit
    from kaldi_ctc_tpu.models import AmConfig as JCfg
    from kaldi_ctc_tpu.models import init_am_params as jparams
    from kaldi_ctc_tpu.training import init_train_state as jstate
    from kaldi_ctc_tpu.training.checkpoint import \
        restore_checkpoint as jrestore
    from kaldi_ctc_tpu_torch.cli import init_model as tinit
    from kaldi_ctc_tpu_torch.models import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.training import init_train_state
    from kaldi_ctc_tpu_torch.training.checkpoint import restore_checkpoint

    import jax

    exp = str(tmp_path / "exp")
    flags = ["--dir", exp, "--input-dim", "8", "--num-targets", "6",
             "--hidden-dim", "16", "--num-layers", "2", "--seed", "3"]
    (tinit if writer == "port" else jinit).main(flags)
    ckpt = os.path.join(exp, "checkpoints")
    with open(os.path.join(exp, "model_config.json")) as f:
        cfg_d = json.load(f)
    with open(os.path.join(ckpt, "step_0", "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"step": 0, "num_leaves": 2 * 14 + 1,
                    "extra": {"epoch": 0, "num_layers": 2},
                    "num_param_leaves": 14}
    np.testing.assert_array_equal(
        np.load(os.path.join(exp, "priors.npy")),
        np.asarray([9, 1, 1, 1, 1, 1], np.float32))
    saved = _leaves(os.path.join(ckpt, "step_0"))

    jcfg = JCfg.from_dict(cfg_d)
    jst, jmeta = jrestore(ckpt, jstate(jparams(jax.random.PRNGKey(0), jcfg)))
    tst, tmeta = restore_checkpoint(
        ckpt, init_train_state(init_am_params(AmConfig.from_dict(cfg_d))))
    assert jmeta == tmeta == meta
    _assert_same_leaves([np.asarray(x) for x in jax.tree_util.tree_leaves(
        jst)], saved)
    _assert_same_leaves([x.numpy() for x in tree_flatten(tst)], saved)
    assert int(tst.step) == 0 and tst.step.dtype == torch.int32


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_average_copy_and_info_match_jax(writer, tmp_path, capsys):
    """average_models, copy_model and model_info of both packages on
    either package's checkpoints: the same leaves, artifact and JSON."""
    from kaldi_ctc_tpu.cli import average_models as javg
    from kaldi_ctc_tpu.cli import copy_model as jcopy
    from kaldi_ctc_tpu.cli import init_model as jinit
    from kaldi_ctc_tpu.cli import model_info as jinfo
    from kaldi_ctc_tpu_torch.cli import average_models as tavg
    from kaldi_ctc_tpu_torch.cli import copy_model as tcopy
    from kaldi_ctc_tpu_torch.cli import init_model as tinit
    from kaldi_ctc_tpu_torch.cli import model_info as tinfo
    from kaldi_ctc_tpu_torch.params import tree_map
    from kaldi_ctc_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)

    exp = str(tmp_path / "exp")
    (tinit if writer == "port" else jinit).main(
        ["--dir", exp, "--input-dim", "8", "--num-targets", "6",
         "--hidden-dim", "16", "--num-layers", "2", "--bidirectional", "0"])
    ckpt = os.path.join(exp, "checkpoints")
    # two more checkpoints with other values in every leaf
    from kaldi_ctc_tpu_torch.models import AmConfig, init_am_params
    from kaldi_ctc_tpu_torch.training import init_train_state
    with open(os.path.join(exp, "model_config.json")) as f:
        cfg = AmConfig.from_dict(json.load(f))
    state, _ = restore_checkpoint(ckpt, init_train_state(
        init_am_params(cfg)))
    for step, scale in ((5, 1.5), (9, -0.25)):
        save_checkpoint(ckpt, step, tree_map(lambda x: x * scale + 0.125
                                             if x.is_floating_point()
                                             else x + step, state),
                        extra={"epoch": 1, "num_layers": 2})

    tavg.main(["--dir", exp, "--steps", "0", "5", "9", "--out-step", "20"])
    javg.main(["--dir", exp, "--steps", "0", "5", "9", "--out-step", "21"])
    _assert_same_leaves(_leaves(os.path.join(ckpt, "step_20")),
                        _leaves(os.path.join(ckpt, "step_21")))
    with open(os.path.join(ckpt, "step_20", "meta.json")) as f:
        tmeta = json.load(f)
    with open(os.path.join(ckpt, "step_21", "meta.json")) as f:
        jmeta = json.load(f)
    assert {**tmeta, "step": 0} == {**jmeta, "step": 0}
    assert tmeta["extra"]["averaged_from"] == [0, 5, 9]

    tcopy.main(["--dir", exp, "--step", "20", "--output",
                str(tmp_path / "t.npz")])
    jcopy.main(["--dir", exp, "--step", "20", "--output",
                str(tmp_path / "j.npz")])
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            if k == "__config__":
                assert json.loads(bytes(t[k])) == json.loads(bytes(j[k]))
            else:
                np.testing.assert_array_equal(t[k], j[k])

    capsys.readouterr()
    for step in ("9", "21"):
        tinfo.main(["--dir", exp, "--step", step])
        got = capsys.readouterr().out
        jinfo.main(["--dir", exp, "--step", step])
        assert got == capsys.readouterr().out


def test_apply_retention(tmp_path):
    from kaldi_ctc_tpu.training.checkpoint import apply_retention as jret
    from kaldi_ctc_tpu_torch.training.checkpoint import (apply_retention,
                                                         latest_step,
                                                         save_checkpoint)

    removed = {}
    for who, fn in (("port", apply_retention), ("jax", jret)):
        d = str(tmp_path / who)
        for s in (0, 50, 100, 150, 200, 201, 202):
            save_checkpoint(d, s, {"w": torch.full((2,), float(s))})
        removed[who] = fn(d, keep_every=100, keep_last=2)
        assert sorted(os.listdir(d)) == ["step_0", "step_100", "step_200",
                                         "step_201", "step_202"]
        assert latest_step(d) == 202
    assert removed["port"] == removed["jax"] == [50, 150]
