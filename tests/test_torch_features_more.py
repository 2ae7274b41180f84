"""The rest of the port's feature front end against the JAX package's:
compute_feats (mfcc, fbank, plp, spectrogram, with and without pitch,
segments and speed perturbation) against the JAX CLI's archive,
compute_cmvn and feat_tool byte for byte, pitch bit for bit, and the
golden and oracle tests of tests/test_features_golden.py,
tests/test_plp_spectrogram.py and tests/test_pitch.py run on the port's
functions (their fixtures reused, not copied)."""

import contextlib
import io
import os
import struct
import wave as wave_mod

import numpy as np
import pytest
import torch

import tests.test_features_golden as golden
import tests.test_pitch as pitch_tests
import tests.test_plp_spectrogram as plp_tests

# compute_feats at --dither 0 against the JAX CLI's uncompressed archive:
# the same f32 framing, FFT, mel and DCT in another summation order
FEATS_ATOL = 1e-4
# the spectrogram's log of low-power bins magnifies each package's f32
# FFT rounding (each is ~1e-4 from a float64 FFT at these inputs); the
# JAX package holds its own spectrogram to numpy's FFT at 1e-3
# (tests/test_plp_spectrogram.py::test_spectrogram_matches_numpy)
SPECTROGRAM_ATOL = 1e-3
# feat_tool deltas: add_deltas' filter taps summed in another order
DELTAS_ATOL = 1e-5


def _numpy_io(fn):
    """A port feature function that takes and returns numpy, as the JAX
    test modules call their functions (``implementation`` is the JAX
    package's choice of kernel and is dropped)."""
    def call(x, *args, **kw):
        kw.pop("implementation", None)
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(np.asarray(x, np.float32))
        out = fn(x, *args, **kw)
        return out.numpy() if isinstance(out, torch.Tensor) else out
    return call


@pytest.fixture
def port_features(monkeypatch):
    """Point the three JAX feature test modules at the port's functions
    and option classes."""
    from kaldi_ctc_tpu_torch import features as F
    from kaldi_ctc_tpu_torch.features import pitch, plp

    names = {"FbankOptions": F.FbankOptions, "FrameOptions": F.FrameOptions,
             "MelOptions": F.MelOptions, "MfccOptions": F.MfccOptions,
             "PlpOptions": F.PlpOptions,
             "SpectrogramOptions": F.SpectrogramOptions,
             "add_deltas": _numpy_io(F.add_deltas),
             "compute_fbank": _numpy_io(F.compute_fbank),
             "compute_mfcc": _numpy_io(F.compute_mfcc),
             "compute_plp": _numpy_io(F.compute_plp),
             "compute_spectrogram": _numpy_io(F.compute_spectrogram),
             "read_htk": F.read_htk, "read_wave": F.read_wave,
             "durbin_lpc": plp.durbin_lpc,
             "equal_loudness_vector": plp.equal_loudness_vector,
             "idft_bases": plp.idft_bases,
             "lpc_to_cepstrum": plp.lpc_to_cepstrum}
    for mod in (golden, plp_tests):
        for name, value in names.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)
    for name in ("PitchOptions", "ProcessPitchOptions",
                 "compute_and_process_pitch", "compute_kaldi_pitch",
                 "process_pitch"):
        monkeypatch.setattr(pitch_tests, name, getattr(pitch, name))


needs_reference = pytest.mark.skipif(
    not os.path.isdir(golden.REF), reason="reference test_data not available")


@needs_reference
@pytest.mark.parametrize("case", sorted(golden.MFCC_CASES))
def test_port_mfcc_htk_golden(port_features, case):
    golden.test_mfcc_htk_golden(case)


@needs_reference
@pytest.mark.parametrize("case", sorted(golden.FBANK_CASES))
def test_port_fbank_htk_golden(port_features, case):
    golden.test_fbank_htk_golden(case)


@needs_reference
def test_port_plp_htk_golden(port_features):
    plp_tests.test_plp_htk_golden()


def test_port_htk_roundtrip(tmp_path):
    """The port writes and reads HTK files as the JAX package does."""
    from kaldi_ctc_tpu.features.htk import read_htk as jax_read
    from kaldi_ctc_tpu.features.htk import write_htk as jax_write
    from kaldi_ctc_tpu_torch.features.htk import read_htk, write_htk

    m = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    write_htk(str(tmp_path / "p.htk"), m, parm_kind=9)
    jax_write(str(tmp_path / "j.htk"), m, parm_kind=9)
    assert (tmp_path / "p.htk").read_bytes() == \
        (tmp_path / "j.htk").read_bytes()
    back, hdr = read_htk(str(tmp_path / "j.htk"))
    np.testing.assert_array_equal(back, m)
    assert hdr == jax_read(str(tmp_path / "p.htk"))[1]


PLP_ORACLE_TESTS = ["test_durbin_matches_numpy_oracle",
                    "test_lpc_to_cepstrum_matches_numpy_oracle",
                    "test_equal_loudness_curve_shape",
                    "test_idft_bases_invert_cosine_expansion",
                    "test_plp_matches_numpy_oracle",
                    "test_spectrogram_matches_numpy",
                    "test_spectrogram_energy_floor_and_windowed_energy"]


@pytest.mark.parametrize("name", PLP_ORACLE_TESTS)
def test_port_plp_spectrogram_oracles(port_features, name):
    getattr(plp_tests, name)()


PITCH_TESTS = [(cls.__name__, name)
               for cls in (pitch_tests.TestComputePitch,
                           pitch_tests.TestProcessPitch)
               for name in sorted(vars(cls)) if name.startswith("test_")]


@pytest.mark.parametrize("cls,name", PITCH_TESTS)
def test_port_pitch_suite(port_features, cls, name):
    getattr(getattr(pitch_tests, cls)(), name)()


def test_pitch_equal_jax():
    """The numpy copy gives the JAX package's pitch bit for bit."""
    from kaldi_ctc_tpu.features import pitch as jax_pitch
    from kaldi_ctc_tpu_torch.features import pitch

    rng = np.random.default_rng(4)
    wave = np.concatenate([pitch_tests.tone(140, 0.4),
                           rng.standard_normal(3000).astype(np.float32)])
    for fn, kw in (("compute_kaldi_pitch", {}),
                   ("compute_and_process_pitch", {"seed": 3})):
        np.testing.assert_array_equal(getattr(pitch, fn)(wave, **kw),
                                      getattr(jax_pitch, fn)(wave, **kw))


def _write_wav(path, pcm, rate=16000):
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(struct.pack(f"<{len(pcm)}h", *pcm))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two seeded recordings (0.9 s and 1.3 s of a tone in noise), a
    wav.scp and a segments file cutting three utterances from them (one
    to the recording's end, one too short)."""
    d = tmp_path_factory.mktemp("wav")
    rng = np.random.default_rng(11)
    lines = []
    for i, secs in enumerate((0.9, 1.3)):
        n = int(16000 * secs)
        x = (3000 * np.sin(2 * np.pi * (120 + 40 * i) * np.arange(n) / 16000)
             + rng.standard_normal(n) * 800)
        _write_wav(d / f"r{i}.wav", x.astype(np.int16))
        lines.append(f"r{i} {d}/r{i}.wav\n")
    (d / "wav.scp").write_text("".join(lines))
    (d / "segments").write_text("a r0 0.0 0.6\nb r1 0.3 -1\nc r1 0.5 0.55\n"
                                "d r0 0.2 0.9\n")
    return d


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


# (type, --add-pitch, extra flags): each type with and without pitch,
# then the hires config, segments, speed perturbation, the HTK/VTLN
# options and pitch alone
FEAT_CASES = [(t, p, "") for t in ("mfcc", "fbank", "plp", "spectrogram")
              for p in (0, 1)] + [
    ("mfcc", 0, "hires"), ("mfcc", 1, "segments"), ("plp", 0, "segments"),
    ("fbank", 0, "speed"), ("mfcc", 0, "segments_speed"), ("mfcc", 0, "htk"),
    ("pitch", 0, "")]


@pytest.mark.parametrize("ftype,pitch,extra", FEAT_CASES)
def test_compute_feats_equal_jax(wavs, tmp_path, ftype, pitch, extra):
    from kaldi_ctc_tpu.cli import compute_feats as jax_cli
    from kaldi_ctc_tpu.utils.kaldi_io import SequentialMatrixReader
    from kaldi_ctc_tpu_torch.cli import compute_feats as port_cli

    argv = ["--wav-scp", f"{wavs}/wav.scp", "--type", ftype,
            "--add-pitch", str(pitch), "--compress", "0", "--dither", "0"]
    if "segments" in extra:
        argv += ["--segments", f"{wavs}/segments"]
    if "speed" in extra:
        argv += ["--speed-perturb", "0.9,1.0,1.1"]
    if extra == "hires":
        argv += ["--config", "hires"]
    if extra == "htk":
        argv += ["--htk-compat", "1", "--num-ceps", "11",
                 "--num-mel-bins", "20", "--vtln-warp", "1.05"]
    mats = {}
    for pkg, cli, dev in (("jax", jax_cli, []),
                          ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / f"{pkg}.ark"
        _run(cli.main, argv + ["--out", f"ark:{out}"] + dev)
        mats[pkg] = list(SequentialMatrixReader(f"ark:{out}"))
    assert [k for k, _ in mats["port"]] == [k for k, _ in mats["jax"]]
    n_keys = {"": 2, "hires": 2, "htk": 2, "segments": 3, "speed": 6,
              "segments_speed": 9}[extra]
    assert len(mats["port"]) == n_keys
    tol = SPECTROGRAM_ATOL if ftype == "spectrogram" else FEATS_ATOL
    for (_, got), (_, want) in zip(mats["port"], mats["jax"]):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_compute_feats_dither_is_seeded(wavs, tmp_path):
    """--dither > 0 draws from a generator seeded per utterance: the same
    seed gives the same archive, another seed another one (the numbers
    differ from the JAX package's, whose draws are jax.random's)."""
    from kaldi_ctc_tpu_torch.cli import compute_feats
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialMatrixReader

    out = {}
    for tag, seed in (("a", "1"), ("b", "1"), ("c", "2")):
        path = tmp_path / f"{tag}.ark"
        _run(compute_feats.main, [
            "--wav-scp", f"{wavs}/wav.scp", "--dither", "1", "--seed", seed,
            "--compress", "0", "--device", "cpu", "--out", f"ark:{path}"])
        out[tag] = dict(SequentialMatrixReader(f"ark:{path}"))
    for k in out["a"]:
        np.testing.assert_array_equal(out["a"][k], out["b"][k])
        assert not np.array_equal(out["a"][k], out["c"][k])


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    """A feature archive (ark,scp) of 6 utterances of two speakers, int
    alignments, CMVN stats, an LDA matrix and per-speaker transforms."""
    from kaldi_ctc_tpu.features.cmvn import acc_cmvn_stats
    from kaldi_ctc_tpu.utils import kaldi_io

    d = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(12)
    mats = {f"u{i}": (rng.standard_normal((int(rng.integers(9, 40)), 5))
                      * 3 + 1).astype(np.float32) for i in range(6)}
    with kaldi_io.MatrixWriter(f"ark,scp:{d}/a.ark,{d}/a.scp") as w:
        for k, v in mats.items():
            w[k] = v
    with kaldi_io.MatrixWriter(f"ark:{d}/b.ark") as w:
        for k, v in mats.items():
            w[k] = v[: len(v) - int(k[1:]) % 2, :2] * 2
    with kaldi_io.IntVectorWriter(f"ark:{d}/ali.ark") as w:
        for k, v in mats.items():
            w[k] = np.arange(len(v), dtype=np.int32) % 4
    (d / "utt2spk").write_text("".join(f"u{i} s{i % 2}\n" for i in range(6)))
    with kaldi_io.MatrixWriter(f"ark:{d}/cmvn.ark") as w:
        for s in ("s0", "s1"):
            w[s] = sum(acc_cmvn_stats(v) for k, v in mats.items()
                       if int(k[1:]) % 2 == int(s[1:]))
    kaldi_io.write_matrix(str(d / "lda.mat"),
                          rng.standard_normal((3, 6)).astype(np.float32))
    with kaldi_io.MatrixWriter(f"ark:{d}/trans.ark") as w:
        w["s1"] = rng.standard_normal((5, 5)).astype(np.float32)
    return d


@pytest.mark.parametrize("flags", [[], ["--utt2spk", "{d}/utt2spk"]],
                         ids=["per_utt", "per_spk"])
def test_compute_cmvn_equal_jax(feats, tmp_path, flags):
    from kaldi_ctc_tpu.cli import compute_cmvn as jax_cli
    from kaldi_ctc_tpu_torch.cli import compute_cmvn as port_cli

    flags = [x.format(d=feats) for x in flags]
    for pkg, cli in (("jax", jax_cli), ("port", port_cli)):
        cli.main(["--feats", f"scp:{feats}/a.scp", "--out",
                  f"ark,scp:{tmp_path}/{pkg}.ark,{tmp_path}/{pkg}.scp"]
                 + flags)
    assert (tmp_path / "port.ark").read_bytes() == \
        (tmp_path / "jax.ark").read_bytes()


FEAT_TOOL_CASES = {
    "copy": ["copy", "--feats", "scp:{d}/a.scp", "--compress", "1"],
    "to-dim": ["to-dim", "--feats", "ark:{d}/a.ark"],
    "to-len": ["to-len", "--feats", "scp:{d}/a.scp"],
    "copy-ints": ["copy-ints", "--feats", "ark:{d}/ali.ark"],
    "paste": ["paste", "--feats", "ark:{d}/a.ark", "--feats",
              "ark:{d}/b.ark", "--length-tolerance", "1"],
    "paste_strict": ["paste", "--feats", "ark:{d}/a.ark", "--feats",
                     "ark:{d}/b.ark"],
    "subsample": ["subsample", "--feats", "ark:{d}/a.ark", "--n", "3",
                  "--offset", "1"],
    "subsample_repeat": ["subsample", "--feats", "ark:{d}/a.ark", "--n",
                         "-2"],
    "splice": ["splice", "--feats", "ark:{d}/a.ark", "--left-context", "2",
               "--right-context", "1"],
    "deltas": ["deltas", "--feats", "ark:{d}/a.ark"],
    "transform": ["transform", "--feats", "ark:{d}/a.ark", "--transforms",
                  "ark:{d}/trans.ark", "--utt2spk", "{d}/utt2spk"],
    "transform_lda": ["transform", "--feats", "ark:{d}/a.ark", "--matrix",
                      "{d}/lda.mat"],
    "apply-cmvn": ["apply-cmvn", "--feats", "ark:{d}/a.ark", "--cmvn",
                   "ark:{d}/cmvn.ark", "--utt2spk", "{d}/utt2spk",
                   "--norm-vars", "1"],
    "select": ["select", "--feats", "ark:{d}/a.ark", "--range", "1-3"],
}


@pytest.mark.parametrize("case", sorted(FEAT_TOOL_CASES))
def test_feat_tool_equal_jax(feats, tmp_path, case):
    """Each subcommand writes the same archive byte for byte (deltas:
    within DELTAS_ATOL) or prints the same lines."""
    from kaldi_ctc_tpu.cli import feat_tool as jax_cli
    from kaldi_ctc_tpu.utils.kaldi_io import SequentialMatrixReader
    from kaldi_ctc_tpu_torch.cli import feat_tool as port_cli

    argv = [x.format(d=feats) for x in FEAT_TOOL_CASES[case]]
    writes = argv[0] not in ("to-dim", "to-len")
    stdout = {}
    for pkg, cli in (("jax", jax_cli), ("port", port_cli)):
        out = ["--output", f"ark:{tmp_path}/{pkg}.ark"] if writes else []
        stdout[pkg] = _run(cli.main, argv + out)
    assert stdout["port"] == stdout["jax"]
    if not writes:
        assert stdout["port"].strip()
        return
    port, jax = tmp_path / "port.ark", tmp_path / "jax.ark"
    if case != "deltas":
        assert port.read_bytes() == jax.read_bytes() and port.stat().st_size
        return
    got = list(SequentialMatrixReader(f"ark:{port}"))
    want = list(SequentialMatrixReader(f"ark:{jax}"))
    assert [k for k, _ in got] == [k for k, _ in want] and got
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=DELTAS_ATOL * max(
            1.0, float(np.abs(w).max())))
