"""The serving slice end to end: the port's /recognize held to the JAX
server's on one ``init_model --bidirectional 1`` directory and the same
seeded PCM, the port's HTTP handler, and the proof that the port and its
serve CLI import with no jax and no kaldi_ctc_tpu loaded."""

import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import wave

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Features: the port's rFFT path against JAX's XLA path (the tolerance
# the JAX package holds its own two feature paths to).  Scores are log
# posteriors of a 2-layer f32 model fed identical features: f32 sums in
# another order.  bf16 layer outputs move scores by ~an ulp of bf16.
FEAT_TOL = 2e-4
SCORE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pcm(seconds=1.2, seed=0):
    """tests/test_serve.py's generator: band-limited-ish noise."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    x = np.cumsum(rng.standard_normal(n)).astype(np.float32)
    x = (x - x.mean()) / (np.abs(x).max() + 1e-6)
    return (x * 20000).astype("<i2")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines(request, tmp_path_factory):
    from kaldi_ctc_tpu.cli import init_model, serve as jserve
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    exp = str(tmp_path_factory.mktemp("serve") / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "6",
                     "--hidden-dim", "16", "--num-layers", "2",
                     "--bidirectional", "1", "--dir", exp])
    cfg_path = os.path.join(exp, "model_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["compute_dtype"] = request.param
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    jeng = jserve.Engine(jserve.parse_args(["--dir", exp]))
    teng = tserve.Engine(tserve.parse_args(["--dir", exp,
                                            "--device", "cpu"]))
    return request.param, jeng, teng


@pytest.mark.parametrize("seconds,seed", [(1.2, 0), (0.7, 3), (1.5, 5)])
def test_recognize_matches_jax(engines, seconds, seed):
    dtype, jeng, teng = engines
    x = _pcm(seconds, seed).astype(np.float32)
    jf = jeng.feats_for(x)
    tf = teng.feats_for(x)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=FEAT_TOL, atol=FEAT_TOL)
    # scores from identical features: the model and score prep alone
    # (JAX pads to its length bucket, the port runs the true length)
    for got, ref in zip(teng.score_utt(torch.as_tensor(jf)),
                        jeng._score_utt(jf)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_TOL[dtype])
    jout, tout = jeng.recognize(x), teng.recognize(x)
    assert tout["num_frames"] == jout["num_frames"]
    assert tout["labels"] == jout["labels"]
    assert set(tout) == set(jout) == {"labels", "num_frames", "rtf"}


@pytest.fixture(scope="module")
def http_server(engines, tmp_path_factory):
    """The CLI's own server (make_server, as main() builds it) on port 0,
    serving the engines' model through a JAX-written artifact."""
    from kaldi_ctc_tpu.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    _, jeng, _ = engines
    path = str(tmp_path_factory.mktemp("artifact") / "final.npz")
    save_inference_artifact(path, jeng.params, jeng.cfg, priors=jeng.priors)
    httpd, teng = tserve.make_server(tserve.parse_args(
        ["--model", path, "--device", "cpu", "--port", "0"]))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1], teng
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = json.loads(resp.read().decode())
    conn.close()
    return resp.status, data


def _wav_bytes(pcm, rate):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def test_http_endpoints(http_server):
    port, teng = http_server
    assert _request(port, "GET", "/healthz") == (
        200, {"ok": True, "streaming": False})
    pcm = _pcm(1.0, seed=9)
    status, raw = _request(port, "POST", "/recognize", pcm.tobytes())
    assert status == 200 and raw["num_frames"] == 98 and raw["rtf"] > 0
    assert raw["labels"] == teng.recognize(pcm.astype(np.float32))["labels"]
    status, wav = _request(port, "POST", "/recognize", _wav_bytes(pcm, 16000))
    assert status == 200 and wav["labels"] == raw["labels"]
    # an 8 kHz WAV is resampled to the served rate first
    status, low = _request(port, "POST", "/recognize",
                           _wav_bytes(pcm[::2], 8000))
    assert status == 200 and low["num_frames"] == 98
    # a bidirectional model cannot stream: no slot opens
    assert _request(port, "POST", "/stream/start") == (
        400, {"error": "streaming needs a unidirectional model"})
    assert teng.stream is None and not teng.slots
    assert _request(port, "POST", "/stream/0/chunk", b"") == (
        404, {"error": "unknown slot 0"})
    assert _request(port, "GET", "/nope")[0] == 404


@pytest.mark.parametrize("bidirectional", ["1", "0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_artifact_serves_like_jax(dtype, bidirectional, tmp_path):
    """An ``init_model --rnn-mode 3`` directory (BiGRU, or GRU): the
    port's CLI server on the CPU (the plain versions of K8a or K9a)
    serving its JAX-written artifact answers /recognize with the JAX
    engine's labels, and scores identical features as JAX does."""
    from kaldi_ctc_tpu.cli import init_model, serve as jserve
    from kaldi_ctc_tpu.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    exp = str(tmp_path / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "6",
                     "--hidden-dim", "16", "--num-layers", "2",
                     "--rnn-mode", "3", "--bidirectional", bidirectional,
                     "--dir", exp])
    cfg_path = os.path.join(exp, "model_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["compute_dtype"] = dtype
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    jeng = jserve.Engine(jserve.parse_args(["--dir", exp]))
    path = str(tmp_path / "final.npz")
    save_inference_artifact(path, jeng.params, jeng.cfg, priors=jeng.priors)
    httpd, teng = tserve.make_server(tserve.parse_args(
        ["--model", path, "--device", "cpu", "--port", "0"]))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        for seconds, seed in ((1.2, 0), (0.7, 3)):
            pcm = _pcm(seconds, seed)
            jf = jeng.feats_for(pcm.astype(np.float32))
            for got, ref in zip(teng.score_utt(torch.as_tensor(jf)),
                                jeng._score_utt(jf)):
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=SCORE_TOL[dtype])
            status, out = _request(httpd.server_address[1], "POST",
                                   "/recognize", pcm.tobytes())
            want = jeng.recognize(pcm.astype(np.float32))
            assert status == 200 and out["labels"] == want["labels"]
            assert out["num_frames"] == want["num_frames"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_short_audio_has_no_frames(engines):
    _, _, teng = engines
    assert teng.recognize(np.zeros(100, np.float32)) == {
        "labels": [], "num_frames": 0}


def test_jax_artifact_serves_in_port(engines, tmp_path):
    """serve --model: a JAX-written artifact gives the --dir engine's
    result."""
    from kaldi_ctc_tpu.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    _, jeng, teng = engines
    path = str(tmp_path / "final.npz")
    save_inference_artifact(path, jeng.params, jeng.cfg, priors=jeng.priors)
    eng = tserve.Engine(tserve.parse_args(["--model", path,
                                           "--device", "cpu"]))
    x = _pcm(0.8, seed=11).astype(np.float32)
    assert eng.recognize(x)["labels"] == teng.recognize(x)["labels"]


def test_engine_options(tmp_path):
    from kaldi_ctc_tpu.cli import init_model
    from kaldi_ctc_tpu_torch.cli import serve as tserve
    from kaldi_ctc_tpu_torch.features.cmvn import acc_cmvn_stats

    exp = str(tmp_path / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "6",
                     "--hidden-dim", "8", "--num-layers", "1",
                     "--dir", exp])
    eng = tserve.Engine(tserve.parse_args(
        ["--dir", exp, "--device", "cpu", "--sample-rate", "8000"]))
    assert eng.fopts.frame_opts.samp_freq == 8000.0
    assert eng.win == 200 and eng.shift == 80
    assert eng.feats_for(np.zeros(8000, np.float32)).shape[0] == 1 + (
        8000 - eng.win) // eng.shift
    # the streaming options and their defaults; a bidirectional model
    # gets no streaming slots
    assert (eng.args.max_streams, eng.args.chunk_frames) == (8, 20)
    assert eng.stream is None and eng.stream_start() is None
    # --graph loads through the port's native loader: a missing graph
    # file raises its error (tests/test_torch_cli.py decodes words)
    with pytest.raises(IOError):
        tserve.Engine(tserve.parse_args(["--dir", exp, "--device", "cpu",
                                         "--graph", str(tmp_path / "no.fst")]))
    # a global CMVN .npy is applied on the engine's device
    x = _pcm(0.5, seed=2).astype(np.float32)
    stats_path = str(tmp_path / "cmvn.npy")
    np.save(stats_path, acc_cmvn_stats(eng.feats_for(x)))
    eng_c = tserve.Engine(tserve.parse_args(
        ["--dir", exp, "--device", "cpu", "--sample-rate", "8000",
         "--cmvn", stats_path]))
    assert abs(float(eng_c.feats_for(x).mean(0).abs().max())) < 1e-3
    # the same stats from a Kaldi archive (its first matrix)
    from kaldi_ctc_tpu_torch.utils.kaldi_io import MatrixWriter
    with MatrixWriter(f"ark:{tmp_path}/cmvn.ark") as w:
        w["global"] = np.load(stats_path)
    eng_a = tserve.Engine(tserve.parse_args(
        ["--dir", exp, "--device", "cpu", "--sample-rate", "8000",
         "--cmvn", f"ark:{tmp_path}/cmvn.ark"]))
    assert torch.equal(eng_a.feats_for(x), eng_c.feats_for(x))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.Engine(tserve.parse_args(["--dir", exp]))


def test_port_imports_without_jax(tmp_path):
    """In a fresh interpreter the port, its CLIs and its native loader
    (with the library loaded) load no jax and no kaldi_ctc_tpu (a
    subprocess: this test process has jax loaded by tests/conftest.py)."""
    code = (
        "import sys\n"
        "import kaldi_ctc_tpu_torch, kaldi_ctc_tpu_torch.cli.serve\n"
        "import kaldi_ctc_tpu_torch.features, kaldi_ctc_tpu_torch.models\n"
        "import kaldi_ctc_tpu_torch.models.artifact\n"
        "import kaldi_ctc_tpu_torch.training.checkpoint\n"
        "import kaldi_ctc_tpu_torch.decoding.scores\n"
        "import kaldi_ctc_tpu_torch.decoding.streaming\n"
        "import kaldi_ctc_tpu_torch.ops.rnn_cuda\n"
        "from kaldi_ctc_tpu_torch.ops.rnn_cuda import (bilstm_seq_fwd_proj,"
        " bilstm_seq_bwd_dgates_proj, use_in_kernel_proj)\n"
        "import kaldi_ctc_tpu_torch.ops.gru_cuda\n"
        "import kaldi_ctc_tpu_torch.ops.ctc, kaldi_ctc_tpu_torch.ops.ctc_cuda\n"
        "import kaldi_ctc_tpu_torch.training.train\n"
        "import kaldi_ctc_tpu_torch.utils.kaldi_io, kaldi_ctc_tpu_torch.data\n"
        "import kaldi_ctc_tpu_torch.data.egs_io\n"
        "import kaldi_ctc_tpu_torch.utils.transition_model\n"
        "import kaldi_ctc_tpu_torch.utils.profiling\n"
        "import kaldi_ctc_tpu_torch.decoding.wfst\n"
        "import kaldi_ctc_tpu_torch.decoding.greedy\n"
        "import kaldi_ctc_tpu_torch.decoding.prefix_beam\n"
        "from kaldi_ctc_tpu_torch.cli import (decode_ctc, nnet_compute,"
        " init_model, copy_model, average_models, model_info)\n"
        "from kaldi_ctc_tpu_torch.cli import (train_ctc, compute_prob,"
        " adjust_priors, decode_stream, prepare_egs, compute_feats,"
        " compute_cmvn, feat_tool)\n"
        "import kaldi_ctc_tpu_torch.data.pipeline, kaldi_ctc_tpu_torch.lm\n"
        "import kaldi_ctc_tpu_torch.parallel.distributed\n"
        "import kaldi_ctc_tpu_torch.parallel.mesh\n"
        "import kaldi_ctc_tpu_torch.parallel.dryrun\n"
        "from kaldi_ctc_tpu_torch.cli import (launch, lattice_tool,"
        " score_lattices)\n"
        "from kaldi_ctc_tpu_torch.decoding import (lattice, det_lattice,"
        " lattice_binary, lattice_ops, mbr, word_align, rescore)\n"
        "from kaldi_ctc_tpu_torch.lm import arpa, const_arpa\n"
        "import kaldi_ctc_tpu_torch.training.realign\n"
        "import kaldi_ctc_tpu_torch.training.natural_gradient\n"
        "from kaldi_ctc_tpu_torch.cli import align_ctc\n"
        "from kaldi_ctc_tpu_torch.features import (functions, transform,"
        " spectrogram, plp, pitch, htk)\n"
        "from kaldi_ctc_tpu_torch.cli import (graph_tool, lm_tool, tree_tool,"
        " generate_report, devwatch)\n"
        "from kaldi_ctc_tpu_torch.decoding import graph, context\n"
        "from kaldi_ctc_tpu_torch.utils import tree, tree_build\n"
        "from kaldi_ctc_tpu_torch.data import synth_lang\n"
        "from kaldi_ctc_tpu_torch.tools import dump_lg\n"
        "kaldi_ctc_tpu_torch.decoding.wfst._load()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kaldi_ctc_tpu')]\n"
        "assert not bad, bad\n"
        "assert kaldi_ctc_tpu_torch.cli.serve.parse_args([]).device "
        "== 'cuda'\n"
        "assert decode_ctc.parse_args(['--feats', 'x']).device == 'cuda'\n"
        "assert nnet_compute.parse_args(['--output', 'x']).device "
        "== 'cuda'\n"
        "for cli, argv in ((train_ctc, ['--num-targets', '2', '--dir', 'x']),"
        " (compute_prob, ['--dir', 'x']), (adjust_priors, ['--dir', 'x']),"
        " (decode_stream, ['--feats', 'x']),"
        " (compute_feats, ['--wav-scp', 'x', '--out', 'y'])):\n"
        "    assert cli.parse_args(argv).device == 'cuda'\n"
        "assert devwatch.probe_device(['--dir', 'x']) == 'cuda'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    # the recipes' scripts import their modules inside main() and the
    # run.sh files name their CLIs: neither may name the JAX package
    import ast
    import re
    recipes = os.path.join(ROOT, "kaldi_ctc_tpu_torch", "recipes")
    scripts = [os.path.join(r, f) for r, _, fs in os.walk(recipes)
               for f in fs if f.endswith((".py", ".sh"))]
    assert len([f for f in scripts if f.endswith(".py")]) == 6
    assert len([f for f in scripts if f.endswith(".sh")]) == 5
    for path in scripts:
        with open(path) as f:
            text = f.read()
        if path.endswith(".py"):
            for node in ast.walk(ast.parse(text)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    assert name.split(".")[0] not in (
                        "jax", "jaxlib", "kaldi_ctc_tpu"), (path, name)
        assert not re.search(r"kaldi_ctc_tpu\.|JAX_PLATFORMS|import jax",
                             text), path


def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, with no CUDA
    device and when it stands alone in a directory."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(str(alone), env)]
    if not torch.cuda.is_available():
        runs.append((ROOT, env))
    for cwd, e in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=e, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok": true' not in proc.stdout
