"""The streaming slice held to the JAX package on the CPU: K7's plain
version against ``lstm_stack_fwd`` in interpret mode, the chunked
``rnn_forward_stream`` against JAX's and against the offline forward,
both recognizers against JAX's on the same chunks, and the port's
``/stream/*`` endpoints against the JAX server on one
``init_model --bidirectional 0`` directory."""

import dataclasses
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.decoding import streaming as jstreaming
from kaldi_ctc_tpu.models import acoustic as jacoustic
from kaldi_ctc_tpu.ops import rnn as jrnn
from kaldi_ctc_tpu.ops import rnn_pallas
from kaldi_ctc_tpu_torch.decoding import streaming as tstreaming
from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig, am_forward,
                                                 init_am_params)
from kaldi_ctc_tpu_torch.ops import rnn as trnn
from kaldi_ctc_tpu_torch.ops import rnn_cuda
from kaldi_ctc_tpu_torch.params import from_jax_params

T, B, D, H = 17, 3, 6, 12
CHUNK = 7
# f32: the same f32 maths in another summation order (a chunk's
# projection is one matmul here, one dot per step in the kernel).
F32_TOL = 1e-5
# bf16: the bound the JAX package holds its own wavefront kernel to
# against its scan path (tests/test_streaming.py): the projection and
# the layer outputs are stored in bf16, so a flipped rounding moves later
# steps by about a bf16 ulp.
BF16_TOL = 3e-2
_DT = {"float32": (jnp.float32, torch.float32, F32_TOL),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(a):
    t = torch.as_tensor(np.array(_np(a)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


# ---- K7 ----

@pytest.mark.parametrize("lens", [[T, 9, 0], [0, 0, 0]])   # ragged, idle
@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_stack_fwd_reference_matches_pallas_interpret(dtype, layers,
                                                           stateful, lens):
    """K7's plain version (what its wrapper runs on a CPU tensor) against
    ``lstm_stack_fwd`` in interpret mode: y, h_fin and c_fin."""
    jdt, _, tol = _DT[dtype]
    rng = np.random.default_rng(layers)
    g4 = 4 * H
    xp0 = rng.standard_normal((T, B, g4)).astype(np.float32)
    whs = [(rng.standard_normal((H, g4)) / np.sqrt(H)).astype(np.float32)
           for _ in range(layers)]
    wxs = [(rng.standard_normal((H, g4)) / np.sqrt(H)).astype(np.float32)
           for _ in range(layers - 1)]
    bs = [(rng.standard_normal(g4) * 0.2).astype(np.float32)
          for _ in range(layers - 1)]
    h0 = c0 = None
    if stateful:
        h0, c0 = (rng.standard_normal((layers, B, H)).astype(np.float32)
                  * 0.5 for _ in range(2))
    lens = np.asarray(lens, np.int32)
    cast = lambda ws: [jnp.asarray(w, jdt) for w in ws]
    ref = rnn_pallas.lstm_stack_fwd(
        jnp.asarray(xp0, jdt), cast(wxs), cast(whs),
        [jnp.asarray(b) for b in bs], jnp.asarray(lens),
        None if h0 is None else jnp.asarray(h0),
        None if c0 is None else jnp.asarray(c0), interpret=True)
    tcast = lambda ws: [_to_torch(w) for w in cast(ws)]
    got = rnn_cuda.lstm_stack_fwd(
        _to_torch(jnp.asarray(xp0, jdt)), tcast(wxs), tcast(whs),
        [torch.as_tensor(b) for b in bs], torch.as_tensor(lens),
        None if h0 is None else torch.as_tensor(h0),
        None if c0 is None else torch.as_tensor(c0))
    for name, g, r in zip(("y", "h_fin", "c_fin"), got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=0,
                                   atol=tol, err_msg=name)
    for row, n in enumerate(lens):                 # y = 0 past lens
        assert not got[0][n:, row].any()
    if not lens.any():                             # idle: state kept
        want = np.zeros((layers, B, H)) if h0 is None else h0
        np.testing.assert_array_equal(got[1].numpy(), want)
    assert rnn_cuda.lstm_stack_fwd.launches == 0   # CPU: plain version


# ---- rnn_forward_stream ----

def _rnn_cfgs(mode, dtype, layers=2):
    kw = dict(input_dim=D, hidden_dim=H, num_layers=layers, mode=mode,
              bidirectional=False, compute_dtype=dtype)
    return jrnn.RnnConfig(implementation="xla", **kw), trnn.RnnConfig(**kw)


def _chunks(x, lens):
    """(x chunk, its per-row valid frames) of CHUNK frames each."""
    for lo in range(0, x.shape[0], CHUNK):
        yield lo, x[lo:lo + CHUNK], np.clip(lens - lo, 0,
                                            min(CHUNK, x.shape[0] - lo))


@pytest.mark.parametrize("mode,dtype", [
    (trnn.RnnMode.LSTM, "float32"), (trnn.RnnMode.LSTM, "bfloat16"),
    (trnn.RnnMode.GRU, "float32"), (trnn.RnnMode.TANH, "float32")])
def test_rnn_forward_stream_matches_jax_and_offline(mode, dtype):
    jcfg, tcfg = _rnn_cfgs(mode, dtype)
    tol = _DT[dtype][2]
    params = jrnn.init_rnn_params(jax.random.PRNGKey(2), jcfg)
    tparams = from_jax_params(jax.device_get(params))
    x = np.random.default_rng(5).standard_normal((T, B, D)).astype(
        np.float32)
    lens = np.array([T, T - 4, 5], np.int32)
    jst = jrnn.init_stream_state(jcfg, B)
    tst = trnn.init_stream_state(tcfg, B)
    outs = []
    for _, xc, cl in _chunks(x, lens):
        jy, jst = jrnn.rnn_forward_stream(params, jnp.asarray(xc), jcfg,
                                          jst, lens=jnp.asarray(cl))
        ty, tst = trnn.rnn_forward_stream(tparams, torch.as_tensor(xc), tcfg,
                                          tst, lens=torch.as_tensor(cl))
        assert ty.dtype == _DT[dtype][1]
        np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=0,
                                   atol=tol)
        outs.append(ty)
    for ts, js in zip(tst, jst):           # the carried states
        for g, r in zip(ts if isinstance(ts, tuple) else (ts,),
                        js if isinstance(js, tuple) else (js,)):
            np.testing.assert_allclose(g.numpy(), _np(r), rtol=0, atol=tol)
    # the chunks together equal the offline forward of the whole input
    full = trnn.rnn_forward(tparams, torch.as_tensor(x), tcfg,
                            torch.as_tensor(lens))
    np.testing.assert_allclose(torch.cat(outs).float().numpy(),
                               full.float().numpy(), rtol=0, atol=tol)


def test_init_stream_state_and_bidirectional_refusal():
    _, tcfg = _rnn_cfgs(trnn.RnnMode.LSTM, "float32", layers=3)
    st = trnn.init_stream_state(tcfg, 4)
    assert len(st) == 3 and all(isinstance(s, tuple) for s in st)
    assert all(a.shape == (4, H) and a.dtype == torch.float32 and
               not a.any() for s in st for a in s)
    gru = dataclasses.replace(tcfg, mode=trnn.RnnMode.GRU)
    assert all(isinstance(s, torch.Tensor)
               for s in trnn.init_stream_state(gru, 2))
    bi = dataclasses.replace(tcfg, bidirectional=True)
    with pytest.raises(ValueError, match="unidirectional"):
        trnn.init_stream_state(bi, 1)
    with pytest.raises(ValueError, match="unidirectional"):
        trnn.rnn_forward_stream([], torch.zeros((2, 1, D)), bi, [])


# ---- recognizers ----

def _am(seed, dtype="float32", mode=trnn.RnnMode.LSTM):
    jcfg = jacoustic.AmConfig(input_dim=D, num_targets=5, hidden_dim=H,
                              num_layers=2, mode=mode, bidirectional=False,
                              compute_dtype=dtype)
    params = jacoustic.init_am_params(jax.random.PRNGKey(seed), jcfg)
    return (params, jcfg, from_jax_params(jax.device_get(params)),
            AmConfig.from_dict(jcfg.to_dict()))


@pytest.mark.parametrize("chunk", [7, 10, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_recognizer_matches_jax_and_offline(dtype, chunk):
    jparams, jcfg, tparams, tcfg = _am(1, dtype)
    feats = (np.random.default_rng(1).standard_normal((37, D)) * 2).astype(
        np.float32)
    priors = np.array([3.0, 1.0, 0.5, 1.0, 2.0], np.float32)
    jrec = jstreaming.StreamingRecognizer(jparams, jcfg, priors=priors)
    trec = tstreaming.StreamingRecognizer(tparams, tcfg, priors=priors)
    for lo in range(0, feats.shape[0], chunk):
        assert trec.process(feats[lo:lo + chunk]) == \
            jrec.process(feats[lo:lo + chunk])
    assert trec.finalize() == jrec.finalize()
    # offline greedy over the port's full-utterance scores
    logits = am_forward(tparams, torch.as_tensor(feats)[None], tcfg)
    ids = (torch.log_softmax(logits, -1)[0]
           - torch.log(torch.as_tensor(priors))).argmax(-1).tolist()
    offline, last = [], 0
    for lab in ids:
        if lab != 0 and lab != last:
            offline.append(lab)
        last = lab
    assert trec.finalize() == offline
    trec.reset()
    assert trec.finalize() == [] and trec.process(feats[:0]) == []


def _stream_slots(rec, utts, chunk, slots):
    """Feed each utterance through its slot, all slots per tick, with
    ragged last chunks."""
    pos = {s: 0 for s in slots}
    while any(pos[s] < utts[s].shape[0] for s in slots):
        block = np.zeros((len(utts), chunk, D), np.float32)
        valid = np.zeros(len(utts), np.int64)
        for s in slots:
            take = min(chunk, utts[s].shape[0] - pos[s])
            block[s, :take] = utts[s][pos[s]:pos[s] + take]
            valid[s] = take
            pos[s] += take
        yield rec.process(block, valid)


def test_batch_recognizer_matches_jax_and_resets_a_slot_in_place():
    jparams, jcfg, tparams, tcfg = _am(5)
    rng = np.random.default_rng(7)
    utts = [(rng.standard_normal((25 + 6 * i, D)) * 2).astype(np.float32)
            for i in range(3)]
    jrec = jstreaming.BatchStreamingRecognizer(jparams, jcfg, 3, 10)
    trec = tstreaming.BatchStreamingRecognizer(tparams, tcfg, 3, 10)
    for got, want in zip(_stream_slots(trec, utts, 10, [0, 1, 2]),
                         _stream_slots(jrec, utts, 10, [0, 1, 2])):
        assert got == want
    assert trec.ticks == 4
    singles = []
    for f in utts:
        rec = tstreaming.StreamingRecognizer(tparams, tcfg)
        rec.process(f)
        singles.append(rec.finalize())
    for s in range(3):
        assert trec.finalize(s) == jrec.finalize(s) == singles[s]
    # reset_slot zeroes slot 1's rows in place and keeps the others
    before = [[a.clone() for a in st] for st in trec._state]
    tensors = [a for st in trec._state for a in st]
    trec.reset_slot(1)
    for st, old in zip(trec._state, before):
        for a, b in zip(st, old):
            assert not a[1].any()
            assert torch.equal(a[[0, 2]], b[[0, 2]])
    assert all(a is b for a, b in zip(
        tensors, [a for st in trec._state for a in st]))
    assert trec.finalize(1) == []
    list(_stream_slots(trec, [utts[1], utts[0], utts[2]], 10, [1]))
    assert trec.finalize(1) == singles[0]
    with pytest.raises(ValueError, match="expected"):
        trec.process(np.zeros((3, 9, D), np.float32), np.zeros(3))


def test_recognizers_refuse_what_cannot_stream():
    jparams, jcfg, tparams, tcfg = _am(0)
    for make in (lambda c: tstreaming.StreamingRecognizer(tparams, c),
                 lambda c: tstreaming.BatchStreamingRecognizer(tparams, c,
                                                               2, 5)):
        for field, msg in (("bidirectional", "unidirectional"),
                           ("splice_left", "splicing"),
                           ("conv_layers", "conv front")):
            value = True if field == "bidirectional" else 1
            with pytest.raises(ValueError, match=msg):
                make(dataclasses.replace(tcfg, **{field: value}))
    # the FT front is frame-local: both recognizers stream it (ROADMAP
    # item 12), the front's weights on the chunk scorer
    ft = dataclasses.replace(tcfg, front_affine_dim=8)
    fparams = init_am_params(ft, torch.Generator().manual_seed(0))
    for rec in (tstreaming.StreamingRecognizer(fparams, ft),
                tstreaming.BatchStreamingRecognizer(fparams, ft, 2, 5)):
        assert rec.chunk_fn.front["front_w"].shape == (ft.input_dim, 8)


# ---- /stream/* against the JAX server ----

def _pcm(seconds=1.2, seed=0):
    """tests/test_serve.py's generator: band-limited-ish noise."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(int(16000 * seconds))).astype(
        np.float32)
    x = (x - x.mean()) / (np.abs(x).max() + 1e-6)
    return (x * 20000).astype("<i2")


@pytest.fixture(scope="module")
def uni_server(tmp_path_factory):
    """The port's CLI server and the JAX engine on one unidirectional
    ``init_model`` directory (4 slots, 7-frame chunks)."""
    from kaldi_ctc_tpu.cli import init_model, serve as jserve
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    exp = str(tmp_path_factory.mktemp("serve_uni") / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "6",
                     "--hidden-dim", "16", "--num-layers", "2",
                     "--bidirectional", "0", "--dir", exp])
    flags = ["--dir", exp, "--use-priors", "0", "--max-streams", "4",
             "--chunk-frames", "7"]
    jeng = jserve.Engine(jserve.parse_args(flags))
    httpd, teng = tserve.make_server(tserve.parse_args(
        flags + ["--device", "cpu", "--port", "0"]))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1], teng, jeng
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


def _settled_stats(port):
    """GET /stats once no POST is in flight: a response is written inside
    its ``serve.request`` span, so the span may end just after the client
    has read the response.  A POST counts ``serve.requests`` as it starts
    and adds to ``serve.request`` as it ends."""
    deadline = time.monotonic() + 30
    while True:
        status, snap = _request(port, "GET", "/stats")
        assert status == 200
        started = snap["counters"].get("serve.requests", 0)
        ended = snap["spans"].get("serve.request", {}).get("count", 0)
        if started == ended or time.monotonic() > deadline:
            return snap
        time.sleep(0.01)


def _jax_stream(jeng, pcm, sizes):
    slot = jeng.stream_start()
    off = 0
    for sz in sizes:
        jeng.stream_chunk(slot, pcm[off:off + sz].astype(np.float32))
        off += sz
    return jeng.stream_end(slot)["labels"]


def test_stream_matches_jax_and_recognize(uni_server):
    port, teng, jeng = uni_server
    assert _request(port, "GET", "/healthz") == (
        200, {"ok": True, "streaming": True})
    pcm = _pcm(1.0, seed=3)
    # ragged chunk sizes exercise the incremental framing
    sizes = [1600, 2400, 3210, 4000, 2790, 2000]
    status, start = _request(port, "POST", "/stream/start")
    assert status == 200
    slot, off, labels = start["slot"], 0, []
    for sz in sizes:
        status, resp = _request(port, "POST", f"/stream/{slot}/chunk",
                                pcm[off:off + sz].tobytes())
        assert status == 200
        labels += resp["labels"]
        off += sz
    status, end = _request(port, "POST", f"/stream/{slot}/end")
    assert status == 200 and end["labels"] == labels + end["new"]
    _, offline = _request(port, "POST", "/recognize", pcm.tobytes())
    assert end["labels"] == offline["labels"]
    assert end["labels"] == _jax_stream(jeng, pcm, sizes)
    # the stream's features are the whole utterance's (sample accounting)
    np.testing.assert_allclose(
        teng.feats_for(pcm.astype(np.float32)).numpy(),
        jeng.feats_for(pcm.astype(np.float32)), rtol=2e-4, atol=2e-4)


def test_interleaved_slots_are_independent(uni_server):
    port, _, _ = uni_server
    b1, b2 = _pcm(0.6, seed=5), _pcm(0.6, seed=6)
    _, off1 = _request(port, "POST", "/recognize", b1.tobytes())
    _, off2 = _request(port, "POST", "/recognize", b2.tobytes())
    _, s1 = _request(port, "POST", "/stream/start")
    _, s2 = _request(port, "POST", "/stream/start")
    h1, h2 = len(b1) // 2, len(b2) // 2
    for slot, part in ((s1, b1[:h1]), (s2, b2[:h2]), (s1, b1[h1:]),
                       (s2, b2[h2:])):
        assert _request(port, "POST", f"/stream/{slot['slot']}/chunk",
                        part.tobytes())[0] == 200
    _, e1 = _request(port, "POST", f"/stream/{s1['slot']}/end")
    _, e2 = _request(port, "POST", f"/stream/{s2['slot']}/end")
    assert e1["labels"] == off1["labels"]
    assert e2["labels"] == off2["labels"]


def test_stats_count_stream_chunks_and_ticks(uni_server):
    """GET /stats after one stream of six chunks: one serve.stream_chunk
    a chunk, one serve.stream_tick a process() call, the streams each
    tick batched, and eight requests (start, six chunks, end)."""
    from kaldi_ctc_tpu_torch.utils import profiling

    port, _, _ = uni_server
    before = _settled_stats(port)
    pcm = _pcm(1.0, seed=4)
    _, start = _request(port, "POST", "/stream/start")
    slot = start["slot"]
    for part in np.array_split(pcm, 6):
        assert _request(port, "POST", f"/stream/{slot}/chunk",
                        part.tobytes())[0] == 200
    assert _request(port, "POST", f"/stream/{slot}/end")[0] == 200
    after = _settled_stats(port)
    d = profiling.diff(after, before)
    spans, counters = d["spans"], d["counters"]
    assert spans["serve.request"]["count"] == 8
    assert spans["serve.stream_chunk"]["count"] == 6
    # 98 frames in 7-frame chunks: 14 ticks, one stream in each
    assert spans["serve.stream_tick"]["count"] == 14
    assert counters["serve.streams_per_tick"] == 14
    assert counters["serve.frames"] == 98
    assert counters["serve.requests"] == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_stream_matches_jax_and_recognize(dtype, tmp_path):
    """An ``init_model --rnn-mode 3 --bidirectional 0`` directory: the
    port's /stream/* (the per-layer loop on the CPU) gives the JAX
    engine's streamed labels and the port's /recognize labels (the plain
    version of K9a), which equal JAX's too."""
    from kaldi_ctc_tpu.cli import init_model, serve as jserve
    from kaldi_ctc_tpu_torch.cli import serve as tserve

    exp = str(tmp_path / "exp")
    init_model.main(["--input-dim", "40", "--num-targets", "6",
                     "--hidden-dim", "16", "--num-layers", "2",
                     "--rnn-mode", "3", "--bidirectional", "0",
                     "--dir", exp])
    cfg_path = f"{exp}/model_config.json"
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["compute_dtype"] = dtype
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    flags = ["--dir", exp, "--use-priors", "0", "--max-streams", "2",
             "--chunk-frames", "7"]
    jeng = jserve.Engine(jserve.parse_args(flags))
    httpd, teng = tserve.make_server(tserve.parse_args(
        flags + ["--device", "cpu", "--port", "0"]))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        pcm = _pcm(1.0, seed=4)
        sizes = [1600, 2400, 3210, 4000, 2790, 2000]
        slot = _request(port, "POST", "/stream/start")[1]["slot"]
        off = 0
        for sz in sizes:
            assert _request(port, "POST", f"/stream/{slot}/chunk",
                            pcm[off:off + sz].tobytes())[0] == 200
            off += sz
        status, end = _request(port, "POST", f"/stream/{slot}/end")
        _, offline = _request(port, "POST", "/recognize", pcm.tobytes())
        assert status == 200 and end["labels"] == offline["labels"]
        assert end["labels"] == _jax_stream(jeng, pcm, sizes)
        assert offline["labels"] == jeng.recognize(
            pcm.astype(np.float32))["labels"]
        assert teng.stream.ticks > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_slot_exhaustion_reuse_and_unknown_slot(uni_server):
    port, teng, _ = uni_server
    slots = [_request(port, "POST", "/stream/start")[1]["slot"]
             for _ in range(4)]
    assert sorted(slots) == [0, 1, 2, 3]
    assert _request(port, "POST", "/stream/start")[0] == 503
    for s in slots:
        assert _request(port, "POST", f"/stream/{s}/end")[0] == 200
    status, data = _request(port, "POST", "/stream/start")
    assert status == 200                  # freed slots are reused
    assert _request(port, "POST", f"/stream/{data['slot']}/end")[0] == 200
    assert _request(port, "POST", "/stream/99/chunk", b"")[0] == 404
    assert _request(port, "POST", f"/stream/{data['slot']}/end")[0] == 404
    assert not teng.slots and len(teng.free) == 4
