"""Smoke run of the PyTorch/CUDA port (kaldi_ctc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kaldi_ctc_tpu_torch/csrc`` and drives
the serving path once at the full width of the flagship model.  Each phase
prints one JSON line; any failed phase exits non-zero with no result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: both kernels compiled by nvcc for sm_90a, timed;
3. k4_log_mel: the log-mel kernel against its plain version on 8 s of
   16 kHz audio (798 frames, MFCC-hires mel bank): max error, median ms;
4. k2_bilstm: the BiLSTM recurrence kernel against its plain version at
   T=800, B=1 and B=8, H=320, in f32 and bf16: max errors, median ms;
5. serve: the 5x320 BLSTM flagship (random weights from a seed) written as
   a JAX-format artifact and served by the port's own HTTP server on cuda;
   4 /recognize requests of 2, 4, 6 and 8 s of seeded audio per compute
   dtype (f32, then bf16); status, frames and labels checked; the kernel
   launch counters must rise by 5 (K2, one per layer) and >= 1 (K4) per
   request; scores compared with the same engine running the plain
   versions on the card; per-request latency and RTF;
6. profile: one 8 s request per dtype under torch.profiler: device time
   by kernel, K2's and K4's shares, the device's idle share of the traced
   request's wall time, and the untraced wall beside it.

Then a line ``{"kernels": [...]}`` with each kernel's launches during the
served requests, its error and its time beside the plain version's; the
card's ``nvidia-smi`` name and power limit; and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device, and when run outside the repository.
"""

import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each against the plain PyTorch version on the same inputs
# on the card.  K4: rtol/atol of the JAX package's own kernel-vs-XLA
# feature test; K2 f32: another f32 summation order compounded over 800
# steps of a contracting recurrence; K2 bf16: y is stored in bf16 (ulp
# 2^-8 near 1) and h enters each step rounded to bf16, so a flipped
# rounding moves later steps by ~an ulp.  Scores are log posteriors.
K4_TOL = 2e-4
K2_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SCORE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def median_ms(fn, runs, torch):
    """Median of per-run CUDA-event times (ms), after one warm-up run."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def max_err(got, ref, rtol, atol):
    """(max |got-ref|, whether every element is within atol + rtol*|ref|)."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= atol + rtol * ref.float().abs()).all())
    return float(d.max()) if d.numel() else 0.0, ok


@contextlib.contextmanager
def plain_versions():
    """Route the wrappers' callers to the plain versions (for the
    comparison run; no kernel launches and no counts)."""
    from kaldi_ctc_tpu_torch.features import stft_cuda
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    saved = stft_cuda.log_mel, rnn_cuda.bilstm_seq_fwd
    stft_cuda.log_mel = stft_cuda.log_mel_reference
    rnn_cuda.bilstm_seq_fwd = rnn_cuda.bilstm_seq_fwd_reference
    try:
        yield
    finally:
        stft_cuda.log_mel, rnn_cuda.bilstm_seq_fwd = saved


def pcm(seconds, seed, np):
    """Seeded band-limited-ish noise as s16le PCM (the serve tests')."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(int(16000 * seconds)))
    x = (x - x.mean()) / (np.abs(x).max() + 1e-6)
    return (x * 20000).astype("<i2")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi[0] if smi else "not read"


def phase_build():
    from kaldi_ctc_tpu_torch import _kernels
    out = {}
    for name in ("log_mel", "bilstm_fwd"):
        t0 = time.perf_counter()
        path = _kernels.build(name)
        out[name] = {"seconds": round(time.perf_counter() - t0, 3),
                     "library": os.path.relpath(path, ROOT)}
    emit({"phase": "build", "nvcc_flags": " ".join(_kernels.NVCC_FLAGS),
          **out})


def phase_k4(torch, np, dev):
    from kaldi_ctc_tpu_torch.features import MfccOptions, stft_cuda
    from kaldi_ctc_tpu_torch.features.mel import mel_banks
    from kaldi_ctc_tpu_torch.features.window import (feature_window,
                                                     frame_signal)
    opts = MfccOptions.hires()
    fo = opts.frame_opts
    wave = torch.as_tensor(pcm(8.0, 100, np).astype(np.float32), device=dev)
    frames = frame_signal(wave, fo).contiguous()
    window = torch.as_tensor(feature_window(fo), device=dev)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, fo), device=dev)
    args = (frames, window, mel, fo.padded_window_size)
    got = stft_cuda.log_mel(*args)
    ref = stft_cuda.log_mel_reference(*args)
    torch.cuda.synchronize()
    err_m, ok_m = max_err(got[0], ref[0], K4_TOL, K4_TOL)
    err_e, ok_e = max_err(got[1], ref[1], K4_TOL, K4_TOL)
    ms = median_ms(lambda: stft_cuda.log_mel(*args), 20, torch)
    plain_ms = median_ms(lambda: stft_cuda.log_mel_reference(*args), 20,
                         torch)
    res = {"phase": "k4_log_mel", "frames": int(frames.shape[0]),
           "max_abs_err_logmel": err_m, "max_abs_err_energy": err_e,
           "tol": K4_TOL, "ms": ms, "plain_ms": plain_ms}
    emit(res)
    if not (ok_m and ok_e) or frames.shape[0] != 798:
        fail(f"K4 log_mel disagrees with its plain version: {res}")
    return {"max_abs_err": max(err_m, err_e), "ms": ms, "plain_ms": plain_ms}


def phase_k2(torch, np, dev):
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    t_max, h = 800, 320
    rows = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for b in (1, 8):
            rng = np.random.default_rng(b)
            xp = torch.as_tensor(rng.standard_normal((t_max, b, 8 * h))
                                 .astype(np.float32) * 0.5, device=dev)
            w = [torch.as_tensor((rng.standard_normal((h, 4 * h))
                                  / np.sqrt(h)).astype(np.float32),
                                 device=dev).to(dtype) for _ in range(2)]
            lens = np.full(b, t_max, np.int32)
            lens[1:] = rng.integers(t_max // 2, t_max + 1, size=b - 1)
            args = (xp.to(dtype), w[0], w[1],
                    torch.as_tensor(lens, device=dev))
            got = rnn_cuda.bilstm_seq_fwd(*args)
            ref = rnn_cuda.bilstm_seq_fwd_reference(*args)
            torch.cuda.synchronize()
            errs = [max_err(g, r, 0.0, K2_TOL[dtype_name])
                    for g, r in zip(got, ref)]
            row = {"dtype": dtype_name, "T": t_max, "B": b, "H": h,
                   "max_abs_err": max(e for e, _ in errs),
                   "tol": K2_TOL[dtype_name],
                   "ms": median_ms(lambda: rnn_cuda.bilstm_seq_fwd(*args),
                                   10, torch),
                   "plain_ms": median_ms(
                       lambda: rnn_cuda.bilstm_seq_fwd_reference(*args), 3,
                       torch)}
            rows.append(row)
            emit({"phase": "k2_bilstm", **row})
            if not all(ok for _, ok in errs):
                fail(f"K2 bilstm_seq_fwd disagrees with its plain version: "
                     f"{row}")
    # the kernels line reports the serving shape: bf16, B = 1
    serve_row = next(r for r in rows
                     if r["dtype"] == "bfloat16" and r["B"] == 1)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": serve_row["ms"], "plain_ms": serve_row["plain_ms"]}


def post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = json.loads(resp.read().decode())
    conn.close()
    return resp.status, data, time.perf_counter() - t0


def phase_serve(torch, np):
    from kaldi_ctc_tpu_torch.cli import serve
    from kaldi_ctc_tpu_torch.features import stft_cuda
    from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig,
                                                     default_priors,
                                                     init_am_params)
    from kaldi_ctc_tpu_torch.models.artifact import save_inference_artifact
    from kaldi_ctc_tpu_torch.ops import rnn_cuda
    from kaldi_ctc_tpu_torch.ops.rnn import RnnMode

    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    seconds = (2.0, 4.0, 6.0, 8.0)
    audio = [pcm(s, 10 + i, np) for i, s in enumerate(seconds)]
    launches = {"log_mel": 0, "bilstm_fwd": 0}
    engines = {}
    for dtype in ("float32", "bfloat16"):
        cfg = AmConfig(input_dim=40, num_targets=72, hidden_dim=320,
                       num_layers=5, mode=RnnMode.LSTM, bidirectional=True,
                       compute_dtype=dtype)
        params = init_am_params(cfg, torch.Generator().manual_seed(0))
        path = os.path.join(out_dir, f"flagship_{dtype}.npz")
        save_inference_artifact(path, params, cfg,
                                priors=default_priors(cfg.num_targets))
        server, engine = serve.make_server(serve.parse_args(
            ["--model", path, "--device", "cuda", "--port", "0"]))
        engines[dtype] = engine
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            # warm-up: first cuBLAS / allocator use, not timed
            status, _, _ = post(port, "/recognize", pcm(1.0, 9, np).tobytes())
            if status != 200:
                fail(f"serve warm-up answered {status}")
            reqs = []
            # counts from the served requests only
            stft_cuda.log_mel.launches = 0
            rnn_cuda.bilstm_seq_fwd.launches = 0
            for secs, x in zip(seconds, audio):
                k2_0 = rnn_cuda.bilstm_seq_fwd.launches
                k4_0 = stft_cuda.log_mel.launches
                status, data, wall = post(port, "/recognize", x.tobytes())
                k2 = rnn_cuda.bilstm_seq_fwd.launches - k2_0
                k4 = stft_cuda.log_mel.launches - k4_0
                frames = 1 + (len(x) - 400) // 160
                reqs.append({"seconds": secs, "status": status,
                             "num_frames": data.get("num_frames"),
                             "num_labels": len(data.get("labels", [])),
                             "latency_ms": round(wall * 1000, 3),
                             "rtf": data.get("rtf"), "k2_launches": k2,
                             "k4_launches": k4})
                if status != 200 or data.get("num_frames") != frames:
                    fail(f"/recognize {secs}s: {status} {data}")
                labels = data["labels"]
                if not all(isinstance(l, int) and 0 < l < 72
                           for l in labels):
                    fail(f"/recognize {secs}s: bad labels {labels[:10]}")
                if k2 != cfg.num_layers or k4 < 1:
                    fail(f"/recognize {secs}s launched K2 {k2}x (want "
                         f"{cfg.num_layers}) and K4 {k4}x (want >= 1)")
            launches["log_mel"] += stft_cuda.log_mel.launches
            launches["bilstm_fwd"] += rnn_cuda.bilstm_seq_fwd.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        # the same engine on the plain versions, on the card
        score_err, same_labels = 0.0, 0
        for x in audio:
            xf = x.astype(np.float32)
            feats = engine.feats_for(xf)
            _, _, raw = engine.score_utt(feats)
            with plain_versions():
                feats_p = engine.feats_for(xf)
                _, _, raw_p = engine.score_utt(feats_p)
            if not np.isfinite(raw).all() or raw.shape != (feats.shape[0],
                                                           72):
                fail(f"scores not finite or misshapen: {raw.shape}")
            score_err = max(score_err, float(np.abs(raw - raw_p).max()))
            same_labels += int((raw.argmax(-1) == raw_p.argmax(-1)).all())
        res = {"phase": "serve", "dtype": dtype,
               "model": "5x320 BLSTM, 40-dim MFCC-hires, 72 targets",
               "requests": reqs, "max_abs_score_err_vs_plain": score_err,
               "score_tol": SCORE_TOL[dtype],
               "utterances_with_equal_frame_argmax": same_labels}
        emit(res)
        if score_err > SCORE_TOL[dtype]:
            fail(f"served scores disagree with the plain versions: {res}")
    return launches, engines


def phase_profile(torch, np, engines):
    """Where one 8 s request's time goes: device time by kernel from
    torch.profiler, against the request's wall time with and without
    the profiler."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    x = pcm(8.0, 13, np).astype(np.float32)
    for dtype, engine in engines.items():
        for _ in range(2):
            engine.recognize(x)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.recognize(x)
            walls.append((time.perf_counter() - t0) * 1000)
        walls.sort()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.recognize(x)
            traced_ms = (time.perf_counter() - t0) * 1000
        kernels = []
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if evt.device_type == DeviceType.CUDA and us > 0:
                kernels.append((us, evt.count, evt.key))
        kernels.sort(reverse=True)
        device_ms = sum(k[0] for k in kernels) / 1000

        def share(tag):
            return round(sum(k[0] for k in kernels if tag in k[2])
                         / 1000 / device_ms, 4) if device_ms else None

        emit({"phase": "profile", "dtype": dtype, "audio_s": 8.0,
              "untraced_ms_median_of_5": round(walls[2], 3),
              "traced_ms": round(traced_ms, 3),
              "device_kernel_ms": (round(device_ms, 3) if device_ms
                                   else "not measured"),
              # busy and idle from the same traced window; the tracer
              # itself adds host time (traced vs untraced wall)
              "device_idle_share_of_traced_wall":
                  (round(1 - device_ms / traced_ms, 4) if device_ms
                   else "not measured"),
              "k2_share_of_device": share("bilstm_fwd_kernel"),
              "k4_share_of_device": share("log_mel_kernel"),
              "top_kernels": [{"name": k[2][:80], "us": round(k[0], 1),
                               "count": k[1]} for k in kernels[:8]]})


def main():
    if not os.path.exists(os.path.join(ROOT, "kaldi_ctc_tpu_torch", "csrc",
                                       "bilstm_fwd.cu")):
        fail("run from a checkout of the repository: kaldi_ctc_tpu_torch/"
             "csrc is missing beside chip_smoke.py")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one NVIDIA card")
    dev = torch.device("cuda", 0)
    smi = phase_device(torch)
    phase_build()
    k4 = phase_k4(torch, np, dev)
    k2 = phase_k2(torch, np, dev)
    launches, engines = phase_serve(torch, np)
    if min(launches.values()) < 1:
        fail(f"a kernel of the serving path never launched: {launches}")
    phase_profile(torch, np, engines)
    emit({"kernels": [
        {"name": "log_mel", "route": "cuda",
         "source": "kaldi_ctc_tpu_torch/csrc/log_mel.cu",
         "replaces": "kaldi_ctc_tpu/features/stft_pallas.py:79",
         "launches": launches["log_mel"], **k4},
        {"name": "bilstm_fwd", "route": "cuda",
         "source": "kaldi_ctc_tpu_torch/csrc/bilstm_fwd.cu",
         "replaces": "kaldi_ctc_tpu/ops/rnn_pallas.py:602",
         "launches": launches["bilstm_fwd"], **k2}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
