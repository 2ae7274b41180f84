"""The benchmark's side of a program process.

``hookpath/sitecustomize.py`` calls :func:`install` at interpreter start
in every process the harness starts with ``ASRBENCH_HOOK`` set to a
settings file.  It runs before the program's ``main``:

- it makes the weights on the device from the seed (``weights``) and
  hands them to the program through the program's own files: a
  checkpoint that ``train_ctc --resume`` starts from, or the model file
  ``serve --model`` loads;
- it stamps the measured window with the host clock: a training run's
  window opens at the record of step ``warm_steps`` and closes at the
  first record past ``seconds``; a server's window is opened and closed
  by the harness with SIGUSR1 and SIGUSR2;
- in a traced run it opens ``torch.profiler`` for the window alone and,
  in ``train_ctc``, puts ``record_function`` spans around the calls into
  the program's layers;
- it keeps what the reference judges: the parameters after the steps in
  ``capture_steps`` and the keys of every training batch;
- with ``fault`` set (the benchmark's own tests and the planted-fault
  readings) it breaks the timed path underneath.

At the window's close it writes ``results.json`` beside the settings.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

__all__ = ["install"]


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class _Window:
    """The window's stamps, the profiler and the results file."""

    def __init__(self, settings: dict, device):
        self.s = settings
        self.device = device
        self.prof = None
        self.t_open = None
        self.closed = False
        self.trace_ns = None
        self.results_path = os.path.join(settings["run_dir"], "results.json")

    def open(self) -> None:
        import torch
        if self.s.get("trace"):
            from torch.profiler import ProfilerActivity, profile
            # host operations only where the spans are read: a server's
            # handler threads are not traced, and their per-operation
            # cost would slow every request
            acts = ([ProfilerActivity.CPU] if self.s.get("trace_host", True)
                    else [])
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.start()
            self.trace_ns = [time.time_ns(), None]
        self.t_open = time.monotonic()

    def close(self, extra: dict) -> None:
        import torch
        self.closed = True
        t_close = time.monotonic()
        out = {"t_open": self.t_open, "t_close": t_close,
               "t_install": self.s.get("t_install"),
               "t_weights": self.s.get("t_weights"), **extra}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            out["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(self.device))
            out["device_name"] = torch.cuda.get_device_name(self.device)
        if self.prof is not None:
            self.trace_ns[1] = time.time_ns()
            self.prof.stop()
            from asrbench.trace import summarize
            t0 = time.monotonic()
            out["trace"] = summarize(self.prof, self.trace_ns[0],
                                     self.trace_ns[1],
                                     self.s.get("kernel_layers", {}))
            out["trace"]["reduce_s"] = time.monotonic() - t0
        _write_json(self.results_path, out)


def _device(settings: dict):
    import torch
    if settings.get("device", "cuda") == "cpu":
        return torch.device("cpu")
    rank = int(os.environ.get("LOCAL_RANK", os.environ.get("PROCESS_ID", "0")))
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def _span(name: str, fn):
    from torch.profiler import record_function

    def wrapped(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# train_ctc
# ---------------------------------------------------------------------------

def _install_train(s: dict) -> None:
    import torch

    import kaldi_ctc_tpu_torch.training as training
    import kaldi_ctc_tpu_torch.training.checkpoint as ckpt
    from kaldi_ctc_tpu_torch.data import pipeline
    from kaldi_ctc_tpu_torch.utils import logging as klog

    from asrbench import weights

    cfg = s["config"]
    device = _device(s)
    rank = int(os.environ.get("PROCESS_ID", "0"))
    ckpt_dir = os.path.join(s["exp_dir"], "checkpoints")
    meta = os.path.join(ckpt_dir, "step_0", "meta.json")
    if rank == 0:
        tree = weights.unflatten(cfg, weights.make_params(cfg, s["seed"],
                                                          device))
        ckpt.save_checkpoint(ckpt_dir, 0, training.init_train_state(tree),
                             extra={"epoch": 0, "epoch_step": 0,
                                    "num_layers": int(cfg["num_layers"])})
    else:
        while not os.path.exists(meta):
            time.sleep(0.05)

    s["t_weights"] = time.monotonic()
    win = _Window(s, device)
    stamps: list = []
    batch_keys: list = []
    keys_lock = threading.Lock()
    capture = set(s.get("capture_steps", []))
    fault = s.get("fault")

    make_step = training.make_train_step

    def make_train_step(cfg_, opts, mesh=None):
        step = make_step(cfg_, opts, mesh)
        calls = [0]

        def train_step(state, batch):
            new, m = step(state, batch)
            if fault == "half_batch":
                # the update from half the rows, scaled to the whole
                # batch; the records keep the whole batch's loss
                half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
                part, _ = step(state, half)
                new = new._replace(params=training.train.tree_map(
                    lambda p0, p1: p0 + 2.0 * (p1 - p0), state.params,
                    part.params))
            if fault == "unchanged":
                new = state._replace(step=new.step)
            calls[0] += 1
            if calls[0] in capture and rank == 0:
                torch.save([t.detach().cpu() for t in
                            weights.flatten(new.params)],
                           os.path.join(s["run_dir"],
                                        f"params_step{calls[0]}.pt"))
            return new, m
        if s.get("trace"):
            return _span("asrbench.train_step", train_step)
        return train_step

    training.make_train_step = make_train_step

    orig_log = klog.MetricsLogger.log

    def log(self, event, **kv):
        orig_log(self, event, **kv)
        if event != "train_step" or win.closed:
            return
        now = time.monotonic()
        stamps.append([int(kv["step"]), now])
        if len(stamps) == int(s["warm_steps"]):
            win.open()
        elif win.t_open is not None and now > win.t_open + float(s["seconds"]):
            if rank != 0:
                win.closed = True
                return
            with keys_lock:
                keys = list(batch_keys)
            win.close({"stamps": stamps, "batch_keys": keys})
            # the harness reads the results and ends the run
            os._exit(0)

    klog.MetricsLogger.log = log

    orig_init = pipeline.EgsPipeline.__init__
    orig_epoch = pipeline.EgsPipeline.epoch
    made = [0]

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        # the first pipeline train_ctc builds is the training set's
        self._asrbench_train = made[0] == 0
        made[0] += 1

    def epoch(self, epoch_idx=0):
        for b in orig_epoch(self, epoch_idx):
            if getattr(self, "_asrbench_train", False):
                with keys_lock:
                    batch_keys.append([int(epoch_idx), list(b["keys"])])
            yield b

    pipeline.EgsPipeline.__init__ = init
    pipeline.EgsPipeline.epoch = epoch

    if fault == "no_exchange":
        import kaldi_ctc_tpu_torch.parallel.mesh as mesh_mod
        mesh_mod.sum_over_data = lambda mesh, tensors: list(tensors)

    if s.get("trace"):
        pipeline.Prefetcher.__next__ = _span("asrbench.data_wait",
                                             pipeline.Prefetcher.__next__)
        training.accuracy_from_outputs = _span(
            "asrbench.accuracy", training.accuracy_from_outputs)
        ckpt.save_checkpoint = _span("asrbench.checkpoint",
                                     ckpt.save_checkpoint)
        klog.MetricsLogger.log = _span("asrbench.log", log)
        make_eval = training.make_eval_step

        def make_eval_step(cfg_, mesh=None):
            return _span("asrbench.cv", make_eval(cfg_, mesh))

        training.make_eval_step = make_eval_step


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def _write_model(path: str, cfg: dict, seed: int, device) -> None:
    """The model file ``serve --model`` loads (the program's artifact
    layout: numbered leaves, the config as JSON bytes, the priors)."""
    import numpy as np

    from asrbench import weights

    arrays = {f"leaf_{i}": t.cpu().numpy() for i, t in
              enumerate(weights.make_params(cfg, seed, device))}
    am = {"input_dim": int(cfg["input_dim"]),
          "num_targets": int(cfg["num_targets"]),
          "hidden_dim": int(cfg["hidden_dim"]),
          "num_layers": int(cfg["num_layers"]),
          "mode": int(cfg["rnn_mode"]),
          "bidirectional": bool(int(cfg["bidirectional"])),
          "param_stddev": float(cfg["param_stddev"]),
          "bias_stddev": float(cfg["bias_stddev"]),
          "compute_dtype": cfg["compute_dtype"]}
    arrays["__config__"] = np.frombuffer(json.dumps(am).encode(), np.uint8)
    priors = np.ones(int(cfg["num_targets"]), np.float32)
    priors[0] = float(cfg["blank_prior"])
    arrays["__priors__"] = priors
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)


def _install_recognize(s: dict) -> None:
    import torch

    import kaldi_ctc_tpu_torch.decoding.scores as scores_mod

    device = _device(s)
    _write_model(s["model_path"], s["config"], s["seed"], device)
    s["t_weights"] = time.monotonic()
    win = _Window(s, device)

    if s.get("fault") == "alter_token":
        orig_scores = scores_mod.acoustic_scores

        def acoustic_scores(logits, priors=None, acoustic_scale=1.0,
                            blank_threshold=0.98, blank=0):
            sc, skip = orig_scores(logits, priors, acoustic_scale,
                                   blank_threshold, blank)
            if blank_threshold >= 1.0 and sc.shape[1] > 0:
                # the greedy token of the middle frame, swapped for the
                # frame's worst one
                t = sc.shape[1] // 2
                sc = sc.clone()
                sc[0, t, torch.argmin(sc[0, t])] = sc[0, t].max() + 1.0
            return sc, skip
        scores_mod.acoustic_scores = acoustic_scores

    ack = os.path.join(s["run_dir"], "opened")

    def on_open(signum, frame):
        win.open()
        _write_json(ack, {"t_open": win.t_open})

    def on_close(signum, frame):
        win.close({})

    signal.signal(signal.SIGUSR1, on_open)
    signal.signal(signal.SIGUSR2, on_close)


def install(path: str) -> None:
    import sys

    t_install = time.monotonic()
    with open(path) as f:
        s = json.load(f)
    argv = list(getattr(sys, "orig_argv", sys.argv))
    if "-m" not in argv or argv[argv.index("-m") + 1:][:1] != [s["entry"]]:
        return      # a launcher, a piped rspecifier's writer
    s.setdefault("run_dir", os.path.dirname(os.path.abspath(path)))
    s["t_install"] = t_install
    {"train": _install_train, "recognize": _install_recognize}[s["role"]](s)
