"""Training cells: ``train_ctc`` (under ``launch`` on several chips) on a
seeded pool of utterances, measured over a window of its steps.

Set-up: the pool's features and alignments reach ``train_ctc`` through
piped rspecifiers (``asrbench.featgen``); the hook writes the seed's
weights as the checkpoint that ``--resume`` starts from; the program
runs ``warmup_epochs`` epochs, whose batches hold every shape the run
uses.  The window opens at the record of the warm-up's last step and
holds every step recorded in the next ``seconds``; the harness then ends
the process.  Afterwards the reference repeats the first three steps on
the card and judges the program's records and parameters.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from asrbench import batches as bt
from asrbench import cells, checks, proc, traffic as tr

__all__ = ["run", "schedule", "warm_steps", "num_steps"]

CAPTURE = (1, 3)


def _flags(t: dict) -> dict:
    return t["train_flags"]


def _program_seed(seed: int) -> int:
    return int(seed) % (1 << 62)


def schedule(traffic: dict, seed: int, pool, steps: int):
    """The program's first ``steps`` global batches, worked out again
    (``batches.global_batches``)."""
    f = _flags(traffic)
    return bt.global_batches(pool, _program_seed(seed),
                             int(f["minibatch-size"]),
                             int(f["max-allow-frames"]),
                             int(f["frame-subsampling-factor"]),
                             int(traffic.get("processes", 1)), steps)


def warm_steps(traffic: dict, seed: int, pool) -> int:
    """Steps of the first ``warmup_epochs`` epochs."""
    epochs = int(traffic.get("warmup_epochs", 1))
    n = 64
    while True:
        sched = schedule(traffic, seed, pool, n)
        if sched[-1]["epoch"] >= epochs:
            return sum(g["epoch"] < epochs for g in sched)
        n *= 2


def num_steps(traffic: dict, pool) -> int:
    """``train_ctc``'s lr decay horizon: a process's loaded utterances
    over its batch, times the epochs."""
    f = _flags(traffic)
    n = int(traffic.get("processes", 1))
    shard = bt.rank_shards(pool, n, int(f["max-allow-frames"]),
                           int(f["frame-subsampling-factor"]))[0]
    return max(len(shard) // (int(f["minibatch-size"]) // n), 1) * int(
        f["epochs"])


def _command(cell, seed: int, run_dir: str, device: str) -> list:
    cfg, t = cell.config, cell.traffic
    py = sys.executable

    def piped(part, what):
        return (f"ark:{py} -m asrbench.featgen --traffic {cell.traffic_path} "
                f"--seed {int(seed)} --part {part} --what {what} "
                f"--dim {int(cfg['input_dim'])} |")

    cmd = [py, "-m", "kaldi_ctc_tpu_torch.cli.train_ctc",
           "--feats", piped("train", "feats"), "--ali", piped("train", "ali"),
           "--valid-feats", piped("valid", "feats"),
           "--valid-ali", piped("valid", "ali"),
           "--num-targets", str(cfg["num_targets"]),
           "--hidden-dim", str(cfg["hidden_dim"]),
           "--num-layers", str(cfg["num_layers"]),
           "--rnn-mode", str(cfg["rnn_mode"]),
           "--bidirectional", str(cfg["bidirectional"]),
           "--compute-dtype", cfg["compute_dtype"]]
    for k, v in _flags(t).items():
        cmd += [f"--{k}", str(v)]
    cmd += ["--seed", str(_program_seed(seed)),
            "--dir", os.path.join(run_dir, "exp"), "--resume",
            "--device", device]
    n = int(t.get("processes", 1))
    if n > 1:
        cmd = [py, "-m", "kaldi_ctc_tpu_torch.cli.launch",
               "--num-processes", str(n), "--"] + cmd
    return cmd


def _labels(ali: np.ndarray) -> np.ndarray:
    keep = np.concatenate([[True], ali[1:] != ali[:-1]])
    return (ali[keep] + 1).astype(np.int64)


def _reference_check(cell, seed: int, run_dir: str, pool, res: dict,
                     device: str) -> dict:
    """Readings of the program's first three steps against the
    reference's."""
    import torch

    from asrbench import reference as ref
    from asrbench import weights

    cfg, t, f = cell.config, cell.traffic, _flags(cell.traffic)
    fs = int(f["frame-subsampling-factor"])
    sched = schedule(t, seed, pool, len(res["batch_keys"]))
    # every batch the program's first process took, against the rules
    differ = sum([pool[i].key for i in g["ranks"][0]] != keys
                 for g, (_, keys) in zip(sched, res["batch_keys"]))
    mine = [sum(g["ranks"], []) for g in sched[:max(CAPTURE)]]
    batches = []
    for b in mine:
        rows = []
        for i in b:
            u = pool[i]
            feats = tr.utterance_features(u, seed, int(cfg["input_dim"]))
            rows.append((feats[0::fs] if fs > 1 else feats,
                         _labels(tr.utterance_alignment(u, t, seed))))
        batches.append(rows)
    p0 = weights.make_params(cfg, seed, device)
    horizon = num_steps(t, pool)
    lr_i, lr_f = (float(f["initial-learning-rate"]),
                  float(f["final-learning-rate"]))
    out = ref.sgd_steps(p0, batches, cfg, lr_i, lr_f, horizon,
                        clip=float(f.get("clip-gradient", 5.0)))
    losses = {}
    with open(os.path.join(run_dir, "exp", "metrics.jsonl")) as fh:
        for line in fh:
            r = json.loads(line)
            if r.get("event") == "train_step" and r["step"] <= len(mine):
                losses[r["step"]] = r["loss_per_frame"]
    prog_loss = [losses.get(s + 1, float("nan")) for s in range(len(mine))]
    p1 = [x.to(device) for x in torch.load(
        os.path.join(run_dir, "params_step1.pt"))]
    p3 = [x.to(device) for x in torch.load(
        os.path.join(run_dir, "params_step3.pt"))]
    lr0 = float(np.float32(ref.lr_at(0, lr_i, lr_f, horizon)))
    g_ref = [(a - b) / lr0 for a, b in zip(p0, out["params"][0])]
    g_prog = [(a - b) / lr0 for a, b in zip(p0, p1)]
    norms = [float(torch.linalg.vector_norm(g.double())) for g in g_ref]
    grad1 = checks.leaf_gaps(g_prog, g_ref, norms)
    change3 = checks.leaf_gaps([a - b for a, b in zip(p3, p0)],
                               [a - b for a, b in zip(out["params"][2], p0)],
                               norms)
    names = weights.leaf_names(cfg)
    for what, gaps in (("grad1", grad1), ("change3", change3)):
        worst = sorted(gaps, key=lambda i: -gaps[i])[:3]
        sys.stderr.write(f"{what} worst leaves: " + ", ".join(
            f"{names[i]} {gaps[i]:.3g}" for i in worst) + "\n")
    sys.stderr.write("loss per frame, program / reference: " + ", ".join(
        f"{a!r} / {b!r}" for a, b in zip(prog_loss, out["loss_per_frame"]))
        + "\n")
    return {
        "batches_differ": float(differ),
        "loss1_rel": checks.loss_gap(prog_loss[:1], out["loss_per_frame"][:1]),
        "loss_rel": checks.loss_gap(prog_loss, out["loss_per_frame"]),
        "grad1_rel": max(grad1.values()),
        "change3_rel": max(change3.values()),
    }


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", fault=None,
        check_cards=None) -> dict:
    """One run → the end-to-end metrics, the readings of ``correct`` and
    the per-layer readers' context.  ``check_cards``, called once the
    program has started, raises ``proc.NoCards`` to end the run."""
    t = cell.traffic
    f = _flags(t)
    pool = tr.train_pool(t, seed, "train")
    warm = warm_steps(t, seed, pool)
    run_dir = tempfile.mkdtemp(prefix="asrbench-train-")
    try:
        settings = {"role": "train",
                    "entry": "kaldi_ctc_tpu_torch.cli.train_ctc", "config": cell.config, "seed": int(seed),
                    "run_dir": run_dir, "exp_dir": os.path.join(run_dir, "exp"),
                    "seconds": float(seconds), "warm_steps": warm,
                    "trace": bool(trace), "device": device,
                    "capture_steps": list(CAPTURE), "fault": fault,
                    "kernel_layers": cells.kernel_layers(cell.bench_dir)}
        spath = os.path.join(run_dir, "settings.json")
        with open(spath, "w") as fh:
            json.dump(settings, fh)
        log = os.path.join(run_dir, "program.log")
        t_spawn = time.monotonic()
        p = proc.start(_command(cell, seed, run_dir, device), spath, log)
        try:
            if check_cards is not None:
                check_cards()
            res = proc.wait_for(os.path.join(run_dir, "results.json"), p,
                                timeout_s=1100.0)
        finally:
            proc.end(p)
        if res is None:
            sys.stderr.write(proc.tail(log))
            raise RuntimeError("train_ctc ended before the window closed")
        t_open, t_end = res["t_open"], res["t_open"] + float(seconds)
        stamps = res["stamps"]
        fs = int(f["frame-subsampling-factor"])
        sched = schedule(t, seed, pool, len(stamps))

        def step_work(k):
            # the global batch: the first process's rows as it recorded
            # them, the others' as the rules deal them (checked against
            # the first's in the readings)
            us = [pool[i] for i in sum(sched[k]["ranks"], [])]
            e = sched[k]["epoch"]
            return (sum(u.seconds for u in us),
                    [tr.subsampled_frames(u.frames, fs, e % fs) for u in us])

        window = [k for k, (_, s) in enumerate(stamps) if t_open < s <= t_end]
        traced = [k for k, (_, s) in enumerate(stamps) if s > t_open]
        audio = sum(step_work(k)[0] for k in window)
        ctx = {"kind": "train", "config": cell.config, "chips": cell.chips,
               "seconds": float(seconds), "trace": res.get("trace"),
               "device_name": res.get("device_name", ""),
               "frames_window": [n for k in window for n in step_work(k)[1]],
               "frames_trace": [n for k in traced for n in step_work(k)[1]],
               "stamps_trace": [stamps[k][1] for k in traced]}
        first = stamps[0][1] if stamps else t_open
        gaps = [b[1] - a[1] for a, b in zip(stamps[:warm], stamps[1:warm])]
        if gaps:
            sys.stderr.write(
                "warm-up step gaps (ms): first " + ", ".join(
                    f"{1e3 * g:.0f}" for g in gaps[:5])
                + f"; median {1e3 * sorted(gaps)[len(gaps) // 2]:.1f}\n")
        sys.stderr.write(
            f"setup: harness {t_spawn - t_start:.2f} s, program start to "
            f"hook {res['t_install'] - t_spawn:.2f} s, weights "
            f"{res['t_weights'] - res['t_install']:.2f} s, to the first step "
            f"{first - res['t_weights']:.2f} s, warm-up steps "
            f"{t_open - first:.2f} s ({warm} steps)\n")
        if res.get("trace"):
            sys.stderr.write(
                f"trace: {res['trace']['device_events']} device events, "
                f"reduced in {res['trace']['reduce_s']:.2f} s\n")
        t_ref = time.monotonic()
        readings = _reference_check(cell, seed, run_dir, pool, res, device)
        sys.stderr.write(f"reference: {time.monotonic() - t_ref:.2f} s\n")
        result = {
            "attempted": len(window), "failed": 0,
            "end_to_end": {"audio_s_per_s": audio / float(seconds),
                           "setup_s": t_open - t_start},
            "readings": readings, "ctx": ctx, "results": res,
        }
        return result
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

