"""Multi-process dry run, and the spawner it runs on.

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: n processes of one process group
(gloo on the CPU; NCCL, one rank per card, with ``device="cuda"``) run
on a ('data', 'model') mesh, with model = 2 when n is even and at least
4:

- one train step of the tiny flagship (2x16 BLSTM), the split leaves
  stored as slices;
- one train step of the DS2 variant (a 2-layer conv front);
- ``realign_examples`` on each process's shard, then the two gathers of
  ``train_ctc``'s realignment (the smallest kept size, the occupancy
  counts summed);
- the scoring forward with the priors from the gathered counts.

Each rank checks that its values are finite and equal to rank 0's.

``spawn(target, n, payload)`` runs ``module:function(payload)`` in n
fresh processes with the launcher's environment on a free port, waits
for them under a time limit, kills the rest when one fails or the limit
passes, and returns each rank's result.

  python -c "from kaldi_ctc_tpu_torch.parallel.dryrun import \\
      dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, List

import numpy as np

__all__ = ["spawn", "dryrun_multichip"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def spawn(target: str, n: int, payload: Any = None, device: str = "cpu",
          timeout: float = 120.0) -> List[Any]:
    """Run ``target`` ("module:function") in n processes of one group and
    return the list of their results, in rank order.  Each process joins
    the group with ``init_distributed(device=device)``, calls
    ``function(payload)`` and leaves the group.  Raises RuntimeError with
    the failing rank's output when a process fails or the ``timeout``
    (seconds, the whole run) passes; every process is stopped either
    way."""
    work = tempfile.mkdtemp(prefix="ctc_spawn_")
    try:
        with open(os.path.join(work, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        env = dict(os.environ)
        env.update(COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
                   NUM_PROCESSES=str(n),
                   # the children import what this process imports
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        procs = []
        for rank in range(n):
            env["PROCESS_ID"] = str(rank)
            log = open(os.path.join(work, f"rank{rank}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, "--target", target,
                 "--dir", work, "--device", device],
                env=dict(env), stdout=log, stderr=subprocess.STDOUT))
            log.close()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
                    break
                if time.monotonic() > deadline:
                    failed = f"no end after {timeout:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed or bad:
            rank = bad[0] if bad else 0
            raise RuntimeError(
                f"spawn {target} x{n}: {failed or f'rank {rank} failed'}; "
                f"rank {rank}'s output:\n"
                + _tail(os.path.join(work, f"rank{rank}.log")))
        results = []
        for rank in range(n):
            with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _child(argv=None) -> None:
    from kaldi_ctc_tpu_torch.parallel.distributed import (init_distributed,
                                                          process_index,
                                                          shutdown)
    p = argparse.ArgumentParser()
    p.add_argument("--target", required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    module, name = args.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    with open(os.path.join(args.dir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    init_distributed(device=args.device)
    try:
        result = fn(payload)
        path = os.path.join(args.dir, f"rank{process_index()}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        shutdown()


def _same_on_every_rank(values: np.ndarray, what: str) -> None:
    """Raise unless ``values`` are finite and equal to rank 0's."""
    from kaldi_ctc_tpu_torch.parallel.distributed import (process_allgather,
                                                          process_index)
    if not np.all(np.isfinite(values)):
        raise AssertionError(f"{what}: non-finite values {values}")
    every = process_allgather(values)
    if not np.array_equal(every[process_index()], every[0]):
        raise AssertionError(f"{what}: rank {process_index()} has "
                             f"{every[process_index()]}, rank 0 {every[0]}")


def _dryrun_rank(_payload=None) -> dict:
    """One rank of ``dryrun_multichip``."""
    import torch

    from kaldi_ctc_tpu_torch.data.egs import CtcExample
    from kaldi_ctc_tpu_torch.decoding.scores import acoustic_scores
    from kaldi_ctc_tpu_torch.models import AmConfig, am_forward, init_am_params
    from kaldi_ctc_tpu_torch.params import tree_flatten
    from kaldi_ctc_tpu_torch.parallel import make_mesh, shard_batch
    from kaldi_ctc_tpu_torch.parallel.distributed import (host_shard,
                                                          process_allgather,
                                                          process_count)
    from kaldi_ctc_tpu_torch.training import (TrainOptions, init_train_state,
                                              make_train_step)
    from kaldi_ctc_tpu_torch.training.realign import realign_examples
    from kaldi_ctc_tpu_torch.training.train import (shard_train_state,
                                                    whole_params)

    n = process_count()
    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(data=n // model_par, model=model_par)
    cfg = AmConfig(input_dim=8, num_targets=8, hidden_dim=16, num_layers=2)

    # the global batch (2 rows a process, as the JAX dry run), this
    # process's rows by its data index
    b, t, lmax = n * 2, 16, 3
    rng = np.random.default_rng(0)
    glob = {
        "feats": rng.standard_normal((b, t, cfg.input_dim)).astype(np.float32),
        "labels": rng.integers(1, cfg.num_targets, (b, lmax)).astype(np.int32),
        "input_lens": np.full((b,), t, np.int32),
        "label_lens": np.full((b,), lmax, np.int32)}
    rows = b // mesh.data
    mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    batch = shard_batch({k: v[mine] for k, v in glob.items()}, mesh)

    out = {}
    for name, c, seed in (("flagship", cfg, 0),
                          ("ds2", dataclasses.replace(
                              cfg, conv_layers=2, conv_channels=4,
                              conv_time_stride=2), 1)):
        params = init_am_params(c, torch.Generator().manual_seed(seed),
                                mesh.device)
        state = shard_train_state(init_train_state(params), c, mesh)
        state, m = make_train_step(c, TrainOptions(), mesh)(state, batch)
        whole = whole_params(state.params, c, mesh)
        values = np.asarray(
            [float(m["loss_total"]), float(m["grad_norm"]),
             int(m["num_frames"])]
            + [float(x.double().sum()) for x in tree_flatten(whole)])
        _same_on_every_rank(values, name)
        out[name] = values
        if name == "flagship":
            flagship = whole

    # realignment over the mesh: each process aligns its shard with the
    # post-step parameters, then train_ctc's two gathers
    rng2 = np.random.default_rng(1)
    exs = []
    for i in range(2 * n):
        tt = 12 + 2 * (i % 3)
        exs.append(CtcExample(
            f"u{i}", rng2.standard_normal((tt, cfg.input_dim)).astype(
                np.float32),
            rng2.integers(1, cfg.num_targets, size=2).astype(np.int32)))
    kept, counts, stats = realign_examples(host_shard(exs), flagship, cfg,
                                           minibatch_size=2)
    sizes = process_allgather(np.asarray([len(kept)], np.int64)).reshape(-1)
    kept = kept[:int(sizes.min())]
    counts = np.zeros_like(counts)
    for e in kept:
        counts += stats["counts_by_key"][e.key]
    counts_g = process_allgather(counts[None]).reshape(
        -1, counts.shape[0]).sum(axis=0)
    if not (counts_g.sum() > 0 and kept):
        raise AssertionError("realignment kept nothing")
    _same_on_every_rank(counts_g.astype(np.float64), "realign counts")
    out["counts"] = counts_g

    # the scoring forward with the realigned priors
    priors = np.maximum((counts_g / counts_g.sum()).astype(np.float32),
                        1.0e-15)
    with torch.no_grad():
        logits = am_forward(flagship, batch["feats"], cfg,
                            input_lens=batch["input_lens"])
        scores, _ = acoustic_scores(logits, priors=priors)
    scores = scores.cpu().numpy()
    if not np.all(np.isfinite(scores)):
        raise AssertionError("non-finite acoustic scores")
    out["scores_sum"] = float(scores.astype(np.float64).sum())
    return out


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     timeout: float = 120.0) -> List[dict]:
    """Run the dry run in ``n_devices`` processes; each rank's values."""
    results = spawn(f"{__name__}:_dryrun_rank", n_devices, device=device,
                    timeout=timeout)
    for r, res in enumerate(results[1:], 1):
        for key in ("flagship", "ds2", "counts"):
            if not np.array_equal(res[key], results[0][key]):
                raise AssertionError(f"rank {r}'s {key} differs from "
                                     "rank 0's")
    return results


if __name__ == "__main__":
    _child()
