"""Readings that set a cell's limits: the program's, the control's and the
planted faults', on the card at the cell's own size.

  python3 asrbench/control.py --workload blstm5x320.train --seeds 1,2,3
  python3 asrbench/control.py --workload blstm5x320.train --seeds 1,2,3 \\
      --program 1 --seconds 2
  python3 asrbench/control.py --workload blstm5x320.train --seeds 1,2,3 \\
      --fault half_batch --seconds 2

Without ``--program`` or ``--fault``: the control, the reference put in
the program's place and computed in TF32 (the precision below the
configuration's IEEE f32), judged by the same numbers against the f32
reference on the same weights and inputs: a training cell's first three
steps, every request of a serving cell's window, all seeds in one
process.  ``--program 1`` runs the cell as the benchmark
does with a short window and prints its readings; ``--fault`` the same
with the timed path broken underneath.  One JSON line a seed.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_train(cell, seed: int) -> dict:
    import torch

    from asrbench import checks, reference as ref, traffic as tr, weights
    from asrbench.drivers import train as drv

    cfg, t = cell.config, cell.traffic
    f = t["train_flags"]
    fs = int(f["frame-subsampling-factor"])
    pool = tr.train_pool(t, seed, "train")
    batches = []
    for g in drv.schedule(t, seed, pool, 3):
        batches.append([(tr.utterance_features(pool[i], seed,
                                               int(cfg["input_dim"]))[0::fs],
                         drv._labels(tr.utterance_alignment(pool[i], t, seed)))
                        for i in sum(g["ranks"], [])])
    p0 = weights.make_params(cfg, seed, "cuda")
    num_steps = drv.num_steps(t, pool)
    lr_i, lr_f = (float(f["initial-learning-rate"]),
                  float(f["final-learning-rate"]))
    args = (batches, cfg, lr_i, lr_f, num_steps)
    exact = ref.sgd_steps(p0, *args)
    low = ref.sgd_steps(p0, *args, tf32=True)
    lr0 = float(torch.tensor(ref.lr_at(0, lr_i, lr_f, num_steps),
                             dtype=torch.float32))
    g_ref = [(a - b) / lr0 for a, b in zip(p0, exact["params"][0])]
    g_low = [(a - b) / lr0 for a, b in zip(p0, low["params"][0])]
    norms = [float(torch.linalg.vector_norm(g.double())) for g in g_ref]
    return {"loss1_rel": checks.loss_gap(low["loss_per_frame"][:1],
                                         exact["loss_per_frame"][:1]),
            "loss_rel": checks.loss_gap(low["loss_per_frame"],
                                        exact["loss_per_frame"]),
            "grad1_rel": checks.leaf_gap(g_low, g_ref, norms),
            "change3_rel": checks.leaf_gap(
                [a - b for a, b in zip(low["params"][2], p0)],
                [a - b for a, b in zip(exact["params"][2], p0)], norms)}


def control_recognize(cell, seed: int, seconds: float) -> dict:
    import numpy as np

    from asrbench import reference as ref, traffic as tr, weights
    from asrbench.drivers import recognize as drv

    cfg, t = cell.config, cell.traffic
    requests = sorted(tr.request_schedule(t, seed, seconds),
                      key=lambda r: r.samples)
    pcm = tr.pcm_pool(t, seed)
    tree = weights.unflatten(cfg, weights.make_params(cfg, seed, "cuda"))
    feats = [ref.mfcc_hires(tr.request_pcm(pcm, r)) for r in requests]
    gap, flips = 0.0, 0
    for i in range(0, len(requests), drv.BLOCK):
        exact = ref.scores(tree, feats[i:i + drv.BLOCK], cfg, "cuda")
        low = ref.scores(tree, feats[i:i + drv.BLOCK], cfg, "cuda", tf32=True)
        for e, lo in zip(exact, low):
            flips += int(np.sum(np.argmax(e, 1) != np.argmax(lo, 1)))
            gap = max(gap, ref.label_gap(e, ref.greedy_labels(lo)))
    return {"label_gap": gap, "frames_flipped": flips}


def main(argv=None) -> int:
    from asrbench import cells

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", type=int, default=0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    cell = cells.find_cell(cells.load_benchmark(ROOT), ROOT, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        if args.program or args.fault:
            out = cells.driver_for(cell).run(cell, seed, args.seconds, False,
                                             t0, device="cuda",
                                             fault=args.fault)
            readings = out["readings"]
        elif cell.traffic["kind"] == "train":
            readings = control_train(cell, seed)
        else:
            readings = control_recognize(cell, seed, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "what": ("fault:" + args.fault if args.fault else
                                   "program" if args.program else "control"),
                          "readings": readings,
                          "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
