"""The numbers that decide ``correct``, each held to its limit.

Training cells compare, against the reference's three steps from the
same weights on the same batches: each step's loss per frame, the norm
of the first gradient as the update applied it (worked out from the
parameters after step 1), and the norm of the parameters' change after
step 3, both by the worst leaf.  Serving cells compare the widest gap by
which a served frame's token lies below the reference's best.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

__all__ = ["leaf_gaps", "leaf_gap", "loss_gap", "judge", "passed", "report_lines"]


def leaf_gaps(prog: Sequence, ref: Sequence,
              ref_grad_norms: Sequence[float]) -> Dict[int, float]:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖)},
    leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's (round-off moves them, not the
    step)."""
    import torch

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    gmed = statistics.median(ref_grad_norms)
    pn = [norm(p) for p in prog]
    rn = [norm(r) for r in ref]
    keep = [i for i, g in enumerate(ref_grad_norms) if g >= 1e-3 * gmed]
    med = statistics.median([rn[i] for i in keep])
    return {i: abs(pn[i] - rn[i]) / max(rn[i], med) for i in keep}


def leaf_gap(prog: Sequence, ref: Sequence,
             ref_grad_norms: Sequence[float]) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, ref_grad_norms).values())


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limited reading; a reading
    with no limit is an error of the benchmark."""
    out = {}
    for name, limit in limits.items():
        if name not in readings:
            raise KeyError(f"no reading {name!r} for its limit")
        out[name] = {"value": readings[name], "limit": limit}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def report_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {n} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
            for n, c in checks.items()]
