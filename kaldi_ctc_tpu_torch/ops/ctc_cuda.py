"""CTC alpha and beta recursions: the CUDA kernels K1, K11, K12 and
their plain versions.

Counterpart of ``kaldi_ctc_tpu/ops/ctc_pallas.py`` (``alpha_beta_pallas``,
``forward_alphas_pallas``, ``backward_betas_pallas``); the plain versions
are the loops of ``kaldi_ctc_tpu/ops/ctc.py`` (``_forward_alphas``,
``_backward_betas``) on the gathered label log-probs.  One CUDA source,
``csrc/ctc_alpha_beta.cu``, has the kernels.  K1 takes one of two
routes, chosen from S by :func:`k1_plan`: ``warp`` (one warp per
utterance and recursion, the states in registers, S up to
``K1_WARP_MAX_S``) or ``block`` (one block per utterance, the rows in
shared memory).  K11 and K12, each one recursion alone, take the
``band`` route up to ``BAND_MAX_S`` (one block per utterance whose
warps each hold a band of 32 states and hand the band's edge states on
through shared memory; :func:`k11_plan`, :func:`k12_plan`), else the
block kernel.  Every route gives the same bits.

Each wrapper takes the JAX signature: ``lp_ext_t`` [T, B, S] f32,
``skip_ok`` / ``skip_down`` [B, S] bool, ``lens`` and ``label_lens`` [B]
int, and returns alphas and/or betas [T, B, S] f32.  A CPU tensor goes
to the plain version; a CUDA tensor launches the kernel or raises.
Log 0 is the finite -1e30, never -inf (hazard F4).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.utils import profiling

__all__ = ["NEG_INF", "K1_WARP_MAX_S", "K1Plan", "k1_plan", "BAND_MAX_S",
           "BandPlan", "k11_plan", "k12_plan", "logaddexp", "alpha_beta",
           "alpha_beta_reference", "forward_alphas",
           "forward_alphas_reference", "backward_betas",
           "backward_betas_reference"]

NEG_INF = -1e30  # finite stand-in for log(0); avoids inf-inf NaNs

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ctc_alpha_beta": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ctc_alpha_beta_warp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ctc_log1p_unit_check": [ctypes.c_uint, ctypes.c_uint, _P, _P],
    "ctc_alphas": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ctc_betas": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ctc_alphas_band": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ctc_betas_band": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ctc_band_smem": [_I],
}
# the block kernel keeps two rows of S per recursion in one block's
# shared memory (227 KB on the H100)
_MAX_S = 232448 // (4 * 4)
# the warp route: at most 8 states a lane (csrc/ctc_alpha_beta.cu
# kMaxPerLane)
K1_WARP_MAX_S = 32 * 8


class K1Plan(NamedTuple):
    """K1's route ("warp" or "block") and, on the warp route, the states
    each lane holds."""
    route: str
    states_per_lane: int


def k1_plan(s: int) -> K1Plan:
    """K1's route for S lattice states: the warp route up to
    ``K1_WARP_MAX_S``, else the block kernel.  A pure function of S."""
    if 1 <= s <= K1_WARP_MAX_S:
        return K1Plan("warp", -(-s // 32))
    return K1Plan("block", 0)


# The band route of K11 and K12 (csrc/ctc_alpha_beta.cu kBandMaxWarps,
# kRing): at most 8 warps of 32 lanes, one state a lane.  On the card (an
# NVIDIA H100 80GB HBM3 at 700 W, B=48, T=240) it beat the block kernel
# at S = 141; two states a lane on fewer warps, and other hand-offs
# between bands, were slower (PERF.md), so above 256 states the plans
# take the block kernel.
BAND_MAX_WARPS = 8
BAND_MAX_S = 32 * BAND_MAX_WARPS
_LP_RING = 5


class BandPlan(NamedTuple):
    """K11's or K12's route ("band" or "block") and, on the band route,
    its warps (one band of 32 states each)."""
    route: str
    warps: int


def _band_plan(s: int) -> BandPlan:
    if 1 <= s <= BAND_MAX_S:
        return BandPlan("band", -(-s // 32))
    return BandPlan("block", 0)


def k11_plan(s: int) -> BandPlan:
    """K11's route for S lattice states: the band route up to
    ``BAND_MAX_S``, else the block kernel.  A pure function of S."""
    return _band_plan(s)


def k12_plan(s: int) -> BandPlan:
    """K12's route for S lattice states, as :func:`k11_plan`."""
    return _band_plan(s)


def _band_smem_bytes(warps: int) -> int:
    """The band route's dynamic shared memory, the twin of
    ``band_smem_bytes`` in the source (``ctc_band_smem`` returns it): per
    warp a ring of lp rows of 32 floats and a float2 edge."""
    return warps * (_LP_RING * 32 * 4 + 8)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``'s formula, max + log1p(exp(-|a-b|)), which the
    kernels use too (torch.logaddexp computes it otherwise)."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x moved k states toward higher s (k < 0: toward lower s), filled
    with NEG_INF; stays [B, S] even when S < |k|."""
    s = x.shape[1]
    pad = x.new_full((x.shape[0], abs(k)), NEG_INF)
    if k > 0:
        return torch.cat([pad, x], dim=1)[:, :s]
    return torch.cat([x, pad], dim=1)[:, -k:]


def forward_alphas_reference(lp_ext_t: torch.Tensor, skip_ok: torch.Tensor,
                             lens: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`forward_alphas` on any device: the alpha
    loop of ``ctc.py::_forward_alphas``.  Differentiable by autograd."""
    t_max, _, s_max = lp_ext_t.shape
    col = torch.arange(s_max, device=lp_ext_t.device)
    live = lens.to(lp_ext_t.device)[:, None]
    alpha = torch.where(col <= 1, lp_ext_t[0], NEG_INF)
    out = [alpha]
    for t in range(1, t_max):
        prev = logaddexp(alpha, _shift(alpha, 1))
        prev = logaddexp(prev, torch.where(skip_ok, _shift(alpha, 2),
                                           NEG_INF))
        new = (prev.clamp_min(NEG_INF) + lp_ext_t[t]).clamp_min(NEG_INF)
        # frames past the true length leave alpha unchanged
        alpha = torch.where(t < live, new, alpha)
        out.append(alpha)
    return torch.stack(out)


def backward_betas_reference(lp_ext_t: torch.Tensor, skip_down: torch.Tensor,
                             lens: torch.Tensor, label_lens: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of :func:`backward_betas` on any device: the beta
    loop of ``ctc.py::_backward_betas``, each utterance starting at its
    own last frame on states 2L and 2L-1."""
    t_max, b, s_max = lp_ext_t.shape
    dev = lp_ext_t.device
    col = torch.arange(s_max, device=dev)[None, :]
    last = (2 * label_lens.to(dev))[:, None]
    terminal = (col == last) | (col == last - 1)
    live = lens.to(dev)[:, None]
    beta = lp_ext_t.new_full((b, s_max), NEG_INF)
    out = [None] * t_max
    for t in range(t_max - 1, -1, -1):
        lp = lp_ext_t[t]
        nxt = logaddexp(beta, _shift(beta, -1))
        nxt = logaddexp(nxt, torch.where(skip_down, _shift(beta, -2),
                                         NEG_INF))
        new = (nxt.clamp_min(NEG_INF) + lp).clamp_min(NEG_INF)
        new = torch.where(t == live - 1, torch.where(terminal, lp, NEG_INF),
                          new)
        # frames past the end stay -1e30 until the init fires
        beta = torch.where(t < live, new, beta)
        out[t] = beta
    return torch.stack(out)


def alpha_beta_reference(lp_ext_t, skip_ok, skip_down, lens, label_lens
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`alpha_beta`: the two loops."""
    return (forward_alphas_reference(lp_ext_t, skip_ok, lens),
            backward_betas_reference(lp_ext_t, skip_down, lens, label_lens))


def _check(what, lp_ext_t, masks, ints):
    """Validate the operands of a kernel launch → int32 copies of
    ``ints``."""
    if lp_ext_t.dim() != 3 or lp_ext_t.dtype != torch.float32 \
            or not lp_ext_t.is_contiguous():
        raise ValueError(f"{what}: lp_ext_t must be contiguous f32 "
                         f"[T, B, S], got {lp_ext_t.dtype} "
                         f"{tuple(lp_ext_t.shape)}")
    _, b, s = lp_ext_t.shape
    if s > _MAX_S:
        raise ValueError(f"{what}: S = {s} states exceed one block's "
                         f"shared memory (at most {_MAX_S})")
    dev = lp_ext_t.device
    for name, m in masks.items():
        if (m.dtype != torch.bool or tuple(m.shape) != (b, s)
                or m.device != dev or not m.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous bool "
                             f"[{b}, {s}] on {dev}, got {m.dtype} "
                             f"{tuple(m.shape)} on {m.device}")
    out = []
    for name, v in ints.items():
        if (tuple(v.shape) != (b,) or v.device != dev
                or v.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"{what}: {name} must be int [{b}] on {dev}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
        out.append(v.to(torch.int32).contiguous())
    return out


def _device(what, lp_ext_t) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if lp_ext_t.device.type == "cpu":
        return False
    if lp_ext_t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {lp_ext_t.device}")
    return True


def _launch(entry, what, lp_ext_t, *args):
    t_max, b, s = lp_ext_t.shape
    lib = _kernels.load("ctc_alpha_beta", _SIGNATURES)
    err = getattr(lib, entry)(*(a.data_ptr() for a in (lp_ext_t,) + args),
                              t_max, b, s,
                              _kernels.stream_ptr(lp_ext_t.device))
    _kernels.check(lib, err, what)


def alpha_beta(lp_ext_t: torch.Tensor, skip_ok: torch.Tensor,
               skip_down: torch.Tensor, lens: torch.Tensor,
               label_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: both recursions in one launch, on :func:`k1_plan`'s route →
    (alphas, betas) [T, B, S] f32."""
    if not _device("alpha_beta", lp_ext_t):
        return alpha_beta_reference(lp_ext_t, skip_ok, skip_down, lens,
                                    label_lens)
    lens32, ll32 = _check("alpha_beta", lp_ext_t,
                          {"skip_ok": skip_ok, "skip_down": skip_down},
                          {"lens": lens, "label_lens": label_lens})
    if not lp_ext_t.numel():
        return torch.empty_like(lp_ext_t), torch.empty_like(lp_ext_t)
    plan = k1_plan(lp_ext_t.shape[2])
    out = _alpha_beta_route(plan.route, lp_ext_t, skip_ok, skip_down, lens32,
                            ll32)
    alpha_beta.launches += 1
    if plan.route == "warp":
        alpha_beta.warp_launches += 1
    else:
        alpha_beta.block_launches += 1
    return out


def _alpha_beta_route(route, lp_ext_t, skip_ok, skip_down, lens32, ll32):
    """K1 on ``route`` on checked operands → (alphas, betas): "warp"
    (``ctc_alpha_beta_warp``, S at most ``K1_WARP_MAX_S``) or "block"
    (``ctc_alpha_beta``)."""
    alphas = torch.empty_like(lp_ext_t)
    betas = torch.empty_like(lp_ext_t)
    entry = "ctc_alpha_beta_warp" if route == "warp" else "ctc_alpha_beta"
    _launch(entry, f"alpha_beta ({route} route)", lp_ext_t, skip_ok,
            skip_down, lens32, ll32, alphas, betas)
    return alphas, betas


def _route_entry(route, entry, s):
    """The C entry point of K11's or K12's ``route`` ("band": ``entry``
    + "_band", refused above ``BAND_MAX_S`` states; "block": ``entry``)."""
    if route != "band":
        return entry
    if s > BAND_MAX_S:
        raise ValueError(f"band route: S = {s} is above BAND_MAX_S = "
                         f"{BAND_MAX_S}")
    return entry + "_band"


def _alphas_route(route, lp_ext_t, skip_ok, lens32):
    """K11 on ``route`` on checked operands → alphas: "band"
    (``ctc_alphas_band``, S at most ``BAND_MAX_S``) or "block"
    (``ctc_alphas``)."""
    alphas = torch.empty_like(lp_ext_t)
    _launch(_route_entry(route, "ctc_alphas", lp_ext_t.shape[2]),
            f"forward_alphas ({route} route)", lp_ext_t, skip_ok, lens32,
            alphas)
    return alphas


def _betas_route(route, lp_ext_t, skip_down, lens32, ll32):
    """K12 on ``route`` on checked operands → betas, as
    :func:`_alphas_route` (``ctc_betas_band``, ``ctc_betas``)."""
    betas = torch.empty_like(lp_ext_t)
    _launch(_route_entry(route, "ctc_betas", lp_ext_t.shape[2]),
            f"backward_betas ({route} route)", lp_ext_t, skip_down, lens32,
            ll32, betas)
    return betas


def forward_alphas(lp_ext_t: torch.Tensor, skip_ok: torch.Tensor,
                   lens: torch.Tensor) -> torch.Tensor:
    """K11: the alpha recursion alone, on :func:`k11_plan`'s route →
    alphas [T, B, S] f32."""
    if not _device("forward_alphas", lp_ext_t):
        return forward_alphas_reference(lp_ext_t, skip_ok, lens)
    (lens32,) = _check("forward_alphas", lp_ext_t, {"skip_ok": skip_ok},
                       {"lens": lens})
    if not lp_ext_t.numel():
        return torch.empty_like(lp_ext_t)
    plan = k11_plan(lp_ext_t.shape[2])
    alphas = _alphas_route(plan.route, lp_ext_t, skip_ok, lens32)
    forward_alphas.launches += 1
    if plan.route == "band":
        forward_alphas.band_launches += 1
    else:
        forward_alphas.block_launches += 1
    return alphas


def backward_betas(lp_ext_t: torch.Tensor, skip_down: torch.Tensor,
                   lens: torch.Tensor, label_lens: torch.Tensor
                   ) -> torch.Tensor:
    """K12: the beta recursion alone, on :func:`k12_plan`'s route →
    betas [T, B, S] f32."""
    if not _device("backward_betas", lp_ext_t):
        return backward_betas_reference(lp_ext_t, skip_down, lens,
                                        label_lens)
    lens32, ll32 = _check("backward_betas", lp_ext_t,
                          {"skip_down": skip_down},
                          {"lens": lens, "label_lens": label_lens})
    if not lp_ext_t.numel():
        return torch.empty_like(lp_ext_t)
    plan = k12_plan(lp_ext_t.shape[2])
    betas = _betas_route(plan.route, lp_ext_t, skip_down, lens32, ll32)
    backward_betas.launches += 1
    if plan.route == "band":
        backward_betas.band_launches += 1
    else:
        backward_betas.block_launches += 1
    return betas


# kernel launches made by each wrapper, and by route
alpha_beta.launches = 0
alpha_beta.warp_launches = 0
alpha_beta.block_launches = 0
forward_alphas.launches = 0
forward_alphas.band_launches = 0
forward_alphas.block_launches = 0
backward_betas.launches = 0
backward_betas.band_launches = 0
backward_betas.block_launches = 0

# every snapshot of the span registry reads these counters where they are
profiling.register_launch_counters(
    alpha_beta, forward_alphas, backward_betas)
