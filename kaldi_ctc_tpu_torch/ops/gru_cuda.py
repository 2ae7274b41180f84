"""GRU recurrences on CUDA: the kernels K9a, K9b (one direction) and K8a,
K8b (both directions of a bidirectional layer), and their plain versions.

Counterpart of ``kaldi_ctc_tpu/ops/gru_pallas.py``: ``gru_seq_fwd``,
``_gru_seq_bwd_dgates`` and ``gru_sequence`` with its custom VJP;
``_bigru_seq_fwd``, ``_bigru_seq_bwd_dgates`` and ``bigru_layer`` with its
custom VJP.  Each kernel wrapper (:func:`gru_seq_fwd` and
:func:`bigru_seq_fwd` of ``csrc/gru_fwd.cu``, :func:`gru_seq_bwd_dgates`
and :func:`bigru_seq_bwd_dgates` of ``csrc/gru_bwd.cu``) sends a CPU
tensor to its plain version (``*_reference``) and launches the kernel or
raises for a CUDA tensor.  :func:`gru_sequence` and :func:`bigru_layer`
are ``torch.autograd.Function``s whose backward runs K9b or K8b and then
the weight and input gradients as plain products, as the JAX package
leaves them to XLA.  On the card K9a's and K8a's routes come from
``rnn_cuda.fwd_chain_plan`` with three gates and one or two directions:
the forward chain in thread-block clusters (``csrc/fwd_chain.cuh`` with
the GRU cell; any B, one launch) where W_h fits a cluster, else the
cooperative kernel in row slices.  K9b's and K8b's come from
``rnn_cuda.bwd_chain_plan`` with three gates and one or two directions:
the backward chain in clusters (``csrc/bwd_chain.cuh`` with the GRU cell;
any B) after K9b's phase 1, every step's recurrent sums at once, or, for
K8b, on the sums K8a stored, which :func:`bigru_layer` asks K8a for where
a backward is recorded; else the cooperative kernel in row slices.

The cell is cuDNN's linear-before-reset GRU (``ops.rnn._gru_gates``, gate
order r, z, n, no recurrent bias).  The forward writes y (and, for K8b,
its recurrent sums); the backward forms the gates from ``x_proj[t] +
y[prev] · W_h`` (the forward's sums, or recomputed) and emits
two gate cotangents: ``dgx`` (the projection's) and ``dgh`` (its n block
scaled by r; the recurrent product's, for dW_h and the dh carry).  Under
bfloat16 the shipped default of the JAX package's ``_bf16_cfg`` holds:
the projection, the layer outputs and both cotangents are stored in bf16,
the weight-gradient operands are bf16, gate math and carries are f32, and
weight gradients come out f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.ops.rnn import (COMPUTE_DTYPES, _gru_gates, _valid,
                                         matmul_f32acc)
from kaldi_ctc_tpu_torch.ops.rnn_cuda import (_I, _P, _REC_GATES_ARGS,
                                              _SUFFIX, BwdChainPlan,
                                              FwdChainPlan, _check_lens,
                                              _check_tensors, _check_x_proj,
                                              _dw_h, _records_backward,
                                              _scratch_steps, _sm_count,
                                              _smem_optin, bwd_chain_plan,
                                              fwd_chain_plan, max_rows,
                                              run_in_row_slices)
from kaldi_ctc_tpu_torch.utils import profiling

__all__ = ["gru_seq_fwd", "gru_seq_fwd_reference", "gru_seq_bwd_dgates",
           "gru_seq_bwd_dgates_reference", "gru_sequence", "bigru_seq_fwd",
           "bigru_seq_fwd_reference", "bigru_seq_bwd_dgates",
           "bigru_seq_bwd_dgates_reference", "bigru_layer", "k8a_plan",
           "k8b_plan", "k9a_plan", "k9b_plan"]

_FWD_SIGNATURES = {"gru_fwd_f32": [_P] * 5 + [_I] * 4 + [_P],
                   "gru_fwd_bf16": [_P] * 5 + [_I] * 4 + [_P],
                   "gru_fwd_chain_f32": [_P] * 5 + [_I] * 6 + [_P],
                   "gru_fwd_chain_bf16": [_P] * 5 + [_I] * 6 + [_P],
                   "gru_fwd_smem_optin": [],
                   "bigru_fwd_f32": [_P] * 7 + [_I] * 3 + [_P],
                   "bigru_fwd_bf16": [_P] * 7 + [_I] * 3 + [_P],
                   "bigru_fwd_chain_f32": [_P] * 8 + [_I] * 5 + [_P],
                   "bigru_fwd_chain_bf16": [_P] * 8 + [_I] * 5 + [_P]}
_BWD_SIGNATURES = {"gru_bwd_f32": [_P] * 8 + [_I] * 4 + [_P],
                   "gru_bwd_bf16": [_P] * 8 + [_I] * 4 + [_P],
                   "bigru_bwd_f32": [_P] * 13 + [_I] * 3 + [_P],
                   "bigru_bwd_bf16": [_P] * 13 + [_I] * 3 + [_P],
                   "gru_bwd_exchange_floats": [_I] * 3,
                   "gru_bwd_smem_optin": [],
                   "gru_bwd_gates_f32": _REC_GATES_ARGS,
                   "gru_bwd_gates_bf16": _REC_GATES_ARGS,
                   "gru_bwd_chain_f32": [_P] * 9 + [_I] * 8 + [_P],
                   "gru_bwd_chain_bf16": [_P] * 9 + [_I] * 8 + [_P],
                   "bigru_bwd_chain_f32": [_P] * 14 + [_I] * 5 + [_P],
                   "bigru_bwd_chain_bf16": [_P] * 14 + [_I] * 5 + [_P]}
# each source's batch-ceiling queries, one per kernel and dtype
_FWD_SIGNATURES.update({f"{k}_fwd_max_rows_{sfx}": [_I]
                        for k in ("gru", "bigru") for sfx in _SUFFIX.values()})
_BWD_SIGNATURES.update({f"{k}_bwd_max_rows_{sfx}": [_I]
                        for k in ("gru", "bigru") for sfx in _SUFFIX.values()})

Pair = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain versions: one direction's loop forward and backward
# ---------------------------------------------------------------------------


def _fwd_loop(x_proj: torch.Tensor, w_h: torch.Tensor, lens: torch.Tensor,
              reverse: bool, y_dtype: torch.dtype) -> torch.Tensor:
    """One direction's forward (``_fwd_kernel``): a loop of T steps;
    x_proj [T, B, 3H] may be a view of the fused projection."""
    t_max, b, g3 = x_proj.shape
    dev = x_proj.device
    valid = _valid(t_max, lens, dev)
    w = w_h.float()
    h = torch.zeros((b, g3 // 3), dtype=torch.float32, device=dev)
    y = torch.empty((t_max, b, g3 // 3), dtype=y_dtype, device=dev)
    for t in (range(t_max - 1, -1, -1) if reverse else range(t_max)):
        v = valid[t]
        r, z, n, _ = _gru_gates(x_proj[t], h, w, w_h.dtype)
        h_new = (1.0 - z) * n + z * h
        h = torch.where(v, h_new, h)
        y[t] = torch.where(v, h_new, 0.0).to(y_dtype)
    return y


def _bwd_loop(dy: torch.Tensor, x_proj: torch.Tensor, y: torch.Tensor,
              w_h: torch.Tensor, lens: torch.Tensor, reverse: bool,
              dg_dtype: torch.dtype) -> Pair:
    """One direction's backward (``_bwd_kernel`` with ``_dgru_update``):
    a loop of T steps in the opposite order of the forward → (dgx, dgh)."""
    t_max, b, h_dim = dy.shape
    cdt = w_h.dtype
    dev = x_proj.device
    valid = _valid(t_max, lens, dev)
    w = w_h.float()
    zeros = torch.zeros((b, h_dim), dtype=torch.float32, device=dev)
    dh = zeros
    dgx = torch.empty((t_max, b, 3 * h_dim), dtype=dg_dtype, device=dev)
    dgh = torch.empty_like(dgx)
    for s in range(t_max):
        t = s if reverse else t_max - 1 - s
        tp = t + 1 if reverse else t - 1
        first = s == t_max - 1        # the forward's first step
        # y[prev] as stored (the compute dtype), as JAX's recompute has it
        hp = zeros if first else y[tp].float()
        r, z, n, hn = _gru_gates(x_proj[t], hp, w, cdt)
        dh_total = dy[t].float() + dh
        dn = dh_total * (1.0 - z) * (1.0 - n * n)
        dz = dh_total * (hp - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        v = valid[t]
        gx = torch.where(v, torch.cat([dr, dz, dn], dim=-1), 0.0)
        gh = torch.where(v, torch.cat([dr, dz, dn * r], dim=-1), 0.0)
        dh = torch.where(v, torch.matmul(gh.to(cdt).float(), w.T)
                         + dh_total * z, dh)
        dgx[t] = gx.to(dg_dtype)
        dgh[t] = gh.to(dg_dtype)
    return dgx, dgh


def _exchange(lib, dirs: int, b: int, h: int, dev, what: str):
    """The partial-dh exchange of K9b / K8b; every entry read is written
    in the step before."""
    floats = lib.gru_bwd_exchange_floats(dirs, b, h)
    if floats < 0:
        raise RuntimeError(f"{what}: no exchange size for B={b}, H={h} on "
                           f"{dev}")
    return torch.empty((floats,), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# One unidirectional direction: K9a (forward) and K9b (backward)
# ---------------------------------------------------------------------------


def gru_seq_fwd_reference(x_proj: torch.Tensor, w_h: torch.Tensor,
                          lens: torch.Tensor, reverse: bool = False
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`gru_seq_fwd` on any device."""
    return _fwd_loop(x_proj, w_h, lens, reverse, x_proj.dtype)


def gru_seq_fwd(x_proj: torch.Tensor, w_h: torch.Tensor, lens: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """x_proj [T, B, 3H] hoisted projection and w_h [H, 3H], both in the
    compute dtype, lens [B], reverse (walk t = T-1 .. 0) → y [T, B, H] in
    the compute dtype.  The contract of ``gru_pallas.gru_seq_fwd``.  On
    the card the route is :func:`k9a_plan`'s, from the shapes: the forward
    chain in thread-block clusters, or the cooperative kernel in row
    slices."""
    if x_proj.device.type == "cpu":
        return gru_seq_fwd_reference(x_proj, w_h, lens, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_seq_fwd: unsupported device {x_proj.device}")
    h = _check_x_proj("gru_seq_fwd", x_proj, 3)
    t_max, b, g3 = x_proj.shape
    dev = x_proj.device
    _check_tensors("gru_seq_fwd", dev, {
        "x_proj": (x_proj, x_proj.dtype, (t_max, b, g3)),
        "w_h": (w_h, x_proj.dtype, (h, g3))})
    _check_lens("gru_seq_fwd", lens, b, dev)
    if t_max == 0 or b == 0:
        return torch.empty((t_max, b, h), dtype=x_proj.dtype, device=dev)
    lib = _kernels.load("gru_fwd", _FWD_SIGNATURES)
    plan = k9a_plan(lib, b, h, x_proj.dtype, dev)
    lens32 = lens.to(torch.int32).contiguous()
    if plan.route == "cluster":
        y = _gru_fwd_chain(lib, x_proj, w_h, lens32, reverse, plan)
    else:
        y = _gru_fwd_cooperative(lib, x_proj, w_h, lens32, reverse)
    gru_seq_fwd.launches += 1
    return y


def k9a_plan(lib, b: int, h: int, dtype: torch.dtype, device
             ) -> FwdChainPlan:
    """K9a's route and launch shape on ``device``:
    ``rnn_cuda.fwd_chain_plan`` with three gates and one direction."""
    return fwd_chain_plan(b, 0, h, dtype, 1, _sm_count(device),
                          _smem_optin(lib, "gru_fwd_smem_optin", device),
                          gates=3)


def _gru_fwd_chain(lib, x_proj: torch.Tensor, w_h: torch.Tensor,
                   lens32: torch.Tensor, reverse: bool, plan: FwdChainPlan
                   ) -> torch.Tensor:
    """K9a's cluster route (``gru_fwd_chain_*``, one launch for any B) on
    checked operands."""
    t_max, b, g3 = x_proj.shape
    h = g3 // 3
    dev = x_proj.device
    y = torch.empty((t_max, b, h), dtype=x_proj.dtype, device=dev)
    # the initial h: the operand's and the cell's f32 carry
    state = torch.zeros((2, 1, b, h), dtype=torch.float32, device=dev)
    err = getattr(lib, "gru_fwd_chain_" + _SUFFIX[x_proj.dtype])(
        x_proj.data_ptr(), w_h.data_ptr(), lens32.data_ptr(), y.data_ptr(),
        state.data_ptr(), t_max, b, h, plan.cluster, plan.rows, int(reverse),
        _kernels.stream_ptr(dev))
    _kernels.check(lib, err, f"gru_seq_fwd at T={t_max}, B={b}, {plan}")
    return y


def _gru_fwd_cooperative(lib, x_proj: torch.Tensor, w_h: torch.Tensor,
                         lens32: torch.Tensor, reverse: bool) -> torch.Tensor:
    """K9a's cooperative route (``gru_fwd_*``) on checked operands, in row
    slices under its ceiling."""
    t_max, _, g3 = x_proj.shape
    h = g3 // 3
    dev = x_proj.device
    sfx = _SUFFIX[x_proj.dtype]

    def launch(x_proj, lens32):
        n = x_proj.shape[1]
        y = torch.empty((t_max, n, h), dtype=x_proj.dtype, device=dev)
        # h exchange between blocks: [parity][B][H], parity 0 = h0
        hbuf = torch.zeros((2, n, h), dtype=torch.float32, device=dev)
        err = getattr(lib, "gru_fwd_" + sfx)(
            x_proj.data_ptr(), w_h.data_ptr(), lens32.data_ptr(),
            y.data_ptr(), hbuf.data_ptr(), t_max, n, h, int(reverse),
            _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "gru_seq_fwd")
        return (y,)

    y, = run_in_row_slices(
        launch, max_rows(lib, "gru_fwd_max_rows_" + sfx, dev, h), x_proj,
        lens32)
    return y


gru_seq_fwd.launches = 0  # kernel launches made by this wrapper


def gru_seq_bwd_dgates_reference(dy: torch.Tensor, x_proj: torch.Tensor,
                                 y: torch.Tensor, w_h: torch.Tensor,
                                 lens: torch.Tensor, reverse: bool = False
                                 ) -> Pair:
    """Plain PyTorch version of :func:`gru_seq_bwd_dgates` on any
    device."""
    return _bwd_loop(dy, x_proj, y, w_h, lens, reverse, x_proj.dtype)


def gru_seq_bwd_dgates(dy: torch.Tensor, x_proj: torch.Tensor,
                       y: torch.Tensor, w_h: torch.Tensor, lens: torch.Tensor,
                       reverse: bool = False) -> Pair:
    """Output cotangent dy [T, B, H] and the forward's residuals (x_proj
    [T, B, 3H], y [T, B, H] and w_h [H, 3H] in the compute dtype, lens
    [B], the forward's direction) → (dgx, dgh) [T, B, 3H] in x_proj's
    dtype.  The contract of ``gru_pallas._gru_seq_bwd_dgates``.  On the
    card the route is :func:`k9b_plan`'s, from the shapes: phase 1 (every
    step's recurrent sums at once) and the backward chain in thread-block
    clusters (any B, chunks of steps above a 256 MiB scratch) where W_h
    fits a cluster, else the cooperative kernel in row slices."""
    if x_proj.device.type == "cpu":
        return gru_seq_bwd_dgates_reference(dy, x_proj, y, w_h, lens,
                                            reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_seq_bwd_dgates: unsupported device "
                         f"{x_proj.device}")
    h = _check_x_proj("gru_seq_bwd_dgates", x_proj, 3)
    t_max, b, g3 = x_proj.shape
    dev = x_proj.device
    cdt = x_proj.dtype
    _check_tensors("gru_seq_bwd_dgates", dev, {
        "dy": (dy, cdt, (t_max, b, h)), "y": (y, cdt, (t_max, b, h)),
        "x_proj": (x_proj, cdt, (t_max, b, g3)), "w_h": (w_h, cdt, (h, g3))})
    _check_lens("gru_seq_bwd_dgates", lens, b, dev)
    if t_max == 0 or b == 0:
        return tuple(torch.empty((t_max, b, g3), dtype=cdt, device=dev)
                     for _ in range(2))
    lib = _kernels.load("gru_bwd", _BWD_SIGNATURES)
    plan = k9b_plan(lib, b, h, cdt, dev)
    lens32 = lens.to(torch.int32).contiguous()
    if plan.route == "cluster":
        out = _gru_bwd_chain(lib, dy, x_proj, y, w_h, lens32, reverse, plan)
    else:
        out = _gru_bwd_cooperative(lib, dy, x_proj, y, w_h, lens32, reverse)
    gru_seq_bwd_dgates.launches += 1
    return out


def k9b_plan(lib, b: int, h: int, dtype: torch.dtype, device
             ) -> BwdChainPlan:
    """K9b's route and launch shape on ``device``:
    ``rnn_cuda.bwd_chain_plan`` with three gates and one direction."""
    return bwd_chain_plan(b, h, dtype, 1, _sm_count(device),
                          _smem_optin(lib, "gru_bwd_smem_optin", device),
                          gates=3)


def _gru_bwd_chain(lib, dy, x_proj, y, w_h, lens32: torch.Tensor,
                   reverse: bool, plan: BwdChainPlan) -> Pair:
    """K9b's cluster route (``gru_bwd_gates_*``, then ``gru_bwd_chain_*``,
    per chunk of steps) on checked operands."""
    t_max, b, g3 = x_proj.shape
    h = g3 // 3
    dev = x_proj.device
    sfx = _SUFFIX[x_proj.dtype]
    stream = _kernels.stream_ptr(dev)
    dgx = torch.empty((t_max, b, g3), dtype=x_proj.dtype, device=dev)
    dgh = torch.empty_like(dgx)
    # phase 1's scratch holds the steps of one chunk; phase 2 carries dh
    # between chunks in `state`
    steps = _scratch_steps(t_max, b, g3)
    pre = torch.empty((steps, b, g3), dtype=torch.float32, device=dev)
    state = torch.zeros((1, 1, b, h), dtype=torch.float32, device=dev)
    what = f"gru_seq_bwd_dgates at T={t_max}, B={b}, {plan}"
    for s0 in range(0, t_max, steps):
        n = min(steps, t_max - s0)
        err = getattr(lib, "gru_bwd_gates_" + sfx)(
            y.data_ptr(), w_h.data_ptr(), pre.data_ptr(), s0, n, t_max, b, h,
            plan.gate_cols, int(reverse), stream)
        _kernels.check(lib, err, what + " phase 1")
        err = getattr(lib, "gru_bwd_chain_" + sfx)(
            dy.data_ptr(), x_proj.data_ptr(), y.data_ptr(), w_h.data_ptr(),
            lens32.data_ptr(), pre.data_ptr(), dgx.data_ptr(),
            dgh.data_ptr(), state.data_ptr(), s0, n, t_max, b, h,
            plan.cluster, plan.rows, int(reverse), stream)
        _kernels.check(lib, err, what + " phase 2")
    return dgx, dgh


def _gru_bwd_cooperative(lib, dy, x_proj, y, w_h, lens32: torch.Tensor,
                         reverse: bool) -> Pair:
    """K9b's cooperative route (``gru_bwd_*``) on checked operands, in
    row slices under its ceiling."""
    t_max, _, g3 = x_proj.shape
    h = g3 // 3
    dev = x_proj.device
    sfx = _SUFFIX[x_proj.dtype]

    def launch(dy, x_proj, y, lens32):
        n = x_proj.shape[1]
        dgx = torch.empty((t_max, n, g3), dtype=x_proj.dtype, device=dev)
        dgh = torch.empty_like(dgx)
        part = _exchange(lib, 1, n, h, dev, "gru_seq_bwd_dgates")
        err = getattr(lib, "gru_bwd_" + sfx)(
            dy.data_ptr(), x_proj.data_ptr(), y.data_ptr(), w_h.data_ptr(),
            lens32.data_ptr(), dgx.data_ptr(), dgh.data_ptr(),
            part.data_ptr(), t_max, n, h, int(reverse),
            _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "gru_seq_bwd_dgates")
        return dgx, dgh

    return run_in_row_slices(
        launch, max_rows(lib, "gru_bwd_max_rows_" + sfx, dev, h), dy, x_proj,
        y, lens32)

gru_seq_bwd_dgates.launches = 0  # kernel launches made by this wrapper


class _GruSequence(torch.autograd.Function):
    """``gru_sequence`` with the custom VJP of ``gru_pallas``: forward
    ``_gru_sequence_fwd`` (K9a), backward ``_gru_sequence_bwd`` (K9b,
    then the sliced dW_h product)."""

    @staticmethod
    def forward(ctx, x_proj, w_h, lens, reverse):
        y = gru_seq_fwd(x_proj, w_h.to(x_proj.dtype).contiguous(), lens,
                        reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(x_proj, w_h, lens, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x_proj, w_h, lens, y = ctx.saved_tensors
        cdt = x_proj.dtype
        dgx, dgh = gru_seq_bwd_dgates(dy.to(cdt).contiguous(), x_proj, y,
                                      w_h.to(cdt).contiguous(), lens,
                                      ctx.reverse)
        # one sliced product over all steps, emitted at the primal w_h's
        # dtype (f32 for master parameters)
        dw_h = _dw_h(y, dgh, ctx.reverse, cdt).to(w_h.dtype)
        return dgx, dw_h, None, None


def gru_sequence(x_proj: torch.Tensor, w_h: torch.Tensor, lens: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """Differentiable GRU over a sequence → y [T, B, H] in x_proj's (the
    compute) dtype.  w_h may arrive in master precision (f32): the cast
    to the compute dtype happens inside, so its gradient comes back f32;
    the x_proj gradient is dgx, in the compute dtype."""
    return _GruSequence.apply(x_proj, w_h, lens, reverse)


# ---------------------------------------------------------------------------
# A bidirectional layer: K8a (forward) and K8b (backward)
# ---------------------------------------------------------------------------


def bigru_seq_fwd_reference(xp: torch.Tensor, w_h_f: torch.Tensor,
                            w_h_b: torch.Tensor, lens: torch.Tensor,
                            y_dtype: Optional[torch.dtype] = None,
                            store_sums: bool = False):
    """Plain PyTorch version of :func:`bigru_seq_fwd` on any device: the
    forward direction at t = s, the backward direction at t = T-1-s.  It
    keeps no sums: with ``store_sums`` the third output is None (its
    backward recomputes them)."""
    g3 = xp.shape[2] // 2
    y_dtype = xp.dtype if y_dtype is None else y_dtype
    return ((_fwd_loop(xp[..., :g3], w_h_f, lens, False, y_dtype),
             _fwd_loop(xp[..., g3:], w_h_b, lens, True, y_dtype))
            + ((None,) if store_sums else ()))


def bigru_seq_fwd(xp: torch.Tensor, w_h_f: torch.Tensor, w_h_b: torch.Tensor,
                  lens: torch.Tensor, y_dtype: Optional[torch.dtype] = None,
                  store_sums: bool = False):
    """xp [T, B, 6H] fused projection (forward half first, compute dtype),
    w_h_f / w_h_b [H, 3H] in the compute dtype, lens [B] → (y_f, y_b)
    [T, B, H] in y_dtype (default xp's).  The contract of
    ``_bigru_seq_fwd``.  On the card the route is :func:`k8a_plan`'s,
    from the shapes: both directions' forward chains in thread-block
    clusters (any B, one launch) where W_h fits a cluster, else the
    cooperative kernel in row slices.

    ``store_sums`` (a backward will follow: :func:`bigru_layer` under
    autograd) appends a third output, the recurrent sums hr, hz, hn the
    cluster route formed its gates from, [T, B, 6H] f32 in K8b's walk
    order (row s: the forward direction's at t = T-1-s, the backward
    one's at t = s), for :func:`bigru_seq_bwd_dgates`; None where nothing
    was stored (the plain version, the cooperative route).  Counter
    ``store_launches``: the forwards that stored them."""
    y_dtype = xp.dtype if y_dtype is None else y_dtype
    if xp.device.type == "cpu":
        return bigru_seq_fwd_reference(xp, w_h_f, w_h_b, lens, y_dtype,
                                       store_sums)
    if xp.device.type != "cuda":
        raise ValueError(f"bigru_seq_fwd: unsupported device {xp.device}")
    h = _check_x_proj("bigru_seq_fwd", xp, 6)
    if y_dtype != xp.dtype:
        raise ValueError(f"bigru_seq_fwd: the kernel stores y in xp's "
                         f"dtype {xp.dtype}, not {y_dtype}")
    t_max, b, g6 = xp.shape
    dev = xp.device
    _check_tensors("bigru_seq_fwd", dev, {
        "xp": (xp, xp.dtype, (t_max, b, g6)),
        "w_h_f": (w_h_f, xp.dtype, (h, 3 * h)),
        "w_h_b": (w_h_b, xp.dtype, (h, 3 * h))})
    _check_lens("bigru_seq_fwd", lens, b, dev)
    if t_max == 0 or b == 0:
        out = tuple(torch.empty((t_max, b, h), dtype=y_dtype, device=dev)
                    for _ in range(2))
        return out + (None,) if store_sums else out
    lib = _kernels.load("gru_fwd", _FWD_SIGNATURES)
    plan = k8a_plan(lib, b, h, xp.dtype, dev)
    lens32 = lens.to(torch.int32).contiguous()
    if plan.route == "cluster":
        out = _bigru_fwd_chain(lib, xp, w_h_f, w_h_b, lens32, plan,
                               store_sums)
        if store_sums:
            bigru_seq_fwd.store_launches += 1
    else:
        out = _bigru_fwd_cooperative(lib, xp, w_h_f, w_h_b, lens32)
        if store_sums:
            out += (None,)
    bigru_seq_fwd.launches += 1
    return out


def k8a_plan(lib, b: int, h: int, dtype: torch.dtype, device
             ) -> FwdChainPlan:
    """K8a's route and launch shape on ``device``:
    ``rnn_cuda.fwd_chain_plan`` with three gates and both directions."""
    return fwd_chain_plan(b, 0, h, dtype, 2, _sm_count(device),
                          _smem_optin(lib, "gru_fwd_smem_optin", device),
                          gates=3)


def _bigru_fwd_chain(lib, xp: torch.Tensor, w_h_f: torch.Tensor,
                     w_h_b: torch.Tensor, lens32: torch.Tensor,
                     plan: FwdChainPlan, store_sums: bool = False):
    """K8a's cluster route (``bigru_fwd_chain_*``, one launch for any B) on
    checked operands; with ``store_sums`` the recurrent sums [T, B, 6H]
    f32 in K8b's walk order are a third output."""
    t_max, b, g6 = xp.shape
    h = g6 // 6
    dev = xp.device
    y_f = torch.empty((t_max, b, h), dtype=xp.dtype, device=dev)
    y_b = torch.empty_like(y_f)
    # the initial h of each direction: the operand's and the cell's carry
    state = torch.zeros((2, 2, b, h), dtype=torch.float32, device=dev)
    sums = (torch.empty((t_max, b, g6), dtype=torch.float32, device=dev)
            if store_sums else None)
    err = getattr(lib, "bigru_fwd_chain_" + _SUFFIX[xp.dtype])(
        xp.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(), lens32.data_ptr(),
        y_f.data_ptr(), y_b.data_ptr(), state.data_ptr(),
        None if sums is None else sums.data_ptr(), t_max, b, h,
        plan.cluster, plan.rows, _kernels.stream_ptr(dev))
    _kernels.check(lib, err, f"bigru_seq_fwd at T={t_max}, B={b}, {plan}")
    return (y_f, y_b, sums) if store_sums else (y_f, y_b)


def _bigru_fwd_cooperative(lib, xp: torch.Tensor, w_h_f: torch.Tensor,
                           w_h_b: torch.Tensor, lens32: torch.Tensor) -> Pair:
    """K8a's cooperative route (``bigru_fwd_*``) on checked operands, in
    row slices under its ceiling."""
    t_max, _, g6 = xp.shape
    h = g6 // 6
    dev = xp.device
    sfx = _SUFFIX[xp.dtype]

    def launch(xp, lens32):
        n = xp.shape[1]
        y_f = torch.empty((t_max, n, h), dtype=xp.dtype, device=dev)
        y_b = torch.empty_like(y_f)
        # h exchange between blocks: [parity][direction][B][H], parity 0
        # = h0
        hbuf = torch.zeros((2, 2, n, h), dtype=torch.float32, device=dev)
        err = getattr(lib, "bigru_fwd_" + sfx)(
            xp.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(),
            lens32.data_ptr(), y_f.data_ptr(), y_b.data_ptr(),
            hbuf.data_ptr(), t_max, n, h, _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "bigru_seq_fwd")
        return y_f, y_b

    return run_in_row_slices(
        launch, max_rows(lib, "bigru_fwd_max_rows_" + sfx, dev, h), xp,
        lens32)


bigru_seq_fwd.launches = 0  # kernel launches made by this wrapper
# of those, the ones that kept the recurrent sums for the backward
bigru_seq_fwd.store_launches = 0


Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bigru_seq_bwd_dgates_reference(
        dy_f: torch.Tensor, dy_b: torch.Tensor, xp: torch.Tensor,
        y_f: torch.Tensor, y_b: torch.Tensor, w_h_f: torch.Tensor,
        w_h_b: torch.Tensor, lens: torch.Tensor,
        dg_dtype: Optional[torch.dtype] = None,
        sums: Optional[torch.Tensor] = None) -> Quad:
    """Plain PyTorch version of :func:`bigru_seq_bwd_dgates` on any
    device: the forward direction at t = T-1-s, the backward direction at
    t = s (``_bibwd_kernel``).  It recomputes the gates from y and leaves
    ``sums`` unread."""
    g3 = xp.shape[2] // 2
    dg_dtype = xp.dtype if dg_dtype is None else dg_dtype
    return (_bwd_loop(dy_f, xp[..., :g3], y_f, w_h_f, lens, False, dg_dtype)
            + _bwd_loop(dy_b, xp[..., g3:], y_b, w_h_b, lens, True,
                        dg_dtype))


def bigru_seq_bwd_dgates(dy_f: torch.Tensor, dy_b: torch.Tensor,
                         xp: torch.Tensor, y_f: torch.Tensor,
                         y_b: torch.Tensor, w_h_f: torch.Tensor,
                         w_h_b: torch.Tensor, lens: torch.Tensor,
                         dg_dtype: Optional[torch.dtype] = None,
                         sums: Optional[torch.Tensor] = None) -> Quad:
    """Output cotangents dy_f / dy_b [T, B, H] and the forward's
    residuals (xp [T, B, 6H], y_f / y_b [T, B, H], w_h_f / w_h_b [H, 3H],
    all in the compute dtype, lens [B]) → (dgx_f, dgh_f, dgx_b, dgh_b)
    [T, B, 3H] in dg_dtype (default xp's).  The contract of
    ``_bigru_seq_bwd_dgates``.  On the card the route is
    :func:`k8b_plan`'s, from the shapes: where W_h fits a cluster, the
    backward chain with both directions in thread-block clusters (any B,
    one launch) on the recurrent sums the forward formed its gates from,
    ``sums`` of :func:`bigru_seq_fwd` with ``store_sums`` ([T, B, 6H] f32,
    K8b's walk order; no recompute, and the gates are the forward's bit
    for bit), which that route requires (a ValueError without them); else
    the cooperative kernel in row slices, which recomputes the sums from
    y and ignores ``sums``.  :func:`bigru_layer` passes them where
    autograd records a backward (an inference forward keeps none; K8a
    takes its cluster route wherever this one does).  Counter
    ``stored_launches``: the calls that read the forward's sums."""
    dg_dtype = xp.dtype if dg_dtype is None else dg_dtype
    if xp.device.type == "cpu":
        return bigru_seq_bwd_dgates_reference(dy_f, dy_b, xp, y_f, y_b,
                                              w_h_f, w_h_b, lens, dg_dtype)
    if xp.device.type != "cuda":
        raise ValueError(f"bigru_seq_bwd_dgates: unsupported device "
                         f"{xp.device}")
    h = _check_x_proj("bigru_seq_bwd_dgates", xp, 6)
    if dg_dtype != xp.dtype:
        raise ValueError(f"bigru_seq_bwd_dgates: the kernel stores the "
                         f"dgates in xp's dtype {xp.dtype}, not {dg_dtype}")
    t_max, b, g6 = xp.shape
    dev = xp.device
    cdt = xp.dtype
    want = {"xp": (xp, cdt, (t_max, b, g6))}
    for name, v in (("dy_f", dy_f), ("dy_b", dy_b), ("y_f", y_f),
                    ("y_b", y_b)):
        want[name] = (v, cdt, (t_max, b, h))
    for name, v in (("w_h_f", w_h_f), ("w_h_b", w_h_b)):
        want[name] = (v, cdt, (h, 3 * h))
    _check_tensors("bigru_seq_bwd_dgates", dev, want)
    _check_lens("bigru_seq_bwd_dgates", lens, b, dev)
    if t_max == 0 or b == 0:
        return tuple(torch.empty((t_max, b, 3 * h), dtype=cdt, device=dev)
                     for _ in range(4))
    lib = _kernels.load("gru_bwd", _BWD_SIGNATURES)
    plan = k8b_plan(lib, b, h, cdt, dev)
    ops = (dy_f, dy_b, xp, y_f, y_b, w_h_f, w_h_b,
           lens.to(torch.int32).contiguous())
    if plan.route == "cluster":
        if sums is None:
            raise ValueError("bigru_seq_bwd_dgates: the cluster route reads "
                             "the recurrent sums of bigru_seq_fwd with "
                             "store_sums=True; none were passed")
        _check_tensors("bigru_seq_bwd_dgates", dev, {
            "sums": (sums, torch.float32, (t_max, b, g6))})
        bigru_seq_bwd_dgates.stored_launches += 1
        out = _bigru_bwd_chain(lib, *ops, sums, plan)
    else:
        out = _bigru_bwd_cooperative(lib, *ops)
    bigru_seq_bwd_dgates.launches += 1
    return out


def k8b_plan(lib, b: int, h: int, dtype: torch.dtype, device
             ) -> BwdChainPlan:
    """K8b's route and launch shape on ``device``:
    ``rnn_cuda.bwd_chain_plan`` with three gates and both directions."""
    return bwd_chain_plan(b, h, dtype, 2, _sm_count(device),
                          _smem_optin(lib, "gru_bwd_smem_optin", device),
                          gates=3)


def _bigru_bwd_chain(lib, dy_f, dy_b, xp, y_f, y_b, w_h_f, w_h_b,
                     lens32: torch.Tensor, sums: torch.Tensor,
                     plan: BwdChainPlan) -> Quad:
    """K8b's cluster route (``bigru_bwd_chain_*``, the whole walk in one
    launch) on checked operands and K8a's stored ``sums``."""
    t_max, b, g6 = xp.shape
    h = g6 // 6
    dev = xp.device
    outs = tuple(torch.empty((t_max, b, 3 * h), dtype=xp.dtype, device=dev)
                 for _ in range(4))
    state = torch.zeros((1, 2, b, h), dtype=torch.float32, device=dev)
    err = getattr(lib, "bigru_bwd_chain_" + _SUFFIX[xp.dtype])(
        dy_f.data_ptr(), dy_b.data_ptr(), xp.data_ptr(), y_f.data_ptr(),
        y_b.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(),
        lens32.data_ptr(), sums.data_ptr(), *(o.data_ptr() for o in outs),
        state.data_ptr(), t_max, b, h, plan.cluster, plan.rows,
        _kernels.stream_ptr(dev))
    _kernels.check(lib, err, f"bigru_seq_bwd_dgates at T={t_max}, B={b}, "
                             f"{plan}")
    return outs


def _bigru_bwd_cooperative(lib, dy_f, dy_b, xp, y_f, y_b, w_h_f, w_h_b,
                           lens32: torch.Tensor) -> Quad:
    """K8b's cooperative route (``bigru_bwd_*``) on checked operands, in
    row slices under its ceiling."""
    t_max, _, g6 = xp.shape
    h = g6 // 6
    dev = xp.device
    sfx = _SUFFIX[xp.dtype]

    def launch(dy_f, dy_b, xp, y_f, y_b, lens32):
        n = xp.shape[1]
        outs = [torch.empty((t_max, n, 3 * h), dtype=xp.dtype, device=dev)
                for _ in range(4)]
        part = _exchange(lib, 2, n, h, dev, "bigru_seq_bwd_dgates")
        err = getattr(lib, "bigru_bwd_" + sfx)(
            dy_f.data_ptr(), dy_b.data_ptr(), xp.data_ptr(), y_f.data_ptr(),
            y_b.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(),
            lens32.data_ptr(), *(o.data_ptr() for o in outs),
            part.data_ptr(), t_max, n, h, _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "bigru_seq_bwd_dgates")
        return tuple(outs)

    return run_in_row_slices(
        launch, max_rows(lib, "bigru_bwd_max_rows_" + sfx, dev, h),
        dy_f, dy_b, xp, y_f, y_b, lens32)


bigru_seq_bwd_dgates.launches = 0  # kernel launches made by this wrapper
# of those, the ones on the sums the forward stored
bigru_seq_bwd_dgates.stored_launches = 0

# every snapshot of the span registry reads these counters where they are
profiling.register_launch_counters(
    gru_seq_fwd, gru_seq_bwd_dgates, bigru_seq_fwd, bigru_seq_bwd_dgates)


class _BiGruLayer(torch.autograd.Function):
    """``bigru_layer`` with the custom VJP of ``gru_pallas``: forward
    ``_bigru_layer_fwd_impl`` (projection, K8a), backward
    ``_bigru_layer_bwd`` (K8b, then plain products).  ``store``: a
    backward is recorded, so K8a keeps its recurrent sums for K8b."""

    @staticmethod
    def forward(ctx, x, w_x, bias, w_h_f, w_h_b, lens, compute_dtype, store):
        t_max, b, d = x.shape
        cdt = COMPUTE_DTYPES[compute_dtype]
        # f32-accumulated projection plus bias, stored in the compute dtype
        xp = (matmul_f32acc(x.reshape(t_max * b, d), w_x, cdt)
              + bias).to(cdt).reshape(t_max, b, -1)
        y_f, y_b, *sums = bigru_seq_fwd(xp, w_h_f.to(cdt).contiguous(),
                                        w_h_b.to(cdt).contiguous(), lens,
                                        cdt, store_sums=store)
        ctx.cdt = cdt
        ctx.save_for_backward(x, w_x, w_h_f, w_h_b, lens, xp, y_f, y_b,
                              sums[0] if sums else None)
        return y_f, y_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        x, w_x, w_h_f, w_h_b, lens, xp, y_f, y_b, sums = ctx.saved_tensors
        cdt = ctx.cdt
        dgx_f, dgh_f, dgx_b, dgh_b = bigru_seq_bwd_dgates(
            dy_f.to(cdt).contiguous(), dy_b.to(cdt).contiguous(), xp, y_f,
            y_b, w_h_f.to(cdt).contiguous(), w_h_b.to(cdt).contiguous(), lens,
            cdt, sums=sums)
        t_max, b, h = y_f.shape
        g3 = 3 * h
        d = x.shape[-1]
        dgxf2 = dgx_f.reshape(t_max * b, g3)
        dgxb2 = dgx_b.reshape(t_max * b, g3)
        # recurrent-weight gradients: one sliced product per direction,
        # emitted f32 against the f32 master weights
        dw_f = _dw_h(y_f, dgh_f, False, cdt)
        dw_b = _dw_h(y_b, dgh_b, True, cdt)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (matmul_f32acc(dgxf2, w_x[:, :g3].T, cdt)
                  + matmul_f32acc(dgxb2, w_x[:, g3:].T, cdt))
            dx = dx.to(x.dtype).reshape(t_max, b, d)
        x2 = x.reshape(t_max * b, d)
        dw_x = torch.cat([matmul_f32acc(x2.T, dgxf2, cdt),
                          matmul_f32acc(x2.T, dgxb2, cdt)], dim=1)
        dbias = torch.cat([dgxf2.float().sum(dim=0),
                           dgxb2.float().sum(dim=0)])
        return dx, dw_x, dbias, dw_f, dw_b, None, None, None


def bigru_layer(x: torch.Tensor, w_x: torch.Tensor, bias: torch.Tensor,
                w_h_f: torch.Tensor, w_h_b: torch.Tensor, lens: torch.Tensor,
                compute_dtype: str = "float32") -> Pair:
    """Full fused bidirectional GRU layer → (y_f, y_b), each [T, B, H]
    in the compute dtype.  x [T, B, D]; w_x = [w_x_fwd | w_x_bwd]
    [D, 6H] and bias [6H] in master precision (f32); the cast to the
    compute dtype happens inside, as in JAX's custom VJP, so the weight
    gradients come back f32 and dx in x's dtype.  Where a backward is
    recorded (grad mode on and an operand requiring a gradient), K8a keeps
    its recurrent sums ([T, B, 6H] f32, saved beside xp and y) and K8b
    reads them; under ``no_grad`` or ``inference_mode`` nothing more is
    stored."""
    store = _records_backward(x, w_x, bias, w_h_f, w_h_b)
    return _BiGruLayer.apply(x, w_x, bias, w_h_f, w_h_b, lens, compute_dtype,
                             store)
