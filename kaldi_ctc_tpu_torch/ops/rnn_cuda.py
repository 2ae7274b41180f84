"""Fused bidirectional LSTM layer: the CUDA kernels K2 (forward) and K3
(backward) and their plain versions.

Counterpart of ``kaldi_ctc_tpu/ops/rnn_pallas.py``'s bidirectional LSTM
(``_bilstm_seq_fwd``, ``_bilstm_seq_bwd_dgates``, ``_dw_h`` and
``bilstm_layer`` with its custom VJP).  :func:`bilstm_seq_fwd` is the
wrapper of ``csrc/bilstm_fwd.cu`` and :func:`bilstm_seq_bwd_dgates` of
``csrc/bilstm_bwd.cu``: a CPU tensor goes to the plain version
(``*_reference``); a CUDA tensor launches the kernel or raises.
:func:`bilstm_layer` is the whole layer — the hoisted input projection
of both directions as one matmul, then the recurrence — as a
``torch.autograd.Function`` whose backward runs K3 and then the weight
and input gradients as plain products, as the JAX package leaves them
to XLA.

Under bfloat16 the shipped default of the JAX package's ``_bf16_cfg``
holds: the projection, the layer outputs and the dgates are stored in
bf16, the weight-gradient operands are bf16, gate math, carries and
cell states are f32, and weight gradients come out f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.ops.rnn import COMPUTE_DTYPES, _lstm_cell, matmul_f32acc

__all__ = ["bilstm_seq_fwd", "bilstm_seq_fwd_reference",
           "bilstm_seq_bwd_dgates", "bilstm_seq_bwd_dgates_reference",
           "bilstm_layer"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
_SIGNATURES = {"bilstm_fwd_f32": _ARGS, "bilstm_fwd_bf16": _ARGS}
_ENTRY = {torch.float32: "bilstm_fwd_f32", torch.bfloat16: "bilstm_fwd_bf16"}
_BWD_ARGS = [_P] * 13 + [_I, _I, _I, _P]
_BWD_SIGNATURES = {"bilstm_bwd_f32": _BWD_ARGS,
                   "bilstm_bwd_bf16": _BWD_ARGS,
                   "bilstm_bwd_exchange_floats": [_I, _I]}
_BWD_ENTRY = {torch.float32: "bilstm_bwd_f32",
              torch.bfloat16: "bilstm_bwd_bf16"}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bilstm_seq_fwd_reference(xp: torch.Tensor, w_h_f: torch.Tensor,
                             w_h_b: torch.Tensor, lens: torch.Tensor,
                             y_dtype: Optional[torch.dtype] = None
                             ) -> Outputs:
    """Plain PyTorch version of :func:`bilstm_seq_fwd` on any device: a
    loop of T steps, forward direction at t=s, backward at t=T-1-s."""
    t_max, b, g8 = xp.shape
    g4 = g8 // 2
    h_dim = g4 // 4
    cdt = w_h_f.dtype
    y_dtype = xp.dtype if y_dtype is None else y_dtype
    valid = (torch.arange(t_max, device=xp.device)[:, None]
             < lens.to(xp.device)[None, :])[..., None]          # [T, B, 1]
    outs = []
    for half, w_h in ((0, w_h_f), (1, w_h_b)):
        w = w_h.float()
        h = torch.zeros((b, h_dim), dtype=torch.float32, device=xp.device)
        c = torch.zeros_like(h)
        y = torch.empty((t_max, b, h_dim), dtype=y_dtype, device=xp.device)
        cs = torch.empty((t_max, b, h_dim), dtype=torch.float32,
                         device=xp.device)
        for s in range(t_max):
            t = s if half == 0 else t_max - 1 - s
            v = valid[t]
            h_new, c_new = _lstm_cell(h, c, xp[t, :, half * g4:(half + 1) * g4],
                                      w, cdt)
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            y[t] = torch.where(v, h_new, 0.0).to(y_dtype)
            cs[t] = c
        outs += [y, cs]
    return tuple(outs)


def _check(xp, w_h_f, w_h_b, lens, y_dtype):
    if xp.dim() != 3 or xp.shape[2] % 8:
        raise ValueError(f"bilstm_seq_fwd: xp must be [T, B, 8H], got "
                         f"{tuple(xp.shape)}")
    if xp.dtype not in _ENTRY:
        raise ValueError(f"bilstm_seq_fwd: xp dtype {xp.dtype} is not "
                         "float32 or bfloat16")
    if y_dtype != xp.dtype:
        raise ValueError(f"bilstm_seq_fwd: the kernel stores y in xp's "
                         f"dtype {xp.dtype}, not {y_dtype}")
    h = xp.shape[2] // 8
    for name, w in (("w_h_f", w_h_f), ("w_h_b", w_h_b)):
        if (tuple(w.shape) != (h, 4 * h) or w.dtype != xp.dtype
                or w.device != xp.device):
            raise ValueError(f"bilstm_seq_fwd: {name} must be {xp.dtype} "
                             f"[{h}, {4 * h}] on {xp.device}, got "
                             f"{w.dtype} {tuple(w.shape)} on {w.device}")
    if tuple(lens.shape) != (xp.shape[1],) or lens.device != xp.device \
            or lens.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bilstm_seq_fwd: lens must be int [B] on "
                         f"{xp.device}, got {lens.dtype} "
                         f"{tuple(lens.shape)} on {lens.device}")
    for name, t in (("xp", xp), ("w_h_f", w_h_f), ("w_h_b", w_h_b)):
        if not t.is_contiguous():
            raise ValueError(f"bilstm_seq_fwd: {name} is not contiguous")


def bilstm_seq_fwd(xp: torch.Tensor, w_h_f: torch.Tensor,
                   w_h_b: torch.Tensor, lens: torch.Tensor,
                   y_dtype: Optional[torch.dtype] = None) -> Outputs:
    """xp [T, B, 8H] fused projection (forward half first, compute dtype),
    w_h_f / w_h_b [H, 4H] in the compute dtype, lens [B] →
    (y_f, c_f, y_b, c_b): y [T, B, H] in y_dtype (default xp's), c
    [T, B, H] f32.  The contract of ``_bilstm_seq_fwd``."""
    y_dtype = xp.dtype if y_dtype is None else y_dtype
    if xp.device.type == "cpu":
        return bilstm_seq_fwd_reference(xp, w_h_f, w_h_b, lens, y_dtype)
    if xp.device.type != "cuda":
        raise ValueError(f"bilstm_seq_fwd: unsupported device {xp.device}")
    _check(xp, w_h_f, w_h_b, lens, y_dtype)
    t_max, b, g8 = xp.shape
    h = g8 // 8
    dev = xp.device
    y_f = torch.empty((t_max, b, h), dtype=y_dtype, device=dev)
    y_b = torch.empty((t_max, b, h), dtype=y_dtype, device=dev)
    c_f = torch.empty((t_max, b, h), dtype=torch.float32, device=dev)
    c_b = torch.empty((t_max, b, h), dtype=torch.float32, device=dev)
    if t_max == 0 or b == 0:
        return y_f, c_f, y_b, c_b
    # h exchange between blocks: [parity][direction][B][H], parity 0 = h0
    hbuf = torch.zeros((2, 2, b, h), dtype=torch.float32, device=dev)
    lens32 = lens.to(torch.int32).contiguous()
    lib = _kernels.load("bilstm_fwd", _SIGNATURES)
    err = getattr(lib, _ENTRY[xp.dtype])(
        xp.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(), lens32.data_ptr(),
        y_f.data_ptr(), c_f.data_ptr(), y_b.data_ptr(), c_b.data_ptr(),
        hbuf.data_ptr(), t_max, b, h, _kernels.stream_ptr(dev))
    _kernels.check(lib, err, "bilstm_seq_fwd")
    bilstm_seq_fwd.launches += 1
    return y_f, c_f, y_b, c_b


bilstm_seq_fwd.launches = 0  # kernel launches made by this wrapper


def bilstm_seq_bwd_dgates_reference(
        dy_f: torch.Tensor, dy_b: torch.Tensor, xp: torch.Tensor,
        y_f: torch.Tensor, c_f: torch.Tensor, y_b: torch.Tensor,
        c_b: torch.Tensor, w_h_f: torch.Tensor, w_h_b: torch.Tensor,
        lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_seq_bwd_dgates` on any
    device: a loop of T steps, forward direction at t=T-1-s, backward
    at t=s (``_bibwd_kernel`` with ``_dgates_update``)."""
    t_max, b, h_dim = dy_f.shape
    g4 = 4 * h_dim
    cdt = w_h_f.dtype
    dev = xp.device
    valid = (torch.arange(t_max, device=dev)[:, None]
             < lens.to(dev)[None, :])[..., None]                # [T, B, 1]
    zeros = torch.zeros((b, h_dim), dtype=torch.float32, device=dev)
    outs = []
    for half, (dy, y, cs, w_h) in enumerate(((dy_f, y_f, c_f, w_h_f),
                                             (dy_b, y_b, c_b, w_h_b))):
        w = w_h.float()
        dh, dc = zeros, zeros
        dg = torch.empty((t_max, b, g4), dtype=xp.dtype, device=dev)
        for s in range(t_max):
            t = t_max - 1 - s if half == 0 else s
            tp = t - 1 if half == 0 else t + 1
            first = s == t_max - 1    # the direction's first forward step
            hp = zeros if first else y[tp]
            cp = zeros if first else cs[tp]
            gates = (xp[t, :, half * g4:(half + 1) * g4].float()
                     + torch.matmul(hp.to(cdt).float(), w))
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            tanh_c = torch.tanh(cs[t])
            dh_total = dy[t].float() + dh
            dc_total = dc + dh_total * o * (1.0 - tanh_c * tanh_c)
            dgates = torch.cat([dc_total * g * i * (1.0 - i),
                                dc_total * cp * f * (1.0 - f),
                                dc_total * i * (1.0 - g * g),
                                dh_total * tanh_c * o * (1.0 - o)], dim=-1)
            v = valid[t]
            dgates = torch.where(v, dgates, 0.0)
            dh = torch.where(v, torch.matmul(dgates.to(cdt).float(), w.T), dh)
            dc = torch.where(v, dc_total * f, dc)
            dg[t] = dgates.to(xp.dtype)
        outs.append(dg)
    return outs[0], outs[1]


def _check_bwd(dy_f, dy_b, xp, y_f, c_f, y_b, c_b, w_h_f, w_h_b, lens):
    if xp.dim() != 3 or xp.shape[2] % 8 or xp.dtype not in _BWD_ENTRY:
        raise ValueError(f"bilstm_seq_bwd_dgates: xp must be f32 or bf16 "
                         f"[T, B, 8H], got {xp.dtype} {tuple(xp.shape)}")
    t_max, b, g8 = xp.shape
    h = g8 // 8
    want = {"dy_f": (dy_f, xp.dtype, (t_max, b, h)),
            "dy_b": (dy_b, xp.dtype, (t_max, b, h)),
            "y_f": (y_f, xp.dtype, (t_max, b, h)),
            "y_b": (y_b, xp.dtype, (t_max, b, h)),
            "c_f": (c_f, torch.float32, (t_max, b, h)),
            "c_b": (c_b, torch.float32, (t_max, b, h)),
            "w_h_f": (w_h_f, xp.dtype, (h, 4 * h)),
            "w_h_b": (w_h_b, xp.dtype, (h, 4 * h)),
            "xp": (xp, xp.dtype, (t_max, b, g8))}
    for name, (v, dtype, shape) in want.items():
        if (v.dtype != dtype or tuple(v.shape) != shape
                or v.device != xp.device or not v.is_contiguous()):
            raise ValueError(f"bilstm_seq_bwd_dgates: {name} must be "
                             f"contiguous {dtype} {list(shape)} on "
                             f"{xp.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if tuple(lens.shape) != (b,) or lens.device != xp.device \
            or lens.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bilstm_seq_bwd_dgates: lens must be int [B] on "
                         f"{xp.device}, got {lens.dtype} "
                         f"{tuple(lens.shape)} on {lens.device}")


def bilstm_seq_bwd_dgates(dy_f: torch.Tensor, dy_b: torch.Tensor,
                          xp: torch.Tensor, y_f: torch.Tensor,
                          c_f: torch.Tensor, y_b: torch.Tensor,
                          c_b: torch.Tensor, w_h_f: torch.Tensor,
                          w_h_b: torch.Tensor, lens: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output cotangents dy_f / dy_b [T, B, H] and the forward's
    residuals (xp [T, B, 8H], y and c of both directions, w_h_f / w_h_b
    [H, 4H] in the compute dtype, lens [B]) → (dg_f, dg_b) [T, B, 4H] in
    xp's dtype, the gate pre-activation cotangents.  The contract of
    ``_bilstm_seq_bwd_dgates`` with its default dgates dtype."""
    if xp.device.type == "cpu":
        return bilstm_seq_bwd_dgates_reference(
            dy_f, dy_b, xp, y_f, c_f, y_b, c_b, w_h_f, w_h_b, lens)
    if xp.device.type != "cuda":
        raise ValueError(f"bilstm_seq_bwd_dgates: unsupported device "
                         f"{xp.device}")
    _check_bwd(dy_f, dy_b, xp, y_f, c_f, y_b, c_b, w_h_f, w_h_b, lens)
    t_max, b, g8 = xp.shape
    h = g8 // 8
    dev = xp.device
    dg_f = torch.empty((t_max, b, 4 * h), dtype=xp.dtype, device=dev)
    dg_b = torch.empty((t_max, b, 4 * h), dtype=xp.dtype, device=dev)
    if t_max == 0 or b == 0:
        return dg_f, dg_b
    lib = _kernels.load("bilstm_bwd", _BWD_SIGNATURES)
    floats = lib.bilstm_bwd_exchange_floats(b, h)
    if floats < 0:
        raise RuntimeError(f"bilstm_seq_bwd_dgates: no exchange size for "
                           f"B={b}, H={h} on {dev}")
    # partial-dh exchange between blocks; every entry read is written
    # in the step before
    part = torch.empty((floats,), dtype=torch.float32, device=dev)
    lens32 = lens.to(torch.int32).contiguous()
    err = getattr(lib, _BWD_ENTRY[xp.dtype])(
        dy_f.data_ptr(), dy_b.data_ptr(), xp.data_ptr(), y_f.data_ptr(),
        c_f.data_ptr(), y_b.data_ptr(), c_b.data_ptr(), w_h_f.data_ptr(),
        w_h_b.data_ptr(), lens32.data_ptr(), dg_f.data_ptr(),
        dg_b.data_ptr(), part.data_ptr(), t_max, b, h,
        _kernels.stream_ptr(dev))
    _kernels.check(lib, err, "bilstm_seq_bwd_dgates")
    bilstm_seq_bwd_dgates.launches += 1
    return dg_f, dg_b


bilstm_seq_bwd_dgates.launches = 0  # kernel launches made by this wrapper


def _dw_h(y: torch.Tensor, dgates: torch.Tensor, reverse: bool,
          cdt: torch.dtype) -> torch.Tensor:
    """dW_h = Σ_t h_prev[t]ᵀ · dgates[t] as one sliced product, f32.

    The first processed step has h_prev = 0, so the sum is
    y[:-1]ᵀ·dg[1:] (forward) / y[1:]ᵀ·dg[:-1] (reverse); operands in
    the compute dtype, f32 accumulation and result."""
    t_max, b, h = y.shape
    if t_max == 1:
        return torch.zeros((h, dgates.shape[-1]), dtype=torch.float32,
                           device=y.device)
    hp, dg = (y[1:], dgates[:-1]) if reverse else (y[:-1], dgates[1:])
    n = (t_max - 1) * b
    return matmul_f32acc(hp.reshape(n, h).T, dg.reshape(n, -1), cdt)


class _BiLstmLayer(torch.autograd.Function):
    """``bilstm_layer`` with the custom VJP of ``rnn_pallas``: forward
    ``_bilstm_layer_fwd_impl`` (projection, K2), backward
    ``_bilstm_layer_bwd`` (K3, then plain products)."""

    @staticmethod
    def forward(ctx, x, w_x, bias, w_h_f, w_h_b, lens, compute_dtype):
        t_max, b, d = x.shape
        cdt = COMPUTE_DTYPES[compute_dtype]
        # f32-accumulated projection plus bias, stored in the compute dtype
        xp = (matmul_f32acc(x.reshape(t_max * b, d), w_x, cdt)
              + bias).to(cdt).reshape(t_max, b, -1)
        y_f, c_f, y_b, c_b = bilstm_seq_fwd(
            xp, w_h_f.to(cdt).contiguous(), w_h_b.to(cdt).contiguous(),
            lens, cdt)
        ctx.cdt = cdt
        ctx.save_for_backward(x, w_x, bias, w_h_f, w_h_b, lens, xp,
                              y_f, c_f, y_b, c_b)
        return y_f, y_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        x, w_x, _, w_h_f, w_h_b, lens, xp, y_f, c_f, y_b, c_b = \
            ctx.saved_tensors
        cdt = ctx.cdt
        dg_f, dg_b = bilstm_seq_bwd_dgates(
            dy_f.contiguous(), dy_b.contiguous(), xp, y_f, c_f, y_b, c_b,
            w_h_f.to(cdt).contiguous(), w_h_b.to(cdt).contiguous(), lens)
        t_max, b, h = y_f.shape
        g4 = 4 * h
        d = x.shape[-1]
        dgf2 = dg_f.reshape(t_max * b, g4)
        dgb2 = dg_b.reshape(t_max * b, g4)
        # recurrent-weight gradients: one sliced product per direction,
        # emitted f32 against the f32 master weights
        dw_f = _dw_h(y_f, dg_f, False, cdt)
        dw_b = _dw_h(y_b, dg_b, True, cdt)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (matmul_f32acc(dgf2, w_x[:, :g4].T, cdt)
                  + matmul_f32acc(dgb2, w_x[:, g4:].T, cdt))
            dx = dx.to(x.dtype).reshape(t_max, b, d)
        x2 = x.reshape(t_max * b, d)
        dw_x = torch.cat([matmul_f32acc(x2.T, dgf2, cdt),
                          matmul_f32acc(x2.T, dgb2, cdt)], dim=1)
        dbias = torch.cat([dgf2.float().sum(dim=0), dgb2.float().sum(dim=0)])
        return dx, dw_x, dbias, dw_f, dw_b, None, None


def bilstm_layer(x: torch.Tensor, w_x: torch.Tensor, bias: torch.Tensor,
                 w_h_f: torch.Tensor, w_h_b: torch.Tensor, lens: torch.Tensor,
                 compute_dtype: str = "float32"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full fused bidirectional LSTM layer → (y_f, y_b), each [T, B, H]
    in the compute dtype.  x [T, B, D]; w_x = [w_x_fwd | w_x_bwd]
    [D, 8H] and bias [8H] in master precision (f32); the cast to the
    compute dtype happens inside, as in JAX's custom VJP, so the weight
    gradients come back f32 and dx in x's dtype."""
    return _BiLstmLayer.apply(x, w_x, bias, w_h_f, w_h_b, lens,
                              compute_dtype)
