"""Fused bidirectional LSTM layer: the CUDA kernel K2 and its plain version.

Counterpart of the forward half of ``kaldi_ctc_tpu/ops/rnn_pallas.py``
(``_bilstm_seq_fwd`` and ``bilstm_layer``).  :func:`bilstm_seq_fwd` is
the wrapper of ``csrc/bilstm_fwd.cu``: a CPU tensor goes to
:func:`bilstm_seq_fwd_reference`; a CUDA tensor launches the kernel or
raises.  :func:`bilstm_layer` is the whole layer — the hoisted input
projection of both directions as one matmul, then the recurrence — as a
``torch.autograd.Function`` whose backward (kernel K3) is not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.ops.rnn import COMPUTE_DTYPES, _lstm_cell, matmul_f32acc

__all__ = ["bilstm_seq_fwd", "bilstm_seq_fwd_reference", "bilstm_layer"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
_SIGNATURES = {"bilstm_fwd_f32": _ARGS, "bilstm_fwd_bf16": _ARGS}
_ENTRY = {torch.float32: "bilstm_fwd_f32", torch.bfloat16: "bilstm_fwd_bf16"}

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


class _BiLstmLayer(torch.autograd.Function):
    """Forward of ``_bilstm_layer_fwd_impl``; backward is kernel K3."""

    @staticmethod
    def forward(ctx, x, w_x, bias, w_h_f, w_h_b, lens, compute_dtype):
        t_max, b, d = x.shape
        cdt = COMPUTE_DTYPES[compute_dtype]
        # f32-accumulated projection plus bias, stored in the compute dtype
        xp = (matmul_f32acc(x.reshape(t_max * b, d), w_x, cdt)
              + bias).to(cdt).reshape(t_max, b, -1)
        y_f, _c_f, y_b, _c_b = bilstm_seq_fwd(
            xp, w_h_f.to(cdt).contiguous(), w_h_b.to(cdt).contiguous(),
            lens, cdt)
        return y_f, y_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        raise NotImplementedError(
            "bilstm_layer backward: kernel K3 (rnn_pallas."
            "_bilstm_seq_bwd_dgates) not ported yet (ROADMAP slice 2)")


def bilstm_layer(x: torch.Tensor, w_x: torch.Tensor, bias: torch.Tensor,
                 w_h_f: torch.Tensor, w_h_b: torch.Tensor, lens: torch.Tensor,
                 compute_dtype: str = "float32"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full fused bidirectional LSTM layer → (y_f, y_b), each [T, B, H]
    in the compute dtype.  x [T, B, D]; w_x = [w_x_fwd | w_x_bwd]
    [D, 8H] and bias [8H] in master precision (f32); the cast to the
    compute dtype happens inside, as in JAX's custom VJP."""
    return _BiLstmLayer.apply(x, w_x, bias, w_h_f, w_h_b, lens,
                              compute_dtype)
