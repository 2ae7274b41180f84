"""LSTM recurrences on CUDA: the kernels K2, K3 (bidirectional layer
from the hoisted projection), K10a, K10b (bidirectional layer with the
projection inside the kernels), K5, K6 (one unidirectional direction) and
K7 (the unidirectional stack as a wavefront), and their plain versions.

Counterpart of ``kaldi_ctc_tpu/ops/rnn_pallas.py``: ``_bilstm_seq_fwd``,
``_bilstm_seq_bwd_dgates``, ``_bilstm_seq_fwd_proj``,
``_bilstm_seq_bwd_dgates_proj``, ``_use_in_kernel_proj``, ``_dw_h`` and
``bilstm_layer`` with its custom VJP; ``lstm_seq_fwd``,
``_lstm_seq_bwd_dgates`` and ``lstm_sequence`` with its custom VJP;
``lstm_stack_fwd``.  Each kernel wrapper (:func:`bilstm_seq_fwd` and
:func:`bilstm_seq_fwd_proj` of ``csrc/bilstm_fwd.cu``,
:func:`bilstm_seq_bwd_dgates` and :func:`bilstm_seq_bwd_dgates_proj` of
``csrc/bilstm_bwd.cu``, :func:`lstm_seq_fwd` of ``csrc/lstm_fwd.cu``,
:func:`lstm_seq_bwd_dgates` of ``csrc/lstm_bwd.cu``,
:func:`lstm_stack_fwd` of ``csrc/lstm_stack.cu``) sends a CPU tensor to
its plain version (``*_reference``) and launches the kernel or raises for
a CUDA tensor.  :func:`bilstm_layer` and :func:`lstm_sequence` are
``torch.autograd.Function``s whose backward runs K3, K10b or K6 and then
the weight and input gradients as plain products, as the JAX package
leaves them to XLA.  :func:`bilstm_layer` picks K10a/K10b or K2/K3 by
:func:`use_in_kernel_proj`, the JAX package's rule.  A kernel that keeps
every batch row in one block's shared memory takes at most its source's
``*_max_rows`` rows a launch; its wrapper runs a larger batch as row
slices (:func:`run_in_row_slices`), so every wrapper takes any batch, as
the reference does.  K10a and K5 walk their recurrence in thread-block
clusters (``csrc/fwd_chain.cuh``), which take any batch by design, and so
do K2 and the GRU's K9a (``ops/gru_cuda.py``) where W_h fits a cluster;
where W_h fits neither a cluster nor a cooperative block (H = 1024), K2
and K3 take their wide route (``csrc/lstm_wide.cuh``: W_h from L2 every
step, the batch in tiles, one walk of T);
their launch shape comes from :func:`fwd_chain_plan`, which sends K2, K5
and K9a (and the GRU's K8a) to their cooperative kernels where W_h fits
no cluster.  The backwards K6, K9b and K10b (phase 2) walk the dh chain
the same way (``csrc/bwd_chain.cuh``) after a phase 1 that computes
every step's gate sums at once; K3 (and the GRU's K8b) walk it on the
recurrent sums their forward stored, which :func:`bilstm_layer` asks K2
for where a backward is recorded.  :func:`bwd_chain_plan` sends K3, K6
and K9b to their cooperative kernels where W_h fits no cluster (K2 takes
its cluster route wherever K3 does).

Under bfloat16 the shipped default of the JAX package's ``_bf16_cfg``
holds: the projection, the layer outputs and the dgates are stored in
bf16, the weight-gradient operands are bf16, gate math, carries and
cell states are f32, and weight gradients come out f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from kaldi_ctc_tpu_torch import _kernels
from kaldi_ctc_tpu_torch.ops.rnn import (COMPUTE_DTYPES, _lstm_cell, _valid,
                                         matmul_f32acc)
from kaldi_ctc_tpu_torch.utils import profiling

__all__ = ["bilstm_seq_fwd", "bilstm_seq_fwd_reference",
           "bilstm_seq_bwd_dgates", "bilstm_seq_bwd_dgates_reference",
           "use_in_kernel_proj", "bilstm_seq_fwd_proj",
           "bilstm_seq_fwd_proj_reference", "bilstm_seq_bwd_dgates_proj",
           "bilstm_seq_bwd_dgates_proj_reference", "bilstm_layer",
           "lstm_seq_fwd", "lstm_seq_fwd_reference",
           "lstm_seq_bwd_dgates", "lstm_seq_bwd_dgates_reference",
           "lstm_sequence", "lstm_stack_fwd", "lstm_stack_fwd_reference",
           "lstm_stack_fits", "max_rows", "run_in_row_slices", "K10bPlan",
           "k10b_plan", "FwdChainPlan", "fwd_chain_plan", "k2_plan",
           "bilstm_fwd_plan", "BwdChainPlan", "bwd_chain_plan",
           "k3_plan", "bilstm_bwd_plan", "k6_plan",
           "StackPlan", "stack_chain_plan", "k7_plan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# each entry point's name ends in the suffix of its compute dtype
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
_PROJ_X_ARGS = [_P] * 4 + [_I] * 8 + [_P]
_FWD_CHAIN_ARGS = [_P] * 9 + [_I] * 7 + [_P]
_XP_CHAIN_ARGS = [_P] * 10 + [_I] * 5 + [_P]
_WIDE_FWD_ARGS = [_P] * 9 + [_I] * 3 + [_P]
_SIGNATURES = {"bilstm_wide_fwd_f32": _WIDE_FWD_ARGS,
               "bilstm_wide_fwd_bf16": _WIDE_FWD_ARGS,
               "bilstm_wide_fwd_smem": [_I],
               "bilstm_fwd_f32": _ARGS, "bilstm_fwd_bf16": _ARGS,
               "bilstm_fwd_smem_optin": [],
               "bilstm_xp_chain_f32": _XP_CHAIN_ARGS,
               "bilstm_xp_chain_bf16": _XP_CHAIN_ARGS,
               "bilstm_proj_x_f32": _PROJ_X_ARGS,
               "bilstm_proj_x_bf16": _PROJ_X_ARGS,
               "bilstm_fwd_chain_f32": _FWD_CHAIN_ARGS,
               "bilstm_fwd_chain_bf16": _FWD_CHAIN_ARGS}
_BWD_ARGS = [_P] * 13 + [_I, _I, _I, _P]
_GATES_ARGS = [_P] * 8 + [_I] * 7 + [_P]
_TILED_ARGS = [_P] * 8 + [_I] * 6 + [_P]
_CHAIN_ARGS = [_P] * 11 + [_I] * 7 + [_P]
# K3's cluster route: the backward chain with both directions
_BI_CHAIN_ARGS = [_P] * 12 + [_I] * 5 + [_P]
_WIDE_BWD_ARGS = [_P] * 12 + [_I] * 3 + [_P]
_BWD_SIGNATURES = {"bilstm_wide_bwd_f32": _WIDE_BWD_ARGS,
                   "bilstm_wide_bwd_bf16": _WIDE_BWD_ARGS,
                   "bilstm_wide_bwd_cols": [_I],
                   "bilstm_wide_bwd_smem": [],
                   "bilstm_bwd_f32": _BWD_ARGS,
                   "bilstm_bwd_bf16": _BWD_ARGS,
                   "bilstm_bwd_exchange_floats": [_I, _I],
                   "bilstm_bwd_max_rows_f32": [_I],
                   "bilstm_bwd_max_rows_bf16": [_I],
                   "bilstm_bwd_smem_optin": [],
                   "bilstm_bwd_chain_f32": _BI_CHAIN_ARGS,
                   "bilstm_bwd_chain_bf16": _BI_CHAIN_ARGS,
                   "bilstm_proj_gates_f32": _GATES_ARGS,
                   "bilstm_proj_gates_bf16": _GATES_ARGS,
                   "bilstm_proj_gates_tiled_f32": _TILED_ARGS,
                   "bilstm_proj_gates_tiled_bf16": _TILED_ARGS,
                   "bilstm_proj_chain_f32": _CHAIN_ARGS,
                   "bilstm_proj_chain_bf16": _CHAIN_ARGS}
_UNI_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_UNI_CHAIN_ARGS = [_P] * 6 + [_I] * 6 + [_P]
_UNI_SIGNATURES = {"lstm_fwd_f32": _UNI_ARGS, "lstm_fwd_bf16": _UNI_ARGS,
                   "lstm_fwd_max_rows_f32": [_I],
                   "lstm_fwd_max_rows_bf16": [_I],
                   "lstm_fwd_smem_optin": [],
                   "lstm_fwd_chain_f32": _UNI_CHAIN_ARGS,
                   "lstm_fwd_chain_bf16": _UNI_CHAIN_ARGS}
_UNI_BWD_ARGS = [_P] * 8 + [_I] * 4 + [_P]
# the backward chains' phase 1 (K6, K9b) and K6's phase 2
_REC_GATES_ARGS = [_P] * 3 + [_I] * 7 + [_P]
_UNI_BWD_CHAIN_ARGS = [_P] * 8 + [_I] * 8 + [_P]
_UNI_BWD_SIGNATURES = {"lstm_bwd_f32": _UNI_BWD_ARGS,
                       "lstm_bwd_bf16": _UNI_BWD_ARGS,
                       "lstm_bwd_exchange_floats": [_I, _I],
                       "lstm_bwd_max_rows_f32": [_I],
                       "lstm_bwd_max_rows_bf16": [_I],
                       "lstm_bwd_smem_optin": [],
                       "lstm_bwd_gates_f32": _REC_GATES_ARGS,
                       "lstm_bwd_gates_bf16": _REC_GATES_ARGS,
                       "lstm_bwd_chain_f32": _UNI_BWD_CHAIN_ARGS,
                       "lstm_bwd_chain_bf16": _UNI_BWD_CHAIN_ARGS}
_STACK_ARGS = [_P] * 11 + [_I] * 4 + [_P]
_STACK_CHAIN_ARGS = [_P] * 12 + [_I] * 6 + [_P]
_STACK_SIGNATURES = {"lstm_stack_f32": _STACK_ARGS,
                     "lstm_stack_bf16": _STACK_ARGS,
                     "lstm_stack_max_rows_f32": [_I] * 2,
                     "lstm_stack_max_rows_bf16": [_I] * 2,
                     "lstm_stack_chain_f32": _STACK_CHAIN_ARGS,
                     "lstm_stack_chain_bf16": _STACK_CHAIN_ARGS,
                     "lstm_stack_chain_clusters_f32": [_I] * 4,
                     "lstm_stack_chain_clusters_bf16": [_I] * 4,
                     "lstm_stack_chain_residency": [],
                     "lstm_stack_smem_optin": []}
_STACK_MAX_LAYERS = 16   # kMaxLayers of csrc/lstm_stack.cu

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_tensors(what: str, device, want) -> None:
    """Raise unless each named tensor is contiguous, of its dtype and
    shape, on ``device``: ``want`` maps name → (tensor, dtype, shape)."""
    for name, (v, dtype, shape) in want.items():
        if (v.dtype != dtype or tuple(v.shape) != tuple(shape)
                or v.device != device or not v.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous {dtype} "
                             f"{list(shape)} on {device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def _check_lens(what: str, lens: torch.Tensor, b: int, device) -> None:
    if tuple(lens.shape) != (b,) or lens.device != device \
            or lens.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: lens must be int [B] on {device}, got "
                         f"{lens.dtype} {tuple(lens.shape)} on "
                         f"{lens.device}")


# batch ceilings already asked of a kernel source: (query, device, dims)
_ROW_CEILINGS: Dict[tuple, int] = {}


def _ceiling(lib: ctypes.CDLL, query: str, device, *dims: int) -> int:
    """The answer of a kernel source's ``query`` on ``device``: a
    ``*_max_rows`` query's most batch rows one launch takes, from the
    launch's own shared-memory and co-residency check over B, 0 if not
    one (or ``lstm_stack_chain_clusters_*``'s clusters the card holds at
    once); nothing is launched.  Cached per device and shape (it depends
    on nothing else)."""
    with torch.cuda.device(device):
        key = (query, torch.cuda.current_device(), dims)
        rows = _ROW_CEILINGS.get(key)
        if rows is None:
            rows = getattr(lib, query)(*dims)
            if rows < 0:
                _kernels.check(lib, -rows, query)
            _ROW_CEILINGS[key] = rows
    return rows


def max_rows(lib: ctypes.CDLL, query: str, device, *dims: int) -> int:
    """:func:`_ceiling`, raising when not even one row fits a launch."""
    rows = _ceiling(lib, query, device, *dims)
    if rows < 1:
        raise RuntimeError(f"{query}{dims}: not one batch row fits a "
                           f"launch on {device}")
    return rows


def run_in_row_slices(launch: Callable[..., Tuple[torch.Tensor, ...]],
                      rows: int, *batched: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
    """``launch(*batched)`` over slices of at most ``rows`` batch rows →
    its outputs for the whole batch.

    Every row's recurrence is independent of the others, so a batch above
    a kernel's ceiling runs as row slices, each written into the full
    outputs.  A [B] tensor has its rows on axis 0, any other on axis 1
    (the [T, B, ...] and [L, B, ...] layouts); None passes through; each
    output has its rows on axis 1.  At or under the ceiling ``launch``
    gets the tensors as they are: one call, no copy."""
    def axis(v):
        return 0 if v.dim() == 1 else 1

    b = batched[0].shape[axis(batched[0])]
    if b <= rows:
        return launch(*batched)
    outs = None
    for r0 in range(0, b, rows):
        n = min(rows, b - r0)
        part = launch(*(None if v is None
                        else v.narrow(axis(v), r0, n).contiguous()
                        for v in batched))
        if outs is None:
            outs = tuple(torch.empty((p.shape[0], b) + tuple(p.shape[2:]),
                                     dtype=p.dtype, device=p.device)
                         for p in part)
        for o, p in zip(outs, part):
            o.narrow(1, r0, n).copy_(p)
    return outs


def bilstm_seq_fwd_reference(xp: torch.Tensor, w_h_f: torch.Tensor,
                             w_h_b: torch.Tensor, lens: torch.Tensor,
                             y_dtype: Optional[torch.dtype] = None,
                             store_sums: bool = False):
    """Plain PyTorch version of :func:`bilstm_seq_fwd` on any device: a
    loop of T steps, forward direction at t=s, backward at t=T-1-s.  It
    keeps no sums: with ``store_sums`` the fifth output is None (its
    backward recomputes them)."""
    t_max, b, g8 = xp.shape
    g4 = g8 // 2
    h_dim = g4 // 4
    cdt = w_h_f.dtype
    y_dtype = xp.dtype if y_dtype is None else y_dtype
    valid = _valid(t_max, lens, xp.device)
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
    return tuple(outs) + ((None,) if store_sums else ())


def _check(xp, w_h_f, w_h_b, lens, y_dtype):
    if xp.dim() != 3 or xp.shape[2] % 8 or xp.dtype not in _SUFFIX:
        raise ValueError(f"bilstm_seq_fwd: xp must be f32 or bf16 "
                         f"[T, B, 8H], got {xp.dtype} {tuple(xp.shape)}")
    if y_dtype != xp.dtype:
        raise ValueError(f"bilstm_seq_fwd: the kernel stores y in xp's "
                         f"dtype {xp.dtype}, not {y_dtype}")
    h = xp.shape[2] // 8
    _check_tensors("bilstm_seq_fwd", xp.device, {
        "xp": (xp, xp.dtype, xp.shape), "w_h_f": (w_h_f, xp.dtype, (h, 4 * h)),
        "w_h_b": (w_h_b, xp.dtype, (h, 4 * h))})
    _check_lens("bilstm_seq_fwd", lens, xp.shape[1], xp.device)


def bilstm_seq_fwd(xp: torch.Tensor, w_h_f: torch.Tensor,
                   w_h_b: torch.Tensor, lens: torch.Tensor,
                   y_dtype: Optional[torch.dtype] = None,
                   store_sums: bool = False):
    """xp [T, B, 8H] fused projection (forward half first, compute dtype),
    w_h_f / w_h_b [H, 4H] in the compute dtype, lens [B] →
    (y_f, c_f, y_b, c_b): y [T, B, H] in y_dtype (default xp's), c
    [T, B, H] f32.  The contract of ``_bilstm_seq_fwd``.  On the card the
    route is :func:`fwd_chain_plan`'s, from the shapes: both directions'
    forward chains in thread-block clusters where W_h fits a cluster, else
    the cooperative kernel, and where neither fits (H = 1024 in f32) the
    wide route (:func:`bilstm_fwd_plan`); one launch for any B each way.

    ``store_sums`` (a backward will follow: :func:`bilstm_layer` under
    autograd) appends a fifth output, the recurrent sums y[t-+1] . W_h the
    cluster route formed its gates from, [T, B, 8H] f32 in K3's walk order
    (row s: the forward direction's at t = T-1-s, the backward one's at
    t = s), for :func:`bilstm_seq_bwd_dgates`; None where nothing was
    stored (the plain version, the cooperative route).  Counters
    ``store_launches``: the forwards that stored them; ``wide_launches``:
    the forwards on the wide route."""
    y_dtype = xp.dtype if y_dtype is None else y_dtype
    if xp.device.type == "cpu":
        return bilstm_seq_fwd_reference(xp, w_h_f, w_h_b, lens, y_dtype,
                                        store_sums)
    if xp.device.type != "cuda":
        raise ValueError(f"bilstm_seq_fwd: unsupported device {xp.device}")
    _check(xp, w_h_f, w_h_b, lens, y_dtype)
    t_max, b, g8 = xp.shape
    h = g8 // 8
    if t_max == 0 or b == 0:
        outs = _fwd_outputs(t_max, b, h, y_dtype, xp.device)
        return outs + (None,) if store_sums else outs
    lib = _kernels.load("bilstm_fwd", _SIGNATURES)
    plan = k2_plan(lib, b, h, xp.dtype, xp.device)
    lens32 = lens.to(torch.int32).contiguous()
    if plan.route == "cluster":
        outs = _bilstm_fwd_chain(lib, xp, w_h_f, w_h_b, lens32, plan,
                                 store_sums)
        if store_sums:
            bilstm_seq_fwd.store_launches += 1
    elif plan.route == "wide":
        outs = _bilstm_fwd_wide(lib, xp, w_h_f, w_h_b, lens32, store_sums)
        bilstm_seq_fwd.wide_launches += 1
        if store_sums:
            bilstm_seq_fwd.store_launches += 1
    else:
        outs = _bilstm_fwd_cooperative(lib, xp, w_h_f, w_h_b, lens32)
        if store_sums:
            outs += (None,)
    bilstm_seq_fwd.launches += 1
    return outs


def k2_plan(lib: ctypes.CDLL, b: int, h: int, dtype: torch.dtype,
            device) -> "FwdChainPlan":
    """K2's route and launch shape on ``device``: :func:`bilstm_fwd_plan`
    with the card's SMs and shared memory."""
    return bilstm_fwd_plan(b, h, dtype, _sm_count(device),
                           _smem_optin(lib, "bilstm_fwd_smem_optin", device))


def _bilstm_coop_fits(b: int, h: int, sms: int, smem_optin: int) -> bool:
    """Whether both cooperative kernels of the layer take it: K2's at
    ``b`` rows (``launch`` of csrc/bilstm_fwd.cu: W_h's 4 hs H floats,
    every row's cell state and one staged row) and K3's at one row of its
    row slices (``plan`` of csrc/bilstm_bwd.cu), hs = ceil(2H / SMs)."""
    hs = -(-2 * h // sms)
    k2 = 4 * (4 * hs * h + b * hs + h + 4 * hs)
    k3 = 4 * (4 * hs * h + h + 2 * 4 * hs + 2 * hs)
    return max(k2, k3) <= smem_optin


# pure in its arguments, and asked on every K2 and K3 call
@functools.lru_cache(maxsize=None)
def _wide_route(b: int, h: int, dtype: torch.dtype, sms: int,
                smem_optin: int) -> bool:
    """Whether a BLSTM layer takes K2's and K3's wide route: neither
    cluster route fits and a cooperative kernel of the pair does not take
    the batch (the same answer for K2 and K3, so the wide backward always
    reads the wide forward's sums).  Raises where the wide grid, one
    block an SM for every 16 units of both directions, exceeds the card
    (H above 16 x SMs / 2: 1,056 on 132 SMs)."""
    fwd = fwd_chain_plan(b, 0, h, dtype, 2, sms, smem_optin)
    bwd = bwd_chain_plan(b, h, dtype, 2, sms, smem_optin)
    if fwd.route == "cluster" or bwd.route == "cluster" \
            or _bilstm_coop_fits(b, h, sms, smem_optin):
        return False
    if 2 * -(-h // 16) > sms:
        raise ValueError(f"BLSTM at H={h}: no route on {sms} SMs (the wide "
                         f"route needs {2 * -(-h // 16)} co-resident blocks)")
    return True


def bilstm_fwd_plan(b: int, h: int, dtype: torch.dtype, sms: int,
                    smem_optin: int) -> "FwdChainPlan":
    """K2's route and launch shape for a batch of ``b`` rows and ``h``
    units on a card of ``sms`` SMs with ``smem_optin`` bytes of shared
    memory a block: :func:`fwd_chain_plan` with both directions, or the
    wide route (``rows`` the 64 rows of a tile; its launch sizes its
    blocks, ``bilstm_wide_fwd_smem``) where no cluster and no cooperative
    kernel fits (:func:`_wide_route`: H = 1024 in either dtype on the
    H100)."""
    if _wide_route(b, h, dtype, sms, smem_optin):
        return FwdChainPlan("wide", 0, 64, 0, 0, 0)
    return fwd_chain_plan(b, 0, h, dtype, 2, sms, smem_optin)


def _wide_weights(w_h_f: torch.Tensor, w_h_b: torch.Tensor) -> torch.Tensor:
    """W_h of both directions in the wide forward's layout, f32 [2][nb][32
    lanes][J][64]: block blk's column 4 jj + q is gate q of unit 16 blk +
    jj, term j of lane l row k = l + 32 j; zeros past H."""
    h = w_h_f.shape[0]
    nb, terms = -(-h // 16), -(-h // 32)
    w = torch.stack([w_h_f, w_h_b]).float().view(2, h, 4, h)
    w = torch.nn.functional.pad(w, (0, 16 * nb - h, 0, 0, 0, 32 * terms - h))
    w = w.view(2, terms, 32, 4, nb, 16).permute(0, 4, 2, 1, 5, 3)
    return w.reshape(2, nb, 32, terms, 64).contiguous()


def _bilstm_fwd_wide(lib: ctypes.CDLL, xp: torch.Tensor, w_h_f, w_h_b,
                     lens32: torch.Tensor, store_sums: bool = False):
    """K2's wide route (``bilstm_wide_fwd_*``, csrc/lstm_wide.cuh) on
    checked operands; with ``store_sums`` the recurrent sums [T, B, 8H]
    f32 in K3's walk order are a fifth output."""
    t_max, b, g8 = xp.shape
    h = g8 // 8
    outs = _fwd_outputs(t_max, b, h, xp.dtype, xp.device)
    hx = torch.zeros((2, 2, 32, -(-h // 32), -(-b // 64) * 64),
                     dtype=torch.float32, device=xp.device)
    sums = (torch.empty((t_max, b, g8), dtype=torch.float32,
                        device=xp.device) if store_sums else None)
    err = getattr(lib, "bilstm_wide_fwd_" + _SUFFIX[xp.dtype])(
        xp.data_ptr(), _wide_weights(w_h_f, w_h_b).data_ptr(),
        lens32.data_ptr(), *(v.data_ptr() for v in outs), hx.data_ptr(),
        None if sums is None else sums.data_ptr(), t_max, b, h,
        _kernels.stream_ptr(xp.device))
    _kernels.check(lib, err, f"bilstm_seq_fwd (wide) at T={t_max}, B={b}, "
                             f"H={h}")
    return outs + (sums,) if store_sums else outs


def _bilstm_fwd_chain(lib: ctypes.CDLL, xp: torch.Tensor, w_h_f, w_h_b,
                      lens32: torch.Tensor, plan: "FwdChainPlan",
                      store_sums: bool = False):
    """K2's cluster route (``bilstm_xp_chain_*``) on checked operands;
    with ``store_sums`` the recurrent sums [T, B, 8H] f32 in K3's walk
    order are a fifth output."""
    t_max, b, g8 = xp.shape
    h = g8 // 8
    outs = _fwd_outputs(t_max, b, h, xp.dtype, xp.device)
    state = torch.zeros((2, 2, b, h), dtype=torch.float32, device=xp.device)
    sums = (torch.empty((t_max, b, g8), dtype=torch.float32,
                        device=xp.device) if store_sums else None)
    err = getattr(lib, "bilstm_xp_chain_" + _SUFFIX[xp.dtype])(
        xp.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(), lens32.data_ptr(),
        *(v.data_ptr() for v in outs), state.data_ptr(),
        None if sums is None else sums.data_ptr(), t_max, b, h,
        plan.cluster, plan.rows, _kernels.stream_ptr(xp.device))
    _kernels.check(lib, err, f"bilstm_seq_fwd at T={t_max}, B={b}, {plan}")
    return outs + (sums,) if store_sums else outs


def _bilstm_fwd_cooperative(lib: ctypes.CDLL, xp: torch.Tensor, w_h_f,
                            w_h_b, lens32: torch.Tensor) -> Outputs:
    """K2's cooperative route (``bilstm_fwd_*``, any B: it stages h[t-1]
    in tiles of rows) on checked operands."""
    t_max, b, g8 = xp.shape
    h = g8 // 8
    outs = _fwd_outputs(t_max, b, h, xp.dtype, xp.device)
    # h exchange between blocks: [parity][direction][B][H], parity 0 = h0
    hbuf = torch.zeros((2, 2, b, h), dtype=torch.float32, device=xp.device)
    err = getattr(lib, "bilstm_fwd_" + _SUFFIX[xp.dtype])(
        xp.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(), lens32.data_ptr(),
        *(v.data_ptr() for v in outs), hbuf.data_ptr(), t_max, b, h,
        _kernels.stream_ptr(xp.device))
    _kernels.check(lib, err, "bilstm_seq_fwd")
    return outs


def _fwd_outputs(t_max: int, b: int, h: int, y_dtype: torch.dtype,
                 device) -> Outputs:
    """K2's and K10a's outputs, unfilled: (y_f, c_f, y_b, c_b)."""
    y = [torch.empty((t_max, b, h), dtype=y_dtype, device=device)
         for _ in range(2)]
    c = [torch.empty((t_max, b, h), dtype=torch.float32, device=device)
         for _ in range(2)]
    return y[0], c[0], y[1], c[1]


bilstm_seq_fwd.launches = 0  # kernel launches made by this wrapper
# of those, the ones that kept the recurrent sums for the backward
bilstm_seq_fwd.store_launches = 0
bilstm_seq_fwd.wide_launches = 0  # and the ones on the wide route


def bilstm_seq_bwd_dgates_reference(
        dy_f: torch.Tensor, dy_b: torch.Tensor, xp: torch.Tensor,
        y_f: torch.Tensor, c_f: torch.Tensor, y_b: torch.Tensor,
        c_b: torch.Tensor, w_h_f: torch.Tensor, w_h_b: torch.Tensor,
        lens: torch.Tensor, sums: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_seq_bwd_dgates` on any
    device: a loop of T steps, forward direction at t=T-1-s, backward
    at t=s (``_bibwd_kernel`` with ``_dgates_update``).  It recomputes
    the gates from y and leaves ``sums`` unread."""
    t_max, b, h_dim = dy_f.shape
    g4 = 4 * h_dim
    cdt = w_h_f.dtype
    dev = xp.device
    valid = _valid(t_max, lens, dev)
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
    if xp.dim() != 3 or xp.shape[2] % 8 or xp.dtype not in _SUFFIX:
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
    _check_tensors("bilstm_seq_bwd_dgates", xp.device, want)
    _check_lens("bilstm_seq_bwd_dgates", lens, b, xp.device)


def bilstm_seq_bwd_dgates(dy_f: torch.Tensor, dy_b: torch.Tensor,
                          xp: torch.Tensor, y_f: torch.Tensor,
                          c_f: torch.Tensor, y_b: torch.Tensor,
                          c_b: torch.Tensor, w_h_f: torch.Tensor,
                          w_h_b: torch.Tensor, lens: torch.Tensor,
                          sums: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output cotangents dy_f / dy_b [T, B, H] and the forward's
    residuals (xp [T, B, 8H], y and c of both directions, w_h_f / w_h_b
    [H, 4H] in the compute dtype, lens [B]) → (dg_f, dg_b) [T, B, 4H] in
    xp's dtype, the gate pre-activation cotangents.  The contract of
    ``_bilstm_seq_bwd_dgates`` with its default dgates dtype.  On the card
    the route is :func:`k3_plan`'s, from the shapes: where W_h fits a
    cluster, the backward chain with both directions in thread-block
    clusters (any B, one launch) on the recurrent sums the forward
    formed its gates from, ``sums`` of :func:`bilstm_seq_fwd` with
    ``store_sums`` ([T, B, 8H] f32, K3's walk order; they need no
    recompute, and the gates are the forward's bit for bit), which that
    route requires (a ValueError without them); else the cooperative
    kernel in row slices, which recomputes the sums from y and ignores
    ``sums``.  :func:`bilstm_layer` passes them where autograd records a
    backward (an inference forward keeps none; K2 takes its cluster route
    wherever this one does).  Where neither fits (H = 1024 in f32) the
    wide route, which reads the sums too (:func:`bilstm_bwd_plan`).
    Counters ``stored_launches``: the calls that read the forward's sums;
    ``wide_launches``: the calls on the wide route."""
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
    if t_max == 0 or b == 0:
        return tuple(torch.empty((t_max, b, 4 * h), dtype=xp.dtype,
                                 device=dev) for _ in range(2))
    lib = _kernels.load("bilstm_bwd", _BWD_SIGNATURES)
    plan = k3_plan(lib, b, h, xp.dtype, dev)
    lens32 = lens.to(torch.int32).contiguous()
    ops = (dy_f, dy_b, xp, y_f, c_f, y_b, c_b, w_h_f, w_h_b, lens32)
    if plan.route in ("cluster", "wide"):
        if sums is None:
            raise ValueError(f"bilstm_seq_bwd_dgates: the {plan.route} route "
                             "reads the recurrent sums of bilstm_seq_fwd with "
                             "store_sums=True; none were passed")
        _check_tensors("bilstm_seq_bwd_dgates", dev, {
            "sums": (sums, torch.float32, (t_max, b, g8))})
        bilstm_seq_bwd_dgates.stored_launches += 1
        if plan.route == "cluster":
            out = _bilstm_bwd_chain(lib, *ops, sums, plan)
        else:
            out = _bilstm_bwd_wide(lib, *ops, sums)
            bilstm_seq_bwd_dgates.wide_launches += 1
    else:
        out = _bilstm_bwd_cooperative(lib, *ops)
    bilstm_seq_bwd_dgates.launches += 1
    return out


def k3_plan(lib: ctypes.CDLL, b: int, h: int, dtype: torch.dtype,
            device) -> "BwdChainPlan":
    """K3's route and launch shape on ``device``: :func:`bilstm_bwd_plan`
    with the card's SMs and shared memory."""
    return bilstm_bwd_plan(b, h, dtype, _sm_count(device),
                           _smem_optin(lib, "bilstm_bwd_smem_optin", device))


def bilstm_bwd_plan(b: int, h: int, dtype: torch.dtype, sms: int,
                    smem_optin: int) -> "BwdChainPlan":
    """K3's route and launch shape: :func:`bwd_chain_plan` with four gates
    and both directions, or the wide route (``rows`` 64; its launch sizes
    its blocks, ``bilstm_wide_bwd_smem``) wherever K2 takes it
    (:func:`_wide_route`)."""
    if _wide_route(b, h, dtype, sms, smem_optin):
        return BwdChainPlan("wide", 0, 0, 0, 64, 0)
    return bwd_chain_plan(b, h, dtype, 2, sms, smem_optin)


def _wide_rows(w_h_f: torch.Tensor, w_h_b: torch.Tensor, cols: int
               ) -> torch.Tensor:
    """W_h of both directions in the wide backward's layout, f32 [2][nb]
    [cols][16] (``cols``: ``bilstm_wide_bwd_cols``, 4H in 8 slices of
    whole 16-column chunks): block blk's row c holds W_h[16 blk + kk][c]
    at kk; zeros past H and 4H."""
    h = w_h_f.shape[0]
    nb = -(-h // 16)
    w = torch.stack([w_h_f, w_h_b]).float()
    w = torch.nn.functional.pad(w, (0, cols - 4 * h, 0, 16 * nb - h))
    return w.view(2, nb, 16, -1).transpose(2, 3).contiguous()


def _bilstm_bwd_wide(lib: ctypes.CDLL, dy_f, dy_b, xp, y_f, c_f, y_b, c_b,
                     w_h_f, w_h_b, lens32: torch.Tensor, sums: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's wide route (``bilstm_wide_bwd_*``, csrc/lstm_wide.cuh) on
    checked operands and the sums K2's wide route stored."""
    t_max, b, g8 = xp.shape
    h = g8 // 8
    dev = xp.device
    dg_f = torch.empty((t_max, b, 4 * h), dtype=xp.dtype, device=dev)
    dg_b = torch.empty_like(dg_f)
    cols = lib.bilstm_wide_bwd_cols(h)
    dgx = torch.zeros((2, 2, cols, -(-b // 64) * 64),
                      dtype=torch.float32, device=dev)
    state = torch.zeros((2, 2, b, h), dtype=torch.float32, device=dev)
    err = getattr(lib, "bilstm_wide_bwd_" + _SUFFIX[xp.dtype])(
        dy_f.data_ptr(), dy_b.data_ptr(), xp.data_ptr(), c_f.data_ptr(),
        c_b.data_ptr(), _wide_rows(w_h_f, w_h_b, cols).data_ptr(),
        lens32.data_ptr(), sums.data_ptr(), dg_f.data_ptr(), dg_b.data_ptr(),
        dgx.data_ptr(), state.data_ptr(), t_max, b, h,
        _kernels.stream_ptr(dev))
    _kernels.check(lib, err, f"bilstm_seq_bwd_dgates (wide) at T={t_max}, "
                             f"B={b}, H={h}")
    return dg_f, dg_b


def _bilstm_bwd_chain(lib: ctypes.CDLL, dy_f, dy_b, xp, y_f, c_f, y_b, c_b,
                      w_h_f, w_h_b, lens32: torch.Tensor,
                      sums: torch.Tensor, plan: "BwdChainPlan"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's cluster route (``bilstm_bwd_chain_*``, the whole walk in one
    launch) on checked operands and K2's stored ``sums``."""
    t_max, b, g8 = xp.shape
    h = g8 // 8
    dev = xp.device
    dg_f = torch.empty((t_max, b, 4 * h), dtype=xp.dtype, device=dev)
    dg_b = torch.empty_like(dg_f)
    state = torch.zeros((2, 2, b, h), dtype=torch.float32, device=dev)
    err = getattr(lib, "bilstm_bwd_chain_" + _SUFFIX[xp.dtype])(
        dy_f.data_ptr(), dy_b.data_ptr(), xp.data_ptr(), c_f.data_ptr(),
        c_b.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(),
        lens32.data_ptr(), sums.data_ptr(), dg_f.data_ptr(), dg_b.data_ptr(),
        state.data_ptr(), t_max, b, h, plan.cluster, plan.rows,
        _kernels.stream_ptr(dev))
    _kernels.check(lib, err, f"bilstm_seq_bwd_dgates at T={t_max}, B={b}, "
                             f"{plan}")
    return dg_f, dg_b


def _bilstm_bwd_cooperative(lib: ctypes.CDLL, dy_f, dy_b, xp, y_f, c_f,
                            y_b, c_b, w_h_f, w_h_b, lens32: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's cooperative route (``bilstm_bwd_*``) on checked operands, in
    row slices under its ceiling."""
    t_max, _, g8 = xp.shape
    h = g8 // 8
    dev = xp.device
    sfx = _SUFFIX[xp.dtype]

    def launch(dy_f, dy_b, xp, y_f, c_f, y_b, c_b, lens32):
        n = xp.shape[1]
        dg_f = torch.empty((t_max, n, 4 * h), dtype=xp.dtype, device=dev)
        dg_b = torch.empty_like(dg_f)
        floats = lib.bilstm_bwd_exchange_floats(n, h)
        if floats < 0:
            raise RuntimeError(f"bilstm_seq_bwd_dgates: no exchange size "
                               f"for B={n}, H={h} on {dev}")
        # partial-dh exchange between blocks; every entry read is written
        # in the step before
        part = torch.empty((floats,), dtype=torch.float32, device=dev)
        err = getattr(lib, "bilstm_bwd_" + sfx)(
            dy_f.data_ptr(), dy_b.data_ptr(), xp.data_ptr(), y_f.data_ptr(),
            c_f.data_ptr(), y_b.data_ptr(), c_b.data_ptr(), w_h_f.data_ptr(),
            w_h_b.data_ptr(), lens32.data_ptr(), dg_f.data_ptr(),
            dg_b.data_ptr(), part.data_ptr(), t_max, n, h,
            _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "bilstm_seq_bwd_dgates")
        return dg_f, dg_b

    return run_in_row_slices(
        launch, max_rows(lib, "bilstm_bwd_max_rows_" + sfx, dev, h),
        dy_f, dy_b, xp, y_f, c_f, y_b, c_b, lens32)


bilstm_seq_bwd_dgates.launches = 0  # kernel launches made by this wrapper
# of those, the ones on the sums the forward stored
bilstm_seq_bwd_dgates.stored_launches = 0
bilstm_seq_bwd_dgates.wide_launches = 0  # and the wide route's


# ---------------------------------------------------------------------------
# The bidirectional layer with the projection inside: K10a and K10b
# ---------------------------------------------------------------------------


def use_in_kernel_proj(d: int, g4: int,
                       dtype: torch.dtype = torch.float32) -> bool:
    """Whether a bidirectional LSTM layer of input width ``d`` and 4H =
    ``g4`` runs K10a/K10b (the projection inside the kernels) rather than
    the hoisted projection with K2/K3: ``_use_in_kernel_proj`` of
    ``rnn_pallas`` with ``KCTPU_RNN_PROJ`` unset, from shapes and dtype
    alone.  Its three tests, in its order: D and 4H multiples of 128; not
    bf16; the resident weights of its backward kernel (w_x, both w_h and
    their transposes) at most 8 MiB.  The rule stays the reference's so
    that the port takes the reference's route; K10a and K10b size their
    shared memory from the shapes they are given."""
    if d % 128 or g4 % 128:
        return False
    if dtype == torch.bfloat16:
        return False
    h = g4 // 4
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (d * 2 * g4 + 4 * h * g4) * itemsize <= 8 * 1024 * 1024


def _project_bilstm(x: torch.Tensor, w_x: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The input projection of both directions for every frame, ``_proj``
    of ``rnn_pallas``: x [T, B, D] · w_x [D, 8H] with f32 sums, plus the
    f32 bias, rounded to w_x's (the compute) dtype → [T, B, 8H].  The
    hoisted route feeds it to K2; the plain versions of K10a and K10b
    both compute it here, as the kernels share ``project()``."""
    t_max, b, d = x.shape
    cdt = w_x.dtype
    return (matmul_f32acc(x.reshape(t_max * b, d), w_x, cdt)
            + bias.float()).to(cdt).reshape(t_max, b, -1)


def bilstm_seq_fwd_proj_reference(x: torch.Tensor, w_x: torch.Tensor,
                                  bias: torch.Tensor, w_h_f: torch.Tensor,
                                  w_h_b: torch.Tensor,
                                  lens: torch.Tensor) -> Outputs:
    """Plain PyTorch version of :func:`bilstm_seq_fwd_proj` on any
    device: the projection of every frame, then K2's plain loop."""
    return bilstm_seq_fwd_reference(_project_bilstm(x, w_x, bias), w_h_f,
                                    w_h_b, lens)


def _check_proj(what: str, x, w_x, bias, w_h_f, w_h_b, lens,
                residuals=None) -> None:
    """Raise unless K10a's operands (and K10b's ``residuals``, name →
    (tensor, dtype), each [T, B, H]) are what the kernels take."""
    if x.dim() != 3 or x.dtype not in _SUFFIX or w_x.dim() != 2 \
            or w_x.shape[1] % 8:
        raise ValueError(f"{what}: x must be f32 or bf16 [T, B, D] and w_x "
                         f"[D, 8H], got {x.dtype} {tuple(x.shape)} and "
                         f"{tuple(w_x.shape)}")
    t_max, b, d = x.shape
    h = w_x.shape[1] // 8
    want = {"x": (x, x.dtype, x.shape), "w_x": (w_x, x.dtype, (d, 8 * h)),
            "bias": (bias, torch.float32, (8 * h,)),
            "w_h_f": (w_h_f, x.dtype, (h, 4 * h)),
            "w_h_b": (w_h_b, x.dtype, (h, 4 * h))}
    for name, (v, dtype) in (residuals or {}).items():
        want[name] = (v, dtype, (t_max, b, h))
    _check_tensors(what, x.device, want)
    _check_lens(what, lens, b, x.device)


def bilstm_seq_fwd_proj(x: torch.Tensor, w_x: torch.Tensor,
                        bias: torch.Tensor, w_h_f: torch.Tensor,
                        w_h_b: torch.Tensor, lens: torch.Tensor) -> Outputs:
    """x [T, B, D], w_x = [w_x_fwd | w_x_bwd] [D, 8H] and w_h_f / w_h_b
    [H, 4H] in the compute dtype, bias [8H] f32, lens [B] → (y_f, c_f,
    y_b, c_b): y [T, B, H] in the compute dtype, c [T, B, H] f32.  Each
    step projects its own frame (the forward direction x[s], the backward
    x[T-1-s]) as (x[t] · w_x half, f32 sums) + bias half, rounded to the
    compute dtype.  The contract of ``_bilstm_seq_fwd_proj``.  On the
    card: phase 1 computes every frame's projection at once into an f32
    scratch, phase 2 walks both directions' recurrences in thread-block
    clusters (:func:`fwd_chain_plan`); any B."""
    if x.device.type == "cpu":
        return bilstm_seq_fwd_proj_reference(x, w_x, bias, w_h_f, w_h_b,
                                             lens)
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_seq_fwd_proj: unsupported device "
                         f"{x.device}")
    _check_proj("bilstm_seq_fwd_proj", x, w_x, bias, w_h_f, w_h_b, lens)
    t_max, b, d = x.shape
    h = w_x.shape[1] // 8
    dev = x.device
    outs = _fwd_outputs(t_max, b, h, x.dtype, dev)
    if t_max == 0 or b == 0:
        return outs
    lib = _kernels.load("bilstm_fwd", _SIGNATURES)
    plan = fwd_chain_plan(b, d, h, x.dtype, 2, _sm_count(dev),
                          _smem_optin(lib, "bilstm_fwd_smem_optin", dev))
    sfx = _SUFFIX[x.dtype]
    stream = _kernels.stream_ptr(dev)
    # phase 1's scratch holds one chunk of frames a direction; phase 2
    # carries h and c between chunks in `state`
    steps = _scratch_steps(t_max, b, 8 * h)
    pre = torch.empty((steps, b, 8 * h), dtype=torch.float32, device=dev)
    state = torch.zeros((2, 2, b, h), dtype=torch.float32, device=dev)
    lens32 = lens.to(torch.int32).contiguous()
    what = f"bilstm_seq_fwd_proj at T={t_max}, B={b}, D={d}, {plan}"
    for s0 in range(0, t_max, steps):
        n = min(steps, t_max - s0)
        # the forward direction's frames s0.., the backward's ..T-1-s0
        err = getattr(lib, "bilstm_proj_x_" + sfx)(
            x.data_ptr(), w_x.data_ptr(), bias.data_ptr(), pre.data_ptr(),
            s0, t_max - s0 - n, n, t_max, b, d, h, plan.proj_cols, stream)
        _kernels.check(lib, err, what + " phase 1")
        err = getattr(lib, "bilstm_fwd_chain_" + sfx)(
            pre.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(),
            lens32.data_ptr(), *(v.data_ptr() for v in outs),
            state.data_ptr(), s0, n, t_max, b, h, plan.cluster, plan.rows,
            stream)
        _kernels.check(lib, err, what + " phase 2")
    bilstm_seq_fwd_proj.launches += 1
    return outs


bilstm_seq_fwd_proj.launches = 0  # kernel launches made by this wrapper


class K10bPlan(NamedTuple):
    """K10b's launch shape.  Phase 1 runs the tiled kernel (64 rows and
    64 gate columns a block) where ``gates_tiled``, else one warp per
    (row, column) over ``gate_cols`` columns a block; ``gates_smem`` is a
    block's shared memory.  Phase 2 runs one cluster of ``cluster`` CTAs
    per (direction, ``rows`` batch rows); each CTA holds ceil(H /
    cluster) units' gate columns of W_h (``chain_smem`` bytes in all)."""
    gates_tiled: bool
    gate_cols: int
    gates_smem: int
    cluster: int
    rows: int
    chain_smem: int


_CLUSTERS = (1, 2, 4, 8, 16)        # powers of two up to 16 CTAs
_K10_SCRATCH_BYTES = 256 << 20      # the phase-1 scratch of K10a, K10b,
                                    # K6 and K9b, per chunk of steps


def _scratch_steps(t_max: int, b: int, g: int) -> int:
    """Steps (or frames) a chunk of a phase-1 scratch [steps, B, g] f32
    holds within ``_K10_SCRATCH_BYTES``, at least one."""
    return max(1, min(t_max, _K10_SCRATCH_BYTES // (b * g * 4)))


def _bwd_chain_words(gates: int, pre: bool) -> int:
    """Words a backward-chain CTA prefetches per (row, unit) and step:
    ``bwd_chain_words`` of csrc/bwd_chain.cuh with the cell's residual
    words (the LSTM's c[t] and c[prev], the GRU's y[prev]); ``pre``: the
    scratch holds the pre-activation (K10b), else x_proj's words too."""
    res = 2 if gates == 4 else 1
    return -(-(gates * (1 if pre else 2) + res + 1) // 4) * 4


def _bwd_chain_bytes(c: int, r: int, h: int, gates: int, words: int) -> int:
    """Shared memory of a backward-chain CTA at cluster size ``c``, ``r``
    rows per cluster, ``h`` units of ``gates`` gate columns, ``words``
    prefetched words per (row, unit): ``bwd_chain_floats`` of
    csrc/bwd_chain.cuh (W_h's share as f32, the received partials, the
    rounded dgates, dh and the cell's second value, two prefetch buffers,
    the lengths)."""
    hsz = -(-h // c)
    rp = -(-r // 4) * 4

    def r4(n):
        return -(-n // 4) * 4
    return 4 * (r4(gates * hsz * h) + r4(2 * c * r * hsz) + gates * hsz * rp
                + 2 * r * hsz + 2 * words * r * hsz + r)


def _bwd_chain_shape(b: int, h: int, gates: int, words: int, dirs: int,
                     sms: int, smem_optin: int) -> Optional[Tuple[int, int]]:
    """A backward chain's cluster size C and rows per cluster R, or None
    where not one row fits beside W_h's share of a cluster of 16.  C is
    the smallest power of two whose CTA at one row takes at most half of
    its shared memory; R the fewest rows per cluster that keep the dirs
    ceil(B/R) clusters in one wave on three quarters of the SMs (whole
    clusters of C CTAs do not pack every SM), as far as shared memory
    allows (a larger batch runs in more waves)."""
    c = next((c for c in _CLUSTERS
              if _bwd_chain_bytes(c, 1, h, gates, words) <= smem_optin // 2),
             _CLUSTERS[-1])
    if _bwd_chain_bytes(c, 1, h, gates, words) > smem_optin:
        return None
    clusters = max(1, sms * 3 // 4 // (dirs * c))
    r = max(1, min(b, -(-b // clusters)))
    while r > 1 and _bwd_chain_bytes(c, r, h, gates, words) > smem_optin:
        r -= 1
    return c, r


def k10b_plan(b: int, d: int, h: int, sms: int, smem_optin: int
              ) -> K10bPlan:
    """K10b's cluster size C and rows per cluster R for a batch of ``b``
    rows, input width ``d`` and ``h`` units on a card of ``sms`` SMs with
    ``smem_optin`` bytes of shared memory per block.

    Phase 1 is tiled where 64 staged rows and 64 columns of D + H f32
    fit a block (D + H <= 426), else it takes 32 gate columns a block, fewer where
    W_x's columns are too long (D = 8064 at H = 32 takes 7).  Phase 2 is
    the backward chain with both directions on the pre-activations
    (:func:`_bwd_chain_shape`): C is 4 at H = 128, 16 at H = 256 and 320.
    Raises when no plan fits."""
    tiled = 4 * (2 * 68 * (d + h) + 64)      # gates_tiled_smem of the .cu
    cols = 64 if tiled <= smem_optin else min(
        32, smem_optin // (4 * (d + h + 1)))
    words = _bwd_chain_words(4, pre=True)
    shape = _bwd_chain_shape(b, h, 4, words, 2, sms, smem_optin)
    if cols < 1 or shape is None:
        raise ValueError(f"K10b: no cluster plan fits D={d}, H={h} in "
                         f"{smem_optin} bytes of shared memory")
    c, r = shape
    return K10bPlan(tiled <= smem_optin, cols,
                    tiled if tiled <= smem_optin else 4 * cols * (d + h + 1),
                    c, r, _bwd_chain_bytes(c, r, h, 4, words))


class BwdChainPlan(NamedTuple):
    """The launch shape of a backward recurrence on the hoisted projection
    (K3, K6, K8b, K9b).  ``route`` "cluster": the backward chain, one
    cluster of ``cluster`` CTAs per (direction, ``rows`` batch rows), each
    CTA holding ceil(H / cluster) units' gate columns of W_h as f32
    (``chain_smem`` bytes in all), on recurrent sums that K6 and K9b
    compute first in a phase 1, on the tiled kernel (64 rows and 64 gate
    columns a block, ``gate_cols`` 0) or one warp per row over
    ``gate_cols`` columns a block, ``gates_smem`` bytes a block; K3 and
    K8b have no phase 1 (they read the sums their forward stored): both
    fields 0.  "cooperative": the kernel's cooperative route (in row
    slices), the other fields 0.  "wide" (K3 alone, :func:`bilstm_bwd_plan`):
    W_h read from L2 every step, ``rows`` a tile's rows, the other fields
    0 (its launch sizes its blocks)."""
    route: str
    gate_cols: int
    gates_smem: int
    cluster: int
    rows: int
    chain_smem: int


def bwd_chain_plan(b: int, h: int, dtype: torch.dtype, dirs: int, sms: int,
                   smem_optin: int, gates: int = 4) -> BwdChainPlan:
    """The route and launch shape of a backward recurrence on the hoisted
    projection for a batch of ``b`` rows, ``h`` units of ``gates`` gate
    columns (4: an LSTM, K3 with dirs 2 and K6 with 1; 3: a GRU, K8b with
    dirs 2 and K9b with 1) and ``dirs`` directions in ``dtype`` on a card
    of ``sms`` SMs with ``smem_optin`` bytes of shared memory per block.

    The chain holds W_h as f32 in either dtype (its dh product reads each
    weight once a step per row, so a bf16 copy would cost a conversion in
    the serial loop), so ``dtype`` does not move the fit: the cluster
    route holds where one row fits beside W_h's share of a cluster of 16
    (the LSTM to H ~465, the GRU to ~545), with C and R from
    :func:`_bwd_chain_shape` (16 and 8 at B = 48, H = 320 with one
    direction, 16 and 16 with two); above that the kernel's cooperative
    route.  K3's and K8b's cluster route reads the recurrent sums their
    forward (K2, K8a) stored while it ran, [T, B, dirs gates H] f32 in the
    walk's order (row s: the forward direction's sums at t = T-1-s, the
    backward one's at t = s), whole, in one launch; the forward stores
    them only where a backward is recorded (training), and its cluster
    route holds wherever this one does (to H ~470 and ~545 in f32, more
    in bf16).  K6's and K9b's phase 1 (dirs 1) is tiled where 64 staged
    rows and 64 columns of H f32 fit a block (H <= 426), else it takes 32
    gate columns a block."""
    if dtype not in _SUFFIX:
        raise ValueError(f"bwd_chain_plan: no kernel for {dtype}")
    words = _bwd_chain_words(gates, pre=False)
    shape = _bwd_chain_shape(b, h, gates, words, dirs, sms, smem_optin)
    if shape is None:
        return BwdChainPlan("cooperative", 0, 0, 0, 0, 0)
    c, r = shape
    chain = _bwd_chain_bytes(c, r, h, gates, words)
    if dirs == 2:
        return BwdChainPlan("cluster", 0, 0, c, r, chain)
    tiled = 4 * (2 * 68 * h + 64)            # gates_tiled_smem(0, H)
    cols = 0 if tiled <= smem_optin else 32
    return BwdChainPlan("cluster", cols,
                        tiled if cols == 0 else 4 * cols * (h + 1), c, r,
                        chain)


class FwdChainPlan(NamedTuple):
    """The launch shape of a forward chain (K2, K5, K8a, K9a, K10a).
    ``route`` "cluster": one cluster of ``cluster`` CTAs per (direction,
    ``rows`` batch rows), each CTA holding ceil(H / cluster) units' gate
    columns of W_h in the compute dtype (``chain_smem`` bytes in all);
    "cooperative" (all but K10a): the kernel's cooperative route, and the
    other fields 0; "wide" (K2 alone, :func:`bilstm_fwd_plan`): W_h read
    from L2 every step, ``rows`` a tile's rows, the other fields 0 (its
    launch sizes its blocks).  K10a's phase 1 runs the tiled kernel (64 frames and 64 gate
    columns a block, ``proj_cols`` 0) or one warp per frame over
    ``proj_cols`` columns a block; ``proj_smem`` is its block's shared
    memory."""
    route: str
    cluster: int
    rows: int
    chain_smem: int
    proj_cols: int
    proj_smem: int


def _fwd_chain_bytes(c: int, r: int, h: int, itemsize: int,
                     gates: int = 4) -> int:
    """Shared memory of a forward-chain CTA at cluster size ``c``, ``r``
    rows per cluster, ``h`` units of ``gates`` gate columns, W_h and h of
    ``itemsize`` bytes: ``fwd_chain_bytes`` of csrc/fwd_chain.cuh (f32
    sums, state and two buffers of prefetched pre-activations: gates + 1 +
    2 gates floats an element)."""
    hsz = -(-h // c)

    def a16(n):
        return -(-n // 16) * 16
    return (a16(gates * hsz * h * itemsize) + a16(2 * r * h * itemsize)
            + a16(r * hsz * itemsize) + 4 * r * hsz * (3 * gates + 1)
            + 4 * r)


def fwd_chain_plan(b: int, d: int, h: int, dtype: torch.dtype, dirs: int,
                   sms: int, smem_optin: int, gates: int = 4
                   ) -> FwdChainPlan:
    """The launch shape of a forward chain for a batch of ``b`` rows,
    ``h`` units of ``gates`` gate columns (4: an LSTM, 3: a GRU) and
    ``dirs`` directions in ``dtype`` on a card of ``sms`` SMs with
    ``smem_optin`` bytes of shared memory per block: K10a with its input
    width ``d`` (dirs 2); a kernel on the hoisted projection with ``d`` 0:
    K2 (dirs 2), K5 and K9a (dirs 1, K9a with gates 3), K8a (dirs 2,
    gates 3).

    C is the smallest power of two whose share of W_h as f32 (gates
    ceil(H/C) H floats) leaves half of a CTA's shared memory to the rows:
    4 at H = 128 (the GRU: 2), 16 at H = 256 and 320 in either dtype.  The
    cluster route holds where one row fits beside that share in the
    compute dtype (the LSTM to H ~470 in f32, ~670 in bf16; the GRU to
    ~545 and ~770); above that a kernel on the hoisted projection takes its
    cooperative route, and K10a, which has none, raises.  (At the serving
    batch B = 1 the chain is no slower than the cooperative kernels on the
    H100, so the batch does not choose the route: PERF.md §5.)
    R is the fewest rows per cluster that keep the dirs ceil(B/R) clusters
    in one wave on three quarters of the SMs (whole clusters of C CTAs do
    not pack every SM), as far as shared memory allows; a larger batch
    runs in more waves.  K10a's phase 1 is tiled where 64 staged frames and
    64 columns of D f32 fit a block (D <= 426), else it takes 32 gate
    columns a block, fewer where W_x's columns are too long.  Raises when
    K10a has no plan."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    c = next((c for c in _CLUSTERS
              if 4 * gates * -(-h // c) * h <= smem_optin // 2),
             _CLUSTERS[-1])
    if _fwd_chain_bytes(c, 1, h, itemsize, gates) > smem_optin:
        if d == 0:
            return FwdChainPlan("cooperative", 0, 0, 0, 0, 0)
        raise ValueError(f"K10a: no cluster plan fits H={h} in {dtype} in "
                         f"{smem_optin} bytes of shared memory")
    clusters = max(1, sms * 3 // 4 // (dirs * c))
    r = max(1, min(b, -(-b // clusters)))
    while r > 1 and _fwd_chain_bytes(c, r, h, itemsize, gates) > smem_optin:
        r -= 1
    cols = proj_smem = 0
    if d:
        proj_smem = 4 * (2 * 68 * d + 64)   # gates_tiled_smem(D, 0)
        if proj_smem > smem_optin:
            cols = min(32, smem_optin // (4 * (d + 1)))
            if cols < 1:
                raise ValueError(f"K10a: no projection plan fits D={d} in "
                                 f"{smem_optin} bytes of shared memory")
            proj_smem = 4 * cols * (d + 1)   # gates_smem(cols, D, 0)
    return FwdChainPlan("cluster", c, r,
                        _fwd_chain_bytes(c, r, h, itemsize, gates), cols,
                        proj_smem)


def _smem_optin(lib: ctypes.CDLL, query: str, device) -> int:
    """The opt-in shared memory of one block on ``device``, in bytes, from
    a kernel source's ``query`` (``*_smem_optin``)."""
    with torch.cuda.device(device):
        optin = getattr(lib, query)()
    if optin < 0:
        _kernels.check(lib, -optin, query)
    return optin


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _k10b_gates(lib, x, y_f, y_b, w_x, bias, w_h_f, w_h_b, pre, s0, n,
                plan: K10bPlan):
    """K10b phase 1 for walk steps s0 .. s0+n-1: the gate pre-activations
    of both directions into pre[:n]."""
    t_max, b, d = x.shape
    args = [x.data_ptr(), y_f.data_ptr(), y_b.data_ptr(), w_x.data_ptr(),
            bias.data_ptr(), w_h_f.data_ptr(), w_h_b.data_ptr(),
            pre.data_ptr(), s0, n, t_max, b, d, w_h_f.shape[0]]
    sfx = _SUFFIX[x.dtype]
    if plan.gates_tiled:
        err = getattr(lib, "bilstm_proj_gates_tiled_" + sfx)(
            *args, _kernels.stream_ptr(x.device))
    else:
        err = getattr(lib, "bilstm_proj_gates_" + sfx)(
            *args, plan.gate_cols, _kernels.stream_ptr(x.device))
    _kernels.check(lib, err, f"bilstm_seq_bwd_dgates_proj phase 1 at "
                             f"T={t_max}, B={b}, D={d}, {plan}")


def _k10b_chain(lib, dy_f, dy_b, c_f, c_b, w_h_f, w_h_b, lens32, pre, dg_f,
                dg_b, state, s0, n, plan: K10bPlan):
    """K10b phase 2 for the same steps: the dh/dc chain in clusters,
    dgates into dg_f, dg_b; ``state`` carries dh and dc across chunks."""
    t_max, b, h = dy_f.shape
    err = getattr(lib, "bilstm_proj_chain_" + _SUFFIX[dy_f.dtype])(
        dy_f.data_ptr(), dy_b.data_ptr(), c_f.data_ptr(), c_b.data_ptr(),
        w_h_f.data_ptr(), w_h_b.data_ptr(), lens32.data_ptr(),
        pre.data_ptr(), dg_f.data_ptr(), dg_b.data_ptr(), state.data_ptr(),
        s0, n, t_max, b, h, plan.cluster, plan.rows,
        _kernels.stream_ptr(dy_f.device))
    _kernels.check(lib, err, f"bilstm_seq_bwd_dgates_proj phase 2 at "
                             f"T={t_max}, B={b}, H={h}, {plan}")


def bilstm_seq_bwd_dgates_proj_reference(
        dy_f: torch.Tensor, dy_b: torch.Tensor, x: torch.Tensor,
        y_f: torch.Tensor, c_f: torch.Tensor, y_b: torch.Tensor,
        c_b: torch.Tensor, w_x: torch.Tensor, bias: torch.Tensor,
        w_h_f: torch.Tensor, w_h_b: torch.Tensor, lens: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_seq_bwd_dgates_proj` on any
    device: the forward's projection recomputed by the same
    ``_project_bilstm``, then K3's plain loop."""
    return bilstm_seq_bwd_dgates_reference(
        dy_f, dy_b, _project_bilstm(x, w_x, bias), y_f, c_f, y_b, c_b,
        w_h_f, w_h_b, lens)


def bilstm_seq_bwd_dgates_proj(dy_f: torch.Tensor, dy_b: torch.Tensor,
                               x: torch.Tensor, y_f: torch.Tensor,
                               c_f: torch.Tensor, y_b: torch.Tensor,
                               c_b: torch.Tensor, w_x: torch.Tensor,
                               bias: torch.Tensor, w_h_f: torch.Tensor,
                               w_h_b: torch.Tensor, lens: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output cotangents dy_f / dy_b [T, B, H] and K10a's operands and
    outputs (x, w_x, bias, w_h_f, w_h_b as :func:`bilstm_seq_fwd_proj`
    takes them, y and c of both directions, lens) → (dg_f, dg_b) [T, B,
    4H] in the compute dtype, zero at pad frames.  The gates are
    recomputed from x through K10a's projection, with h_prev from the
    stored y.  The contract of ``_bilstm_seq_bwd_dgates_proj``.  On the
    card: phase 1 computes every step's gate pre-activations at once into
    an f32 scratch, phase 2 walks the dh/dc chain in thread-block clusters
    (:func:`k10b_plan`); any B."""
    if x.device.type == "cpu":
        return bilstm_seq_bwd_dgates_proj_reference(
            dy_f, dy_b, x, y_f, c_f, y_b, c_b, w_x, bias, w_h_f, w_h_b, lens)
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_seq_bwd_dgates_proj: unsupported device "
                         f"{x.device}")
    f32 = torch.float32
    _check_proj("bilstm_seq_bwd_dgates_proj", x, w_x, bias, w_h_f, w_h_b,
                lens, {"dy_f": (dy_f, x.dtype), "dy_b": (dy_b, x.dtype),
                       "y_f": (y_f, x.dtype), "y_b": (y_b, x.dtype),
                       "c_f": (c_f, f32), "c_b": (c_b, f32)})
    t_max, b, d = x.shape
    h = w_x.shape[1] // 8
    dev = x.device
    dg_f = torch.empty((t_max, b, 4 * h), dtype=x.dtype, device=dev)
    dg_b = torch.empty((t_max, b, 4 * h), dtype=x.dtype, device=dev)
    if t_max == 0 or b == 0:
        return dg_f, dg_b
    lib = _kernels.load("bilstm_bwd", _BWD_SIGNATURES)
    plan = k10b_plan(b, d, h, _sm_count(dev),
                     _smem_optin(lib, "bilstm_bwd_smem_optin", dev))
    # phase 1's scratch holds the steps of one chunk; phase 2 carries dh
    # and dc between chunks in `state`
    steps = _scratch_steps(t_max, b, 8 * h)
    pre = torch.empty((steps, b, 8 * h), dtype=f32, device=dev)
    state = torch.zeros((2, 2, b, h), dtype=f32, device=dev)
    lens32 = lens.to(torch.int32).contiguous()
    for s0 in range(0, t_max, steps):
        n = min(steps, t_max - s0)
        _k10b_gates(lib, x, y_f, y_b, w_x, bias, w_h_f, w_h_b, pre, s0, n,
                    plan)
        _k10b_chain(lib, dy_f, dy_b, c_f, c_b, w_h_f, w_h_b, lens32, pre,
                    dg_f, dg_b, state, s0, n, plan)
    bilstm_seq_bwd_dgates_proj.launches += 1
    return dg_f, dg_b


bilstm_seq_bwd_dgates_proj.launches = 0  # kernel launches by this wrapper


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
    ``_bilstm_layer_fwd_impl`` (K10a, or the projection and K2), backward
    ``_bilstm_layer_bwd`` (K10b or K3, then plain products).  ``store``:
    a backward is recorded, so K2 keeps its recurrent sums for K3."""

    @staticmethod
    def forward(ctx, x, w_x, bias, w_h_f, w_h_b, lens, compute_dtype, store):
        cdt = COMPUTE_DTYPES[compute_dtype]
        whf, whb = w_h_f.to(cdt).contiguous(), w_h_b.to(cdt).contiguous()
        sums = []
        if use_in_kernel_proj(x.shape[-1], w_x.shape[1] // 2, cdt):
            # the projection inside the kernel: no [T, B, 8H] residual is
            # written, kept or read back (xp None, as in the reference)
            xp = None
            y_f, c_f, y_b, c_b = bilstm_seq_fwd_proj(
                x.to(cdt).contiguous(), w_x.to(cdt).contiguous(),
                bias.float().contiguous(), whf, whb, lens)
        else:
            xp = _project_bilstm(x, w_x.to(cdt), bias)
            y_f, c_f, y_b, c_b, *sums = bilstm_seq_fwd(
                xp, whf, whb, lens, cdt, store_sums=store)
        ctx.cdt = cdt
        ctx.save_for_backward(x, w_x, bias, w_h_f, w_h_b, lens, xp,
                              y_f, c_f, y_b, c_b, sums[0] if sums else None)
        return y_f, y_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        x, w_x, bias, w_h_f, w_h_b, lens, xp, y_f, c_f, y_b, c_b, sums = \
            ctx.saved_tensors
        cdt = ctx.cdt
        whf, whb = w_h_f.to(cdt).contiguous(), w_h_b.to(cdt).contiguous()
        if xp is None:
            dg_f, dg_b = bilstm_seq_bwd_dgates_proj(
                dy_f.contiguous(), dy_b.contiguous(), x.to(cdt).contiguous(),
                y_f, c_f, y_b, c_b, w_x.to(cdt).contiguous(),
                bias.float().contiguous(), whf, whb, lens)
        else:
            dg_f, dg_b = bilstm_seq_bwd_dgates(
                dy_f.contiguous(), dy_b.contiguous(), xp, y_f, c_f, y_b, c_b,
                whf, whb, lens, sums=sums)
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
        return dx, dw_x, dbias, dw_f, dw_b, None, None, None


def _records_backward(*tensors: torch.Tensor) -> bool:
    """Whether autograd records the op about to run on ``tensors`` for a
    backward: grad mode is on (not ``no_grad``, not ``inference_mode``)
    and one of them requires a gradient.  The bidirectional layers keep
    the forward's recurrent sums for the backward exactly then."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def bilstm_layer(x: torch.Tensor, w_x: torch.Tensor, bias: torch.Tensor,
                 w_h_f: torch.Tensor, w_h_b: torch.Tensor, lens: torch.Tensor,
                 compute_dtype: str = "float32"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full fused bidirectional LSTM layer → (y_f, y_b), each [T, B, H]
    in the compute dtype.  x [T, B, D]; w_x = [w_x_fwd | w_x_bwd]
    [D, 8H] and bias [8H] in master precision (f32); the cast to the
    compute dtype happens inside, as in JAX's custom VJP, so the weight
    gradients come back f32 and dx in x's dtype.  Where a backward is
    recorded (:func:`_records_backward`), K2 keeps its recurrent sums
    ([T, B, 8H] f32, saved beside xp, y and c) and K3 reads them; under
    ``no_grad`` or ``inference_mode`` nothing more is stored."""
    store = _records_backward(x, w_x, bias, w_h_f, w_h_b)
    return _BiLstmLayer.apply(x, w_x, bias, w_h_f, w_h_b, lens,
                              compute_dtype, store)


# ---------------------------------------------------------------------------
# One unidirectional LSTM direction: K5 (forward) and K6 (backward)
# ---------------------------------------------------------------------------


def _check_x_proj(what: str, x_proj: torch.Tensor, gates: int) -> int:
    """Raise unless x_proj is an f32 or bf16 [T, B, gates*H] → H."""
    if x_proj.dim() != 3 or x_proj.shape[2] % gates \
            or x_proj.dtype not in _SUFFIX:
        raise ValueError(f"{what}: x_proj must be f32 or bf16 "
                         f"[T, B, {gates}H], got {x_proj.dtype} "
                         f"{tuple(x_proj.shape)}")
    return x_proj.shape[2] // gates


def lstm_seq_fwd_reference(x_proj: torch.Tensor, w_h: torch.Tensor,
                           lens: torch.Tensor, reverse: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lstm_seq_fwd` on any device: a
    loop of T steps (``_fwd_kernel``)."""
    t_max, b, g4 = x_proj.shape
    h_dim = g4 // 4
    dev = x_proj.device
    valid = _valid(t_max, lens, dev)
    w = w_h.float()
    h = torch.zeros((b, h_dim), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    y = torch.empty((t_max, b, h_dim), dtype=x_proj.dtype, device=dev)
    cs = torch.empty((t_max, b, h_dim), dtype=torch.float32, device=dev)
    for t in (range(t_max - 1, -1, -1) if reverse else range(t_max)):
        v = valid[t]
        h_new, c_new = _lstm_cell(h, c, x_proj[t], w, w_h.dtype)
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
        y[t] = torch.where(v, h_new, 0.0).to(y.dtype)
        cs[t] = c
    return y, cs


def lstm_seq_fwd(x_proj: torch.Tensor, w_h: torch.Tensor, lens: torch.Tensor,
                 reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_proj [T, B, 4H] hoisted projection and w_h [H, 4H], both in the
    compute dtype, lens [B], reverse (walk t = T-1 .. 0) → (y [T, B, H] in
    the compute dtype, c_seq [T, B, H] f32).  The contract of
    ``rnn_pallas.lstm_seq_fwd``; its ``block_t`` is dropped: the time
    blocks exist only to move larger DMA blocks on the TPU, and one
    kernel covers both of its kernel bodies here.  On the card the route
    is :func:`fwd_chain_plan`'s, from the shapes: the forward chain in
    thread-block clusters (any B, one launch) where W_h fits a cluster,
    else the cooperative kernel in row slices."""
    if x_proj.device.type == "cpu":
        return lstm_seq_fwd_reference(x_proj, w_h, lens, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_seq_fwd: unsupported device {x_proj.device}")
    _check_x_proj("lstm_seq_fwd", x_proj, 4)
    t_max, b, g4 = x_proj.shape
    h = g4 // 4
    dev = x_proj.device
    _check_tensors("lstm_seq_fwd", dev, {
        "x_proj": (x_proj, x_proj.dtype, (t_max, b, g4)),
        "w_h": (w_h, x_proj.dtype, (h, g4))})
    _check_lens("lstm_seq_fwd", lens, b, dev)
    if t_max == 0 or b == 0:
        return (torch.empty((t_max, b, h), dtype=x_proj.dtype, device=dev),
                torch.empty((t_max, b, h), dtype=torch.float32, device=dev))
    lib = _kernels.load("lstm_fwd", _UNI_SIGNATURES)
    sfx = _SUFFIX[x_proj.dtype]
    plan = fwd_chain_plan(b, 0, h, x_proj.dtype, 1, _sm_count(dev),
                          _smem_optin(lib, "lstm_fwd_smem_optin", dev))
    lens32 = lens.to(torch.int32).contiguous()
    if plan.route == "cluster":
        # the forward chain in clusters: one launch for any B
        y = torch.empty((t_max, b, h), dtype=x_proj.dtype, device=dev)
        cs = torch.empty((t_max, b, h), dtype=torch.float32, device=dev)
        state = torch.zeros((2, 1, b, h), dtype=torch.float32, device=dev)
        err = getattr(lib, "lstm_fwd_chain_" + sfx)(
            x_proj.data_ptr(), w_h.data_ptr(), lens32.data_ptr(),
            y.data_ptr(), cs.data_ptr(), state.data_ptr(), t_max, b, h,
            plan.cluster, plan.rows, int(reverse), _kernels.stream_ptr(dev))
        _kernels.check(lib, err, f"lstm_seq_fwd at T={t_max}, B={b}, {plan}")
        lstm_seq_fwd.launches += 1
        return y, cs

    def launch(x_proj, lens32):
        n = x_proj.shape[1]
        y = torch.empty((t_max, n, h), dtype=x_proj.dtype, device=dev)
        cs = torch.empty((t_max, n, h), dtype=torch.float32, device=dev)
        # h exchange between blocks: [parity][B][H], parity 0 = h0
        hbuf = torch.zeros((2, n, h), dtype=torch.float32, device=dev)
        err = getattr(lib, "lstm_fwd_" + sfx)(
            x_proj.data_ptr(), w_h.data_ptr(), lens32.data_ptr(),
            y.data_ptr(), cs.data_ptr(), hbuf.data_ptr(), t_max, n, h,
            int(reverse), _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "lstm_seq_fwd")
        return y, cs

    # the cooperative route (W_h fits no cluster), in row slices
    out = run_in_row_slices(
        launch, max_rows(lib, "lstm_fwd_max_rows_" + sfx, dev, h), x_proj,
        lens32)
    lstm_seq_fwd.launches += 1
    return out


lstm_seq_fwd.launches = 0  # kernel launches made by this wrapper


def lstm_seq_bwd_dgates_reference(dy: torch.Tensor, x_proj: torch.Tensor,
                                  y: torch.Tensor, c_seq: torch.Tensor,
                                  w_h: torch.Tensor, lens: torch.Tensor,
                                  reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`lstm_seq_bwd_dgates` on any
    device: a loop of T steps in the opposite order of the forward
    (``_bwd_kernel`` with ``_dgates_update``)."""
    t_max, b, h_dim = dy.shape
    dev = x_proj.device
    valid = _valid(t_max, lens, dev)
    w = w_h.float()
    zeros = torch.zeros((b, h_dim), dtype=torch.float32, device=dev)
    dh, dc = zeros, zeros
    dg = torch.empty((t_max, b, 4 * h_dim), dtype=x_proj.dtype, device=dev)
    for s in range(t_max):
        t = s if reverse else t_max - 1 - s
        tp = t + 1 if reverse else t - 1
        first = s == t_max - 1        # the forward's first step
        hp = zeros if first else y[tp]
        cp = zeros if first else c_seq[tp]
        gates = x_proj[t].float() + torch.matmul(hp.to(w_h.dtype).float(), w)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        tanh_c = torch.tanh(c_seq[t])
        dh_total = dy[t].float() + dh
        dc_total = dc + dh_total * o * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_total * g * i * (1.0 - i),
                            dc_total * cp * f * (1.0 - f),
                            dc_total * i * (1.0 - g * g),
                            dh_total * tanh_c * o * (1.0 - o)], dim=-1)
        v = valid[t]
        dgates = torch.where(v, dgates, 0.0)
        dh = torch.where(v, torch.matmul(dgates.to(w_h.dtype).float(), w.T),
                         dh)
        dc = torch.where(v, dc_total * f, dc)
        dg[t] = dgates.to(x_proj.dtype)
    return dg


def lstm_seq_bwd_dgates(dy: torch.Tensor, x_proj: torch.Tensor,
                        y: torch.Tensor, c_seq: torch.Tensor,
                        w_h: torch.Tensor, lens: torch.Tensor,
                        reverse: bool = False) -> torch.Tensor:
    """Output cotangent dy [T, B, H] and the forward's residuals (x_proj
    [T, B, 4H], y [T, B, H] in the compute dtype, c_seq [T, B, H] f32,
    w_h [H, 4H] in the compute dtype, lens [B], the forward's direction)
    → dgates [T, B, 4H] in x_proj's dtype.  The contract of
    ``rnn_pallas._lstm_seq_bwd_dgates``.  On the card the route is
    :func:`k6_plan`'s, from the shapes: phase 1 (every step's recurrent
    sums at once) and the backward chain in thread-block clusters (any B,
    chunks of steps above a 256 MiB scratch) where W_h fits a cluster,
    else the cooperative kernel in row slices."""
    if x_proj.device.type == "cpu":
        return lstm_seq_bwd_dgates_reference(dy, x_proj, y, c_seq, w_h, lens,
                                             reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_seq_bwd_dgates: unsupported device "
                         f"{x_proj.device}")
    _check_x_proj("lstm_seq_bwd_dgates", x_proj, 4)
    t_max, b, g4 = x_proj.shape
    h = g4 // 4
    dev = x_proj.device
    cdt = x_proj.dtype
    _check_tensors("lstm_seq_bwd_dgates", dev, {
        "dy": (dy, cdt, (t_max, b, h)), "x_proj": (x_proj, cdt, (t_max, b, g4)),
        "y": (y, cdt, (t_max, b, h)),
        "c_seq": (c_seq, torch.float32, (t_max, b, h)),
        "w_h": (w_h, cdt, (h, g4))})
    _check_lens("lstm_seq_bwd_dgates", lens, b, dev)
    if t_max == 0 or b == 0:
        return torch.empty((t_max, b, g4), dtype=cdt, device=dev)
    lib = _kernels.load("lstm_bwd", _UNI_BWD_SIGNATURES)
    plan = k6_plan(lib, b, h, cdt, dev)
    lens32 = lens.to(torch.int32).contiguous()
    if plan.route == "cluster":
        dg = _lstm_bwd_chain(lib, dy, x_proj, y, c_seq, w_h, lens32, reverse,
                             plan)
    else:
        dg = _lstm_bwd_cooperative(lib, dy, x_proj, y, c_seq, w_h, lens32,
                                   reverse)
    lstm_seq_bwd_dgates.launches += 1
    return dg


def k6_plan(lib: ctypes.CDLL, b: int, h: int, dtype: torch.dtype,
            device) -> BwdChainPlan:
    """K6's route and launch shape on ``device``: :func:`bwd_chain_plan`
    with four gates and one direction."""
    return bwd_chain_plan(b, h, dtype, 1, _sm_count(device),
                          _smem_optin(lib, "lstm_bwd_smem_optin", device))


def _lstm_bwd_chain(lib: ctypes.CDLL, dy, x_proj, y, c_seq, w_h,
                    lens32: torch.Tensor, reverse: bool,
                    plan: BwdChainPlan) -> torch.Tensor:
    """K6's cluster route (``lstm_bwd_gates_*``, then
    ``lstm_bwd_chain_*``, per chunk of steps) on checked operands."""
    t_max, b, g4 = x_proj.shape
    h = g4 // 4
    dev = x_proj.device
    sfx = _SUFFIX[x_proj.dtype]
    stream = _kernels.stream_ptr(dev)
    dg = torch.empty((t_max, b, g4), dtype=x_proj.dtype, device=dev)
    # phase 1's scratch holds the steps of one chunk; phase 2 carries dh
    # and dc between chunks in `state`
    steps = _scratch_steps(t_max, b, g4)
    pre = torch.empty((steps, b, g4), dtype=torch.float32, device=dev)
    state = torch.zeros((2, 1, b, h), dtype=torch.float32, device=dev)
    what = f"lstm_seq_bwd_dgates at T={t_max}, B={b}, {plan}"
    for s0 in range(0, t_max, steps):
        n = min(steps, t_max - s0)
        err = getattr(lib, "lstm_bwd_gates_" + sfx)(
            y.data_ptr(), w_h.data_ptr(), pre.data_ptr(), s0, n, t_max, b, h,
            plan.gate_cols, int(reverse), stream)
        _kernels.check(lib, err, what + " phase 1")
        err = getattr(lib, "lstm_bwd_chain_" + sfx)(
            dy.data_ptr(), x_proj.data_ptr(), c_seq.data_ptr(),
            w_h.data_ptr(), lens32.data_ptr(), pre.data_ptr(), dg.data_ptr(),
            state.data_ptr(), s0, n, t_max, b, h, plan.cluster, plan.rows,
            int(reverse), stream)
        _kernels.check(lib, err, what + " phase 2")
    return dg


def _lstm_bwd_cooperative(lib: ctypes.CDLL, dy, x_proj, y, c_seq, w_h,
                          lens32: torch.Tensor, reverse: bool
                          ) -> torch.Tensor:
    """K6's cooperative route (``lstm_bwd_*``) on checked operands, in
    row slices under its ceiling."""
    t_max, _, g4 = x_proj.shape
    h = g4 // 4
    dev = x_proj.device
    sfx = _SUFFIX[x_proj.dtype]

    def launch(dy, x_proj, y, c_seq, lens32):
        n = x_proj.shape[1]
        dg = torch.empty((t_max, n, g4), dtype=x_proj.dtype, device=dev)
        floats = lib.lstm_bwd_exchange_floats(n, h)
        if floats < 0:
            raise RuntimeError(f"lstm_seq_bwd_dgates: no exchange size for "
                               f"B={n}, H={h} on {dev}")
        # partial-dh exchange between blocks; every entry read is written
        # in the step before
        part = torch.empty((floats,), dtype=torch.float32, device=dev)
        err = getattr(lib, "lstm_bwd_" + sfx)(
            dy.data_ptr(), x_proj.data_ptr(), y.data_ptr(), c_seq.data_ptr(),
            w_h.data_ptr(), lens32.data_ptr(), dg.data_ptr(), part.data_ptr(),
            t_max, n, h, int(reverse), _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "lstm_seq_bwd_dgates")
        return (dg,)

    dg, = run_in_row_slices(
        launch, max_rows(lib, "lstm_bwd_max_rows_" + sfx, dev, h), dy, x_proj,
        y, c_seq, lens32)
    return dg


lstm_seq_bwd_dgates.launches = 0  # kernel launches made by this wrapper


class _LstmSequence(torch.autograd.Function):
    """``lstm_sequence`` with the custom VJP of ``rnn_pallas``: forward
    ``_lstm_sequence_fwd`` (K5), backward ``_lstm_sequence_bwd`` (K6,
    then the sliced dW_h product)."""

    @staticmethod
    def forward(ctx, x_proj, w_h, lens, reverse):
        cdt = x_proj.dtype
        y, c_seq = lstm_seq_fwd(x_proj, w_h.to(cdt).contiguous(), lens,
                                reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(x_proj, w_h, lens, y, c_seq)
        return y

    @staticmethod
    def backward(ctx, dy):
        x_proj, w_h, lens, y, c_seq = ctx.saved_tensors
        cdt = x_proj.dtype
        dgates = lstm_seq_bwd_dgates(dy.to(cdt).contiguous(), x_proj, y,
                                     c_seq, w_h.to(cdt).contiguous(), lens,
                                     ctx.reverse)
        # one sliced product over all steps, emitted at the primal w_h's
        # dtype (f32 for master parameters)
        dw_h = _dw_h(y, dgates, ctx.reverse, cdt).to(w_h.dtype)
        return dgates, dw_h, None, None


def lstm_sequence(x_proj: torch.Tensor, w_h: torch.Tensor, lens: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """Differentiable LSTM over a sequence → y [T, B, H] in x_proj's
    (the compute) dtype.  w_h may arrive in master precision (f32): the
    cast to the compute dtype happens inside, so its gradient comes back
    f32; the x_proj gradient is the dgates, in the compute dtype."""
    return _LstmSequence.apply(x_proj, w_h, lens, reverse)


# ---------------------------------------------------------------------------
# The unidirectional stack as a wavefront: K7
# ---------------------------------------------------------------------------


def lstm_stack_fwd_reference(xp0: torch.Tensor, wxs, whs, bs,
                             lens: torch.Tensor,
                             h0: Optional[torch.Tensor] = None,
                             c0: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of :func:`lstm_stack_fwd` on any device:
    the layers one after the other, each a loop of T steps.  Layer l >= 1
    projects the layer below's output (held in the compute dtype) and
    stores the projection in the compute dtype, as the kernel does."""
    t_max, b, g4 = xp0.shape
    h_dim = g4 // 4
    n_layers = len(whs)
    cdt = xp0.dtype
    dev = xp0.device
    valid = _valid(t_max, lens, dev)
    zeros = torch.zeros((n_layers, b, h_dim), dtype=torch.float32, device=dev)
    h0 = zeros if h0 is None else h0
    c0 = zeros if c0 is None else c0
    xp, h_fin, c_fin = xp0, [], []
    for layer in range(n_layers):
        if layer > 0:
            xp = (matmul_f32acc(y.reshape(t_max * b, h_dim), wxs[layer - 1],
                                cdt)
                  + bs[layer - 1]).to(cdt).reshape(t_max, b, g4)
        w = whs[layer].float()
        h, c = h0[layer].float(), c0[layer].float()
        y = torch.empty((t_max, b, h_dim), dtype=cdt, device=dev)
        for t in range(t_max):
            v = valid[t]
            h_new, c_new = _lstm_cell(h, c, xp[t], w, cdt)
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            y[t] = torch.where(v, h_new, 0.0).to(cdt)
        h_fin.append(h)
        c_fin.append(c)
    return y, torch.stack(h_fin), torch.stack(c_fin)


class StackPlan(NamedTuple):
    """K7's route and launch shape.  ``route`` "cluster": the wavefront of
    per-layer clusters, "cooperative": the cooperative kernel.  The
    cluster route's shape, where it fits (else zeros): one cluster of
    ``cluster`` CTAs per (layer, ``rows`` batch rows), ``groups`` groups
    of L clusters a launch (0: any, a one-layer stack waits on nothing),
    ``chain_rows`` rows a launch (0: any B), ``chain_smem`` bytes a CTA.
    ``coop_rows``: the cooperative kernel's rows a launch (its
    ``lstm_stack_max_rows_*`` ceiling)."""
    route: str
    cluster: int
    rows: int
    groups: int
    chain_rows: int
    chain_smem: int
    coop_rows: int

    @property
    def launch_rows(self) -> int:
        """Rows one launch of the chosen route takes (0: any B)."""
        return self.chain_rows if self.route == "cluster" else self.coop_rows


def _stack_chain_bytes(n_layers: int, c: int, r: int, h: int,
                       itemsize: int) -> int:
    """Shared memory of a K7 cluster-route CTA for ``n_layers`` layers at
    cluster size ``c``, ``r`` rows per cluster, ``h`` units, W and h of
    ``itemsize`` bytes: ``stack_chain_bytes`` of csrc/lstm_stack.cu (W_h's
    and, above one layer, W_x's gate columns, two parities of h, the
    layer below's rows, the CTA's h slice, then f32 sums, c, h, layer 0's
    two prefetch buffers of xp0, the bias and the lengths)."""
    hsz = -(-h // c)
    m = 1 if n_layers > 1 else 0

    def a16(n):
        return -(-n // 16) * 16
    return ((1 + m) * a16(4 * hsz * h * itemsize) + a16(2 * r * h * itemsize)
            + m * a16(r * h * itemsize) + a16(r * hsz * itemsize)
            + 4 * r * hsz * 14 + 4 * m * 4 * hsz + 4 * r)


def stack_chain_plan(n_layers: int, b: int, h: int, dtype: torch.dtype,
                     sms: int, smem_optin: int,
                     clusters: Callable[[int, int], int],
                     coop_rows: int) -> StackPlan:
    """K7's route and launch shape for an ``n_layers`` stack of ``h`` units
    at a batch of ``b`` rows in ``dtype`` on a card of ``sms`` SMs with
    ``smem_optin`` bytes of shared memory per block.  ``clusters(c, r)``:
    the clusters of ``c`` CTAs at ``r`` rows the card holds at once (the
    kernel source's ``lstm_stack_chain_clusters_*``); ``coop_rows``: the
    cooperative kernel's ceiling (``lstm_stack_max_rows_*``).

    The cluster route: C is the smallest power of two whose share of W_h
    (and, above one layer, W_x) as f32 leaves half of a CTA's shared
    memory to the rows, as the forward chain's plan takes it (16 at H =
    320); it fits where one row fits beside that share in the compute
    dtype.  Above one layer each layer's cluster waits on
    the layer below, so a launch holds at most clusters(C, R_max) / L
    groups, co-resident: R_max rows a group (~42 in bf16, 5 in f32 at 5 x
    320).  A one-layer stack waits on nothing: R as the forward chain's
    (the clusters in one wave on three quarters of the SMs), any B.

    The route: the cluster route where it runs the batch in one launch,
    else the cooperative kernel where that runs it in one launch, else
    whichever fits, in row slices (the cluster route first).  Raises when
    neither fits."""
    if dtype not in _SUFFIX or not 1 <= n_layers <= _STACK_MAX_LAYERS:
        raise ValueError(f"K7: no kernel for {n_layers} layers in {dtype}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    m = 2 if n_layers > 1 else 1

    def size(c, r):
        return _stack_chain_bytes(n_layers, c, r, h, itemsize)

    c = next((c for c in _CLUSTERS
              if m * 16 * -(-h // c) * h <= smem_optin // 2),
             _CLUSTERS[-1])
    chain = None
    if size(c, 1) <= smem_optin:
        lo, hi = 1, 1 << 16                  # the most rows a cluster holds
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if size(c, mid) <= smem_optin else (lo, mid - 1)
        r_max = lo
        if n_layers == 1:
            per_wave = max(1, sms * 3 // 4 // c)
            r = max(1, min(b, -(-b // per_wave), r_max))
            chain = (c, r, 0, 0)
        else:
            k = clusters(c, r_max) // n_layers   # co-resident groups
            if k >= 1:
                n = min(b, k * r_max)            # this call's rows a launch
                groups = min(k, n)
                chain = (c, -(-n // groups), groups, k * r_max)
    if chain is not None and (chain[3] == 0 or b <= chain[3]):
        route = "cluster"
    elif coop_rows >= b:
        route = "cooperative"
    elif chain is not None:
        route = "cluster"
    elif coop_rows >= 1:
        route = "cooperative"
    else:
        raise ValueError(f"K7: neither route fits L={n_layers}, H={h} in "
                         f"{dtype} in {smem_optin} bytes of shared memory")
    if chain is None:
        return StackPlan(route, 0, 0, 0, 0, 0, coop_rows)
    c, r, groups, rows = chain
    return StackPlan(route, c, r, groups, rows, size(c, r), coop_rows)


# K7's plans already made: (layers, B, H, dtype, device) → StackPlan
_STACK_PLANS: Dict[tuple, StackPlan] = {}


def k7_plan(lib: ctypes.CDLL, n_layers: int, b: int, h: int,
            dtype: torch.dtype, device) -> StackPlan:
    """K7's route and launch shape on ``device``: :func:`stack_chain_plan`
    with the card's SMs, shared memory, co-resident clusters and the
    cooperative kernel's ceiling, from the kernel source's queries.
    Cached per shape and device: the streaming server asks every tick."""
    key = (n_layers, b, h, dtype, device)
    plan = _STACK_PLANS.get(key)
    if plan is None:
        sfx = _SUFFIX[dtype]

        def clusters(c, r):
            return _ceiling(lib, "lstm_stack_chain_clusters_" + sfx, device,
                            n_layers, h, c, r)

        plan = stack_chain_plan(
            n_layers, b, h, dtype, _sm_count(device),
            _smem_optin(lib, "lstm_stack_smem_optin", device), clusters,
            _ceiling(lib, "lstm_stack_max_rows_" + sfx, device, n_layers,
                     h))
        _STACK_PLANS[key] = plan
    return plan


def lstm_stack_fits(num_layers: int, batch: int, hidden: int,
                    dtype: torch.dtype, device) -> bool:
    """Whether K7 runs an L-layer stack of ``hidden`` units at ``batch``
    rows on ``device`` in one launch: :func:`k7_plan`'s route takes that
    many rows (the cluster route's shared memory and the co-residency of
    its L clusters, or the cooperative kernel's ceiling).  Decided from
    the shapes alone; nothing is launched."""
    if not 1 <= num_layers <= _STACK_MAX_LAYERS:
        return False
    lib = _kernels.load("lstm_stack", _STACK_SIGNATURES)
    try:
        plan = k7_plan(lib, num_layers, batch, hidden, dtype, device)
    except ValueError:
        return False
    return plan.launch_rows == 0 or batch <= plan.launch_rows


def lstm_stack_fwd(xp0: torch.Tensor, wxs, whs, bs, lens: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wavefront forward through an L-layer unidirectional LSTM stack,
    the contract of ``rnn_pallas.lstm_stack_fwd``: xp0 [T, B, 4H] layer
    0's projection in the compute dtype; wxs the L-1 input weights and
    whs the L recurrent weights [H, 4H] in the compute dtype (lists, or
    [L-1, H, 4H] / [L, H, 4H] tensors); bs the L-1 biases [4H] f32; lens
    [B]; h0, c0 optional [L, B, H] f32 carries → (y [T, B, H] of the top
    layer in the compute dtype, h_fin, c_fin [L, B, H] f32).  Inference
    only.  On the card the route is :func:`k7_plan`'s, from the shapes:
    the wavefront of per-layer clusters, or the cooperative kernel, each
    in row slices above its ceiling."""
    if xp0.device.type == "cpu":
        return lstm_stack_fwd_reference(xp0, wxs, whs, bs, lens, h0, c0)
    if xp0.device.type != "cuda":
        raise ValueError(f"lstm_stack_fwd: unsupported device {xp0.device}")
    _check_x_proj("lstm_stack_fwd", xp0, 4)
    t_max, b, g4 = xp0.shape
    h = g4 // 4
    n_layers = len(whs)
    dev = xp0.device
    cdt = xp0.dtype
    if not 1 <= n_layers <= _STACK_MAX_LAYERS or len(wxs) != n_layers - 1 \
            or len(bs) != n_layers - 1:
        raise ValueError(f"lstm_stack_fwd: {n_layers} recurrent weights "
                         f"(1..{_STACK_MAX_LAYERS}) need one fewer input "
                         f"weights and biases, got {len(wxs)} and {len(bs)}")
    want = {"xp0": (xp0, cdt, (t_max, b, g4))}
    for name, ws, dtype, shape in (("whs", whs, cdt, (h, g4)),
                                   ("wxs", wxs, cdt, (h, g4)),
                                   ("bs", bs, torch.float32, (g4,))):
        want.update({f"{name}[{i}]": (w, dtype, shape)
                     for i, w in enumerate(ws)})
    for name, v in (("h0", h0), ("c0", c0)):
        if v is not None:
            want[name] = (v, torch.float32, (n_layers, b, h))
    _check_tensors("lstm_stack_fwd", dev, want)
    _check_lens("lstm_stack_fwd", lens, b, dev)
    if t_max == 0 or b == 0:
        zeros = torch.zeros((n_layers, b, h), dtype=torch.float32, device=dev)
        return (torch.empty((t_max, b, h), dtype=cdt, device=dev),
                (zeros if h0 is None else h0).clone(),
                (zeros if c0 is None else c0).clone())
    lib = _kernels.load("lstm_stack", _STACK_SIGNATURES)
    plan = k7_plan(lib, n_layers, b, h, cdt, dev)
    ops = (xp0, wxs, whs, bs, lens.to(torch.int32).contiguous(), h0, c0)
    if plan.route == "cluster":
        out = _lstm_stack_chain(lib, *ops, plan)
    else:
        out = _lstm_stack_cooperative(lib, *ops)
    lstm_stack_fwd.launches += 1
    return out


def _stack_ptrs(*weight_lists):
    """Host arrays of device pointers, one per list of tensors."""
    return [ctypes.cast((_P * max(len(ws), 1))(*[w.data_ptr() for w in ws]),
                        _P) for ws in weight_lists]


def _stack_outputs(t_max: int, n_layers: int, n: int, h: int, cdt, dev):
    """y [T, n, H] in the compute dtype, h_fin and c_fin [L, n, H] f32."""
    h_fin = torch.empty((n_layers, n, h), dtype=torch.float32, device=dev)
    return (torch.empty((t_max, n, h), dtype=cdt, device=dev), h_fin,
            torch.empty_like(h_fin))


def _lstm_stack_chain(lib: ctypes.CDLL, xp0, wxs, whs, bs,
                      lens32: torch.Tensor, h0, c0, plan: StackPlan):
    """K7's cluster route (``lstm_stack_chain_*``) on checked operands, in
    row slices of ``plan.chain_rows`` (0: one launch)."""
    t_max, b, g4 = xp0.shape
    h = g4 // 4
    n_layers = len(whs)
    dev, cdt = xp0.device, xp0.dtype
    ptrs = _stack_ptrs(whs, wxs, bs)

    def launch(xp0, lens32, h0, c0):
        n = xp0.shape[1]
        zeros = None
        if h0 is None or c0 is None:
            zeros = torch.zeros((n_layers, n, h), dtype=torch.float32,
                                device=dev)
        h_in = zeros if h0 is None else h0
        c_in = zeros if c0 is None else c0
        y, h_fin, c_fin = _stack_outputs(t_max, n_layers, n, h, cdt, dev)
        ybuf = flags = None
        if n_layers > 1:
            # the outputs of the layers below the top, and the hand-off
            # flag of each of their CTAs, zero before the launch
            ybuf = torch.empty((n_layers - 1, t_max, n, h), dtype=cdt,
                               device=dev)
            flags = torch.zeros((n_layers - 1, -(-n // plan.rows),
                                 plan.cluster), dtype=torch.int32, device=dev)
        err = getattr(lib, "lstm_stack_chain_" + _SUFFIX[cdt])(
            xp0.data_ptr(), *ptrs, lens32.data_ptr(), h_in.data_ptr(),
            c_in.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
            c_fin.data_ptr(), *(None if v is None else v.data_ptr()
                                for v in (ybuf, flags)),
            t_max, n_layers, n, h, plan.cluster, plan.rows,
            _kernels.stream_ptr(dev))
        _kernels.check(lib, err, f"lstm_stack_fwd at L={n_layers}, "
                                 f"T={t_max}, B={n}, {plan}")
        return y, h_fin, c_fin

    return run_in_row_slices(launch, plan.chain_rows or b, xp0, lens32, h0,
                             c0)


def _lstm_stack_cooperative(lib: ctypes.CDLL, xp0, wxs, whs, bs,
                            lens32: torch.Tensor, h0, c0):
    """K7's cooperative route (``lstm_stack_*``) on checked operands, in
    row slices under its ceiling."""
    t_max, _, g4 = xp0.shape
    h = g4 // 4
    n_layers = len(whs)
    dev, cdt = xp0.device, xp0.dtype
    sfx = _SUFFIX[cdt]
    ptrs = _stack_ptrs(whs, wxs, bs)

    def launch(xp0, lens32, h0, c0):
        n = xp0.shape[1]
        # h exchange [parity][L][B][H], parity 0 = h0; the layer-output
        # exchange has the same shape, and every entry read is written
        # in the step before
        hbuf = torch.empty((2, n_layers, n, h), dtype=torch.float32,
                           device=dev)
        if h0 is None:
            hbuf[0].zero_()
        else:
            hbuf[0].copy_(h0)
        c_in = (torch.zeros((n_layers, n, h), dtype=torch.float32,
                            device=dev) if c0 is None else c0)
        y, h_fin, c_fin = _stack_outputs(t_max, n_layers, n, h, cdt, dev)
        ybuf = torch.empty_like(hbuf)
        err = getattr(lib, "lstm_stack_" + sfx)(
            xp0.data_ptr(), *ptrs, lens32.data_ptr(), c_in.data_ptr(),
            y.data_ptr(), h_fin.data_ptr(), c_fin.data_ptr(),
            hbuf.data_ptr(), ybuf.data_ptr(), t_max, n_layers, n, h,
            _kernels.stream_ptr(dev))
        _kernels.check(lib, err, "lstm_stack_fwd")
        return y, h_fin, c_fin

    return run_in_row_slices(
        launch, max_rows(lib, "lstm_stack_max_rows_" + sfx, dev, n_layers, h),
        xp0, lens32, h0, c0)


lstm_stack_fwd.launches = 0  # kernel launches made by this wrapper

# every snapshot of the span registry reads these counters where they are
profiling.register_launch_counters(
    bilstm_seq_fwd, bilstm_seq_bwd_dgates, bilstm_seq_fwd_proj,
    bilstm_seq_bwd_dgates_proj, lstm_seq_fwd, lstm_seq_bwd_dgates,
    lstm_stack_fwd)
