"""Multi-layer (B)LSTM/GRU/ReLU/Tanh recurrent stacks on PyTorch.

Counterpart of ``kaldi_ctc_tpu/ops/rnn.py``: the same modes (RELU 0,
TANH 1, LSTM 2, GRU 3, the reference's rnn-mode integers), multi-layer,
uni- or bidirectional, with the same parameter tree
``params[layer]["dirs"][d]{"w_x", "w_h", "b"}`` and the same numerics:

- the input projection ``x @ W_x + b`` for all frames is hoisted out of
  the recurrence into one matmul; operands in the compute dtype, f32
  accumulation, the result stored in the compute dtype;
- the recurrent product takes h rounded to the compute dtype and
  accumulates in f32; gate math and the LSTM cell state stay f32;
- ``input_lens`` masks the recurrence: state carries across pad frames
  and outputs there are zero.

"Compute-dtype operands, f32 accumulation" is written as an f32 matmul
of operands rounded to the compute dtype: a product of two bf16 values
is exact in f32, so only the order of the f32 sum differs from a bf16
tensor-core product, on the CPU and on the card alike.

A bidirectional LSTM or GRU layer goes through :func:`_run_birnn_fused`
→ ``rnn_cuda.bilstm_layer`` or ``gru_cuda.bigru_layer`` (K8a, K8b).  The
BLSTM layer picks its route by ``rnn_cuda.use_in_kernel_proj``, the JAX
package's rule: in f32 a layer whose input width and 4H are multiples of
128 and whose weights are at most 8 MiB (the 3x128 BLSTM's layers 2-3)
runs K10a forward and K10b backward, the projection inside the kernels;
every other layer the hoisted projection, K2 and K3.  A unidirectional
LSTM direction goes through ``rnn_cuda.lstm_sequence`` (K5 forward, K6
backward), a GRU direction through ``gru_cuda.gru_sequence`` (K9a, K9b).
On the CPU each kernel's plain version runs.  ReLU and Tanh run the
plain per-step loop on every device (the JAX package has no kernel for
them).

:func:`rnn_forward_stream` is the chunked forward with carried state of
a unidirectional stack (online recognition); on CUDA an LSTM stack runs
the wavefront kernel K7, and the other modes run the per-layer loop in
torch ops, as the JAX package runs its XLA scan for them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["RnnMode", "RnnConfig", "COMPUTE_DTYPES", "init_rnn_params",
           "rnn_param_shapes", "rnn_forward", "matmul_f32acc",
           "init_stream_state", "rnn_forward_stream"]


class RnnMode(enum.IntEnum):
    """Matches the reference's rnn-mode config integers."""

    RELU = 0
    TANH = 1
    LSTM = 2
    GRU = 3


_GATES = {RnnMode.RELU: 1, RnnMode.TANH: 1, RnnMode.LSTM: 4, RnnMode.GRU: 3}

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RnnConfig:
    """Mirror of CuDNNRecurrentComponent's config surface
    (nnet-cudnn-component.cc:72-98,488-491)."""

    input_dim: int
    hidden_dim: int
    num_layers: int = 1
    mode: RnnMode = RnnMode.LSTM
    bidirectional: bool = True  # reference default (nnet-cudnn-component.cc:488)
    param_stddev: float = 0.02
    bias_stddev: float = 0.2
    # matmul compute dtype: "float32" or "bfloat16" (mixed precision —
    # params/state stay f32, matmul operands cast, f32 accumulation)
    compute_dtype: str = "float32"
    # deepspeech.pytorch's BatchRNN: a bidirectional layer's two
    # directions summed (H wide, not concatenated), and a batch norm of
    # every layer's input but the first's (its SequenceWise BatchNorm1d;
    # leaves norm_g and norm_b in the layer)
    batch_rnn: bool = False

    @property
    def num_directions(self) -> int:
        return 2 if self.bidirectional else 1

    @property
    def output_dim(self) -> int:
        return self.hidden_dim * (1 if self.batch_rnn
                                  else self.num_directions)

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]

    def layer_input_dim(self, layer: int) -> int:
        return self.input_dim if layer == 0 else self.output_dim


def rnn_param_shapes(cfg: RnnConfig) -> List[Dict[str, Any]]:
    """The parameter tree with shapes (``torch.Size``) as leaves:
    params[layer]["dirs"][d] = {"w_x": [D_in, G*H], "w_h": [H, G*H],
    "b": [G*H]}; with ``batch_rnn`` layers 2.. also hold "norm_g" and
    "norm_b" [D_in]."""
    gh = _GATES[cfg.mode] * cfg.hidden_dim
    out = []
    for layer in range(cfg.num_layers):
        d_in = cfg.layer_input_dim(layer)
        shapes: Dict[str, Any] = {
            "dirs": [{"w_x": torch.Size((d_in, gh)),
                      "w_h": torch.Size((cfg.hidden_dim, gh)),
                      "b": torch.Size((gh,))}
                     for _ in range(cfg.num_directions)]}
        if layer and cfg.batch_rnn:
            shapes["norm_g"] = shapes["norm_b"] = torch.Size((d_in,))
        out.append(shapes)
    return out


def init_rnn_params(cfg: RnnConfig,
                    generator: Optional[torch.Generator] = None,
                    device="cpu") -> List[Dict[str, Any]]:
    """Gaussian init (nnet-cudnn-component.cc:327-360): weights with
    param_stddev, biases with bias_stddev, drawn from ``generator`` on
    the CPU and moved to ``device``."""
    def draw(shape, std):
        return (std * torch.randn(shape, generator=generator,
                                  dtype=torch.float32)).to(device)

    out = []
    for layer in rnn_param_shapes(cfg):
        params: Dict[str, Any] = {
            "dirs": [{"w_x": draw(d["w_x"], cfg.param_stddev),
                      "w_h": draw(d["w_h"], cfg.param_stddev),
                      "b": draw(d["b"], cfg.bias_stddev)}
                     for d in layer["dirs"]]}
        if "norm_g" in layer:
            params["norm_g"] = torch.ones(layer["norm_g"], device=device)
            params["norm_b"] = torch.zeros(layer["norm_b"], device=device)
        out.append(params)
    return out


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor,
                  cdt: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to ``cdt`` and an f32 result."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


def _lstm_cell(h, c, x_proj, w_h, cdt):
    """One LSTM step; w_h is f32 holding compute-dtype values."""
    gates = x_proj.float() + torch.matmul(h.to(cdt).float(), w_h)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _gru_gates(x_proj, h, w_h, cdt):
    """Activated (r, z, n, hn) of the cuDNN linear-before-reset GRU from
    the stored projection and the previous output (``_gru_gates`` of
    ``gru_pallas``): the recurrent projection computed once, the reset
    gate applied to the candidate's recurrent term; w_h is f32 holding
    compute-dtype values.  The forward cell and the backward recompute
    both call it."""
    h_proj = torch.matmul(h.to(cdt).float(), w_h)
    xr, xz, xn = x_proj.float().chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    return r, z, torch.tanh(xn + r * hn), hn


def _gru_cell(h, x_proj, w_h, cdt):
    r, z, n, _ = _gru_gates(x_proj, h, w_h, cdt)
    return (1.0 - z) * n + z * h


def _scan(x_proj: torch.Tensor, valid: torch.Tensor, w_h: torch.Tensor,
          cfg: RnnConfig, state, reverse: bool = False):
    """The plain per-step loop of one direction from ``state`` ((h, c) for
    an LSTM, h otherwise, f32 [B, H]) → (ys [T, B, H] in the compute
    dtype, final state).  Frames where ``valid`` [T, B, 1] is false carry
    the state and output zero.  w_h in master precision."""
    cdt = cfg.dtype
    w_h = w_h.to(cdt).float()
    h, c = state if cfg.mode == RnnMode.LSTM else (state, None)
    ys = [None] * x_proj.shape[0]
    for t in (range(x_proj.shape[0] - 1, -1, -1) if reverse
              else range(x_proj.shape[0])):
        v = valid[t]
        if cfg.mode == RnnMode.LSTM:
            h_new, c_new = _lstm_cell(h, c, x_proj[t], w_h, cdt)
            c = torch.where(v, c_new, c)
        elif cfg.mode == RnnMode.GRU:
            h_new = _gru_cell(h, x_proj[t], w_h, cdt)
        else:
            act = torch.relu if cfg.mode == RnnMode.RELU else torch.tanh
            h_new = act(x_proj[t].float()
                        + torch.matmul(h.to(cdt).float(), w_h))
        h = torch.where(v, h_new, h)
        ys[t] = torch.where(v, h_new, 0.0)
    out = (torch.stack(ys).to(cdt) if ys       # output in the compute dtype
           else x_proj.new_zeros((0,) + h.shape, dtype=cdt))
    return out, ((h, c) if cfg.mode == RnnMode.LSTM else h)


def _project(x: torch.Tensor, p: Dict[str, Any], cdt) -> torch.Tensor:
    """The hoisted input projection [T, B, D] → [T, B, G*H]: f32
    accumulation plus bias, stored in the compute dtype."""
    t_max, b, _ = x.shape
    return (matmul_f32acc(x.reshape(t_max * b, -1), p["w_x"], cdt)
            + p["b"]).to(cdt).reshape(t_max, b, -1)


def _valid(t_max: int, lens: torch.Tensor, device) -> torch.Tensor:
    return (torch.arange(t_max, device=device)[:, None]
            < lens.to(device)[None, :])[..., None]             # [T, B, 1]


def _run_direction(
    x: torch.Tensor,               # [T, B, D_in]
    lens: Optional[torch.Tensor],  # [B] or None
    p: Dict[str, Any],
    cfg: RnnConfig,
    reverse: bool,
) -> torch.Tensor:
    """One direction → [T, B, H] in the compute dtype (``_run_direction``
    of the JAX package).  An LSTM goes through ``rnn_cuda.lstm_sequence``
    and a GRU through ``gru_cuda.gru_sequence`` on every device, the JAX
    package's TPU route: K5 / K9a forward and K6 / K9b backward on CUDA,
    their plain versions on the CPU.  ReLU and Tanh run the plain
    per-step loop."""
    t_max, b, _ = x.shape
    x_proj = _project(x, p, cfg.dtype)
    if lens is None:
        lens = torch.full((b,), t_max, dtype=torch.int32, device=x.device)
    lens = lens.to(x.device)
    if cfg.mode == RnnMode.LSTM:
        from kaldi_ctc_tpu_torch.ops.rnn_cuda import lstm_sequence
        return lstm_sequence(x_proj, p["w_h"], lens, reverse)
    if cfg.mode == RnnMode.GRU:
        from kaldi_ctc_tpu_torch.ops.gru_cuda import gru_sequence
        return gru_sequence(x_proj, p["w_h"], lens, reverse)
    h = torch.zeros((b, cfg.hidden_dim), dtype=torch.float32, device=x.device)
    return _scan(x_proj, _valid(t_max, lens, x.device), p["w_h"], cfg, h,
                 reverse)[0]


def rnn_forward(
    params: List[Dict[str, Any]],
    x: torch.Tensor,
    cfg: RnnConfig,
    input_lens: Optional[torch.Tensor] = None,
    norm: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """Run the full stack. x: [T, B, input_dim] → [T, B, output_dim] in
    the compute dtype.  ``norm(x, g, b)`` normalises the input of each
    layer that holds ``norm_g`` and ``norm_b`` (``batch_rnn``; the
    acoustic model's batch norm over the valid frames)."""
    out = x
    for layer_params in params:
        if "norm_g" in layer_params:
            if norm is None:
                raise ValueError("rnn_forward: a layer with an input norm "
                                 "needs `norm`")
            out = norm(out, layer_params["norm_g"], layer_params["norm_b"])
        dirs = layer_params["dirs"]
        if cfg.bidirectional and cfg.mode in (RnnMode.LSTM, RnnMode.GRU):
            out = _run_birnn_fused(out, input_lens, dirs, cfg)
            continue
        fwd = _run_direction(out, input_lens, dirs[0], cfg, reverse=False)
        if cfg.bidirectional:
            bwd = _run_direction(out, input_lens, dirs[1], cfg, reverse=True)
            out = _merge(fwd, bwd, cfg)
        else:
            out = fwd
    return out


def _merge(fwd: torch.Tensor, bwd: torch.Tensor, cfg: RnnConfig
           ) -> torch.Tensor:
    """A bidirectional layer's output: the directions concatenated, or
    summed (``batch_rnn``)."""
    return fwd + bwd if cfg.batch_rnn else torch.cat([fwd, bwd], dim=-1)


def _run_birnn_fused(x, input_lens, dirs, cfg: RnnConfig) -> torch.Tensor:
    """Both B(LSTM|GRU) directions through one fused layer: the two
    input weights merged into one [D, 2*G*H] matrix, then one pass of K2
    after the hoisted projection, of K10a with the projection inside it
    (chosen inside ``bilstm_layer`` by ``use_in_kernel_proj``, as JAX
    chooses inside its layer), or of K8a."""
    if cfg.mode == RnnMode.LSTM:
        from kaldi_ctc_tpu_torch.ops.rnn_cuda import bilstm_layer as bi_layer
    else:
        from kaldi_ctc_tpu_torch.ops.gru_cuda import bigru_layer as bi_layer
    t_max, b, _ = x.shape
    lens = (input_lens if input_lens is not None
            else torch.full((b,), t_max, dtype=torch.int32, device=x.device))
    w_x = torch.cat([dirs[0]["w_x"], dirs[1]["w_x"]], dim=1)
    bias = torch.cat([dirs[0]["b"], dirs[1]["b"]])
    y_f, y_b = bi_layer(x, w_x, bias, dirs[0]["w_h"], dirs[1]["w_h"], lens,
                        cfg.compute_dtype)
    return _merge(y_f, y_b, cfg)


# ---------------------------------------------------------------------------
# Streaming (state-carrying) forward: unidirectional stacks only
# ---------------------------------------------------------------------------

def init_stream_state(cfg: RnnConfig, batch: int, device="cpu") -> List[Any]:
    """Zero carry state per layer, f32 [B, H] on ``device``: (h, c) for
    an LSTM, h otherwise."""
    if cfg.bidirectional:
        raise ValueError("streaming requires a unidirectional stack")
    if cfg.batch_rnn:
        raise ValueError("streaming takes no batch norm")
    states: List[Any] = []
    for _ in range(cfg.num_layers):
        h = torch.zeros((batch, cfg.hidden_dim), dtype=torch.float32,
                        device=device)
        states.append((h, torch.zeros_like(h)) if cfg.mode == RnnMode.LSTM
                      else h)
    return states


def rnn_forward_stream(
    params: List[Dict[str, Any]],
    x: torch.Tensor,                       # [T, B, input_dim] (one chunk)
    cfg: RnnConfig,
    states: List[Any],
    lens: Optional[torch.Tensor] = None,   # [B] valid frames this chunk
) -> tuple:
    """Chunked forward with explicit carry: feeding chunks with the
    carried state equals one full-utterance forward.  Frames >= lens[b]
    neither update stream b's state nor produce output (an idle slot has
    lens 0).  → (y [T, B, H] in the compute dtype, new states).

    On CUDA an LSTM stack runs kernel K7, all L layers as one wavefront,
    whenever ``rnn_cuda.lstm_stack_fits`` holds for its shapes (the
    port's residency rule, ``rnn_cuda.k7_plan``: the cluster route where
    each layer's weights fit one cluster's shared memory and the L
    clusters of the batch are co-resident, else the cooperative kernel
    where its grid is; the JAX package's 10 MB VMEM budget and its L > 1
    condition are TPU limits and do not apply).  A stack that does not fit takes the per-layer path, as the
    JAX package's scan branch does, with each layer a one-layer K7
    launch.  Other modes, and the CPU, run the per-layer loop in torch
    ops: for a GRU, ReLU or Tanh stack that is the JAX package's own
    route on every device, an XLA scan with no kernel."""
    if cfg.bidirectional:
        raise ValueError("streaming requires a unidirectional stack")
    t_max, b, _ = x.shape
    if lens is None:
        lens = torch.full((b,), t_max, dtype=torch.int32, device=x.device)
    lens = lens.to(x.device)
    if x.device.type == "cuda" and cfg.mode == RnnMode.LSTM:
        return _stream_lstm_stack(params, x, cfg, states, lens)
    valid = _valid(t_max, lens, x.device)
    out, new_states = x, []
    for layer_params, st in zip(params, states):
        p = layer_params["dirs"][0]
        out, st = _scan(_project(out, p, cfg.dtype), valid, p["w_h"], cfg, st)
        new_states.append(st)
    return out, new_states


def _stream_lstm_stack(params, x, cfg: RnnConfig, states, lens) -> tuple:
    """An LSTM stack's chunk through K7: the whole stack in one launch
    when it fits, else one one-layer launch per layer."""
    from kaldi_ctc_tpu_torch.ops.rnn_cuda import lstm_stack_fits, lstm_stack_fwd

    cdt = cfg.dtype
    dirs = [layer["dirs"][0] for layer in params]
    n_layers, b = len(dirs), x.shape[1]
    if lstm_stack_fits(n_layers, b, cfg.hidden_dim, cdt, x.device):
        y, h_fin, c_fin = lstm_stack_fwd(
            _project(x, dirs[0], cdt),
            [d["w_x"].to(cdt) for d in dirs[1:]],
            [d["w_h"].to(cdt) for d in dirs], [d["b"] for d in dirs[1:]],
            lens, torch.stack([h for h, _ in states]),
            torch.stack([c for _, c in states]))
        return y, [(h_fin[i], c_fin[i]) for i in range(n_layers)]
    out, new_states = x, []
    for d, (h, c) in zip(dirs, states):
        out, h_fin, c_fin = lstm_stack_fwd(
            _project(out, d, cdt), [], [d["w_h"].to(cdt)], [], lens,
            h[None].contiguous(), c[None].contiguous())
        new_states.append((h_fin[0], c_fin[0]))
    return out, new_states
