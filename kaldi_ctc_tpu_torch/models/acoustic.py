"""The CTC acoustic model: recurrent stack + output projection + priors.

Counterpart of ``kaldi_ctc_tpu/models/acoustic.py``: the 'google'
family (make_configs.py:237-365: stacked recurrent layers → affine to
num_targets), with its input splicing, the 'FT' front layer, the 'DS2'
conv front end and dropout after the stack.  Output index 0 is the
blank; priors default to ones with prior[blank]=9
(nnet2-ctc-init-model.cc:64-67).

Parameters are the JAX package's tree with torch tensors as leaves, so
``params.from_jax_params`` carries JAX parameters across unchanged; the
conv weights stay HWIO [time, freq, in, out] in the tree and are
permuted to torch's OIHW only at the call.  The convs are
``F.conv2d`` (the JAX package computes them outside any Pallas kernel,
with ``lax.conv_general_dilated``), always in f32, with TF32 off.

Beyond the JAX package (its defaults leave every model as it was):
DeepSpeech2 as deepspeech.pytorch builds it (``model.py``), all of it
under one switch, ``conv_norm`` "batch": the conv front's BatchNorm2d and
Hardtanh(0, 20), the directions of each bidirectional layer summed and a
batch norm before every recurrent layer but the first (its BatchRNN,
``RnnConfig.batch_rnn``), and a batch norm before a bias-free output
affine.  A batch norm
normalises by the batch's statistics over the valid frames alone in
training (deepspeech.pytorch counts the pad frames too, so there a
batch's result depends on its padding) and by running statistics in
eval; those are held beside the parameters, not among them
(:func:`init_norm_stats`, ``TrainState.stats``, checkpoints and model
files).  Its conv map is flattened f*C + c like the JAX package's, where
deepspeech.pytorch flattens c*F + f: a permutation of the first layer's
W_x rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import torch.nn.functional as F

from kaldi_ctc_tpu_torch.ops.rnn import (RnnConfig, RnnMode, init_rnn_params,
                                         matmul_f32acc, rnn_forward,
                                         rnn_param_shapes)

__all__ = ["AmConfig", "init_am_params", "am_forward", "am_param_shapes",
           "default_priors", "grow_rnn_layer", "front_layer",
           "init_norm_stats", "BN_MOMENTUM", "BN_EPS"]

FRONT_NONLINS = ("relu", "tanh", "sigmoid", "pnorm", "maxout")
# the batch norms' running-statistics momentum and epsilon (PyTorch's)
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


@dataclasses.dataclass(frozen=True)
class AmConfig:
    """Model config; field for field the JAX package's AmConfig."""

    input_dim: int
    num_targets: int  # pdfs + 1 blank; blank = index 0
    hidden_dim: int = 320
    num_layers: int = 5
    mode: RnnMode = RnnMode.LSTM
    bidirectional: bool = True
    param_stddev: float = 0.02
    bias_stddev: float = 0.2
    dropout: float = 0.0
    # matmul compute dtype: "float32" or "bfloat16" (mixed precision)
    compute_dtype: str = "float32"
    # input splicing (SpliceComponent): frames [-left .. +right]
    # concatenated per step, clamped at each utterance's own last frame
    splice_left: int = 0
    splice_right: int = 0
    # the 'FT' front layer (make_configs.py:269-279): Affine of this width
    # + nonlinearity + RMS renormalize before the stack; 0 = 'google'
    front_affine_dim: int = 0
    # relu | tanh | sigmoid | pnorm (p=2 over front_group-sized groups) |
    # maxout (max over them)
    front_nonlin: str = "relu"
    front_group: int = 1
    # the 'DS2' conv front end: kernels (11,41), (11,21), (11,21), freq
    # stride 2 a layer, time stride conv_time_stride on the first layer,
    # "seq" normalization (moments per utterance and channel over its
    # valid frames) or "none", leaky clipped ReLU(20); or "batch",
    # deepspeech.pytorch's DS2 (``deepspeech``): a batch norm then
    # Hardtanh(0, 20) in the front, its BatchRNN stack and a batch norm
    # before the output affine, which has no bias
    conv_layers: int = 0
    conv_channels: int = 32
    conv_time_stride: int = 2
    conv_norm: str = "seq"

    # (time_kernel, freq_kernel, time_stride, freq_stride) per conv layer
    _DS2_SPECS = ((11, 41, None, 2), (11, 21, 1, 2), (11, 21, 1, 2))

    def conv_specs(self):
        if self.conv_layers > len(self._DS2_SPECS):
            raise ValueError(f"at most {len(self._DS2_SPECS)} conv layers")
        out = []
        for i in range(self.conv_layers):
            tk, fk, ts, fs = self._DS2_SPECS[i]
            out.append((tk, fk, self.conv_time_stride if ts is None else ts,
                        fs))
        return out

    @property
    def time_stride(self) -> int:
        """Output frames per input frame denominator (1 without convs)."""
        s = 1
        for _tk, _fk, ts, _fs in self.conv_specs():
            s *= ts
        return s

    def output_lens(self, input_lens):
        """Map input frame counts to logit frame counts ('SAME' conv
        padding: out = ceil(in / stride) per strided layer); identity
        when conv_layers=0.  Works on ints, numpy and torch."""
        lens = input_lens
        for _tk, _fk, ts, _fs in self.conv_specs():
            if ts > 1:
                lens = -(-lens // ts)
        return lens

    @property
    def conv_out_dim(self) -> int:
        f = self.input_dim
        for _tk, _fk, _ts, fs in self.conv_specs():
            f = -(-f // fs)
        return f * self.conv_channels

    @property
    def spliced_dim(self) -> int:
        return self.input_dim * (1 + self.splice_left + self.splice_right)

    @property
    def front_out_dim(self) -> int:
        """Front affine output width: group-expanded for pnorm/maxout."""
        group = (self.front_group
                 if self.front_nonlin in ("pnorm", "maxout") else 1)
        return self.front_affine_dim * group

    @property
    def rnn(self) -> RnnConfig:
        if self.conv_layers and (self.splice_left or self.splice_right
                                 or self.front_affine_dim):
            raise ValueError("DS2 conv front end does not combine with "
                             "splicing or the FT front layer")
        return RnnConfig(
            input_dim=(self.conv_out_dim if self.conv_layers
                       else (self.front_affine_dim or self.spliced_dim)),
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            mode=self.mode,
            bidirectional=self.bidirectional,
            param_stddev=self.param_stddev,
            bias_stddev=self.bias_stddev,
            compute_dtype=self.compute_dtype,
            batch_rnn=self.deepspeech,
        )

    @property
    def deepspeech(self) -> bool:
        """deepspeech.pytorch's DS2 (``conv_norm`` "batch"), which needs
        the conv front."""
        if self.conv_norm == "batch" and not self.conv_layers:
            raise ValueError("conv_norm 'batch' (deepspeech.pytorch's DS2) "
                             "needs the conv front (conv_layers)")
        return self.conv_norm == "batch"

    def norm_widths(self) -> List[int]:
        """The width of every batch norm in the forward's order: the conv
        front's layers, the stack's layers 2.., the output; empty but for
        deepspeech.pytorch's DS2."""
        if not self.deepspeech:
            return []
        rnn = self.rnn
        return ([self.conv_channels] * self.conv_layers
                + [rnn.layer_input_dim(i) for i in range(1, self.num_layers)]
                + [rnn.output_dim])

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mode"] = int(self.mode)
        return d

    @staticmethod
    def from_dict(d: dict) -> "AmConfig":
        d = dict(d)
        d["mode"] = RnnMode(d["mode"])
        return AmConfig(**d)


def default_priors(num_targets: int, blank_prior: float = 9.0) -> np.ndarray:
    """Prior vector: ones with a large blank prior (nnet2-ctc-init-model.cc:64-67)."""
    p = np.ones(num_targets, dtype=np.float32)
    p[0] = blank_prior
    return p


def am_param_shapes(cfg: AmConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree with shapes (``torch.Size``) as
    leaves: ``rnn``, ``out_w`` [H*dirs, A], ``out_b`` [A]; with the FT
    front ``front_w`` [spliced_dim, front_out_dim] and ``front_b``; with
    the conv front ``conv``, a list of {conv_w [tk, fk, in, C] (HWIO),
    conv_b [C]} and, under "seq" or "batch" normalization, norm_g and
    norm_b [C].  deepspeech.pytorch's DS2 (``conv_norm`` "batch") has
    ``out_norm_g`` and ``out_norm_b`` [H] and no ``out_b``."""
    rnn = cfg.rnn
    shapes: Dict[str, Any] = {
        "rnn": rnn_param_shapes(rnn),
        "out_w": torch.Size((rnn.output_dim, cfg.num_targets))}
    if cfg.deepspeech:
        shapes["out_norm_g"] = torch.Size((rnn.output_dim,))
        shapes["out_norm_b"] = torch.Size((rnn.output_dim,))
    else:
        shapes["out_b"] = torch.Size((cfg.num_targets,))
    if cfg.front_affine_dim:
        if cfg.front_nonlin not in FRONT_NONLINS:
            raise ValueError(f"unknown front_nonlin {cfg.front_nonlin!r}")
        shapes["front_w"] = torch.Size((cfg.spliced_dim, cfg.front_out_dim))
        shapes["front_b"] = torch.Size((cfg.front_out_dim,))
    if cfg.conv_layers:
        if cfg.conv_norm not in ("seq", "none", "batch"):
            raise ValueError(f"unknown conv_norm {cfg.conv_norm!r}")
        c, c_in, convs = cfg.conv_channels, 1, []
        for tk, fk, _ts, _fs in cfg.conv_specs():
            layer = {"conv_w": torch.Size((tk, fk, c_in, c)),
                     "conv_b": torch.Size((c,))}
            if cfg.conv_norm != "none":
                layer["norm_g"] = torch.Size((c,))
                layer["norm_b"] = torch.Size((c,))
            convs.append(layer)
            c_in = c
        shapes["conv"] = convs
    return shapes


def init_am_params(cfg: AmConfig,
                   generator: Optional[torch.Generator] = None,
                   device="cpu") -> Dict[str, Any]:
    """Random init from ``generator`` (same distributions as the JAX
    package, different numbers: tests carry JAX parameters across with
    ``params.from_jax_params`` instead).  The conv kernels are drawn
    fan-in scaled, N(0, 2 / (tk fk c_in)), the front weight
    N(0, param_stddev^2); biases 0, norm gains 1."""
    shapes = am_param_shapes(cfg)
    out_w = cfg.param_stddev * torch.randn(shapes["out_w"],
                                           generator=generator)
    params = {"rnn": init_rnn_params(cfg.rnn, generator, device),
              "out_w": out_w.to(device)}
    for name in ("out_b", "out_norm_b"):
        if name in shapes:
            params[name] = torch.zeros(shapes[name], device=device)
    if "out_norm_g" in shapes:
        params["out_norm_g"] = torch.ones(shapes["out_norm_g"], device=device)
    if cfg.front_affine_dim:
        params["front_w"] = (cfg.param_stddev * torch.randn(
            shapes["front_w"], generator=generator)).to(device)
        params["front_b"] = torch.zeros(shapes["front_b"], device=device)
    if cfg.conv_layers:
        convs = []
        for layer in shapes["conv"]:
            tk, fk, c_in, _ = layer["conv_w"]
            w = torch.randn(layer["conv_w"], generator=generator) * float(
                np.sqrt(2.0 / (tk * fk * c_in)))
            out = {"conv_w": w.to(device),
                   "conv_b": torch.zeros(layer["conv_b"], device=device)}
            if "norm_g" in layer:
                out["norm_g"] = torch.ones(layer["norm_g"], device=device)
                out["norm_b"] = torch.zeros(layer["norm_b"], device=device)
            convs.append(out)
        params["conv"] = convs
    return params


def grow_rnn_layer(params: Dict[str, Any], cfg: AmConfig,
                   generator: Optional[torch.Generator] = None) -> tuple:
    """Append a freshly initialized recurrent layer (layer-wise growth,
    the nnet-insert step of steps/ctc/train.sh:357-384).

    The new layer has the shapes and stddevs of ``init_rnn_params``'
    layers, drawn per direction (w_x, w_h, b) from ``generator`` on the
    CPU and placed on the device of the existing parameters.  The
    distributions are the JAX package's, the numbers are not (its
    ``jax.random`` draws differ from ``torch.Generator``'s, as for
    ``init_am_params``).  Returns (new_params, new_cfg); the caller
    rebuilds the optimizer state, whose tree changed.
    """
    if cfg.norm_widths():
        raise ValueError("layer growth takes no batch norm")
    new_cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
    shapes = rnn_param_shapes(new_cfg.rnn)[-1]["dirs"]
    device = params["out_w"].device

    def draw(shape, std):
        return (std * torch.randn(shape, generator=generator,
                                  dtype=torch.float32)).to(device)

    dirs = [{"w_x": draw(d["w_x"], cfg.param_stddev),
             "w_h": draw(d["w_h"], cfg.param_stddev),
             "b": draw(d["b"], cfg.bias_stddev)} for d in shapes]
    new_params = dict(params)
    new_params["rnn"] = list(params["rnn"]) + [{"dirs": dirs}]
    return new_params, new_cfg


def _valid_frames(t: int, lens: torch.Tensor) -> torch.Tensor:
    """[B, t] bool: frame < lens[b]."""
    return (torch.arange(t, device=lens.device)[None, :]
            < lens.to(torch.int64)[:, None])


def init_norm_stats(cfg: AmConfig, device="cpu") -> list:
    """Fresh running statistics of every batch norm of ``cfg``
    (``norm_widths``' order): [{"mean": 0, "var": 1}], f32; empty for a
    model with none."""
    return [{"mean": torch.zeros(w, device=device),
             "var": torch.ones(w, device=device)} for w in cfg.norm_widths()]


class _BatchNorms:
    """One forward's batch norms, taken in ``norm_widths``' order.

    Training (``update``, a list): each normalises the valid frames by
    their own mean and biased variance, gathering those rows for
    ``F.batch_norm`` and scattering them back (zeros at the pad frames),
    and appends its running statistics, moved from ``stats`` by
    ``BN_MOMENTUM`` toward the batch's (the unbiased variance, as
    ``F.batch_norm`` moves them), to ``update``.  Eval: each normalises
    every frame by ``stats``, elementwise (a pad frame's value is never
    read)."""

    def __init__(self, stats: Optional[list], update: Optional[list]):
        if stats is None:
            raise ValueError("a model with batch norm needs its running "
                             "statistics (init_norm_stats, a checkpoint's "
                             "or a model file's)")
        self.stats, self.update, self.i = stats, update, 0

    def _rows(self, rows: torch.Tensor, g, b) -> torch.Tensor:
        s = self.stats[self.i]
        self.i += 1
        if self.update is None:
            return F.batch_norm(rows, s["mean"], s["var"], g, b, False,
                                0.0, BN_EPS)
        mean, var = s["mean"].clone(), s["var"].clone()
        out = F.batch_norm(rows, mean, var, g, b, True, BN_MOMENTUM, BN_EPS)
        self.update.append({"mean": mean, "var": var})
        return out

    def frames(self, x: torch.Tensor, rows: Optional[torch.Tensor], g, b
               ) -> torch.Tensor:
        """x [N, K] (K a multiple of g's C: each row K / C positions of C
        channels, channel fastest), ``rows`` the indices of its valid rows
        (None: all) → the normalised f32 x."""
        n, k = x.shape
        c = g.shape[0]
        x = x.float()
        if self.update is None or rows is None:
            return self._rows(x.reshape(-1, c), g, b).reshape(n, k)
        y = self._rows(x.index_select(0, rows).reshape(-1, c), g, b)
        return torch.zeros_like(x).index_copy(0, rows, y.reshape(-1, k))


def _valid_rows(t: int, lens: Optional[torch.Tensor], time_major: bool):
    """The indices of the valid (frame, row) pairs of a [T, B] (or, not
    ``time_major``, [B, T]) layout flattened; None without lens."""
    if lens is None:
        return None
    valid = _valid_frames(t, lens)
    return (valid.T if time_major else valid).reshape(-1).nonzero()[:, 0]


def _conv_front(convs, feats: torch.Tensor, cfg: AmConfig,
                lens: Optional[torch.Tensor],
                norms: Optional[_BatchNorms] = None):
    """The DS2 conv front in f32 (also under bf16): feats [B, T, F] →
    ([B, T', F' * C] with the (freq, channel) map flattened f*C + c, as
    the JAX package's NHWC reshape, and the logit-rate lens)."""
    x = feats.float()[:, None]                        # [B, 1, T, F] NCHW
    for conv, (tk, fk, ts, fs) in zip(convs, cfg.conv_specs()):
        if lens is not None:
            x = torch.where(_valid_frames(x.shape[2], lens)[:, None, :, None],
                            x, 0.0)
        # explicit ((k-1)//2, k//2) padding per axis, not 'SAME', so an
        # utterance's window alignment does not depend on its bucket;
        # F.pad lists the last axis (freq) first
        x = F.pad(x, ((fk - 1) // 2, fk // 2, (tk - 1) // 2, tk // 2))
        x = F.conv2d(x, conv["conv_w"].permute(3, 2, 0, 1), conv["conv_b"],
                     stride=(ts, fs))
        if cfg.conv_norm == "batch":
            # BatchNorm2d over the layer's valid output frames (its lens
            # after the stride), then Hardtanh(0, 20)
            b_, c, t, f = x.shape
            out_lens = None if lens is None else -(-lens // ts)
            rows = (_valid_rows(t, out_lens, False)
                    if norms.update is not None else None)
            y = norms.frames(x.permute(0, 2, 3, 1).reshape(b_ * t, f * c),
                             rows, conv["norm_g"], conv["norm_b"])
            x = torch.clamp(y.reshape(b_, t, f, c).permute(0, 3, 1, 2),
                            0.0, 20.0)
            lens = out_lens
            continue
        if "norm_g" in conv:
            # sequence-wise norm: moments per (utterance, channel) over the
            # valid frames and every freq bin, biased variance.  The mask
            # is that of the layer's input lens (a strided layer's output
            # is masked with its pre-stride lens): the JAX package's
            # behaviour, copied (ROADMAP F1)
            if lens is not None:
                v = _valid_frames(x.shape[2], lens).to(x.dtype)   # [B, T']
                n = torch.clamp_min(v.sum(1) * x.shape[3], 1.0)   # [B]
                vm = v[:, None, :, None]
                mean = (x * vm).sum((2, 3)) / n[:, None]          # [B, C]
                var = (((x - mean[:, :, None, None]) ** 2 * vm).sum((2, 3))
                       / n[:, None])
            else:
                mean = x.mean((2, 3))
                var = x.var((2, 3), unbiased=False)
            x = ((x - mean[:, :, None, None])
                 / torch.sqrt(var[:, :, None, None] + 1e-5)
                 * conv["norm_g"][:, None, None] + conv["norm_b"][:, None, None])
        # leaky clipped ReLU(20)
        x = torch.clamp_max(torch.where(x > 0, x, 0.01 * x), 20.0)
        if lens is not None and ts > 1:
            lens = -(-lens // ts)
    b, c, t, f = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, t, f * c), lens


def _splice(x: torch.Tensor, cfg: AmConfig,
            lens: Optional[torch.Tensor]) -> torch.Tensor:
    """SpliceComponent on time-major x [T, B, D]: frames t-L..t+R
    concatenated, clamped at 0 and at each utterance's own last frame
    max(len-1, 0) (T-1 without lens) → [T, B, D * (1+L+R)]."""
    t, b, d = x.shape
    last = (torch.full((1,), t - 1, device=x.device) if lens is None
            else torch.clamp_min(lens.to(x.device, torch.int64) - 1, 0))
    steps = torch.arange(t, device=x.device)[:, None]
    parts = []
    for off in range(-cfg.splice_left, cfg.splice_right + 1):
        idx = torch.minimum(torch.clamp_min(steps + off, 0),
                            last[None, :]).expand(t, b)          # [T, B]
        parts.append(torch.gather(x, 0, idx[..., None].expand(t, b, d)))
    return torch.cat(parts, dim=-1)


def front_layer(params: Dict[str, Any], x: torch.Tensor, cfg: AmConfig,
                taps: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The FT front, frame-local: Affine (compute-dtype operands, f32
    accumulation) + nonlinearity + renormalize to unit RMS.  ``taps``
    receives the layer's input rows (``front_in``) and its pre-activation
    (``front_pre``, whose gradient is NG-SGD's output derivative)."""
    if taps is not None:
        taps["front_in"] = x
    h = matmul_f32acc(x, params["front_w"], cfg.rnn.dtype) + params["front_b"]
    if taps is not None:
        taps["front_pre"] = h
    if cfg.front_nonlin == "relu":
        h = torch.relu(h)
    elif cfg.front_nonlin == "tanh":
        h = torch.tanh(h)
    elif cfg.front_nonlin == "sigmoid":
        h = torch.sigmoid(h)
    else:   # pnorm / maxout over contiguous front_group-sized groups
        g = h.reshape(h.shape[:-1] + (cfg.front_affine_dim, cfg.front_group))
        h = (torch.sqrt(torch.sum(g * g, dim=-1) + 1e-20)
             if cfg.front_nonlin == "pnorm" else g.amax(dim=-1))
    rms = torch.sqrt(torch.mean(h * h, dim=-1, keepdim=True) + 1e-20)
    return h / rms


def am_forward(
    params: Dict[str, Any],
    feats: torch.Tensor,            # [B, T, D] batch-major
    cfg: AmConfig,
    input_lens: Optional[torch.Tensor] = None,
    dropout_mask: Optional[torch.Tensor] = None,
    taps: Optional[Dict[str, torch.Tensor]] = None,
    stats: Optional[list] = None,
    new_stats: Optional[list] = None,
) -> torch.Tensor:
    """Forward pass → f32 logits [B, T', num_targets] (T' = T without a
    conv front, ceil(T / time_stride) with it).

    In the JAX package's order: the conv front, splicing, the FT front,
    the recurrent stack, dropout, the output affine (one [T*B, H] @ [H, A]
    matmul with compute-dtype operands and f32 accumulation).  Dropout
    acts only where the caller gives ``dropout_mask`` (bool, the stack
    output's shape [T', B, H*dirs], True = keep; training draws it, see
    ``training.train.dropout_mask``).  ``taps``, a dict the caller passes
    in, receives the affine layers' input rows and pre-activations
    (``out_in`` [T', B, H*dirs], ``out_pre`` [T'*B, A], and the front's),
    the two factors of the natural-gradient update.

    A model with batch norms (``cfg.norm_widths()``) takes ``stats``, the
    running statistics (:func:`init_norm_stats`' layout): with
    ``new_stats``, a list, it runs in training mode (the batch's
    statistics over the valid frames) and appends the moved running
    statistics to it; without, in eval mode on ``stats``.
    """
    norms = (_BatchNorms(stats, new_stats) if cfg.norm_widths() else None)
    if cfg.conv_layers:
        feats, input_lens = _conv_front(params["conv"], feats, cfg,
                                        input_lens, norms)
    x = feats.transpose(0, 1)            # [T, B, D]
    if cfg.splice_left or cfg.splice_right:
        x = _splice(x, cfg, input_lens)
    if cfg.front_affine_dim:
        x = front_layer(params, x, cfg, taps)
    rows = (None if norms is None or new_stats is None
            else _valid_rows(x.shape[0], input_lens, True))

    def norm(v, g, b):
        t_, b_, d = v.shape
        return norms.frames(v.reshape(t_ * b_, d), rows, g, b).reshape(
            t_, b_, d)

    y = rnn_forward(params["rnn"], x, cfg.rnn, input_lens, norm)
    if cfg.dropout > 0.0 and dropout_mask is not None:
        # the keep probability in y's dtype, as JAX's weakly typed scalar
        # is: under bf16 the divisor is bf16(1 - p)
        keep = torch.tensor(1.0 - cfg.dropout, dtype=y.dtype, device=y.device)
        y = torch.where(dropout_mask, y / keep, 0.0)
    if cfg.deepspeech:
        y = norm(y, params["out_norm_g"], params["out_norm_b"])
    t, b, h = y.shape
    if taps is not None:
        taps["out_in"] = y
    logits = matmul_f32acc(y.reshape(t * b, h), params["out_w"],
                           cfg.rnn.dtype)
    if "out_b" in params:
        logits = logits + params["out_b"]
    if taps is not None:
        taps["out_pre"] = logits
    return logits.reshape(t, b, -1).transpose(0, 1)   # [B, T', A]
