"""The CTC acoustic model: recurrent stack + output projection + priors.

Counterpart of ``kaldi_ctc_tpu/models/acoustic.py`` for the 'google'
family (make_configs.py:237-365): stacked recurrent layers → affine to
num_targets.  Output index 0 is the blank; priors default to ones with
prior[blank]=9 (nnet2-ctc-init-model.cc:64-67).

Parameters are the JAX package's tree with torch tensors as leaves, so
``params.from_jax_params`` carries JAX parameters across unchanged.
``AmConfig`` keeps every field of the JAX config so artifacts and
training directories load as they are; splicing, the FT front layer,
dropout and the DS2 conv front are not ported yet and raise
``NotImplementedError`` (ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from kaldi_ctc_tpu_torch.ops.rnn import (RnnConfig, RnnMode, init_rnn_params,
                                         matmul_f32acc, rnn_forward,
                                         rnn_param_shapes)

__all__ = ["AmConfig", "init_am_params", "am_forward", "am_param_shapes",
           "default_priors", "grow_rnn_layer"]

_NOT_PORTED = ("{} is not ported yet: ROADMAP.md item 12 "
               "(am_forward extras)")


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
    splice_left: int = 0
    splice_right: int = 0
    front_affine_dim: int = 0
    front_nonlin: str = "relu"
    front_group: int = 1
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
    def is_google(self) -> bool:
        """RNN-first with no splicing, front layer or conv front."""
        return not (self.splice_left or self.splice_right
                    or self.front_affine_dim or self.conv_layers)

    @property
    def rnn(self) -> RnnConfig:
        if not self.is_google:
            raise NotImplementedError(_NOT_PORTED.format(
                "splicing / the FT front / the DS2 conv front"))
        return RnnConfig(
            input_dim=self.input_dim,
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            mode=self.mode,
            bidirectional=self.bidirectional,
            param_stddev=self.param_stddev,
            bias_stddev=self.bias_stddev,
            compute_dtype=self.compute_dtype,
        )

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
    leaves: ``rnn``, ``out_w`` [H*dirs, A], ``out_b`` [A]."""
    rnn = cfg.rnn
    return {"rnn": rnn_param_shapes(rnn),
            "out_w": torch.Size((rnn.output_dim, cfg.num_targets)),
            "out_b": torch.Size((cfg.num_targets,))}


def init_am_params(cfg: AmConfig,
                   generator: Optional[torch.Generator] = None,
                   device="cpu") -> Dict[str, Any]:
    """Random init from ``generator`` (same distributions as the JAX
    package, different numbers: tests carry JAX parameters across with
    ``params.from_jax_params`` instead)."""
    shapes = am_param_shapes(cfg)
    out_w = cfg.param_stddev * torch.randn(shapes["out_w"],
                                           generator=generator)
    return {"rnn": init_rnn_params(cfg.rnn, generator, device),
            "out_w": out_w.to(device),
            "out_b": torch.zeros(shapes["out_b"], device=device)}


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


def am_forward(
    params: Dict[str, Any],
    feats: torch.Tensor,            # [B, T, D] batch-major
    cfg: AmConfig,
    input_lens: Optional[torch.Tensor] = None,
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Forward pass → f32 logits [B, T, num_targets].

    Time-major inside; the output affine is one [T*B, H] @ [H, A] matmul
    with compute-dtype operands and f32 accumulation.  Dropout, like the
    JAX package's, acts only in training (with a generator) and is not
    ported yet.
    """
    if cfg.dropout > 0.0 and dropout_generator is not None:
        raise NotImplementedError(_NOT_PORTED.format("dropout"))
    x = feats.transpose(0, 1)            # [T, B, D]
    y = rnn_forward(params["rnn"], x, cfg.rnn, input_lens)
    t, b, h = y.shape
    logits = (matmul_f32acc(y.reshape(t * b, h), params["out_w"],
                            cfg.rnn.dtype)
              + params["out_b"]).reshape(t, b, -1)
    return logits.transpose(0, 1)        # [B, T, A]
