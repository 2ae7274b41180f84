"""The 'deepspeech2' family: DeepSpeech2 as deepspeech.pytorch builds it
(SeanNaren/deepspeech.pytorch, ``deepspeech_pytorch/model.py``) over
spectrogram frames.

Configuration keys: ``input_dim`` (spectrogram bins), ``num_targets``,
``hidden_dim``, ``num_layers``, ``conv_channels``, ``compute_dtype``,
``blank_prior``.

- The conv front: two layers; per layer the input masked to each
  utterance's frames, padded by (k - 1) / 2 frames and bins, a 2-D
  convolution plus a bias (kernels 11 frames x 41 bins, stride 2 x 2,
  then 11 x 21, stride 1 x 2), a batch norm over the layer's valid output
  positions (its lengths ceil(len / 2)), and Hardtanh(0, 20).  The
  (bin, channel) map is flattened bin * C + channel (deepspeech.pytorch
  flattens channel * F + bin: a permutation of the first layer's W_x
  rows).
- The stack: per layer but the first a batch norm of its input over the
  valid frames, then a bidirectional LSTM (gates i, f, g, o, one bias a
  direction, the state held past an utterance's end, the backward
  direction from its last frame down), the two directions summed.
- Output: a batch norm over the valid frames, then ``y W_out``, no bias.
- A batch norm in training mode normalises by the valid positions' mean
  and biased variance and moves its running statistics by 0.1 toward
  the mean and the unbiased variance (eps 1e-5); in eval mode it
  normalises by the running statistics.  Pad positions never enter a
  statistic (deepspeech.pytorch's do; the configuration's ``assumed``).
- The tree: ``conv[i]{"conv_w" [tk, fk, in, C], "conv_b", "norm_g",
  "norm_b"}``, ``rnn[layer]{"dirs"[d]{"w_x", "w_h", "b"}, "norm_g",
  "norm_b"}`` (no norm on layer 0), ``out_norm_g``, ``out_norm_b``,
  ``out_w``; PyTorch's default init: U(+-1/sqrt(H)) for the LSTM's,
  U(+-1/sqrt(fan in)) for the convolutions' and the output's, gains 1,
  shifts 0.
- Work: the products at 2 operations a multiply-add; the recurrent
  stack as ``google``'s at the logit rate; the conv front's
  convolutions (the first's input gradient is not formed: its input is
  data); the batch norms' bytes, each position read once and written
  once forward, and read twice and written once backward.

Torch and the reference are imported inside the functions that use
them, as in ``google``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from asrbench.families import google

__all__ = ["program_flags", "model_file_config", "param_shapes",
           "make_params", "forward", "logits", "output_lens", "time_stride",
           "forward_flops_per_frame", "layer_work", "features",
           "norm_widths"]

# (time kernel, bin kernel, time stride, bin stride) of the two layers
_SPECS = ((11, 41, 2, 2), (11, 21, 1, 2))
MOMENTUM, EPS = 0.1, 1e-5


def _bins(cfg: dict) -> List[int]:
    """Output bins of each conv layer."""
    f, out = int(cfg["input_dim"]), []
    for _, _, _, fs in _SPECS:
        f = -(-f // fs)
        out.append(f)
    return out


def _stack_cfg(cfg: dict) -> dict:
    """The stack as the 'google' family sees one of its layers."""
    return dict(cfg, input_dim=_bins(cfg)[-1] * int(cfg["conv_channels"]),
                rnn_mode=2, bidirectional=1)


def program_flags(cfg: dict) -> List[str]:
    return ["--num-targets", str(cfg["num_targets"]),
            "--hidden-dim", str(cfg["hidden_dim"]),
            "--num-layers", str(cfg["num_layers"]),
            "--rnn-mode", "2", "--bidirectional", "1",
            "--compute-dtype", cfg["compute_dtype"],
            "--conv-layers", str(len(_SPECS)),
            "--conv-channels", str(cfg["conv_channels"]),
            "--conv-time-stride", str(_SPECS[0][2]),
            "--conv-norm", "batch"]


def model_file_config(cfg: dict) -> dict:
    return {"input_dim": int(cfg["input_dim"]),
            "num_targets": int(cfg["num_targets"]),
            "hidden_dim": int(cfg["hidden_dim"]),
            "num_layers": int(cfg["num_layers"]), "mode": 2,
            "bidirectional": True, "compute_dtype": cfg["compute_dtype"],
            "conv_layers": len(_SPECS),
            "conv_channels": int(cfg["conv_channels"]),
            "conv_time_stride": _SPECS[0][2], "conv_norm": "batch"}


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    h, a = int(cfg["hidden_dim"]), int(cfg["num_targets"])
    c, c_in, out = int(cfg["conv_channels"]), 1, []
    for i, (tk, fk, _, _) in enumerate(_SPECS):
        out += [(f"conv.{i}.conv_b", (c,)),
                (f"conv.{i}.conv_w", (tk, fk, c_in, c)),
                (f"conv.{i}.norm_b", (c,)), (f"conv.{i}.norm_g", (c,))]
        c_in = c
    out += [("out_norm_b", (h,)), ("out_norm_g", (h,)), ("out_w", (h, a))]
    for layer in range(int(cfg["num_layers"])):
        d_in = _stack_cfg(cfg)["input_dim"] if layer == 0 else h
        for d in range(2):
            pre = f"rnn.{layer}.dirs.{d}."
            out += [(pre + "b", (4 * h,)), (pre + "w_h", (h, 4 * h)),
                    (pre + "w_x", (d_in, 4 * h))]
        if layer:
            out += [(f"rnn.{layer}.norm_b", (h,)),
                    (f"rnn.{layer}.norm_g", (h,))]
    return out


def make_params(cfg: dict, seed: int, device) -> List["torch.Tensor"]:
    """The flat leaves, f32 on ``device``, each drawn in turn from one
    generator seeded with ``seed``: PyTorch's default init (``nn.LSTM``:
    every weight and bias U(+-1/sqrt(H)); ``nn.Conv2d``: weight and bias
    U(+-1/sqrt(in x tk x fk)); ``nn.Linear``: U(+-1/sqrt(H))); norm
    gains 1, shifts 0."""
    import torch

    h = int(cfg["hidden_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    conv_fan = {}
    for name, shape in param_shapes(cfg):
        if name.endswith("conv_w"):
            conv_fan[name.rsplit(".", 1)[0]] = shape[0] * shape[1] * shape[2]
    leaves = []
    for name, shape in param_shapes(cfg):
        last = name.rsplit(".", 1)[-1]
        if last in ("norm_g", "out_norm_g"):
            leaves.append(torch.ones(shape, device=device))
            continue
        if last in ("norm_b", "out_norm_b"):
            leaves.append(torch.zeros(shape, device=device))
            continue
        fan = conv_fan[name.rsplit(".", 1)[0]] if name.startswith("conv") \
            else h
        bound = 1.0 / math.sqrt(fan)
        u = torch.rand(shape, generator=gen, device=device)
        leaves.append((2.0 * u - 1.0) * bound)
    return leaves


def norm_widths(cfg: dict) -> List[int]:
    """Every batch norm's width, in the forward's order."""
    c, h = int(cfg["conv_channels"]), int(cfg["hidden_dim"])
    return [c] * len(_SPECS) + [h] * (int(cfg["num_layers"]) - 1) + [h]


def _batch_norm(x, valid, g, b, stats, update):
    """x [B, T, ..., C] with ``valid`` [B, T] bool (or [T, B]: the two
    leading axes) → normalised x.  ``update`` (a list): by the valid
    positions' statistics, appending the running ones ``stats`` moved
    toward them (where given); else by ``stats`` {"mean", "var"}."""
    import torch

    if update is None:
        return (x - stats["mean"]) / torch.sqrt(stats["var"] + EPS) * g + b
    rows = x[valid].reshape(-1, x.shape[-1])          # [N, C]
    n = rows.shape[0]
    mean = rows.sum(0) / n
    var = ((rows - mean) ** 2).sum(0) / n
    if stats is not None:
        update.append({
            "mean": (1.0 - MOMENTUM) * stats["mean"] + MOMENTUM * mean,
            "var": (1.0 - MOMENTUM) * stats["var"]
            + MOMENTUM * var * (n / (n - 1.0))})
    return (x - mean) / torch.sqrt(var + EPS) * g + b


def forward(tree: Dict, feats: "torch.Tensor", lens: "torch.Tensor",
            cfg: dict, stats: Optional[list] = None,
            update: Optional[list] = None, train: bool = True
            ) -> "torch.Tensor":
    """feats [B, T, D] → logits [T', B, A].  ``train``: each batch norm
    by the batch's statistics (with ``stats`` and ``update``, the moved
    running statistics appended to ``update``); else by ``stats``."""
    import torch
    import torch.nn.functional as F

    from asrbench import reference as ref

    norms = iter(stats if stats is not None else [None] * len(
        norm_widths(cfg)))

    def bn(x, valid, g, b):
        if not train:
            return _batch_norm(x, valid, g, b, next(norms), None)
        return _batch_norm(x, valid, g, b, next(norms),
                           [] if update is None else update)

    x = feats[:, None]                                # [B, 1, T, F]
    for conv, (tk, fk, ts, fs) in zip(tree["conv"], _SPECS):
        valid = (torch.arange(x.shape[2], device=x.device)[None, :]
                 < lens.to(x.device)[:, None])
        x = torch.where(valid[:, None, :, None], x, 0.0)
        x = F.pad(x, ((fk - 1) // 2, fk // 2, (tk - 1) // 2, tk // 2))
        x = ref.conv2d(x, conv["conv_w"].permute(3, 2, 0, 1), (ts, fs)) \
            + conv["conv_b"][:, None, None]
        lens = -(-lens // ts)
        valid = (torch.arange(x.shape[2], device=x.device)[None, :]
                 < lens.to(x.device)[:, None])          # [B, T']
        y = bn(x.permute(0, 2, 3, 1), valid, conv["norm_g"], conv["norm_b"])
        x = torch.clamp(y, 0.0, 20.0).permute(0, 3, 1, 2)
    b, c, t, f = x.shape
    y = x.permute(2, 0, 3, 1).reshape(t, b, f * c)   # [T', B, F' C]
    valid = (torch.arange(t, device=y.device)[:, None]
             < lens.to(y.device)[None, :])           # [T', B]
    h = int(cfg["hidden_dim"])
    layer_cfg = dict(_stack_cfg(cfg), num_layers=1)
    for i, layer in enumerate(tree["rnn"]):
        if i:
            y = bn(y, valid, layer["norm_g"], layer["norm_b"])
        both = google.rnn_stack({"rnn": [layer]}, y, lens, layer_cfg)
        y = both[..., :h] + both[..., h:]
    y = bn(y, valid, tree["out_norm_g"], tree["out_norm_b"])
    return ref.mm(y.reshape(t * b, h), tree["out_w"]).reshape(t, b, -1)


def logits(tree: Dict, feats: "torch.Tensor", lens: "torch.Tensor",
           cfg: dict) -> "torch.Tensor":
    """feats [B, T, D] → logits [T', B, A], in training mode."""
    return forward(tree, feats, lens, cfg)


def output_lens(cfg: dict, lens):
    for _, _, ts, _ in _SPECS:
        lens = -(-lens // ts)
    return lens


def time_stride(cfg: dict) -> int:
    return math.prod(ts for _, _, ts, _ in _SPECS)


def _conv_flops(cfg: dict) -> List[float]:
    """Each conv layer's forward operations for one input frame."""
    c, c_in, per, out = int(cfg["conv_channels"]), 1, 1.0, []
    for (tk, fk, ts, _), f in zip(_SPECS, _bins(cfg)):
        per /= ts
        out.append(per * f * 2.0 * tk * fk * c_in * c)
        c_in = c
    return out


def forward_flops_per_frame(cfg: dict) -> float:
    """The convolutions' products at each output position, and the
    stack's and the output's a logit frame, over the input frames."""
    h, a = int(cfg["hidden_dim"]), int(cfg["num_targets"])
    stack = _stack_cfg(cfg)
    d0 = int(stack["input_dim"])
    rnn = sum(2 * (2.0 * (d0 if i == 0 else h) * 4 * h + 2.0 * h * 4 * h)
              for i in range(int(cfg["num_layers"])))
    return sum(_conv_flops(cfg)) + (rnn + 2.0 * h * a) / time_stride(cfg)


def layer_work(cfg: dict, layer: str, frames: Sequence[int], backward: bool
               ) -> Dict[str, float]:
    """{"flops", "bytes"} over utterances of ``frames`` input frames:
    "recurrent stack" (``google``'s, at the logit rate), "conv front"
    (the convolutions; backward, the second's input gradient and both
    weight gradients; bytes: each layer's input read and output written
    once, f32, and its weights), "batch norm" (bytes alone: each
    position read and written once forward, read twice and written once
    backward, f32)."""
    s = time_stride(cfg)
    logit = [math.ceil(n / s) for n in frames]
    if layer == "recurrent stack":
        return google.recurrent_work(_stack_cfg(cfg), logit, backward)
    n_in, n_out = float(sum(frames)), float(sum(logit))
    c = int(cfg["conv_channels"])
    if layer == "conv front":
        f1, f2 = _conv_flops(cfg)
        flops = (f1 + f2) * n_in
        if backward:
            flops += f1 * n_in + 2.0 * f2 * n_in
        b1, b2 = _bins(cfg)
        acts = (n_in * int(cfg["input_dim"]) + n_out * b1 * c
                + n_out * b1 * c + n_out * b2 * c)
        weights = sum(tk * fk * ci * c for (tk, fk, _, _), ci in
                      zip(_SPECS, (1, c)))
        passes = 2.0 if backward else 1.0
        return {"flops": flops, "bytes": 4.0 * passes * (acts + weights)}
    if layer == "batch norm":
        b1, b2 = _bins(cfg)
        per = (b1 + b2) * c + sum(norm_widths(cfg)[len(_SPECS):])
        return {"flops": 0.0,
                "bytes": 4.0 * n_out * per * (5.0 if backward else 2.0)}
    raise KeyError(f"the deepspeech2 family has no layer {layer!r}")


def features(cfg: dict, pcm):
    """Spectrogram frames in the manner of deepspeech.pytorch's loader
    (20 ms Hamming windows every 10 ms, |STFT| at n_fft 320, log1p,
    normalised by the utterance's mean and standard deviation; frames
    not centred), [frames, 161] f32."""
    import numpy as np

    x = np.asarray(pcm, np.float64) / 32768.0
    win, hop, nfft = 320, 160, 320
    if x.shape[0] < win:
        return np.zeros((0, nfft // 2 + 1), np.float32)
    n = 1 + (x.shape[0] - win) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    w = np.hamming(win)
    spec = np.log1p(np.abs(np.fft.rfft(x[idx] * w, n=nfft, axis=1)))
    spec = (spec - spec.mean()) / max(spec.std(), 1e-12)
    return spec.astype(np.float32)
