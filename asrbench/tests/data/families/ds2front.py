"""A family for the benchmark's own tests, added to a copy of the
benchmark as a file: the port's DS2 conv front (``train_ctc
--conv-layers``, ``--conv-norm none``) over a 'google' stack.

The front, as the port documents it (``models/acoustic.py``): per layer
the input masked to each utterance's frames, padded by ((k-1)//2, k//2)
frames and bins, a 2-D convolution (kernels 11x41, then 11x21; the
first strides ``conv_time_stride`` in time, each strides 2 in
frequency) plus a bias, and the leaky clipped ReLU(20)
``min(max(x, 0.01 x), 20)``; a strided layer's lengths become
ceil(len / stride).  The (frequency, channel) map is flattened
``f * C + c`` into the stack's input.  The sequence-wise norm is left
out (``conv_norm`` "none"): its moments depend on how the program pads
a batch.  The stack and the output layer are ``google``'s, over the
front's output frames.  Torch is imported where it is used, as in
``google``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

from asrbench.families import google

# (time kernel, freq kernel, time stride, freq stride); None: the
# configuration's conv_time_stride
_SPECS = ((11, 41, None, 2), (11, 21, 1, 2), (11, 21, 1, 2))


def _specs(cfg: dict):
    return [(tk, fk, int(cfg["conv_time_stride"]) if ts is None else ts, fs)
            for tk, fk, ts, fs in _SPECS[:int(cfg["conv_layers"])]]


def _stack_cfg(cfg: dict) -> dict:
    f = int(cfg["input_dim"])
    for _, _, _, fs in _specs(cfg):
        f = -(-f // fs)
    return dict(cfg, input_dim=f * int(cfg["conv_channels"]))


def program_flags(cfg: dict) -> List[str]:
    return google.program_flags(cfg) + [
        "--conv-layers", str(cfg["conv_layers"]),
        "--conv-channels", str(cfg["conv_channels"]),
        "--conv-time-stride", str(cfg["conv_time_stride"]),
        "--conv-norm", "none"]


def model_file_config(cfg: dict) -> dict:
    return dict(google.model_file_config(cfg),
                conv_layers=int(cfg["conv_layers"]),
                conv_channels=int(cfg["conv_channels"]),
                conv_time_stride=int(cfg["conv_time_stride"]),
                conv_norm="none")


def param_shapes(cfg: dict):
    c, c_in, out = int(cfg["conv_channels"]), 1, []
    for i, (tk, fk, _, _) in enumerate(_specs(cfg)):
        out += [(f"conv.{i}.conv_b", (c,)),
                (f"conv.{i}.conv_w", (tk, fk, c_in, c))]
        c_in = c
    return out + google.param_shapes(_stack_cfg(cfg))


def make_params(cfg: dict, seed: int, device) -> List["torch.Tensor"]:
    """The stack's leaves as ``google`` draws them; the kernels
    N(0, 2 / (tk fk c_in)) (the port's init) from a second generator,
    the conv biases 0."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % (1 << 63))
    conv = []
    for name, shape in param_shapes(cfg):
        if name.endswith("conv_b"):
            conv.append(torch.zeros(shape, device=device))
        elif name.endswith("conv_w"):
            tk, fk, c_in, _ = shape
            conv.append(torch.randn(shape, generator=gen, device=device)
                        * math.sqrt(2.0 / (tk * fk * c_in)))
    return conv + google.make_params(_stack_cfg(cfg), seed, device)


def logits(tree: Dict, feats: "torch.Tensor", lens: "torch.Tensor",
           cfg: dict) -> "torch.Tensor":
    """feats [B, T, D] → logits [T', B, A]."""
    import torch
    import torch.nn.functional as F

    from asrbench import reference as ref

    x = feats[:, None]                                   # [B, 1, T, F]
    for conv, (tk, fk, ts, fs) in zip(tree["conv"], _specs(cfg)):
        valid = (torch.arange(x.shape[2], device=x.device)[None, :]
                 < lens.to(x.device)[:, None])
        x = torch.where(valid[:, None, :, None], x, 0.0)
        x = F.pad(x, ((fk - 1) // 2, fk // 2, (tk - 1) // 2, tk // 2))
        x = ref.conv2d(x, conv["conv_w"].permute(3, 2, 0, 1), (ts, fs)) \
            + conv["conv_b"][:, None, None]
        x = torch.clamp_max(torch.maximum(x, 0.01 * x), 20.0)
        lens = -(-lens // ts)
    b, c, t, f = x.shape
    y = x.permute(2, 0, 3, 1).reshape(t, b, f * c)       # [T', B, F' C]
    return google.output_layer(tree, google.rnn_stack(tree, y, lens, cfg))


def time_stride(cfg: dict) -> int:
    return math.prod(ts for _, _, ts, _ in _specs(cfg))


def output_lens(cfg: dict, lens):
    for _, _, ts, _ in _specs(cfg):
        lens = -(-lens // ts)
    return lens


def forward_flops_per_frame(cfg: dict) -> float:
    """The convolutions' products at each output position, and the
    stack's a logit frame, over the input frames they take."""
    total, per, f, c_in = 0.0, 1.0, int(cfg["input_dim"]), 1
    c = int(cfg["conv_channels"])
    for tk, fk, ts, fs in _specs(cfg):
        per /= ts
        f = -(-f // fs)
        total += per * f * 2.0 * tk * fk * c_in * c
        c_in = c
    stack = _stack_cfg(cfg)
    return total + per * google.stack_flops_per_frame(
        stack, int(stack["input_dim"]))


def layer_work(cfg: dict, layer: str, frames: Sequence[int], backward: bool
               ) -> Dict[str, float]:
    s = time_stride(cfg)
    return google.layer_work(_stack_cfg(cfg), layer,
                             [math.ceil(n / s) for n in frames], backward)


def features(cfg: dict, pcm):
    return google.features(cfg, pcm)
