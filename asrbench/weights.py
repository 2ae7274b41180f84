"""The model's weights, made from the seed on the device.

The benchmark makes the weights the program starts from, and the
reference makes the same ones again: one ``torch.Generator`` on the
device, seeded with the run's seed, fills every weight in one draw and
every bias in another.  The tree is the program's layout
(``rnn[layer]["dirs"][d]{"w_x", "w_h", "b"}``, ``out_w``, ``out_b``),
flattened in ``jax.tree_util`` order (dict keys sorted), which the
program's checkpoints and model files number their leaves by.  Torch
only: nothing here imports the program.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

__all__ = ["gates", "param_shapes", "make_params", "flatten", "leaf_names",
           "unflatten"]


def gates(cfg: dict) -> int:
    return {2: 4, 3: 3}[int(cfg["rnn_mode"])]


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, in flatten order."""
    h, g = int(cfg["hidden_dim"]), gates(cfg)
    dirs = 2 if int(cfg["bidirectional"]) else 1
    out = [("out_b", (int(cfg["num_targets"]),)),
           ("out_w", (h * dirs, int(cfg["num_targets"])))]
    for layer in range(int(cfg["num_layers"])):
        d_in = int(cfg["input_dim"]) if layer == 0 else h * dirs
        for d in range(dirs):
            pre = f"rnn.{layer}.dirs.{d}."
            out += [(pre + "b", (g * h,)), (pre + "w_h", (h, g * h)),
                    (pre + "w_x", (d_in, g * h))]
    return out


def leaf_names(cfg: dict) -> List[str]:
    return [n for n, _ in param_shapes(cfg)]


def make_params(cfg: dict, seed: int, device) -> List[torch.Tensor]:
    """The flat leaves: weights N(0, param_stddev^2), recurrent biases
    N(0, bias_stddev^2), the output bias 0 (the port's and the
    reference's init), f32 on ``device``.  With ``near_tie_pairs`` = n,
    the output columns of labels 2k and 2k-1, k <= n, differ by the
    factor 1 + ``near_tie_eps``: their logits nearly tie on every frame
    where one of them leads, so the served labels show a loss of
    precision in the forward (TF32 rounds the two columns alike) that
    random weights would hide."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    is_w = [n.split(".")[-1] in ("w_h", "w_x", "out_w") for n, _ in shapes]
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    n_w = sum(s for s, w in zip(sizes, is_w) if w)
    n_b = sum(s for (n, _), s, w in zip(shapes, sizes, is_w)
              if not w and n != "out_b")
    wbuf = torch.randn(n_w, generator=gen, device=device) * float(
        cfg["param_stddev"])
    bbuf = torch.randn(n_b, generator=gen, device=device) * float(
        cfg["bias_stddev"])
    leaves, iw, ib = [], 0, 0
    for (name, shape), size, w in zip(shapes, sizes, is_w):
        if name == "out_b":
            leaves.append(torch.zeros(shape, device=device))
        elif w:
            leaves.append(wbuf[iw:iw + size].view(shape))
            iw += size
        else:
            leaves.append(bbuf[ib:ib + size].view(shape))
            ib += size
    pairs = int(cfg.get("near_tie_pairs", 0))
    if pairs:
        out_w = leaves[1]
        eps = float(cfg["near_tie_eps"])
        for k in range(1, pairs + 1):
            out_w[:, 2 * k] = out_w[:, 2 * k - 1] * (1.0 + eps)
    return leaves


def unflatten(cfg: dict, leaves: List[Any]) -> Dict[str, Any]:
    """The program's parameter tree from flat leaves."""
    it = iter(zip(leaf_names(cfg), leaves))
    tree: Dict[str, Any] = {}
    dirs = 2 if int(cfg["bidirectional"]) else 1
    tree["out_b"] = next(it)[1]
    tree["out_w"] = next(it)[1]
    tree["rnn"] = []
    for _ in range(int(cfg["num_layers"])):
        layer = {"dirs": []}
        for _ in range(dirs):
            d = {}
            for key in ("b", "w_h", "w_x"):
                d[key] = next(it)[1]
            layer["dirs"].append(d)
        tree["rnn"].append(layer)
    return tree


def flatten(tree: Dict[str, Any]) -> List[Any]:
    out = [tree["out_b"], tree["out_w"]]
    for layer in tree["rnn"]:
        for d in layer["dirs"]:
            out += [d["b"], d["w_h"], d["w_x"]]
    return out
