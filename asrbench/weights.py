"""The model's weights, made from the seed on the device.

The benchmark makes the weights the program starts from, and the
reference makes the same ones again: the configuration's family
(``families``) lists the leaves and draws them from one
``torch.Generator`` on the device, seeded with the run's seed.  The tree
is the program's layout, each leaf named by its path
(``rnn.0.dirs.1.w_x``: dict keys and list indices), and its leaves are
numbered in ``jax.tree_util`` order (dict keys sorted, lists in order),
as the program's checkpoints and model files number them.  Torch only:
nothing here imports the program.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from asrbench import families

__all__ = ["param_shapes", "make_params", "flatten", "leaf_names",
           "unflatten"]


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, in flatten order."""
    return families.of(cfg).param_shapes(cfg)


def leaf_names(cfg: dict) -> List[str]:
    return [n for n, _ in param_shapes(cfg)]


def make_params(cfg: dict, seed: int, device) -> List[torch.Tensor]:
    """The flat leaves from the seed, f32 on ``device``."""
    return families.of(cfg).make_params(cfg, seed, device)


def unflatten(cfg: dict, leaves: List[Any]) -> Dict[str, Any]:
    """The program's parameter tree from flat leaves: each name's parts
    are dict keys, or list indices where they are digits."""
    tree: Dict[str, Any] = {}
    for name, leaf in zip(leaf_names(cfg), leaves):
        parts = name.split(".")
        node: Any = tree
        for key, below in zip(parts, parts[1:]):
            child = [] if below.isdigit() else {}
            if isinstance(node, list):
                if int(key) == len(node):
                    node.append(child)
                node = node[int(key)]
            else:
                node = node.setdefault(key, child)
        if isinstance(node, list):
            node.append(leaf)
        else:
            node[parts[-1]] = leaf
    return tree


def flatten(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts and lists, in ``jax.tree_util``
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [tree]
