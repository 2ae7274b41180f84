"""Parameter trees across the two packages.

The port keeps the JAX package's parameter tree (nested dicts and lists)
with torch tensors as leaves.  :func:`tree_flatten` reproduces the leaf
order of ``jax.tree_util.tree_flatten`` — dict keys sorted, lists and
tuples in order — without importing jax.  That order numbers the leaves
of every ``.npz`` artifact and checkpoint, and many leaves share a shape
(``w_h`` of both directions, ``w_x`` of layers >= 1), so a wrong order
would load with no error and silently swap weights (hazard F3).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

import numpy as np
import torch

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "from_jax_params",
           "to_jax_params", "train_state_from_jax", "train_state_to_jax"]


def _is_seq(x) -> bool:
    # a torch.Size is a shape leaf (the templates of models.acoustic)
    return isinstance(x, (list, tuple)) and not isinstance(x, torch.Size)


def tree_flatten(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util`` order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if _is_seq(tree):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild ``template``'s structure from leaves in flatten order."""
    n = len(tree_flatten(template))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a template of {n}")
    it: Iterator[Any] = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            # fill in sorted-key order, keep the template's key order
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if _is_seq(node):
            values = [build(v) for v in node]
            # a NamedTuple (TrainState) takes its fields as arguments
            return (type(node)(*values) if hasattr(node, "_fields")
                    else type(node)(values))
        return next(it)

    return build(template)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf by leaf, of the trees
    in ``rest`` (which share its structure), as ``jax.tree_util``."""
    return tree_unflatten(tree, [fn(*leaves) for leaves in zip(
        tree_flatten(tree), *(tree_flatten(r) for r in rest))])


def from_jax_params(tree: Any, device="cpu") -> Any:
    """A JAX parameter tree (numpy or jax arrays as leaves) → the port's
    tree of float32 torch tensors on ``device`` (copies: the port owns
    its parameters)."""
    return tree_map(lambda a: torch.tensor(
        np.asarray(a, dtype=np.float32), device=device), tree)


def to_jax_params(tree: Any) -> Any:
    """The port's tree → the same tree of float32 numpy arrays, ready for
    ``jnp.asarray`` on the JAX side."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    tree)


def _ng_from_jax(ng: Any, device) -> Any:
    """JAX ``NgState`` leaves (w, rho, d f32; t int32) → the port's
    ``NgState``s, the counter kept int32."""
    if not ng:
        return ng
    from kaldi_ctc_tpu_torch.training.natural_gradient import NgState
    return {name: {side: NgState(
        w=torch.tensor(np.asarray(s.w, np.float32), device=device),
        rho=torch.tensor(np.asarray(s.rho, np.float32), device=device),
        d=torch.tensor(np.asarray(s.d, np.float32), device=device),
        t=torch.tensor(np.asarray(s.t, np.int32), device=device))
        for side, s in layer.items()} for name, layer in ng.items()}


def train_state_from_jax(state: Any, device="cpu"):
    """A JAX ``TrainState`` (its ``params``, ``velocity``, ``step`` and
    natural-gradient states ``ng``, numpy or jax arrays as leaves) → the
    port's ``training.train.TrainState`` on ``device``."""
    from kaldi_ctc_tpu_torch.training.train import TrainState
    return TrainState(params=from_jax_params(state.params, device),
                      velocity=from_jax_params(state.velocity, device),
                      step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=device),
                      ng=_ng_from_jax(getattr(state, "ng", None), device))


def train_state_to_jax(state: Any) -> dict:
    """The port's ``TrainState`` → ``dict(params, velocity, step)`` of
    numpy arrays, the fields of a JAX ``TrainState``
    (``TrainState(**d)`` on the JAX side).  With natural-gradient states
    it adds ``ng``: per layer and side a dict of the ``NgState`` fields
    (``NgState(**s)`` on the JAX side; ``t`` int32)."""
    out = {"params": to_jax_params(state.params),
           "velocity": to_jax_params(state.velocity),
           "step": np.asarray(int(state.step), dtype=np.int32)}
    if state.ng:
        out["ng"] = {name: {side: {
            f: getattr(s, f).detach().cpu().numpy() for f in s._fields}
            for side, s in layer.items()} for name, layer in state.ng.items()}
    return out
