"""Training: the CTC train step and the outer-loop pieces.

Counterpart of ``kaldi_ctc_tpu/training/train.py`` (the reference's
NnetCtcUpdater, ``ctc/ctc-nnet-update.cc:76-348``):

- one step: forward recurrent stack → CTC alpha-beta loss + gradient →
  backprop → elementwise gradient clip ±5 (cuDNN component clip,
  ``nnet-cudnn-component.cc:602-603``) → SGD with optional momentum;
- SGD on gradient *sums* over the minibatch (no 1/B), scaled by
  ``objective_scale``;
- exponential lr decay ``lr(x) = lr_i * exp(x*log(lr_f/lr_i)/num_steps)``
  (``steps/ctc/train.sh:352``) after an optional linear warmup;
- greedy-collapse label accuracy (``ctc/ctc-nnet-update.cc:261-317``):
  argmax and collapse on the device, Levenshtein on the host;
- ``affine_type="natural"``: the output affine's and the FT front's
  gradients replaced by online NG-SGD updates
  (``training/natural_gradient.py``) formed from the layers' input rows
  and their pre-activation gradients, taken from autograd on those
  tensors (the JAX package's zero probes);
- dropout after the stack (training only) with a mask drawn by
  :func:`dropout_mask`;
- batch norms (DeepSpeech2 as deepspeech.pytorch builds it): the step
  normalises by the batch's statistics and moves the running statistics
  in ``TrainState.stats``; the eval step normalises by those.

On the card the step runs, for each layer, the forward and backward
kernels of its mode: K2 and K3 (BLSTM), K5 and K6 (unidirectional LSTM),
K8a and K8b (BiGRU), K9a and K9b (unidirectional GRU); and K1 for the
loss (K11 in the eval step).  On the CPU their plain versions.  PyTorch
runs eagerly: there is no jit, and ``make_train_step`` returns the step
as it is (no buffers are donated).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from kaldi_ctc_tpu_torch.models.acoustic import (AmConfig, am_forward,
                                                 am_param_shapes)
from kaldi_ctc_tpu_torch.ops.ctc import ctc_loss, greedy_collapse
from kaldi_ctc_tpu_torch.params import tree_flatten, tree_map, tree_unflatten
from kaldi_ctc_tpu_torch.utils.edit_distance import batch_edit_distance

__all__ = ["TrainOptions", "exponential_lr", "build_train_step",
           "make_train_step", "make_eval_step", "accuracy_from_outputs",
           "TrainState", "init_train_state", "dropout_mask",
           "shard_train_state", "whole_params"]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """Mirror of the reference's trainer knobs (ctc/ctc-nnet-train.h:33-66,
    steps/ctc/train.sh:7-116); field for field the JAX package's."""

    initial_learning_rate: float = 5e-4
    final_learning_rate: float = 1e-5
    num_steps: int = 10000          # decay horizon (num_iters analogue)
    momentum: float = 0.0
    clip_elementwise: float = 5.0   # cudnn component clip ±5
    clip_norm: float = 0.0          # optional global-norm clip (0 = off)
    objective_scale: float = 1.0    # 1/num_data_shards for parity
    # NaN/Inf guard (ctc-nnet-update.cc:232-234,254): the update is
    # suppressed when loss or grad norm is non-finite; the training loop
    # reads the "finite" metric.  False removes the select.
    guard_nonfinite: bool = True
    # "simple" (plain SGD) or "natural" (online NG-SGD preconditioning
    # of the affine updates, --affine-type natural)
    affine_type: str = "simple"
    ng_rank_in: int = 30
    ng_rank_out: int = 80
    ng_update_period: int = 1
    ng_num_samples_history: float = 2000.0
    ng_alpha: float = 4.0
    # linear lr warmup over this many steps before the exponential decay
    # (0 = off, the reference schedule)
    warmup_steps: int = 0


class TrainState(NamedTuple):
    params: Any
    velocity: Any
    step: torch.Tensor              # int32 scalar on the params' device
    # natural-gradient states: {"out": {"in": NgState, "out": NgState}}
    # and "front" with an FT front; None for plain affine (no leaves)
    ng: Any = None
    # the batch norms' running statistics (models.acoustic.
    # init_norm_stats); None or empty for a model with none (no leaves)
    stats: Any = None


def _device(params: Any) -> torch.device:
    return tree_flatten(params)[0].device


def init_train_state(params: Any, opts: "TrainOptions" = None,
                     stats: Any = None) -> TrainState:
    device = _device(params)
    ng = None
    if opts is not None and opts.affine_type == "natural":
        from kaldi_ctc_tpu_torch.training.natural_gradient import ng_init
        ng = {}
        for name in ("front", "out"):
            w = params.get(f"{name}_w")
            if w is None:
                continue
            d_in, d_out = int(w.shape[0]), int(w.shape[1])
            ng[name] = {
                "in": ng_init(d_in + 1, opts.ng_rank_in, opts.ng_alpha,
                              device),
                "out": ng_init(d_out, opts.ng_rank_out, opts.ng_alpha,
                               device)}
    return TrainState(params=params,
                      velocity=tree_map(torch.zeros_like, params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      ng=ng, stats=stats)


def dropout_mask(step: int, keep: float, shape, device) -> torch.Tensor:
    """The keep mask (bool, True with probability ``keep``) of training
    step ``step``: uniform draws from a ``torch.Generator`` on ``device``
    seeded with the step, so a step's mask is the same on a resumed run.
    JAX draws ``bernoulli(fold_in(PRNGKey(0), step))``, other bits: the
    masks differ between the packages (ROADMAP §3)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(step))
    return torch.rand(shape, generator=gen, device=device) < keep


def exponential_lr(opts: TrainOptions, step: torch.Tensor) -> torch.Tensor:
    """lr(x) = lr_i * exp(x * log(lr_f/lr_i) / num_steps) (train.sh:352),
    optionally preceded by a linear warmup ramp (warmup_steps > 0); an
    f32 scalar tensor on step's device."""
    ratio = math.log(opts.final_learning_rate / opts.initial_learning_rate)
    x = torch.as_tensor(step).to(torch.float32)
    lr = opts.initial_learning_rate * torch.exp(
        x * (ratio / max(opts.num_steps, 1)))
    if opts.warmup_steps > 0:
        w = (x + 1.0) / float(opts.warmup_steps)
        lr = lr * torch.clamp_max(w, 1.0)
    return lr


def _clip_tree(grads: Any, opts: TrainOptions) -> Any:
    if opts.clip_elementwise > 0:
        c = opts.clip_elementwise
        grads = tree_map(lambda g: torch.clamp(g, -c, c), grads)
    if opts.clip_norm > 0:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_flatten(grads)))
        scale = torch.clamp_max(
            opts.clip_norm / torch.clamp_min(norm, 1e-20), 1.0)
        grads = tree_map(lambda g: g * scale, grads)
    return grads


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _model_axis(mesh) -> bool:
    return mesh is not None and mesh.model > 1


def _split_dims(cfg: AmConfig, mesh) -> list:
    """The dim of each parameter leaf (flatten order) that the mesh's
    model axis splits, or None."""
    from kaldi_ctc_tpu_torch.parallel.mesh import split_dims
    return split_dims(mesh, am_param_shapes(cfg))


def shard_train_state(state: TrainState, cfg: AmConfig, mesh) -> TrainState:
    """This rank's train state from the whole one: its slices of the
    parameters and velocities that the mesh's model axis splits; the NG
    states stay replicated.  The identity without a model axis."""
    if not _model_axis(mesh):
        return state
    from kaldi_ctc_tpu_torch.parallel.mesh import local_slices
    dims = _split_dims(cfg, mesh)
    return state._replace(
        params=tree_unflatten(state.params, local_slices(
            mesh, tree_flatten(state.params), dims)),
        velocity=tree_unflatten(state.velocity, local_slices(
            mesh, tree_flatten(state.velocity), dims)))


def whole_params(params: Any, cfg: AmConfig, mesh) -> Any:
    """The whole parameters from this rank's slices (an all-gather over
    the model group); ``params`` as they are without a model axis."""
    if not _model_axis(mesh):
        return params
    from kaldi_ctc_tpu_torch.parallel.mesh import gather_model
    return tree_unflatten(params, gather_model(
        mesh, tree_flatten(params), _split_dims(cfg, mesh)))


def build_train_step(cfg: AmConfig, opts: TrainOptions, mesh=None):
    """The train step: ``state, metrics = step(state, batch)``.

    batch: feats [B, T, D] f32, labels [B, L], input_lens [B],
    label_lens [B] (torch tensors or numpy arrays; moved to the params'
    device).  metrics: scalars as tensors on the device, plus the
    greedy hypotheses (``hyp_ids``, ``hyp_lens``) for host-side
    accuracy.  Nothing is read back to the host, but for the step
    number that seeds a dropout mask (with ``cfg.dropout > 0``).

    ``mesh`` (``parallel.make_mesh``): with no mesh, or a mesh with no
    process group, the step runs alone.  Otherwise each process gives
    its own rows (its shard of the global batch, the same shape on every
    rank) and the step computes what the JAX package's step computes on
    the global batch:

    - the gradient is the SUM of the ranks' gradients over the data
      group (the loss is ``sum(losses) * objective_scale``, not a mean);
    - the clips, ``grad_norm`` and ``finite`` read the summed gradient
      and the summed loss, so every rank applies or skips one update;
    - ``loss_total``, ``num_frames`` and ``loss_per_frame`` cover the
      global batch (``hyp_ids`` stay this rank's rows);
    - NG-SGD preconditions with the rows of the global batch, gathered
      over the data group in JAX's row order, so every rank holds the
      same NG states;
    - a dropout mask is drawn at the global batch's shape and each rank
      takes its own columns;
    - with a model axis, ``state`` holds this rank's slices of the split
      leaves (``shard_train_state``); the step all-gathers the whole
      leaves for the forward and updates its own slices.
    """
    use_ng = opts.affine_type == "natural"
    if use_ng:
        from kaldi_ctc_tpu_torch.training.natural_gradient import (
            NgOptions, ng_affine_update)
        ng_opts = NgOptions(
            rank_in=opts.ng_rank_in, rank_out=opts.ng_rank_out,
            update_period=opts.ng_update_period,
            num_samples_history=opts.ng_num_samples_history,
            alpha=opts.ng_alpha)
    ng_layers = [name for name in ("out", "front")
                 if use_ng and (name == "out" or cfg.front_affine_dim)]
    spmd = mesh is not None and mesh.distributed
    norms = bool(cfg.norm_widths())
    if norms and (use_ng or (spmd and mesh.data > 1)):
        raise ValueError("batch norm takes neither NG-SGD nor a data group "
                         "of several processes")
    if spmd:
        from kaldi_ctc_tpu_torch.parallel.mesh import (gather_over_data,
                                                       sum_over_data)
    dims = _split_dims(cfg, mesh) if _model_axis(mesh) else None
    # the leaves NG-SGD replaces: formed from the global rows, so they
    # are the same on every rank and are not summed again
    ng_leaves = {f"{name}_{wb}" for name in ng_layers for wb in "wb"}
    shapes, summed, at = am_param_shapes(cfg), [], 0
    for k in sorted(shapes):      # flatten order: top-level keys sorted
        n = len(tree_flatten(shapes[k]))
        if k not in ng_leaves:
            summed += range(at, at + n)
        at += n

    def train_step(state: TrainState, batch: Dict[str, Any]):
        batch = _on(batch, state.step.device)
        whole = tree_flatten(whole_params(state.params, cfg, mesh))
        leaves = [p.detach().requires_grad_(True) for p in whole]
        params = tree_unflatten(state.params, leaves)
        out_lens = cfg.output_lens(batch["input_lens"])
        mask = None
        if cfg.dropout > 0.0:
            b, t = batch["feats"].shape[:2]
            data = mesh.data if spmd else 1
            mask = dropout_mask(int(state.step), 1.0 - cfg.dropout,
                                (cfg.output_lens(t), b * data,
                                 cfg.rnn.output_dim), state.step.device)
            if data > 1:
                mask = mask[:, mesh.data_index * b:(mesh.data_index + 1) * b]
        taps = {} if use_ng else None
        new_stats = [] if norms else None
        with torch.enable_grad():
            logits = am_forward(params, batch["feats"], cfg,
                                input_lens=batch["input_lens"],
                                dropout_mask=mask, taps=taps,
                                stats=state.stats, new_stats=new_stats)
            losses = ctc_loss(logits, batch["labels"], out_lens,
                              batch["label_lens"])
            total = torch.sum(losses) * opts.objective_scale
        # with NG-SGD, the gradients of the affine pre-activations too:
        # the JAX package's zero-probe gradients, [T'*B, A] for the output
        # affine (time-major rows) and [T, B, F] for the front
        pre = [taps[f"{name}_pre"] for name in ng_layers]
        all_grads = torch.autograd.grad(total, leaves + pre)
        grad_leaves = list(all_grads[:len(leaves)])
        new_ng = state.ng
        with torch.no_grad():
            losses = losses.detach()
            loss_sum = torch.sum(losses)
            num_frames = torch.sum(out_lens)
            if spmd:
                # one all-reduce on one flat f32 buffer over the data
                # group: the summed leaves' gradients, the loss sum and
                # the frame count (exact in f32 below 2^24 frames)
                reduced = sum_over_data(
                    mesh, [grad_leaves[i] for i in summed]
                    + [loss_sum, num_frames.to(torch.float32)])
                for i, g in zip(summed, reduced):
                    grad_leaves[i] = g
                loss_sum = reduced[-2]
                num_frames = torch.round(reduced[-1]).to(num_frames.dtype)
            grads = tree_unflatten(state.params, grad_leaves)
            if use_ng:
                new_ng = dict(state.ng)
                for name, dy in zip(ng_layers, all_grads[len(leaves):]):
                    x = taps[f"{name}_in"].detach().float()
                    dy = dy.reshape(x.shape[:-1] + dy.shape[-1:])
                    if spmd:
                        # the global batch's rows, in JAX's order: gather
                        # [T, B_local, .] along the batch dim, then flatten
                        x = gather_over_data(mesh, x, 1)
                        dy = gather_over_data(mesh, dy, 1)
                    gw, gb, s_in, s_out = ng_affine_update(
                        state.ng[name]["in"], state.ng[name]["out"],
                        x.reshape(-1, x.shape[-1]),
                        dy.reshape(-1, dy.shape[-1]), ng_opts)
                    grads[f"{name}_w"], grads[f"{name}_b"] = gw, gb
                    new_ng[name] = {"in": s_in, "out": s_out}
            grads = _clip_tree(grads, opts)
            lr = exponential_lr(opts, state.step)
            grad_norm = torch.sqrt(sum(torch.sum(g * g)
                                       for g in tree_flatten(grads)))
            # elementwise clip keeps NaN NaN, so grad_norm still sees it
            finite = torch.isfinite(loss_sum) & torch.isfinite(grad_norm)
            if dims is not None:
                from kaldi_ctc_tpu_torch.parallel.mesh import local_slices
                grads = tree_unflatten(state.params, local_slices(
                    mesh, tree_flatten(grads), dims))
            if opts.momentum > 0:
                velocity = tree_map(lambda v, g: opts.momentum * v + g,
                                    state.velocity, grads)
            else:
                velocity = grads
            if opts.guard_nonfinite:
                # a poisoned batch leaves params AND velocity as they were
                # (a NaN velocity would re-poison every later step)
                params = tree_map(
                    lambda p, v: torch.where(finite, p - lr * v, p),
                    state.params, velocity)
                velocity = tree_map(
                    lambda v_new, v_old: torch.where(finite, v_new, v_old),
                    velocity, state.velocity)
                if use_ng:
                    # nor the preconditioners
                    new_ng = tree_map(lambda n, o: torch.where(finite, n, o),
                                      new_ng, state.ng)
                if norms:
                    # nor the running statistics
                    new_stats = tree_map(
                        lambda n, o: torch.where(finite, n, o), new_stats,
                        state.stats)
            else:
                params = tree_map(lambda p, v: p - lr * v, state.params,
                                  velocity)
            new_state = TrainState(
                params=params,
                velocity=velocity if opts.momentum > 0 else state.velocity,
                step=state.step + 1, ng=new_ng,
                stats=new_stats if norms else state.stats)
            hyp_ids, hyp_lens = greedy_collapse(
                torch.argmax(logits.detach(), dim=-1), out_lens)
            metrics = {
                "loss_total": loss_sum,
                "loss_per_frame": loss_sum / num_frames.float(),
                "num_frames": num_frames,
                "lr": lr,
                "grad_norm": grad_norm,
                "finite": finite,
                "hyp_ids": hyp_ids,
                "hyp_lens": hyp_lens,
            }
        return new_state, metrics

    return train_step


def make_train_step(cfg: AmConfig, opts: TrainOptions, mesh=None):
    """The train step to call in a loop: :func:`build_train_step`'s, as
    it is (PyTorch runs eagerly; no state is donated)."""
    return build_train_step(cfg, opts, mesh)


def make_eval_step(cfg: AmConfig, mesh=None):
    """Diagnostic objf/accuracy pass (nnet2-ctc-compute-prob analogue):
    no gradient, so the loss takes the alpha recursion alone.  With a
    process group in ``mesh``, ``loss_total`` and ``num_frames`` are
    summed over the data group (``hyp_ids`` stay this rank's rows), and
    ``params`` are this rank's slices where a model axis splits them.
    ``stats``: the running statistics of a model with batch norms."""
    spmd = mesh is not None and mesh.distributed

    def eval_step(params, batch, stats=None):
        batch = _on(batch, _device(params))
        with torch.no_grad():
            params = whole_params(params, cfg, mesh)
            logits = am_forward(params, batch["feats"], cfg,
                                input_lens=batch["input_lens"], stats=stats)
            out_lens = cfg.output_lens(batch["input_lens"])
            losses = ctc_loss(logits, batch["labels"], out_lens,
                              batch["label_lens"])
            hyp_ids, hyp_lens = greedy_collapse(
                torch.argmax(logits, dim=-1), out_lens)
            loss_total = torch.sum(losses)
            num_frames = torch.sum(out_lens)
            if spmd:
                from kaldi_ctc_tpu_torch.parallel.mesh import sum_over_data
                loss_total, frames = sum_over_data(
                    mesh, [loss_total, num_frames.to(torch.float32)])
                num_frames = torch.round(frames).to(num_frames.dtype)
        return {
            "loss_total": loss_total,
            "num_frames": num_frames,
            "hyp_ids": hyp_ids,
            "hyp_lens": hyp_lens,
        }

    return eval_step


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy_from_outputs(
    metrics: Dict[str, Any],
    labels: np.ndarray,
    label_lens: np.ndarray,
) -> Tuple[float, int, int]:
    """Greedy-collapse label accuracy = 1 - edit_distance/ref_len.

    Host-side Levenshtein over the device-computed collapsed hypotheses
    (ComputeTotAccuracy, ctc-nnet-update.cc:261-317).
    Returns (accuracy, total_errors, total_ref_len).
    """
    dists, ref_lens = batch_edit_distance(
        _numpy(labels), _numpy(label_lens), _numpy(metrics["hyp_ids"]),
        _numpy(metrics["hyp_lens"]))
    total_err = int(dists.sum())
    total_ref = int(ref_lens.sum())
    acc = 1.0 - total_err / max(total_ref, 1)
    return acc, total_err, total_ref
