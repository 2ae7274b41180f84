"""CTC loss: log-space alpha-beta over the blank-interleaved label lattice.

Counterpart of ``kaldi_ctc_tpu/ops/ctc.py``, with its contract: pre-softmax
activations [B, T, A] batch-major, blank = 0, per-utterance negative
log-likelihood, and d(loss)/d(activations) directly (the trainer
minimises).  Utterances where T < 2L+1 have zero probability: their
loss and gradient are 0 (feasibility is log Z > -5e29, hazard F4).

The recursions are ``ops/ctc_cuda.py``: kernel K1 (fused alpha + beta)
for a gradient on the card, K11 (alpha alone) for a loss without a
gradient, and their plain loops on the CPU.  The gradient is assembled
after the sweep in plain torch, as the JAX package assembles it in XLA:
state posteriors, their masks, and a one-hot product onto the alphabet
at full f32.  ``ctc_viterbi_align``, the forced alignment through the same
lattice, is a loop of torch ops a frame on the logits' device, as the JAX
package's is a ``lax.scan`` with no kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kaldi_ctc_tpu_torch.ops import ctc_cuda
from kaldi_ctc_tpu_torch.ops.ctc_cuda import NEG_INF, logaddexp

__all__ = ["ctc_loss", "ctc_loss_and_grad", "extend_labels",
           "greedy_collapse", "ctc_loss_forward_only", "ctc_viterbi_align"]


def extend_labels(labels: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """[B, L] labels → [B, 2L+1] blank-interleaved extended sequence:
    ext[2i] = blank, ext[2i+1] = labels[i]."""
    b, l = labels.shape
    ext = labels.new_full((b, 2 * l + 1), blank)
    ext[:, 1::2] = labels
    return ext


def _transition_masks(ext: torch.Tensor, blank: int) -> torch.Tensor:
    """Mask [B, S] of states allowed to take the s-2 (skip) transition."""
    # pad-then-slice stays [B, S] even when S < 2 (empty label batches)
    s2 = torch.cat([ext.new_full((ext.shape[0], 2), -1), ext],
                   dim=1)[:, :ext.shape[1]]
    return (ext != blank) & (ext != s2)


def _log_z(final_alpha: torch.Tensor,
           label_lens: torch.Tensor) -> torch.Tensor:
    """logsumexp of the two terminal states S-1 = 2L, S-2 = 2L-1."""
    idx_last = (2 * label_lens).long()[:, None]
    a_last = final_alpha.gather(1, idx_last)[:, 0]
    a_prev = final_alpha.gather(1, (idx_last - 1).clamp_min(0))[:, 0]
    a_prev = torch.where(label_lens > 0, a_prev, NEG_INF)
    return logaddexp(a_last, a_prev)


def _skip_down(skip_ok: torch.Tensor) -> torch.Tensor:
    """Mask [B, S] of states allowed to take the s -> s+2 transition of
    the beta recursion: skip_ok at s+2."""
    b, s_max = skip_ok.shape
    return torch.cat([skip_ok[:, 2:], skip_ok.new_zeros((b, 2))],
                     dim=1)[:, :s_max].contiguous()


def _lattice(logits, labels, blank):
    """log_probs [B, T, A], ext [B, S], skip_ok [B, S] and the gathered
    label log-probs lp_ext_t [T, B, S] (contiguous, for the kernels)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    ext = extend_labels(labels, blank)
    skip_ok = _transition_masks(ext, blank)
    lp_ext = log_probs.gather(
        2, ext.long()[:, None, :].expand(-1, log_probs.shape[1], -1))
    return log_probs, ext, skip_ok, lp_ext.transpose(0, 1).contiguous()


def _ctc_forward(logits, labels, input_lens, label_lens, blank,
                 forward_alphas):
    _, _, skip_ok, lp_ext_t = _lattice(logits, labels, blank)
    alphas = forward_alphas(lp_ext_t, skip_ok, input_lens)
    log_z = _log_z(alphas[-1], label_lens)
    # infeasible (zero-probability) utterances are masked to 0
    return torch.where(log_z > 0.5 * NEG_INF, -log_z, 0.0)


def ctc_loss_and_grad(
    logits: torch.Tensor, labels: torch.Tensor, input_lens: torch.Tensor,
    label_lens: torch.Tensor, blank: int = 0, implementation: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loss [B] and d(loss)/d(logits) [B, T, A] f32 via the alpha-beta
    sweep:  softmax(logit)[t,a] - (1/Z) Σ_{s: ext[s]=a}
    exp(alpha[t,s] + beta[t,s] - lp[t,a]).

    implementation: "fused" (one sweep, K1 on the card), "separate" (the
    alpha and beta recursions one after the other, K11 and K12 on the
    card; the JAX package's "xla"), or "auto" (fused on the card,
    separate on the CPU).  On a CPU tensor every choice runs the plain
    loops.
    """
    if implementation == "auto":
        implementation = "fused" if logits.is_cuda else "separate"
    if implementation not in ("fused", "separate"):
        raise ValueError(f"ctc_loss_and_grad: unknown implementation "
                         f"{implementation!r}")
    b, t_max, a_dim = logits.shape
    log_probs, ext, skip_ok, lp_ext_t = _lattice(logits, labels, blank)
    s_max = ext.shape[1]
    skip_down = _skip_down(skip_ok)
    if implementation == "fused":
        alphas, betas = ctc_cuda.alpha_beta(lp_ext_t, skip_ok, skip_down,
                                            input_lens, label_lens)
    else:
        alphas = ctc_cuda.forward_alphas(lp_ext_t, skip_ok, input_lens)
        betas = ctc_cuda.backward_betas(lp_ext_t, skip_down, input_lens,
                                        label_lens)
    log_z = _log_z(alphas[-1], label_lens)

    # state posteriors: gamma = alpha + beta - lp (lp counted twice)
    gamma = alphas + betas - lp_ext_t                        # [T, B, S]
    post = torch.exp(torch.clamp_max(gamma - log_z[None, :, None], 0.0))
    dev = logits.device
    valid_t = (torch.arange(t_max, device=dev)[:, None, None]
               < input_lens.to(dev)[None, :, None])
    valid_s = (torch.arange(s_max, device=dev)[None, None, :]
               <= 2 * label_lens.to(dev)[None, :, None])
    post = torch.where(valid_t & valid_s, post, 0.0)
    # posteriors summed onto the alphabet as a batched product with a
    # one-hot of the extended labels, at full f32 (TF32 is off, F2)
    onehot = torch.nn.functional.one_hot(ext.long(), a_dim).float()
    label_post = torch.bmm(post.transpose(0, 1), onehot)    # [B, T, A]
    feasible = log_z > 0.5 * NEG_INF
    keep = feasible[:, None, None] & valid_t.transpose(0, 1)
    grad = torch.where(keep, torch.exp(log_probs) - label_post, 0.0)
    loss = torch.where(feasible, -log_z, 0.0)
    return loss, grad


class _CtcLoss(torch.autograd.Function):
    """``ctc_loss``'s custom VJP: with a gradient to take, the forward
    runs the alpha-beta sweep and keeps its gradient; the backward
    scales it by the loss cotangent.  Without one it runs alpha alone."""

    @staticmethod
    def forward(ctx, logits, labels, input_lens, label_lens, blank):
        if not ctx.needs_input_grad[0]:
            return _ctc_forward(logits, labels, input_lens, label_lens,
                                blank, ctc_cuda.forward_alphas)
        loss, grad = ctc_loss_and_grad(logits, labels, input_lens,
                                       label_lens, blank)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g[:, None, None], None, None, None, None


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lens: torch.Tensor, label_lens: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood [B] (0 for infeasible
    utterances where T < 2L+1).  logits [B, T, A] f32 pre-softmax,
    labels [B, L] padded ids in [1, A), input_lens / label_lens [B]."""
    return _CtcLoss.apply(logits, labels, input_lens, label_lens, blank)


def ctc_loss_forward_only(logits, labels, input_lens, label_lens, blank=0):
    """Loss through the plain alpha loop, differentiable by autograd:
    the independent check of the alpha-beta gradient."""
    return _ctc_forward(logits, labels, input_lens, label_lens, blank,
                        ctc_cuda.forward_alphas_reference)


def ctc_viterbi_align(logits: torch.Tensor, labels: torch.Tensor,
                      input_lens: torch.Tensor, label_lens: torch.Tensor,
                      blank: int = 0):
    """CTC forced alignment: the Viterbi path through the
    blank-interleaved label lattice the loss uses (the CTC-native
    realignment of ``steps/nnet2/align.sh`` + ``relabel_egs2.sh``).

    logits [B, T, A] pre-softmax; labels [B, L] padded ids in [1, A);
    input_lens, label_lens [B].  → (frame_labels [B, T] int32: the
    symbol each frame emits, blank at pad frames and on infeasible rows;
    path_logprob [B] f32; feasible [B] bool, False where no path exists,
    T < 2L+1 with repeats).  Log 0 is -1e30 (F4).  The recursion picks
    the first maximum of (stay, s-1, s-2), and the terminal state is 2L
    where its score is >= 2L-1's, as the JAX package's ``argmax`` and
    ``>=`` do.  It is a loop over frames in torch ops on the logits'
    device (a few small ops a frame: host-bound on the card), then a
    backtrace loop of one gather a frame.
    """
    dev = logits.device
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    b, t_max, _ = log_probs.shape
    ext = extend_labels(labels.to(dev), blank)                # [B, S]
    s_max = ext.shape[1]
    skip_ok = _transition_masks(ext, blank)
    lp_ext = log_probs.gather(
        2, ext.long()[:, None, :].expand(-1, t_max, -1))      # [B, T, S]
    input_lens = input_lens.to(dev)
    label_lens = label_lens.to(dev)
    neg = torch.full((b, 2), NEG_INF, device=dev)

    delta = torch.full((b, s_max), NEG_INF, device=dev)
    delta[:, :2] = lp_ext[:, 0, :2]
    bps = []                      # back-pointers, 0: stay, 1: s-1, 2: s-2
    for t in range(1, t_max):
        shift1 = torch.cat([neg[:, :1], delta[:, :-1]], dim=1)
        shift2 = torch.where(skip_ok, torch.cat([neg, delta], dim=1)
                             [:, :s_max], NEG_INF)
        best, choice = torch.stack([delta, shift1, shift2]).max(dim=0)
        active = (t < input_lens)[:, None]
        delta = torch.where(active, torch.clamp_min(best + lp_ext[:, t],
                                                    NEG_INF), delta)
        bps.append(torch.where(active, choice, 0))

    # terminal state: the better of 2L (trailing blank) and 2L-1
    idx_last = (2 * label_lens).long()
    d_last = delta.gather(1, idx_last[:, None])[:, 0]
    idx_prev = torch.clamp_min(idx_last - 1, 0)
    d_prev = delta.gather(1, idx_prev[:, None])[:, 0]
    d_prev = torch.where(label_lens > 0, d_prev, NEG_INF)
    s = torch.where(d_last >= d_prev, idx_last, idx_prev)
    path_logprob = torch.maximum(d_last, d_prev)
    feasible = path_logprob > 0.5 * NEG_INF

    # backtrace: s[t-1] = s[t] - bp[t, s[t]] while t-1 is a real frame
    states = [s]
    for t in range(t_max - 1, 0, -1):
        step_back = bps[t - 1].gather(1, s[:, None])[:, 0]
        s = torch.where(t < input_lens, s - step_back, s)
        states.append(s)
    states = torch.stack(states[::-1], dim=1)                 # [B, T]
    frame_labels = ext.long().gather(1, states)
    valid = (torch.arange(t_max, device=dev)[None, :] < input_lens[:, None])
    frame_labels = torch.where(valid & feasible[:, None], frame_labels,
                               blank).to(torch.int32)
    return frame_labels, path_logprob, feasible


def greedy_collapse(argmax_ids: torch.Tensor, input_lens: torch.Tensor,
                    blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse framewise argmax ids [B, T]: drop repeats, then blanks
    (ComputeTotAccuracy, ctc-nnet-update.cc:261-317) → (collapsed [B, T]
    padded with 0, lengths [B])."""
    b, t = argmax_ids.shape
    dev = argmax_ids.device
    prev = torch.cat([argmax_ids.new_full((b, 1), -1), argmax_ids[:, :-1]],
                     dim=1)
    in_range = (torch.arange(t, device=dev)[None, :]
                < input_lens.to(dev)[:, None])
    keep = (argmax_ids != prev) & (argmax_ids != blank) & in_range
    # stable compaction: position of each kept element in the output;
    # dropped ones go to the spare column t
    pos = torch.cumsum(keep, dim=1) - 1
    scatter_pos = torch.where(keep, pos, t)
    out = argmax_ids.new_zeros((b, t + 1))
    out.scatter_(1, scatter_pos, torch.where(keep, argmax_ids, 0))
    return out[:, :t], keep.sum(dim=1)
