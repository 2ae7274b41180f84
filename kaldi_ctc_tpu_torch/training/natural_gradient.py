"""Online natural-gradient (NG-SGD) preconditioning for affine layers.

Counterpart of ``kaldi_ctc_tpu/training/natural_gradient.py``: the
reference's ``NaturalGradientAffineComponent`` /
``AffineComponentPreconditionedOnline`` (``--affine-type natural``,
steps/ctc/nnet2/components.py:30-33) preconditions each affine update
with two low-rank-plus-identity approximations of the Fisher matrix, one
over the layer's input rows (bias column appended) and one over its
output-derivative rows, kept online by a power-method update
(src/nnet2/nnet-precondition-online.h:37-260; Povey et al., ICLR
workshop 2015).

State per preconditioner: ``W = E^{1/2} R`` [R, D] (R orthonormal rows),
``rho`` (identity floor), ``d`` [R] (low-rank eigenvalues), ``t`` (update
count, int32).  Per minibatch X [N, D]: ``X_hat = X - (X W^T) W``; the
state update runs an R x R symmetric eigendecomposition (R is 30-80).
It is plain torch on the parameters' device, as the JAX package's is
plain XLA.  Where the JAX package branches with ``lax.cond`` (update or
skip), this computes the update and selects on the device, so the
counter is never read back to the host.  ``torch.linalg.cholesky_ex``
stands for ``jnp.linalg.cholesky``, which returns NaN on a matrix that is
not positive definite: its ``info`` joins the finiteness guard.

R_0 is the first R rows of the identity with d = rho = epsilon (the JAX
package's documented deviation from the reference's first-minibatch
eigenvectors); the first 10 calls always update
(nnet-precondition-online.cc:327-329), later ones every
``update_period``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

__all__ = ["NgOptions", "NgState", "ng_init", "ng_precondition",
           "ng_affine_update"]

_EPS = 1.0e-10
_DELTA = 5.0e-04   # relative floor on rho/d (nnet-precondition-online.cc:27)


@dataclasses.dataclass(frozen=True)
class NgOptions:
    """Defaults = the reference's (nnet-component.cc:1684-1685,
    nnet-precondition-online.cc:28)."""

    rank_in: int = 30
    rank_out: int = 80
    update_period: int = 1
    num_samples_history: float = 2000.0
    alpha: float = 4.0


class NgState(NamedTuple):
    """Leaves flatten in field order (w, rho, d, t), as the JAX
    package's NamedTuple does in checkpoints."""

    w: torch.Tensor      # [R, D] = E^{1/2} R, f32
    rho: torch.Tensor    # scalar f32
    d: torch.Tensor      # [R] f32
    t: torch.Tensor      # scalar int32 update counter


def ng_init(dim: int, rank: int, alpha: float = 4.0,
            device="cpu") -> NgState:
    """Fresh preconditioner state for D=dim vectors (rank clipped to
    dim-1 as in nnet-component.cc:1626-1627).  W is the identity rows
    scaled by sqrt(e) at the d = rho = eps floor."""
    rank = min(rank, dim - 1)
    if rank <= 0:
        raise ValueError(f"rank must be positive (dim {dim})")
    r0 = torch.eye(rank, dim, dtype=torch.float32, device=device)
    beta0 = _EPS * (1.0 + alpha) + alpha * rank * _EPS / dim
    e0 = torch.tensor(1.0 / (beta0 / _EPS + 1.0), dtype=torch.float32)
    return NgState(w=torch.sqrt(e0).to(device) * r0,
                   rho=torch.tensor(_EPS, dtype=torch.float32, device=device),
                   d=torch.full((rank,), _EPS, dtype=torch.float32,
                                device=device),
                   t=torch.zeros((), dtype=torch.int32, device=device))


def _compute_e(d: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """e_i = 1/(beta/d_i + 1)  (eqn:tii)."""
    return 1.0 / (beta / d + 1.0)


def _updated(state: NgState, x: torch.Tensor, eta: torch.Tensor,
             tr_x2: torch.Tensor, j_t: torch.Tensor, k_t: torch.Tensor,
             l_t: torch.Tensor, e: torch.Tensor, alpha: float) -> NgState:
    """The state after a power-method update (eqns St..Zt)."""
    n, dim = x.shape
    r = state.w.shape[0]
    w, d_t, rho = state.w, state.d, state.rho
    ie = 1.0 / torch.sqrt(e)
    dr = d_t + rho
    iel = ie[:, None] * l_t * ie[None, :]
    # Z_t (eqn:Zt), R x R symmetric
    z = ((eta / n) ** 2 * (ie[:, None] * k_t * ie[None, :])
         + (eta / n) * (1.0 - eta) * (iel * dr[None, :] + dr[:, None] * iel)
         + (1.0 - eta) ** 2 * torch.diag(dr * dr))
    z = 0.5 * (z + z.T)
    # a non-finite batch must not make eigh raise: its update is
    # discarded by the train step's guard, as in the JAX package, where
    # eigh returns NaN
    z = torch.where(torch.isfinite(z), z, 0.0)
    c, u = torch.linalg.eigh(z)                  # ascending
    c = torch.flip(c, (0,))
    u = torch.flip(u, (1,))                      # sorted descending
    c_floor = (rho * (1.0 - eta)) ** 2
    need_reorth = c[0] > 1.0e6 * torch.clamp_min(c[-1], 1e-37)
    c = torch.maximum(c, c_floor)
    sqrt_c = torch.sqrt(torch.clamp_min(c, 1e-37))
    # rho_{t+1} (eqn:rhot1 expanded)
    rho1 = (eta / n * tr_x2 + (1.0 - eta) * (dim * rho + torch.sum(d_t))
            - torch.sum(sqrt_c)) / (dim - r)
    d1 = sqrt_c - rho1
    # positive floor keeps every e_i in (0, 1)
    # (nnet-precondition-online.cc:452-456)
    floor_val = torch.clamp_min(_DELTA * sqrt_c[0], _EPS)
    rho1 = torch.maximum(rho1, floor_val)
    d1 = torch.maximum(d1, floor_val)
    beta1 = rho1 * (1.0 + alpha) + alpha * torch.sum(d1) / dim
    sqrt_e1 = torch.sqrt(_compute_e(d1, beta1))
    # W_{t+1} = A B (ComputeWt1): A [R, R], B [R, D]
    a = ((eta / n) * (sqrt_e1[:, None] / sqrt_c[:, None]) * u.T
         * ie[None, :])
    b = j_t + ((1.0 - eta) * n / eta) * dr[:, None] * w
    w1 = a @ b
    # re-orthogonalize R_{t+1} when C_t was ill-conditioned
    # (nnet-precondition-online.h "* Keeping R_t orthogonal *")
    inv_sqrt_e1 = 1.0 / sqrt_e1
    o = (inv_sqrt_e1[:, None] * (w1 @ w1.T)) * inv_sqrt_e1[None, :]
    chol, info = torch.linalg.cholesky_ex(
        o + 1e-12 * torch.eye(r, dtype=o.dtype, device=o.device))
    m = torch.linalg.solve_triangular(chol, torch.diag(inv_sqrt_e1),
                                      upper=False)
    w_fixed = (sqrt_e1[:, None] * m) @ w1
    ok = (info == 0) & torch.all(torch.isfinite(w_fixed))
    w1 = torch.where(need_reorth & ok, w_fixed, w1)
    return NgState(w=w1, rho=rho1, d=d1, t=state.t + 1)


def ng_precondition(state: NgState, x: torch.Tensor, opts: NgOptions
                    ) -> Tuple[torch.Tensor, torch.Tensor, NgState]:
    """→ (x_bar [N, D] preconditioned and renormalized, scale gamma,
    new_state).  x_bar = gamma * (x - x W^T W); x is taken in f32 (a
    bf16 x holds values that f32 represents exactly, as JAX's promotion
    against the f32 state does)."""
    x = x.float()
    n, dim = x.shape
    alpha = opts.alpha
    eta = torch.clamp_max(1.0 - torch.exp(torch.tensor(
        -n / opts.num_samples_history, dtype=torch.float32,
        device=x.device)), 0.9)
    w, d_t, rho = state.w, state.d, state.rho
    beta = rho * (1.0 + alpha) + alpha * torch.sum(d_t) / dim
    e = _compute_e(d_t, beta)

    h = x @ w.T                                  # [N, R]
    x_hat = x - h @ w
    tr_xhat2 = torch.sum(x_hat * x_hat)
    j_t = h.T @ x                                # [R, D]
    k_t = j_t @ j_t.T                            # [R, R]
    l_t = h.T @ h                                # [R, R]
    # tr(X X^T) = tr(Xhat Xhat^T) - tr(L E) + 2 tr(L)   (W W^T = E)
    diag_l = torch.diagonal(l_t)
    tr_x2 = tr_xhat2 - torch.sum(diag_l * e) + 2.0 * torch.sum(diag_l)
    gamma = torch.where(tr_xhat2 > 0.0, torch.sqrt(
        tr_x2 / torch.clamp_min(tr_xhat2, 1e-37)), 1.0)

    new = _updated(state, x, eta, tr_x2, j_t, k_t, l_t, e, alpha)
    # always update for the first 10 calls, then every update_period
    # (nnet-precondition-online.cc:327-329); selected on the device
    period = max(opts.update_period, 1)
    do_update = (state.t < 10) | (state.t % period == 0)
    new_state = NgState(*(torch.where(do_update, a, b) for a, b in zip(
        new, state._replace(t=state.t + 1))))
    return gamma * x_hat, gamma, new_state


def ng_affine_update(ng_in: NgState, ng_out: NgState, x: torch.Tensor,
                     dy: torch.Tensor, opts: NgOptions
                     ) -> Tuple[torch.Tensor, torch.Tensor, NgState, NgState]:
    """→ (grad_w [D_in, D_out], grad_b [D_out], ng_in', ng_out').

    AffineComponentPreconditionedOnline::Update: a 1.0 bias column
    appended to the input rows x [N, D_in], inputs and output derivatives
    dy [N, D_out] preconditioned independently, the update formed from
    the preconditioned factors in the [in, out] weight layout."""
    x = x.float()
    x_ext = torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)
    x_bar, _, ng_in = ng_precondition(ng_in, x_ext, opts)
    dy_bar, _, ng_out = ng_precondition(ng_out, dy, opts)
    grad_w = x_bar[:, :-1].T @ dy_bar
    grad_b = x_bar[:, -1] @ dy_bar
    return grad_w, grad_b, ng_in, ng_out
