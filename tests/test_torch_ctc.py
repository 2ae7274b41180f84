"""The port's CTC (``kaldi_ctc_tpu_torch/ops/ctc.py`` and the plain
versions of kernels K1, K11, K12 in ``ops/ctc_cuda.py``) held to the JAX
package's: the recursions against the Pallas kernels in interpret mode,
the loss and gradient against ``ctc_loss_and_grad`` on the cases of
``tests/test_ctc_pallas.py``.  Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_ctc_tpu.ops import ctc as jctc
from kaldi_ctc_tpu.ops import ctc_pallas
from kaldi_ctc_tpu_torch.ops import ctc as tctc
from kaldi_ctc_tpu_torch.ops import ctc_cuda

# Loss and gradient: the tolerances the JAX package holds its Pallas
# sweep to against its XLA scan (tests/test_ctc_pallas.py): the same f32
# log-space sums, with exp/log1p from another library.
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Raw alphas/betas are log-probabilities that grow to ~-100 over T steps;
# one f32 ulp there is ~8e-6, compounded over T steps.
LATTICE_RTOL, LATTICE_ATOL = 1e-6, 1e-4


def _random_case(seed, b=6, t=24, a=10, lmax=5):
    """tests/test_ctc_pallas.py::_random_case, as numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, a)).astype(np.float32) * 2
    label_lens = rng.integers(1, lmax + 1, size=b)
    labels = np.zeros((b, lmax), dtype=np.int32)
    for i in range(b):
        labels[i, : label_lens[i]] = rng.integers(1, a, size=label_lens[i])
    input_lens = rng.integers(2 * lmax + 1, t + 1, size=b)
    return (logits, labels, input_lens.astype(np.int32),
            label_lens.astype(np.int32))


def _infeasible_case():
    """utt 0 is infeasible ([1, 1, 1] needs 5 frames, has 4)."""
    logits = np.random.default_rng(2).standard_normal((3, 9, 5)).astype(
        np.float32)
    labels = np.array([[1, 1, 1, 0], [2, 3, 0, 0], [4, 0, 0, 0]], np.int32)
    return (logits, labels, np.array([4, 9, 3], np.int32),
            np.array([3, 2, 1], np.int32))


def _empty_case():
    """All-empty transcripts: S = 1."""
    logits = np.random.default_rng(0).standard_normal((2, 6, 5)).astype(
        np.float32)
    return (logits, np.zeros((2, 0), np.int32), np.array([6, 4], np.int32),
            np.zeros((2,), np.int32))


CASES = {"seed0": lambda: _random_case(0), "seed1": lambda: _random_case(1),
         "infeasible": _infeasible_case, "empty": _empty_case}


def _torch(args):
    return tuple(torch.as_tensor(np.array(a)) for a in args)


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


def _lattice_inputs(case):
    """The kernels' operands, made by the JAX package from one case."""
    logits, labels, input_lens, label_lens = CASES[case]()
    log_probs = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    ext = jctc.extend_labels(jnp.asarray(labels))
    skip_ok = jctc._transition_masks(ext, 0)
    skip_down = jnp.concatenate(
        [skip_ok[:, 2:], jnp.zeros((ext.shape[0], 2), dtype=bool)],
        axis=1)[:, :skip_ok.shape[1]]
    lp_ext_t = jnp.moveaxis(jnp.take_along_axis(
        log_probs, ext[:, None, :].astype(jnp.int32), axis=2), 1, 0)
    return tuple(np.asarray(a) for a in (lp_ext_t, skip_ok, skip_down,
                                         input_lens, label_lens))


@pytest.mark.parametrize("labels", [
    [[1, 2, 2, 0], [3, 0, 0, 0]], [[4, 4, 4, 4], [1, 2, 3, 4]],
    np.zeros((2, 0), np.int32)])
def test_extend_labels_and_transition_masks_match_jax(labels):
    labels = np.asarray(labels, np.int32)
    j_ext = jctc.extend_labels(jnp.asarray(labels))
    t_ext = tctc.extend_labels(torch.as_tensor(labels))
    np.testing.assert_array_equal(t_ext.numpy(), np.asarray(j_ext))
    np.testing.assert_array_equal(
        tctc._transition_masks(t_ext, 0).numpy(),
        np.asarray(jctc._transition_masks(j_ext, 0)))


def test_greedy_collapse_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 4, size=(5, 17)).astype(np.int32)
    ids[0] = 0                                  # all blank
    lens = np.array([17, 17, 9, 1, 0], np.int32)
    j_out, j_lens = jctc.greedy_collapse(jnp.asarray(ids), jnp.asarray(lens))
    t_out, t_lens = tctc.greedy_collapse(torch.as_tensor(ids),
                                         torch.as_tensor(lens))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", ["alpha_beta", "forward_alphas",
                                    "backward_betas"])
def test_plain_recursions_match_pallas_interpret(kernel, case):
    """K1, K11 and K12's plain versions (what their wrappers run on a CPU
    tensor) against the three Pallas kernels in interpret mode."""
    lp, skip_ok, skip_down, lens, label_lens = _lattice_inputs(case)
    before = getattr(ctc_cuda, kernel).launches
    if kernel == "alpha_beta":
        ref = ctc_pallas.alpha_beta_pallas(*_jax(
            (lp, skip_ok, skip_down, lens, label_lens)), interpret=True)
        got = ctc_cuda.alpha_beta(*_torch(
            (lp, skip_ok, skip_down, lens, label_lens)))
    elif kernel == "forward_alphas":
        ref = [ctc_pallas.forward_alphas_pallas(
            *_jax((lp, skip_ok, lens)), interpret=True)]
        got = [ctc_cuda.forward_alphas(*_torch((lp, skip_ok, lens)))]
    else:
        ref = [ctc_pallas.backward_betas_pallas(
            *_jax((lp, skip_down, lens, label_lens)), interpret=True)]
        got = [ctc_cuda.backward_betas(
            *_torch((lp, skip_down, lens, label_lens)))]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=LATTICE_RTOL, atol=LATTICE_ATOL)
    assert getattr(ctc_cuda, kernel).launches == before   # CPU: plain


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl,jax_impl", [("fused", "pallas_interpret"),
                                           ("separate", "xla")])
def test_ctc_loss_and_grad_matches_jax(case, impl, jax_impl):
    """The port's fused sweep against JAX's fused Pallas kernel, and its
    separate recursions against JAX's separate XLA scans."""
    args = CASES[case]()
    loss_j, grad_j = jctc.ctc_loss_and_grad(*_jax(args),
                                            implementation=jax_impl)
    loss_t, grad_t = tctc.ctc_loss_and_grad(*_torch(args),
                                            implementation=impl)
    assert grad_t.dtype == torch.float32 and grad_t.shape == grad_j.shape
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if case == "infeasible":
        assert float(loss_t[0]) == 0.0 and not grad_t[0].any()
    # zero gradient past each utterance's frames
    for row, n in enumerate(args[2]):
        assert not grad_t[row, n:].any()


@pytest.mark.parametrize("case", ["seed0", "infeasible"])
def test_ctc_loss_autograd_matches_forward_only(case):
    """The custom backward (alpha-beta gradient times the loss
    cotangent) against autograd through the plain alpha loop; the JAX
    package's tolerance for the same check (tests/test_ctc.py)."""
    logits, *rest = _torch(CASES[case]())
    scale = torch.linspace(0.5, 2.0, logits.shape[0])
    x1 = logits.clone().requires_grad_(True)
    (tctc.ctc_loss(x1, *rest) * scale).sum().backward()
    x2 = logits.clone().requires_grad_(True)
    (tctc.ctc_loss_forward_only(x2, *rest) * scale).sum().backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_ctc_loss_without_grad_is_the_alpha_loss():
    """No gradient to take: ``ctc_loss`` runs the alpha recursion alone
    and returns ``ctc_loss_and_grad``'s loss, as JAX's primal does."""
    args = _torch(_random_case(3))
    with torch.no_grad():
        loss = tctc.ctc_loss(*args)
    ref, _ = jctc.ctc_loss_and_grad(*_jax([a.numpy() for a in args]))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref),
                               rtol=LOSS_TOL, atol=LOSS_TOL)


def test_unknown_implementation_raises():
    with pytest.raises(ValueError, match="implementation"):
        tctc.ctc_loss_and_grad(*_torch(_random_case(0)),
                               implementation="pallas")
