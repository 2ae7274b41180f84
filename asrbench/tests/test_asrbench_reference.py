"""The plain reference against hand-checked cases."""

import math

import numpy as np
import pytest
import torch

from asrbench import reference as ref
from asrbench import weights
from asrbench.families import google


def _sig(x):
    return 1.0 / (1.0 + math.exp(-x))


def _tiny(mode):
    return {"rnn_mode": mode, "input_dim": 1, "hidden_dim": 1,
            "num_layers": 1, "num_targets": 2, "bidirectional": 1,
            "param_stddev": 0.5, "bias_stddev": 0.1, "blank_prior": 1.0}


def _tree(cfg, wx, wh, b):
    leaves = []
    for name, shape in weights.param_shapes(cfg):
        key = name.split(".")[-1]
        val = {"w_x": wx, "w_h": wh, "b": b}.get(key)
        leaves.append(torch.tensor(val if val is not None else 0.0,
                                   dtype=torch.float64).expand(shape).clone())
    return weights.unflatten(cfg, leaves)


def test_lstm_two_frames_by_hand():
    """H=1, D=1, every gate weight 0.5, recurrent 0.25, bias 0.1."""
    cfg = _tiny(2)
    tree = _tree(cfg, 0.5, 0.25, 0.1)
    x = torch.tensor([[[1.0]], [[-2.0]]], dtype=torch.float64)   # [T, B, D]
    y = google.rnn_stack(tree, x, torch.tensor([2]), cfg)
    h, c, fwd = 0.0, 0.0, []
    for xt in (1.0, -2.0):
        a = 0.5 * xt + 0.25 * h + 0.1           # the same for all gates
        c = _sig(a) * c + _sig(a) * math.tanh(a)
        h = _sig(a) * math.tanh(c)
        fwd.append(h)
    h, c, bwd = 0.0, 0.0, []
    for xt in (-2.0, 1.0):
        a = 0.5 * xt + 0.25 * h + 0.1
        c = _sig(a) * c + _sig(a) * math.tanh(a)
        h = _sig(a) * math.tanh(c)
        bwd.append(h)
    bwd.reverse()
    np.testing.assert_allclose(y[:, 0, 0].numpy(), fwd, rtol=1e-12)
    np.testing.assert_allclose(y[:, 0, 1].numpy(), bwd, rtol=1e-12)


def test_gru_frame_by_hand_and_padding():
    """Linear-before-reset GRU; past the length the output is 0 and the
    backward direction starts at the last valid frame."""
    cfg = _tiny(3)
    tree = _tree(cfg, 0.5, 0.25, 0.1)
    x = torch.tensor([[[1.0]], [[7.0]]], dtype=torch.float64)
    y = google.rnn_stack(tree, x, torch.tensor([1]), cfg)
    a = 0.5 * 1.0 + 0.1
    r = z = _sig(a)
    n = math.tanh(a + r * 0.0)
    h = (1 - z) * n
    np.testing.assert_allclose(y[0, 0].numpy(), [h, h], rtol=1e-12)
    assert float(y[1].abs().sum()) == 0.0


def test_ctc_loss_enumerates_paths():
    """T=2, one label: the paths (a, a), (a, -), (-, a)."""
    lg = torch.tensor([[[0.3, -0.2]], [[1.1, 0.4]]], dtype=torch.float64)
    p = torch.softmax(lg, dim=-1)[:, 0]
    prob = (p[0, 1] * p[1, 1] + p[0, 1] * p[1, 0] + p[0, 0] * p[1, 1])
    loss = ref.ctc_losses(lg, [np.array([1])], torch.tensor([2]))
    assert float(loss[0]) == pytest.approx(-math.log(float(prob)), rel=1e-12)


def test_sgd_step_clips_and_decays():
    assert ref.lr_at(0, 5e-4, 1e-5, 100) == 5e-4
    assert ref.lr_at(100, 5e-4, 1e-5, 100) == pytest.approx(1e-5)
    cfg = dict(_tiny(2), num_targets=3)
    leaves = weights.make_params(cfg, 3, "cpu")
    batch = [(np.ones((4, 1), np.float32) * 50.0, np.array([1, 2]))]
    out = ref.sgd_steps(leaves, [batch], cfg, 0.5, 0.5, 10, clip=5.0)
    moved = max(float((a - b).abs().max())
                for a, b in zip(leaves, out["params"][0]))
    assert moved <= 0.5 * 5.0 + 1e-6


def test_label_gap_by_hand():
    sc = np.log(np.array([[0.6, 0.3, 0.1],
                          [0.2, 0.7, 0.1],
                          [0.5, 0.1, 0.4]]))
    assert ref.greedy_labels(sc) == [1]
    assert ref.label_gap(sc, [1]) == 0.0
    # [2]: the path (-, -, 2) gaps log(.7/.2) on frame 1 and log(.5/.4)
    # on frame 2; every other path has a frame that gaps more
    assert ref.label_gap(sc, [2]) == pytest.approx(math.log(0.7 / 0.2))
    # [1, 2]: (-, 1, 2) gaps only on frame 2, log(.5/.4)
    assert ref.label_gap(sc, [1, 2]) == pytest.approx(math.log(0.5 / 0.4))
    # three labels cannot come from three frames with a repeat
    assert ref.label_gap(sc, [1, 1, 2]) == math.inf


def test_mfcc_matches_the_ports_features():
    """The reference's float64 MFCC-hires and the port's plain path on
    the CPU agree to f32 rounding."""
    from kaldi_ctc_tpu_torch.features import MfccOptions, compute_mfcc

    rng = np.random.default_rng(0)
    pcm = np.clip(rng.normal(0, 1000, 16000), -32768, 32767).astype(np.int16)
    mine = ref.mfcc_hires(pcm)
    theirs = compute_mfcc(torch.as_tensor(pcm.astype(np.float32)),
                          MfccOptions.hires()).numpy()
    assert mine.shape == theirs.shape == (98, 40)
    np.testing.assert_allclose(mine, theirs, atol=2e-3 * np.abs(mine).max())


def test_tf32_conv_rounds_its_operands():
    """Under the control's precision the convolution rounds both
    operands and the incoming gradient to TF32: on values that TF32
    holds exactly it is the plain convolution, forward and backward;
    1 + 2^-12, which it does not, counts as 1."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-8, 8, (2, 1, 9, 8), generator=gen).float()
    w = torch.randint(-8, 8, (3, 1, 3, 5), generator=gen).float()
    g = torch.randint(-8, 8, (2, 3, 4, 2), generator=gen).float()
    plain = [t.clone().requires_grad_(True) for t in (x, w)]
    y0 = F.conv2d(*plain, stride=(2, 2))
    y0.backward(g)
    mine = [t.clone().requires_grad_(True) for t in (x, w)]
    with ref.precision(tf32=True):
        y1 = ref.conv2d(*mine, (2, 2))
    y1.backward(g)
    assert torch.equal(y0, y1)
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(plain, mine))
    off = torch.ones(1, 1, 1, 1) + 2.0 ** -12
    with ref.precision(tf32=True):
        assert float(ref.conv2d(off, off, (1, 1))) == 1.0
    assert float(ref.conv2d(off, off, (1, 1))) > 1.0
