"""The plain reference: the model, its CTC loss, gradient and update, and
the serving front end, in plain PyTorch and NumPy.

Written from the published equations, not from the program; it imports
nothing of the program and takes nothing it made (the weights come from
``weights.make_params`` with the run's seed, the inputs from
``traffic``).  IEEE f32 throughout (TF32 off) unless a caller asks for
TF32, the control's precision: then every product rounds its operands
to TF32, forward and backward.

- Recurrent stack: per layer and direction, over all frames the input
  projection ``x W_x + b``, then a loop over time of ``h W_h`` and the
  cell: LSTM gates (i, f, g, o), ``c' = s(f) c + s(i) tanh(g)``,
  ``h' = s(o) tanh(c')``; GRU (linear before reset) ``r = s(x_r + h_r)``,
  ``z = s(x_z + h_z)``, ``n = tanh(x_n + r h_n)``, ``h' = (1 - z) n + z h``.
  Past an utterance's length the state is held and the output is 0; the
  backward direction runs from the last frame down.
- Output: ``y W_out + b_out``; the CTC loss is ``F.ctc_loss`` (blank 0)
  summed over the batch; the gradient is autograd's, clipped to +-5 a
  element; SGD ``p - lr(step) g`` with
  ``lr(s) = lr_i exp(s log(lr_f / lr_i) / num_steps)``.
- Serving: Kaldi's MFCC (``feature-mfcc.cc``, the hires options) in
  float64, the forward, ``log softmax - log priors`` and the greedy
  labels.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asrbench import weights as wts

__all__ = ["precision", "rnn_stack", "logits", "ctc_losses", "lr_at",
           "sgd_steps", "mfcc_hires", "scores", "greedy_labels",
           "label_gap"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even), as
    a tensor core rounds each operand of a TF32 product."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and f32 accumulation, in
    the forward and in the two products of the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return (g @ tf32_round(b).transpose(-1, -2),
                tf32_round(a).transpose(-1, -2) @ g)


_TF32 = [False]


@contextlib.contextmanager
def precision(tf32: bool = False):
    """IEEE f32 matmuls (TF32 off), or, for the control, every matmul of
    the reference with its operands rounded to TF32 (explicitly: cuBLAS
    may run a small product without tensor cores even where TF32 is
    allowed)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved, _TF32[0] = _TF32[0], tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        _TF32[0] = saved


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's matrix product (batched where ``a`` is 3-d)."""
    if _TF32[0]:
        return _Tf32Matmul.apply(a, b)
    return a @ b


def _lstm_cell(pre, h, c, w_h):
    """pre [dirs, B, 4H], h and c [dirs, B, H], w_h [dirs, H, 4H]."""
    i, f, g, o = (pre + mm(h, w_h)).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_cell(pre, h, w_h):
    xr, xz, xn = pre.chunk(3, dim=-1)
    hr, hz, hn = mm(h, w_h).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def rnn_stack(tree: Dict, x: torch.Tensor, lens: torch.Tensor, cfg: dict
              ) -> torch.Tensor:
    """x [T, B, D] → [T, B, H * dirs].  The directions of a layer step
    together: at loop index t the forward direction takes frame t and
    the backward direction frame T-1-t."""
    mode = int(cfg["rnn_mode"])
    t_max, b, _ = x.shape
    h_dim = int(cfg["hidden_dim"])
    valid = (torch.arange(t_max, device=x.device)[:, None]
             < lens.to(x.device)[None, :])[..., None]          # [T, B, 1]
    out = x
    for layer in tree["rnn"]:
        dirs = layer["dirs"]
        n = len(dirs)
        # time-major per direction, the backward one read back to front
        pre = torch.stack([
            (mm(out.reshape(t_max * b, -1), p["w_x"]) + p["b"]).reshape(
                t_max, b, -1).flip(0) if d else
            (mm(out.reshape(t_max * b, -1), p["w_x"]) + p["b"]).reshape(
                t_max, b, -1) for d, p in enumerate(dirs)], dim=1)
        v_all = torch.stack([valid.flip(0) if d else valid
                             for d in range(n)], dim=1)      # [T, n, B, 1]
        w_h = torch.stack([p["w_h"] for p in dirs])           # [n, H, G]
        h = x.new_zeros((n, b, h_dim))
        c = x.new_zeros((n, b, h_dim))
        ys = []
        for t in range(t_max):
            v = v_all[t]
            if mode == 2:
                h_new, c_new = _lstm_cell(pre[t], h, c, w_h)
                c = torch.where(v, c_new, c)
            else:
                h_new = _gru_cell(pre[t], h, w_h)
            h = torch.where(v, h_new, h)
            ys.append(torch.where(v, h_new, 0.0))
        y = torch.stack(ys)                                    # [T, n, B, H]
        out = torch.cat([y[:, d].flip(0) if d else y[:, d]
                         for d in range(n)], dim=-1)
    return out


def logits(tree: Dict, feats: torch.Tensor, lens: torch.Tensor, cfg: dict
           ) -> torch.Tensor:
    """feats [B, T, D] → logits [T, B, A]."""
    y = rnn_stack(tree, feats.transpose(0, 1), lens, cfg)
    t, b, h = y.shape
    return (mm(y.reshape(t * b, h), tree["out_w"]) + tree["out_b"]).reshape(
        t, b, -1)


def ctc_losses(lg: torch.Tensor, labels: Sequence[np.ndarray],
               lens: torch.Tensor) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood [B] (blank 0)."""
    lp = torch.log_softmax(lg, dim=-1)
    targets = torch.as_tensor(np.concatenate(labels), dtype=torch.long,
                              device=lg.device)
    tl = torch.as_tensor([len(x) for x in labels], dtype=torch.long,
                         device=lg.device)
    with torch.backends.cudnn.flags(enabled=False):
        return F.ctc_loss(lp, targets, lens.to(lg.device, torch.long), tl,
                          blank=0, reduction="none", zero_infinity=False)


def lr_at(step: int, lr_i: float, lr_f: float, num_steps: int) -> float:
    return lr_i * math.exp(step * math.log(lr_f / lr_i) / max(num_steps, 1))


def _batch_tensors(batch: Sequence[Tuple[np.ndarray, np.ndarray]], device
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[np.ndarray]]:
    """[(feats [T_i, D], labels [L_i])] → (feats [B, T_max, D] padded with
    zeros, lens [B], labels)."""
    t_max = max(f.shape[0] for f, _ in batch)
    d = batch[0][0].shape[1]
    feats = np.zeros((len(batch), t_max, d), np.float32)
    for i, (f, _) in enumerate(batch):
        feats[i, :f.shape[0]] = f
    lens = torch.as_tensor([f.shape[0] for f, _ in batch], dtype=torch.int32)
    return (torch.as_tensor(feats, device=device), lens.to(device),
            [lab for _, lab in batch])


def sgd_steps(leaves: List[torch.Tensor], batches, cfg: dict, lr_i: float,
              lr_f: float, num_steps: int, clip: float = 5.0,
              tf32: bool = False) -> Dict[str, object]:
    """Train steps 1..len(batches) from ``leaves`` (step s uses lr(s-1)).
    → {"loss_per_frame": [per step], "params": [leaves after each step]}."""
    params = [p.detach().clone() for p in leaves]
    losses, after = [], []
    with precision(tf32):
        for s, batch in enumerate(batches):
            device = params[0].device
            feats, lens, labels = _batch_tensors(batch, device)
            req = [p.detach().requires_grad_(True) for p in params]
            tree = wts.unflatten(cfg, req)
            with torch.enable_grad():
                lg = logits(tree, feats, lens, cfg)
                loss = ctc_losses(lg, labels, lens)
                total = loss.sum()
            grads = torch.autograd.grad(total, req)
            lr = torch.tensor(lr_at(s, lr_i, lr_f, num_steps),
                              dtype=torch.float32, device=device)
            with torch.no_grad():
                params = [p - lr * torch.clamp(g, -clip, clip)
                          for p, g in zip(params, grads)]
            losses.append(float(total.detach()) / float(lens.sum()))
            after.append(params)
    return {"loss_per_frame": losses, "params": after}


# ---------------------------------------------------------------------------
# serving front end
# ---------------------------------------------------------------------------

def _mel_banks(num_bins: int, low: float, high: float, sr: float,
               padded: int) -> np.ndarray:
    """Triangular mel bins over the padded FFT's first padded/2 bins
    (mel-computations.cc:33-140)."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)
    nyq = 0.5 * sr
    high = high if high > 0 else nyq + high
    fmel = mel(sr / padded * np.arange(padded // 2))
    m_lo, m_hi = mel(low), mel(high)
    delta = (m_hi - m_lo) / (num_bins + 1)
    out = np.zeros((num_bins, padded // 2))
    for b in range(num_bins):
        left, center, right = (m_lo + b * delta, m_lo + (b + 1) * delta,
                               m_lo + (b + 2) * delta)
        w = np.where(fmel <= center, (fmel - left) / (center - left),
                     (right - fmel) / (right - center))
        out[b] = np.where((fmel > left) & (fmel < right), w, 0.0)
    return out


def mfcc_hires(pcm: np.ndarray, sr: float = 16000.0) -> np.ndarray:
    """MFCC-hires of int16 samples → [frames, 40] f32: 25 ms frames every
    10 ms (snip edges), DC removed, preemphasis 0.97, the Povey window,
    a 512-point power spectrum, 40 mel bins from 20 Hz to Nyquist - 400,
    log floored at f32 epsilon, the orthonormal DCT-II to 40 cepstra and
    the lifter 22; no dither, no energy."""
    x = np.asarray(pcm, np.float64)
    win, shift, padded, ceps, bins = 400, 160, 512, 40, 40
    n = 0 if x.shape[0] < win else 1 + (x.shape[0] - win) // shift
    idx = np.arange(n)[:, None] * shift + np.arange(win)[None, :]
    fr = x[idx]
    fr = fr - fr.mean(axis=1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], axis=1)
    i = np.arange(win)
    fr = fr * (0.5 - 0.5 * np.cos(2 * math.pi * i / (win - 1))) ** 0.85
    spec = np.fft.rfft(fr, n=padded, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power[:, :padded // 2] @ _mel_banks(bins, 20.0, -400.0, sr,
                                              padded).T
    logmel = np.log(np.maximum(mel, np.finfo(np.float32).eps))
    k = np.arange(ceps)[:, None]
    dct = np.sqrt(2.0 / bins) * np.cos(math.pi / bins
                                       * (np.arange(bins)[None, :] + 0.5) * k)
    dct[0] = np.sqrt(1.0 / bins)
    lifter = 1.0 + 0.5 * 22.0 * np.sin(math.pi * np.arange(ceps) / 22.0)
    return (logmel @ (dct * lifter[:, None]).T).astype(np.float32)


def scores(tree: Dict, feats_list: Sequence[np.ndarray], cfg: dict, device,
           tf32: bool = False) -> List[np.ndarray]:
    """Per utterance [frames, A] f64: log softmax minus log priors (ones,
    ``blank_prior`` for blank), the statistic the greedy labels maximise."""
    batch = [(f, np.zeros(0, np.int64)) for f in feats_list]
    feats, lens, _ = _batch_tensors(batch, device)
    priors = np.ones(int(cfg["num_targets"]))
    priors[0] = float(cfg["blank_prior"])
    with precision(tf32), torch.no_grad():
        lp = torch.log_softmax(logits(tree, feats, lens, cfg), dim=-1)
    lp = lp.double().cpu().numpy() - np.log(priors)[None, None]
    return [lp[:int(n), i] for i, n in enumerate(lens.cpu().numpy())]


def greedy_labels(sc: np.ndarray) -> List[int]:
    """Frame argmax, repeats merged, blanks dropped."""
    ids = np.argmax(sc, axis=-1)
    keep = (ids != 0) & np.concatenate([[True], ids[1:] != ids[:-1]])
    return [int(i) for i in ids[keep]]


def label_gap(sc: np.ndarray, labels: Sequence[int]) -> float:
    """The widest gap by which a served frame's token lies below the
    reference's best on that frame, for the most lenient reading of the
    served labels: over every CTC path that collapses to ``labels``, the
    least of its largest ``max_k sc[t, k] - sc[t, path_t]`` (a min-max
    recursion over the blank-interleaved labels).  0 when ``labels`` are
    the reference's own greedy labels; inf when no path yields them."""
    labels = list(labels)
    if labels == greedy_labels(sc):
        return 0.0
    t_max = sc.shape[0]
    if t_max == 0:
        return math.inf
    ext = np.zeros(2 * len(labels) + 1, np.int64)
    ext[1::2] = labels
    s_max = ext.shape[0]
    skip = np.zeros(s_max, bool)
    skip[2:] = (ext[2:] != 0) & (ext[2:] != ext[:-2])
    gap = sc.max(axis=1, keepdims=True) - sc[:, ext]          # [T, S]
    cost = np.full(s_max, math.inf)
    cost[:2] = gap[0, :2]
    inf2 = np.full(2, math.inf)
    for t in range(1, t_max):
        prev = np.minimum(cost, np.concatenate([inf2[:1], cost[:-1]]))
        prev = np.where(skip, np.minimum(
            prev, np.concatenate([inf2, cost[:-2]])), prev)
        cost = np.maximum(prev, gap[t])
    return float(min(cost[-1], cost[-2] if s_max > 1 else math.inf))
