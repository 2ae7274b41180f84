"""The 'google' family: stacked recurrent layers and an affine to the
targets (kaldi-ctc's ``make_configs.py`` 'google' model), over MFCC-hires.

Configuration keys: ``input_dim``, ``num_targets``, ``hidden_dim``,
``num_layers``, ``rnn_mode`` (2 LSTM, 3 GRU), ``bidirectional``,
``compute_dtype``, ``param_stddev``, ``bias_stddev``, ``blank_prior``,
and optionally ``near_tie_pairs`` and ``near_tie_eps``.

- The tree: ``rnn[layer]["dirs"][d]{"w_x", "w_h", "b"}``, ``out_w``,
  ``out_b``; weights N(0, param_stddev^2) in one draw, recurrent biases
  N(0, bias_stddev^2) in another, the output bias 0.
- Recurrent stack: per layer and direction, over all frames the input
  projection ``x W_x + b``, then a loop over time of ``h W_h`` and the
  cell: LSTM gates (i, f, g, o), ``c' = s(f) c + s(i) tanh(g)``,
  ``h' = s(o) tanh(c')``; GRU (linear before reset) ``r = s(x_r + h_r)``,
  ``z = s(x_z + h_z)``, ``n = tanh(x_n + r h_n)``, ``h' = (1 - z) n + z h``.
  Past an utterance's length the state is held and the output is 0; the
  backward direction runs from the last frame down; the directions'
  outputs are concatenated.
- Output: ``y W_out + b_out``, one logit frame an input frame.
- Work: the matrix products at 2 operations a multiply-add; the
  recurrent stack's roofline counts the recurrent products alone with
  each input byte read once and each output byte written once
  (``PERF.md``'s rule); elementwise gate arithmetic is not counted.

Torch and the reference are imported inside the functions that use
them: the harness reads the flags and the time stride before it starts
the program, where importing torch would add its seconds to every run's
set-up.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

__all__ = ["program_flags", "model_file_config", "param_shapes",
           "make_params", "rnn_stack", "logits", "output_lens",
           "time_stride", "forward_flops_per_frame", "layer_work",
           "features"]


def gates(cfg: dict) -> int:
    return {2: 4, 3: 3}[int(cfg["rnn_mode"])]


def _dirs(cfg: dict) -> int:
    return 2 if int(cfg["bidirectional"]) else 1


def program_flags(cfg: dict) -> List[str]:
    return ["--num-targets", str(cfg["num_targets"]),
            "--hidden-dim", str(cfg["hidden_dim"]),
            "--num-layers", str(cfg["num_layers"]),
            "--rnn-mode", str(cfg["rnn_mode"]),
            "--bidirectional", str(cfg["bidirectional"]),
            "--compute-dtype", cfg["compute_dtype"]]


def model_file_config(cfg: dict) -> dict:
    return {"input_dim": int(cfg["input_dim"]),
            "num_targets": int(cfg["num_targets"]),
            "hidden_dim": int(cfg["hidden_dim"]),
            "num_layers": int(cfg["num_layers"]),
            "mode": int(cfg["rnn_mode"]),
            "bidirectional": bool(int(cfg["bidirectional"])),
            "param_stddev": float(cfg["param_stddev"]),
            "bias_stddev": float(cfg["bias_stddev"]),
            "compute_dtype": cfg["compute_dtype"]}


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    h, g, dirs = int(cfg["hidden_dim"]), gates(cfg), _dirs(cfg)
    out = [("out_b", (int(cfg["num_targets"]),)),
           ("out_w", (h * dirs, int(cfg["num_targets"])))]
    for layer in range(int(cfg["num_layers"])):
        d_in = int(cfg["input_dim"]) if layer == 0 else h * dirs
        for d in range(dirs):
            pre = f"rnn.{layer}.dirs.{d}."
            out += [(pre + "b", (g * h,)), (pre + "w_h", (h, g * h)),
                    (pre + "w_x", (d_in, g * h))]
    return out


def make_params(cfg: dict, seed: int, device) -> List["torch.Tensor"]:
    """The flat leaves: weights N(0, param_stddev^2), recurrent biases
    N(0, bias_stddev^2), the output bias 0 (the port's and the
    reference's init), f32 on ``device``.  With ``near_tie_pairs`` = n,
    the output columns of labels 2k and 2k-1, k <= n, differ by the
    factor 1 + ``near_tie_eps``: their logits nearly tie on every frame
    where one of them leads, so the served labels show a loss of
    precision in the forward (TF32 rounds the two columns alike) that
    random weights would hide."""
    import torch

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


def rnn_stack(tree: Dict, x: "torch.Tensor", lens: "torch.Tensor", cfg: dict
              ) -> "torch.Tensor":
    """x [T, B, D] → [T, B, H * dirs].  The directions of a layer step
    together: at loop index t the forward direction takes frame t and
    the backward direction frame T-1-t."""
    import torch

    from asrbench import reference as ref

    def lstm_cell(pre, h, c, w_h):
        """pre [dirs, B, 4H], h and c [dirs, B, H], w_h [dirs, H, 4H]."""
        i, f, g, o = (pre + ref.mm(h, w_h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def gru_cell(pre, h, w_h):
        xr, xz, xn = pre.chunk(3, dim=-1)
        hr, hz, hn = ref.mm(h, w_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h

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
            (ref.mm(out.reshape(t_max * b, -1), p["w_x"]) + p["b"]).reshape(
                t_max, b, -1).flip(0) if d else
            (ref.mm(out.reshape(t_max * b, -1), p["w_x"]) + p["b"]).reshape(
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
                h_new, c_new = lstm_cell(pre[t], h, c, w_h)
                c = torch.where(v, c_new, c)
            else:
                h_new = gru_cell(pre[t], h, w_h)
            h = torch.where(v, h_new, h)
            ys.append(torch.where(v, h_new, 0.0))
        y = torch.stack(ys)                                    # [T, n, B, H]
        out = torch.cat([y[:, d].flip(0) if d else y[:, d]
                         for d in range(n)], dim=-1)
    return out


def output_layer(tree: Dict, y: "torch.Tensor") -> "torch.Tensor":
    """y [T, B, H'] → logits [T, B, A]."""
    from asrbench import reference as ref

    t, b, h = y.shape
    return (ref.mm(y.reshape(t * b, h), tree["out_w"])
            + tree["out_b"]).reshape(t, b, -1)


def logits(tree: Dict, feats: "torch.Tensor", lens: "torch.Tensor",
           cfg: dict) -> "torch.Tensor":
    """feats [B, T, D] → logits [T, B, A]."""
    return output_layer(tree, rnn_stack(tree, feats.transpose(0, 1), lens,
                                        cfg))


def output_lens(cfg: dict, lens):
    return lens


def time_stride(cfg: dict) -> int:
    return 1


def stack_flops_per_frame(cfg: dict, input_dim: int) -> float:
    """The recurrent stack's and the output affine's forward operations
    for one frame of the stack's input of width ``input_dim``."""
    h, g, dirs = int(cfg["hidden_dim"]), gates(cfg), _dirs(cfg)
    total = 0.0
    for layer in range(int(cfg["num_layers"])):
        d_in = input_dim if layer == 0 else h * dirs
        total += dirs * (2.0 * d_in * g * h + 2.0 * h * g * h)
    return total + 2.0 * h * dirs * int(cfg["num_targets"])


def forward_flops_per_frame(cfg: dict) -> float:
    return stack_flops_per_frame(cfg, int(cfg["input_dim"]))


def recurrent_work(cfg: dict, frames: Sequence[int], backward: bool
                   ) -> Dict[str, float]:
    """The recurrent stack's work over utterances of ``frames`` frames of
    the stack: the recurrent products ``h W_h`` (and, with ``backward``,
    ``dgates W_h^T``) of every layer and direction, and the bytes each
    direction must move at least (f32): its input projection read, its
    outputs written, W_h read; the backward also reads the outputs'
    gradients and writes the gates' gradients."""
    h, g, dirs = int(cfg["hidden_dim"]), gates(cfg), _dirs(cfg)
    layers = int(cfg["num_layers"])
    n = float(sum(frames))
    passes = 2.0 if backward else 1.0
    flops = passes * layers * dirs * n * 2.0 * h * g * h
    per_dir = n * (g * h + h) * 4.0 + h * g * h * 4.0
    if backward:
        per_dir += n * (h + g * h) * 4.0 + h * g * h * 4.0
    return {"flops": flops, "bytes": layers * dirs * per_dir}


def layer_work(cfg: dict, layer: str, frames: Sequence[int], backward: bool
               ) -> Dict[str, float]:
    if layer != "recurrent stack":
        raise KeyError(f"the google family has no layer {layer!r}")
    return recurrent_work(cfg, frames, backward)


def features(cfg: dict, pcm):
    from asrbench import reference as ref

    return ref.mfcc_hires(pcm)
