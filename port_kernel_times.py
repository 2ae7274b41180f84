"""Times K4, K1, K11 and K12 of the PyTorch/CUDA port through their public
wrappers, so that two checkouts can be timed in one call on one card:

    python3 port_kernel_times.py [--root CHECKOUT] [--label NAME]

``--root`` is the checkout whose ``kaldi_ctc_tpu_torch`` is timed
(default: the one beside this script); its kernels build into its own
``build/kernels``.  The inputs are ``chip_smoke.py``'s (this script's
copy): K4 (``stft_cuda.log_mel``) on MFCC-hires frames of 8 s of seeded
audio (798 frames, a request) and on its first 20 frames (one 0.2 s
stream chunk); K1 (``ctc_cuda.alpha_beta``), K11
(``ctc_cuda.forward_alphas``) and K12 (``ctc_cuda.backward_betas``) at
bench.py's CTC shape (B=48, T=240, S=141, short, label-less and
infeasible rows), each on the route its checkout's plan takes.  Each is
timed three ways: one call between CUDA events (the host's time before
its launch included), 50 calls back to back, and the card's time a call
in a torch.profiler trace.  Prints one JSON line with the card's
``nvidia-smi`` name and power limit.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

import chip_smoke as cs


def times(torch, fn, tags):
    return {"ms": cs.median_ms(fn, 20, torch),
            "back_to_back_ms": cs.back_to_back_ms(fn, 50, torch),
            "device_ms": cs.device_ms(torch, fn, tags)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=cs.ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the timing needs one NVIDIA card")
    from kaldi_ctc_tpu_torch.features import MfccOptions, stft_cuda
    from kaldi_ctc_tpu_torch.features.mel import mel_banks
    from kaldi_ctc_tpu_torch.features.window import (feature_window,
                                                     frame_signal)
    from kaldi_ctc_tpu_torch.ops import ctc, ctc_cuda
    if not stft_cuda.__file__.startswith(root):
        cs.fail(f"imported {stft_cuda.__file__}, not the port under {root}")
    dev = torch.device("cuda", 0)
    opts = MfccOptions.hires()
    fo = opts.frame_opts
    wave = torch.as_tensor(cs.pcm(8.0, 100, np).astype(np.float32),
                           device=dev)
    frames = frame_signal(wave, fo).contiguous()
    window = torch.as_tensor(feature_window(fo), device=dev)
    mel = torch.as_tensor(mel_banks(opts.mel_opts, fo), device=dev)
    out = {"label": args.label, "root": root}
    for count in (798, 20):
        x = frames[:count].contiguous()
        out[f"k4_{count}_frames"] = times(
            torch, lambda: stft_cuda.log_mel(x, window, mel,
                                             fo.padded_window_size),
            ("log_mel",))
    data = cs.ctc_batch(np, 1)
    logits, labels, input_lens, label_lens = (
        torch.as_tensor(data[k], device=dev)
        for k in ("logits", "labels", "input_lens", "label_lens"))
    _, _, skip_ok, lp = ctc._lattice(logits, labels, 0)
    skip_down = ctc._skip_down(skip_ok)
    out["k1_bench"] = times(
        torch, lambda: ctc_cuda.alpha_beta(lp, skip_ok, skip_down,
                                           input_lens, label_lens),
        ("ctc_",))
    out["k11_bench"] = times(
        torch, lambda: ctc_cuda.forward_alphas(lp, skip_ok, input_lens),
        ("ctc_",))
    out["k12_bench"] = times(
        torch, lambda: ctc_cuda.backward_betas(lp, skip_down, input_lens,
                                               label_lens),
        ("ctc_",))
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
