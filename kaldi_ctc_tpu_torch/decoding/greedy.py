"""Greedy (best-path) CTC decoding.

Counterpart of ``kaldi_ctc_tpu/decoding/greedy.py``: framewise argmax →
collapse repeats → drop blanks (the rule of ComputeTotAccuracy,
``ctc/ctc-nnet-update.cc:261-317``), on the scores' device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kaldi_ctc_tpu_torch.ops.ctc import greedy_collapse

__all__ = ["greedy_decode"]


def greedy_decode(
    scores: torch.Tensor,       # [B, T, A] (logits or log-probs; argmax same)
    input_lens: torch.Tensor,   # [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (labels [B, T] padded with 0, lengths [B])."""
    return greedy_collapse(torch.argmax(scores, dim=-1), input_lens)
