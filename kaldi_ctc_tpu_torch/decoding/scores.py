"""Acoustic score preparation for decoding.

Counterpart of ``kaldi_ctc_tpu/decoding/scores.py`` (CtcDecodableAmNnet,
``ctc/ctc-decodable-am-nnet.cc:29-87``): softmax posteriors →
blank-threshold frame handling → floor + log → divide by priors →
acoustic scale.  Frames whose blank posterior reaches the threshold are
forced to pure blank (0 for blank, -1e30 — never -inf, hazard F4 — for
every other label), and the mask is returned so host-side decoders can
drop them exactly like the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["acoustic_scores"]


def acoustic_scores(
    logits: torch.Tensor,              # [B, T, A]
    priors: Optional[np.ndarray] = None,
    acoustic_scale: float = 1.0,
    blank_threshold: float = 0.98,     # run_ctc_phone.sh:38
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (scores [B, T, A] f32, skip_mask [B, T] bool)."""
    post = torch.softmax(logits.float(), dim=-1)
    if blank_threshold < 1.0:
        skip = post[..., blank] >= blank_threshold
    else:
        skip = torch.zeros(post.shape[:2], dtype=torch.bool,
                           device=post.device)
    floor = torch.finfo(torch.float32).tiny
    log_post = torch.log(torch.clamp_min(post, floor))
    if priors is not None:
        log_post = log_post - torch.log(torch.as_tensor(
            np.asarray(priors, np.float32), device=post.device))[None, None]
    scores = acoustic_scale * log_post
    one_hot_blank = torch.full((logits.shape[-1],), -1e30,
                               dtype=torch.float32, device=post.device)
    one_hot_blank[blank] = 0.0
    scores = torch.where(skip[..., None], one_hot_blank[None, None], scores)
    return scores, skip
