"""Online (streaming) CTC recognition with carried recurrent state.

Counterpart of ``kaldi_ctc_tpu/decoding/streaming.py``.  CTC and a
unidirectional stack make this simple: a per-chunk forward with an
explicit carry ((h, c) for an LSTM, h for a GRU) equals the
full-utterance forward, so the labels match offline greedy decoding
while the latency is one chunk.

Both recognizers run eagerly on the device their parameters live on
(there is no ``jit``): on CUDA each chunk of an LSTM stack is one launch
of the wavefront kernel K7 (``ops.rnn.rnn_forward_stream``); a GRU stack
runs the per-layer loop in torch ops on the card, as the JAX package runs
its XLA scan (it has no GRU stack kernel); on the CPU every mode runs the
plain per-layer loop.  The FT front layer (``front_affine_dim``) is
frame-local, so it streams exactly: each chunk runs ``am_forward``'s
``front_layer`` before the stack (every ``front_nonlin``; the JAX
package's recognizers apply relu whatever the config names, ROADMAP §3).
Splicing and the conv front reach across chunk boundaries and are
refused, as in the JAX package.

Usage:
    rec = StreamingRecognizer(params, cfg, priors=...)
    for chunk in feature_chunks:          # [T_chunk, D] each
        new_labels = rec.process(chunk)   # incremental emissions
    labels = rec.finalize()
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from kaldi_ctc_tpu_torch.models.acoustic import AmConfig, front_layer
from kaldi_ctc_tpu_torch.ops.rnn import (init_stream_state, matmul_f32acc,
                                         rnn_forward_stream)
from kaldi_ctc_tpu_torch.params import tree_flatten

__all__ = ["StreamingRecognizer", "BatchStreamingRecognizer"]

_SPLICE = ("streaming does not support input splicing (frame context "
           "crosses chunk boundaries); train without "
           "--splice-left/--splice-right for streaming serving")
_CONV = ("streaming does not support the DS2 conv front end (the time "
         "kernel crosses chunk boundaries)")


def _check_streamable(cfg: AmConfig, bidirectional_msg: str) -> None:
    if cfg.bidirectional:
        raise ValueError(bidirectional_msg)
    if cfg.splice_left or cfg.splice_right:
        raise ValueError(_SPLICE)
    if cfg.conv_layers:
        raise ValueError(_CONV)


class _ChunkScorer:
    """The chunk function shared by both recognizers: features of one
    chunk and the carried states → per-frame scores and new states."""

    def __init__(self, params: Any, cfg: AmConfig,
                 priors: Optional[np.ndarray], acoustic_scale: float,
                 device):
        self.cfg = cfg
        self.device = torch.device(device if device is not None
                                   else tree_flatten(params)[0].device)
        cdt = cfg.rnn.dtype
        # the matrices cast to the compute dtype once, biases kept f32:
        # each chunk then reads them as they are
        self.rnn = [{"dirs": [{"w_x": d["w_x"].to(self.device, cdt),
                               "w_h": d["w_h"].to(self.device, cdt),
                               "b": d["b"].to(self.device, torch.float32)}
                              for d in layer["dirs"]]}
                    for layer in params["rnn"]]
        self.out_w = params["out_w"].to(self.device, cdt)
        self.out_b = params["out_b"].to(self.device, torch.float32)
        self.front = ({k: params[k].to(self.device, torch.float32)
                       for k in ("front_w", "front_b")}
                      if cfg.front_affine_dim else None)
        self.log_priors = (None if priors is None else torch.log(
            torch.as_tensor(np.asarray(priors, np.float32),
                            device=self.device)))
        self.acoustic_scale = acoustic_scale

    def __call__(self, x: torch.Tensor, lens: Optional[torch.Tensor],
                 states: List[Any]):
        """x [T, B, D] f32 on the device, lens [B] or None → (scores
        [T, B, A] f32, new states); the given states are not changed."""
        with torch.inference_mode():
            if self.front is not None:
                x = front_layer(self.front, x, self.cfg)
            y, new_states = rnn_forward_stream(self.rnn, x, self.cfg.rnn,
                                               states, lens=lens)
            t, b, h = y.shape
            # am_forward's output projection: compute-dtype operands, f32
            # accumulation, so streaming equals the offline forward
            logits = (matmul_f32acc(y.reshape(t * b, h), self.out_w,
                                    self.cfg.rnn.dtype)
                      + self.out_b).reshape(t, b, -1)
            scores = torch.log_softmax(logits, dim=-1)
            if self.log_priors is not None:
                scores = scores - self.log_priors
            return self.acoustic_scale * scores, new_states


class StreamingRecognizer:
    """Single-stream greedy CTC recognizer over feature chunks."""

    def __init__(
        self,
        params: Any,
        cfg: AmConfig,
        priors: Optional[np.ndarray] = None,
        acoustic_scale: float = 1.0,
        blank: int = 0,
        device=None,
    ):
        _check_streamable(
            cfg, "streaming requires a unidirectional model "
                 "(--bidirectional 0); a bidirectional stack needs the "
                 "whole utterance")
        self._cfg = cfg
        self._blank = blank
        self.chunk_fn = _ChunkScorer(params, cfg, priors, acoustic_scale,
                                     device)
        self.reset()

    def process(self, feats) -> List[int]:
        """Feed one chunk [T, D]; returns labels newly emitted."""
        if feats.shape[0] == 0:
            return []
        x = torch.as_tensor(feats, dtype=torch.float32,
                            device=self.chunk_fn.device)[:, None, :]
        scores, self._state = self.chunk_fn(x, None, self._state)
        new: List[int] = []
        for lab in scores[:, 0].argmax(dim=-1).tolist():
            if lab != self._blank and lab != self._last:
                new.append(int(lab))
            self._last = lab
        self._labels.extend(new)
        return new

    def finalize(self) -> List[int]:
        """Full collapsed label sequence seen so far."""
        return list(self._labels)

    def reset(self) -> None:
        self._state = init_stream_state(self._cfg.rnn, 1,
                                        self.chunk_fn.device)
        self._last = self._blank
        self._labels: List[int] = []


class BatchStreamingRecognizer:
    """Serving-oriented batched streaming: N independent streams decoded
    per chunk of a fixed length.  The per-slot state stays on the device
    as f32 [N, H] tensors per layer, so a slot reset zeroes one row in
    place.  ``ticks`` counts the chunks processed."""

    def __init__(
        self,
        params: Any,
        cfg: AmConfig,
        max_streams: int,
        chunk_frames: int,
        priors: Optional[np.ndarray] = None,
        acoustic_scale: float = 1.0,
        blank: int = 0,
        device=None,
    ):
        _check_streamable(cfg, "streaming requires a unidirectional model")
        self._cfg = cfg
        self._blank = blank
        self._b = max_streams
        self._t = chunk_frames
        self._dim = cfg.input_dim
        self.chunk_fn = _ChunkScorer(params, cfg, priors, acoustic_scale,
                                     device)
        self._state = init_stream_state(cfg.rnn, max_streams,
                                        self.chunk_fn.device)
        self._last = [blank] * max_streams
        self._labels: List[List[int]] = [[] for _ in range(max_streams)]
        self.ticks = 0

    def process(self, chunks, valid_frames) -> List[List[int]]:
        """Feed one [B, T_chunk, D] block (idle slots: valid_frames 0).

        Returns per-slot newly emitted labels."""
        b, t, d = chunks.shape
        if (b, t, d) != (self._b, self._t, self._dim):
            raise ValueError(
                f"expected [{self._b}, {self._t}, {self._dim}] chunks, "
                f"got {tuple(chunks.shape)}")
        dev = self.chunk_fn.device
        x = torch.as_tensor(chunks, dtype=torch.float32,
                            device=dev).transpose(0, 1)      # [T, B, D]
        valid = [int(v) for v in np.asarray(valid_frames)]
        lens = torch.tensor(valid, dtype=torch.int32, device=dev)
        scores, self._state = self.chunk_fn(x, lens, self._state)
        self.ticks += 1
        ids = scores.argmax(dim=-1).cpu().numpy()            # [T, B]
        out: List[List[int]] = []
        for s in range(self._b):
            new: List[int] = []
            for ti in range(valid[s]):
                lab = int(ids[ti, s])
                if lab != self._blank and lab != self._last[s]:
                    new.append(lab)
                self._last[s] = lab
            self._labels[s].extend(new)
            out.append(new)
        return out

    def finalize(self, slot: int) -> List[int]:
        return list(self._labels[slot])

    def reset_slot(self, slot: int) -> None:
        """Free a slot for a new stream: its row of every layer's carried
        state is zeroed in place on the device."""
        with torch.inference_mode():     # the chunks' states are inference tensors
            for st in self._state:
                for a in (st if isinstance(st, tuple) else (st,)):
                    a[slot].zero_()
        self._last[slot] = self._blank
        self._labels[slot] = []
