"""Batched CTC prefix beam search on the scores' device.

Counterpart of ``kaldi_ctc_tpu/decoding/prefix_beam.py`` (a
``jax.lax.scan`` over frames): the same dense [B, W, ...] beam state and
the same per-frame steps, run as a Python loop over frames of torch ops.
The LM-free decoder between greedy best-path and the WFST TLG decoder:
per frame a (beam × top-K) expansion, duplicate prefixes merged by an
O(P²) masked logsumexp over the candidate pool, and the best W kept.

Three things keep it equal to the JAX package's:

- **Ties.**  ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  Pools hold many entries at
  exactly −1e30, and bf16 scores tie often, so both selections are a
  stable descending sort cut to k (:func:`_top_k`).
- **Hashes.**  The two rolling prefix hashes are uint32 with wrap-around.
  They are held in int64 and reduced mod 2^32 after each multiply-add,
  the product split so that no intermediate passes 2^63
  (:func:`_hash_step`).
- **Constants.**  −1e30 as log 0 (hazard F4), ``k = min(prune_k, A-1)``,
  the 1e-37 floor inside the class logsumexp, and the first pool index of
  each class as its representative.

State per (batch, beam): prefix history [Lmax], length, rolling hashes,
p_blank / p_nonblank log-probabilities (the classic two-track
bookkeeping).  There is no kernel here: the JAX package has none either.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["prefix_beam_search"]

_NEG_INF = -1e30
_HASH_MULT = 1000003
_HASH_MULT2 = 2654435761  # independent channel: 64-bit key
_MASK32 = 0xFFFFFFFF


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _hash_step(h: torch.Tensor, mult: int, tok: torch.Tensor) -> torch.Tensor:
    """(h * mult + tok + 1) mod 2^32 for int64 h, tok in [0, 2^32): the
    multiplier split in 16-bit halves keeps every product below 2^48."""
    lo = h * (mult & 0xFFFF)
    hi = ((h * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi + tok + 1) & _MASK32


def prefix_beam_search(
    log_probs: torch.Tensor,    # [B, T, A] log posteriors (or scaled scores)
    input_lens: torch.Tensor,   # [B]
    beam: int = 8,
    prune_k: int = 8,
    max_len: int = 0,           # max output labels; 0 → T
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode → (labels [B, Lmax] int32, lengths [B] int32, scores [B]).

    Returns the best prefix per utterance with its total log-probability.
    """
    with torch.inference_mode():
        return _search(log_probs.float(), input_lens, beam, prune_k,
                       max_len, blank)


def _search(log_probs, input_lens, beam, prune_k, max_len, blank):
    b, t_max, a = log_probs.shape
    dev = log_probs.device
    l_max = max_len if max_len > 0 else t_max
    w = beam
    k = min(prune_k, a - 1)
    pool = w * (1 + k)
    lens = torch.as_tensor(input_lens, device=dev).long()

    # beam state
    prefixes = torch.zeros((b, w, l_max), dtype=torch.int32, device=dev)
    plen = torch.zeros((b, w), dtype=torch.int64, device=dev)
    last = torch.full((b, w), -1, dtype=torch.int64, device=dev)
    hashes = torch.zeros((b, w), dtype=torch.int64, device=dev)
    hashes2 = torch.zeros((b, w), dtype=torch.int64, device=dev)
    p_b = torch.full((b, w), _NEG_INF, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((b, w), _NEG_INF, device=dev)

    # bookkeeping for each pool entry: source beam, and for the W*K
    # extensions the top-k slot of the appended token
    beams = torch.arange(w, device=dev)
    src_beam = torch.cat([beams, beams.repeat_interleave(k)])[None].expand(
        b, pool)                                          # [B, P]
    is_ext = torch.arange(pool, device=dev) >= w          # [P]
    idx = torch.arange(pool, device=dev)
    positions = torch.arange(l_max, device=dev)
    neg_wk = torch.full((b, w * k), _NEG_INF, device=dev)

    # frames past every row's length change nothing
    steps = min(t_max, int(lens.max())) if b else 0
    for t in range(steps):
        lp_t = log_probs[:, t]                            # [B, A]
        lp_noblank = lp_t.clone()
        lp_noblank[:, blank] = _NEG_INF
        topk_lp, topk_id = _top_k(lp_noblank, k)          # [B, K]

        total = torch.logaddexp(p_b, p_nb)                # [B, W]

        # candidate 0 (per beam): keep the prefix.
        #   new p_b: any path + blank emission
        #   new p_nb: repeat the last label (from p_nb only)
        keep_pb = total + lp_t[:, blank][:, None]
        lp_last = torch.gather(lp_t, 1, torch.clamp_min(last, 0))
        keep_pnb = torch.where(last >= 0, p_nb + lp_last,
                               torch.full_like(p_nb, _NEG_INF))

        # candidates 1..K (per beam): extend with token topk_id[k]; a
        # token equal to the last label extends from p_b only (a repeat
        # across a blank), any other from both tracks
        tok = topk_id[:, None, :]                         # [B, 1, K]
        same_as_last = tok == last[:, :, None]            # [B, W, K]
        src = torch.where(same_as_last, p_b[:, :, None], total[:, :, None])
        ext_pnb = src + topk_lp[:, None, :]               # [B, W, K]
        ext_pnb = torch.where((plen < l_max)[:, :, None], ext_pnb,
                              torch.full_like(ext_pnb, _NEG_INF))

        # pool: W keep-candidates + W*K extend-candidates
        pool_pb = torch.cat([keep_pb, neg_wk], dim=1)
        pool_pnb = torch.cat([keep_pnb, ext_pnb.reshape(b, w * k)], dim=1)
        app_tok = torch.cat([torch.full((b, w), -1, dtype=torch.int64,
                                        device=dev),
                             tok.expand(b, w, k).reshape(b, w * k)], dim=1)

        tok_u = torch.clamp_min(app_tok, 0)
        new_len = torch.gather(plen, 1, src_beam) + is_ext
        src_hash = torch.gather(hashes, 1, src_beam)
        new_hash = torch.where(is_ext, _hash_step(src_hash, _HASH_MULT,
                                                  tok_u), src_hash)
        src_hash2 = torch.gather(hashes2, 1, src_beam)
        new_hash2 = torch.where(is_ext, _hash_step(src_hash2, _HASH_MULT2,
                                                   tok_u), src_hash2)
        new_last = torch.where(is_ext, app_tok,
                               torch.gather(last, 1, src_beam))

        # merge duplicate prefixes: same (hash64, len, last) → same prefix
        # (two independent 32-bit rolling hashes make collisions ~2^-64)
        eq = ((new_hash[:, :, None] == new_hash[:, None, :])
              & (new_hash2[:, :, None] == new_hash2[:, None, :])
              & (new_len[:, :, None] == new_len[:, None, :])
              & (new_last[:, :, None] == new_last[:, None, :]))  # [B, P, P]

        def seg_lse(scores):
            # logsumexp of scores over each equality class
            masked = torch.where(eq, scores[:, None, :],
                                 torch.full_like(scores[:, None, :],
                                                 _NEG_INF))
            m = masked.max(dim=2).values
            s = torch.where(eq, torch.exp(scores[:, None, :] - m[:, :, None]),
                            torch.zeros((), device=dev)).sum(dim=2)
            return m + torch.log(torch.clamp_min(s, 1e-37))

        # representative = first pool index in each class; the others
        # carry no mass, or top-k could select duplicates that
        # double-count on later frames
        first = torch.where(eq, idx[None, None, :],
                            torch.full((), pool, device=dev)).min(dim=2).values
        first_in_class = first == idx[None, :]
        neg = torch.full((b, pool), _NEG_INF, device=dev)
        merged_pb = torch.where(first_in_class, seg_lse(pool_pb), neg)
        merged_pnb = torch.where(first_in_class, seg_lse(pool_pnb), neg)
        merged_total = torch.logaddexp(merged_pb, merged_pnb)

        # top-W beams from the pool
        _, top_idx = _top_k(merged_total, w)              # [B, W]

        def sel(x):
            return torch.gather(x, 1, top_idx)

        nb_src = sel(src_beam)
        nb_tok = sel(app_tok)

        # rebuild prefixes: gather source rows, append the token
        gathered = torch.gather(prefixes, 1,
                                nb_src[:, :, None].expand(b, w, l_max))
        src_len = torch.gather(plen, 1, nb_src)
        pos_mask = ((positions[None, None, :] == src_len[:, :, None])
                    & (nb_tok[:, :, None] >= 0))
        new_prefixes = torch.where(
            pos_mask, torch.clamp_min(nb_tok, 0)[:, :, None].to(torch.int32),
            gathered)

        # frames past input_len leave everything unchanged
        active = (t < lens)[:, None]
        prefixes = torch.where(active[:, :, None], new_prefixes, prefixes)
        plen = torch.where(active, sel(new_len), plen)
        last = torch.where(active, sel(new_last), last)
        hashes = torch.where(active, sel(new_hash), hashes)
        hashes2 = torch.where(active, sel(new_hash2), hashes2)
        p_b = torch.where(active, sel(merged_pb), p_b)
        p_nb = torch.where(active, sel(merged_pnb), p_nb)

    final = torch.logaddexp(p_b, p_nb)                    # [B, W]
    best = torch.argmax(final, dim=1)                     # [B]
    rows = torch.arange(b, device=dev)
    return (prefixes[rows, best], plen[rows, best].to(torch.int32),
            final[rows, best])
