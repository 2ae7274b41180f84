#!/usr/bin/env python
"""Hard synthetic corpus — a WER benchmark that can *detect* quality.

Counterpart of ``recipes/hard/make_data.py`` over the port's modules:
the same corpus, byte for byte.

The medium corpus (``kaldi_ctc_tpu_torch/recipes/medium/make_data.py``)
paints each phone as a fixed random 40-d vector at ~5:1 SNR: the
flagship-family model drives train accuracy to 1.0 and every ablation
lands on the corpus's data-side floor, so no modeling change is
measurable against it.  This generator
makes the acoustics genuinely confusable, with knobs calibrated so the
scaled-flagship config lands at mid-range WER (target 10-25%), the
regime where the reference's own headline table lives (its README's
test_clean 8.63 / test_other 20.75) and where realign/NG/DS2/bf16
ablations can separate.

Confusability machinery (each independently tunable):

- **clustered phone embeddings**: phone means are cluster centers plus
  small within-cluster offsets (``--clusters``, ``--within-sep``), so
  specific phone pairs are near-neighbors — confusions are structured,
  like real phone confusion matrices, not uniform;
- **correlated articulation noise** (``--artic``): each phone *instance*
  draws one offset vector shared by all its frames — frame-averaging
  inside an instance cannot remove it, so per-instance identity stays
  ambiguous even for a model with perfect temporal integration;
- **coarticulation** (``--coart``): linear crossfade between adjacent
  phone means over the boundary frames, blurring exactly the frames a
  CTC spike model leans on;
- **speaker variation**: per-utterance diagonal gain (lognormal
  ``--gain-var``) + bias (``--spk-var``) affine, and a per-utterance
  speaking-rate factor (``--rate-var``) scaling all spans;
- **frame noise** (``--noise`` mean, ``--snr-var`` per-utterance
  spread): i.i.d. additive Gaussian on top of everything.

Durations: base spans ``--span-lo``..``--span-hi`` raw frames per phone
(shorter than medium's 6-12, so subsampled evidence is thin), scaled by
the utterance rate factor, floored at 2 frames.

The JSON line includes ``frame_acc_nearest`` — accuracy of a
nearest-phone-mean classifier on noisy mid-phone frames — as a fast
generative-side confusability diagnostic (≈ an optimistic bound on
per-frame acoustic separability; calibrate before paying for training).

Alignments carry the per-frame pdf (= phone-1) exactly as ``ali-to-pdf``
output would; adjacent identical phones merge under the ali collapse
rule (the reference's ``--unique=true`` artifact), the same small
data-side floor the medium recipe documents.
"""

import argparse
import json
import os
import sys

import numpy as np


def make_phone_embeddings(num_phones, feat_dim, clusters, within_sep,
                          rng):
    """Cluster centers + scaled within-cluster offsets, all unit-ish."""
    centers = rng.standard_normal((clusters, feat_dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = np.zeros((num_phones + 1, feat_dim), np.float32)
    for p in range(1, num_phones + 1):
        c = centers[(p - 1) % clusters]
        off = rng.standard_normal(feat_dim).astype(np.float32)
        off /= np.linalg.norm(off)
        emb[p] = c + within_sep * off
    return emb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--vocab", type=int, default=5000)
    p.add_argument("--train-utts", type=int, default=1200)
    p.add_argument("--test-utts", type=int, default=120)
    p.add_argument("--feat-dim", type=int, default=40)
    p.add_argument("--clusters", type=int, default=12,
                   help="embedding clusters (phone confusion families)")
    p.add_argument("--within-sep", type=float, default=0.85,
                   help="within-cluster separation (relative to the "
                        "unit-norm cluster centers)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="overall embedding magnitude")
    p.add_argument("--noise", type=float, default=0.45,
                   help="mean per-frame noise sigma")
    p.add_argument("--snr-var", type=float, default=0.25,
                   help="lognormal sigma of per-utterance noise scale")
    p.add_argument("--artic", type=float, default=0.25,
                   help="per-phone-instance correlated offset sigma")
    p.add_argument("--coart", type=int, default=2,
                   help="crossfade frames at each phone boundary")
    p.add_argument("--spk-var", type=float, default=0.15,
                   help="per-utterance bias sigma")
    p.add_argument("--gain-var", type=float, default=0.1,
                   help="lognormal sigma of per-utterance diagonal gain")
    p.add_argument("--rate-var", type=float, default=0.25,
                   help="lognormal sigma of per-utterance rate factor")
    p.add_argument("--span-lo", type=int, default=4)
    p.add_argument("--span-hi", type=int, default=9)
    p.add_argument("--fs-factor", type=int, default=3,
                   help="training-time frame subsampling, used only for "
                        "the CTC feasibility floor below")
    p.add_argument("--min-sub-ratio", type=float, default=2.4,
                   help="guarantee subsampled_frames >= ratio*labels by "
                        "scaling spans up (2L+1 is the hard CTC "
                        "feasibility bound the egs skip rules enforce, "
                        "ctc-nnet-train.cc:90-94)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from kaldi_ctc_tpu_torch.data.synth_lang import make_language
    from kaldi_ctc_tpu_torch.utils.kaldi_io import (IntVectorWriter,
                                                    MatrixWriter)

    lang = make_language(vocab=args.vocab, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)

    with open(os.path.join(args.out, "lexicon.txt"), "w") as f:
        for w, phones in lang.lexicon:
            print(w, *phones, file=f)
    with open(os.path.join(args.out, "lm.arpa"), "w") as f:
        f.write(lang.arpa_text)
    with open(os.path.join(args.out, "phones.txt"), "w") as f:
        for i in range(1, lang.num_phones + 1):
            print(f"p{i:02d}", i, file=f)

    erng = np.random.default_rng(args.seed + 7)
    emb = make_phone_embeddings(lang.num_phones, args.feat_dim,
                                args.clusters, args.within_sep, erng)
    emb *= args.scale

    # generative-side confusability diagnostic: nearest-mean accuracy on
    # mid-phone frames with articulation + frame noise (no speaker
    # affine — the classifier is given the clean reference means, so
    # this is an optimistic per-frame bound)
    drng = np.random.default_rng(args.seed + 13)
    n_probe = 4000
    probe_p = drng.integers(1, lang.num_phones + 1, n_probe)
    probe = (emb[probe_p]
             + args.artic * drng.standard_normal(
                 (n_probe, args.feat_dim)).astype(np.float32)
             + args.noise * drng.standard_normal(
                 (n_probe, args.feat_dim)).astype(np.float32))
    d2 = ((probe[:, None, :] - emb[None, 1:, :]) ** 2).sum(-1)
    frame_acc = float((d2.argmin(1) + 1 == probe_p).mean())

    def write_split(split, n_utts, seed, with_ali):
        d = os.path.join(args.out, split)
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(seed)
        frames = 0
        text_lines = []
        fw = MatrixWriter(f"ark:{d}/feats.ark")
        aw = IntVectorWriter(f"ark:{d}/ali.ark") if with_ali else None
        for i in range(n_utts):
            key = f"{split}-{i:05d}"
            wids = lang.sample_sentence(rng)
            phone_seq = np.concatenate([lang.prons[w] for w in wids])
            n_ph = phone_seq.shape[0]
            rate = float(np.exp(rng.normal(0.0, args.rate_var)))
            spans = np.maximum(
                np.round(rng.integers(args.span_lo, args.span_hi + 1,
                                      size=n_ph) * rate), 2).astype(
                np.int64)
            # CTC feasibility floor: after fs subsampling the utterance
            # must carry >= min_sub_ratio frames per label, or the egs
            # skip rules drop it (2L+1 bound).  Collapsed label count
            # <= n_ph, so n_ph is the conservative L.
            need = args.min_sub_ratio * n_ph * args.fs_factor
            if spans.sum() < need:
                spans = np.maximum(
                    np.round(spans * (need / spans.sum())), 2).astype(
                    np.int64)
            t = int(spans.sum())
            # per-instance articulation offsets, repeated over spans
            artic = args.artic * rng.standard_normal(
                (n_ph, args.feat_dim)).astype(np.float32)
            means = (emb[phone_seq] + artic)          # [n_ph, D]
            feats = np.repeat(means, spans, axis=0)   # [t, D]
            # coarticulation: crossfade the last/first `coart` frames of
            # each boundary between the two instance means
            if args.coart > 0 and n_ph > 1:
                ends = np.cumsum(spans)
                for b in range(n_ph - 1):
                    e = int(ends[b])
                    for k in range(args.coart):
                        # frame e-1-k (end of phone b): blend toward b+1
                        j = e - 1 - k
                        if j <= e - int(spans[b]):
                            break
                        w = 0.5 * (k + 1) / (args.coart + 1)
                        feats[j] = (1 - w) * feats[j] + w * means[b + 1]
                        # frame e+k (start of phone b+1): blend toward b
                        j2 = e + k
                        if j2 < e + int(spans[b + 1]):
                            w2 = 0.5 * (args.coart - k) / (args.coart + 1)
                            feats[j2] = ((1 - w2) * feats[j2]
                                         + w2 * means[b])
            # speaker affine + frame noise
            gain = np.exp(rng.normal(
                0.0, args.gain_var, args.feat_dim)).astype(np.float32)
            bias = (args.spk_var * rng.standard_normal(
                args.feat_dim)).astype(np.float32)
            sigma = args.noise * float(np.exp(rng.normal(0.0,
                                                         args.snr_var)))
            feats = (feats * gain + bias
                     + sigma * rng.standard_normal(
                         (t, args.feat_dim)).astype(np.float32))
            fw[key] = feats.astype(np.float32)
            if aw is not None:
                aw[key] = np.repeat(phone_seq - 1, spans).astype(np.int32)
            text_lines.append(
                key + " " + " ".join(lang.words[w] for w in wids))
            frames += t
        fw.close()
        if aw is not None:
            aw.close()
        with open(os.path.join(d, "text"), "w") as f:
            f.write("\n".join(text_lines) + "\n")
        return frames

    tr = write_split("train", args.train_utts, args.seed + 1, True)
    te = write_split("test", args.test_utts, args.seed + 2, False)
    print(json.dumps({
        "vocab": args.vocab, "num_phones": lang.num_phones,
        "train_utts": args.train_utts, "test_utts": args.test_utts,
        "train_hours": round(tr * 0.01 / 3600, 2),
        "test_hours": round(te * 0.01 / 3600, 2),
        "frame_acc_nearest": round(frame_acc, 3),
        "knobs": {"within_sep": args.within_sep, "noise": args.noise,
                  "artic": args.artic, "coart": args.coart,
                  "span": [args.span_lo, args.span_hi],
                  "rate_var": args.rate_var, "snr_var": args.snr_var},
    }))


if __name__ == "__main__":
    sys.exit(main())
