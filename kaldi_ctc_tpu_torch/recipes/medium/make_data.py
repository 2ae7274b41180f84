#!/usr/bin/env python
"""Medium-scale synthetic corpus for the end-to-end WER recipe.

Counterpart of ``recipes/medium/make_data.py`` over the port's
modules: the same output.

Generates, fully seeded, the data-prep outputs the librispeech recipe
consumes as fixtures (the data contract of
``kaldi_ctc_tpu_torch/recipes/librispeech_ctc/run.sh``, standing in for
``egs/librispeech/ctc/run.sh:21-46`` data prep):

- ``lexicon.txt`` / ``lm.arpa`` / ``phones.txt`` — a synthetic language
  (``data/synth_lang.py``): Zipf unigrams, sparse bigram/trigram
  continuations, random 3–7 phone pronunciations over 41 phones;
- ``train/{feats.ark,ali.ark,text}`` and ``test/{feats.ark,text}`` —
  utterances sampled *from the LM*; features embed each phone as a noisy
  fixed random 40-d vector sustained over a variable 6–12 raw-frame span
  (a learnable but non-trivial acoustic mapping at hires-MFCC dims), and
  alignments carry the per-frame pdf (= phone-1) exactly as
  ``ali-to-pdf`` output would.

Known floor: adjacent identical phones (within a pronunciation or across
a word boundary) merge under the ali collapse rule — the same artifact
the reference's ``ali-to-pdf --unique=true`` route has — so WER has a
small data-side floor independent of the model.

Prints one JSON line with corpus statistics (hours, utterances, vocab).
"""

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--vocab", type=int, default=5000)
    p.add_argument("--train-utts", type=int, default=400)
    p.add_argument("--test-utts", type=int, default=40)
    p.add_argument("--feat-dim", type=int, default=40)
    p.add_argument("--noise", type=float, default=0.4)
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

    # fixed per-phone acoustic embeddings (rows 1..num_phones)
    erng = np.random.default_rng(args.seed + 7)
    emb = erng.standard_normal(
        (lang.num_phones + 1, args.feat_dim)).astype(np.float32)

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
            spans = rng.integers(6, 13, size=phone_seq.shape[0])
            t = int(spans.sum())
            feats = (emb[np.repeat(phone_seq, spans)] * 2.0
                     + rng.standard_normal((t, args.feat_dim)).astype(
                         np.float32) * args.noise)
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
    }))


if __name__ == "__main__":
    sys.exit(main())
