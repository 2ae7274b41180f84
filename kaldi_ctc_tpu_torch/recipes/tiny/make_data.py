"""Generate the tiny synthetic corpus for the smoke recipe.

Counterpart of ``recipes/tiny/make_data.py`` over the port's
modules: the same output.

Features paint the active label onto a feature channel, so a small BLSTM
can learn the mapping in a few hundred steps — the yesno/rm-class
integration dataset (SURVEY build plan step 5).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

from kaldi_ctc_tpu_torch.utils import kaldi_io  # noqa: E402

NUM_TARGETS = 6
DIM = 8


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--num-utts", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    os.makedirs(args.dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    lines = []
    with kaldi_io.MatrixWriter(f"ark:{args.dir}/feats.ark") as fw, \
         kaldi_io.IntVectorWriter(f"ark:{args.dir}/ali.ark") as aw:
        for i in range(args.num_utts):
            n_labs = int(rng.integers(2, 6))
            pdfs = rng.integers(0, NUM_TARGETS - 1, size=n_labs)
            span = 8
            t = n_labs * span
            feats = rng.standard_normal((t, DIM)).astype(np.float32) * 0.1
            ali = np.zeros(t, np.int32)
            for j, pdf in enumerate(pdfs):
                feats[j * span:(j + 1) * span, (pdf + 1) % DIM] += 2.0
                ali[j * span:(j + 1) * span] = pdf
            fw[f"utt{i}"] = feats
            aw[f"utt{i}"] = ali
            labs = []
            for q in pdfs:
                if not labs or labs[-1] != q + 1:
                    labs.append(int(q) + 1)
            lines.append(f"utt{i} {' '.join(map(str, labs))}")
    with open(f"{args.dir}/text", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.num_utts} utterances to {args.dir}")


if __name__ == "__main__":
    main()
