"""Write a training pool's Kaldi archives to standard output.

The benchmark's own writer of Kaldi binary tables, run as the command of
a piped rspecifier, so the pool's features and alignments reach
``train_ctc`` without touching the disk:

  --feats "ark:python3 -m asrbench.featgen --traffic T --seed N --part train --what feats |"

``--what feats``: float matrices ("FM"), ``--what ali``: per-frame pdf
ids as int32 vectors.  Numpy only.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys

import numpy as np

from asrbench import traffic as tr

__all__ = ["matrix_record", "int_vector_record", "write_part"]


def matrix_record(key: str, mat: np.ndarray) -> bytes:
    """One binary float-matrix record of a Kaldi archive."""
    mat = np.ascontiguousarray(mat, np.float32)
    return (key.encode() + b" \0BFM " + b"\x04" + struct.pack("<i", mat.shape[0])
            + b"\x04" + struct.pack("<i", mat.shape[1]) + mat.tobytes())


def int_vector_record(key: str, vec: np.ndarray) -> bytes:
    """One binary int32-vector record of a Kaldi archive."""
    vec = np.ascontiguousarray(vec, np.int32)
    return (key.encode() + b" \0B" + b"\x04" + struct.pack("<i", vec.shape[0])
            + vec.tobytes())


def write_part(out, traffic: dict, seed: int, part: str, what: str,
               dim: int) -> None:
    for u in tr.train_pool(traffic, seed, part):
        if what == "feats":
            out.write(matrix_record(u.key, tr.utterance_features(u, seed, dim)))
        else:
            out.write(int_vector_record(
                u.key, tr.utterance_alignment(u, traffic, seed)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--part", choices=["train", "valid"], required=True)
    p.add_argument("--what", choices=["feats", "ali"], required=True)
    p.add_argument("--dim", type=int, default=40)
    args = p.parse_args(argv)
    with open(args.traffic) as f:
        traffic = json.load(f)
    out = sys.stdout.buffer
    write_part(out, traffic, args.seed, args.part, args.what, args.dim)
    out.flush()


if __name__ == "__main__":
    main()
