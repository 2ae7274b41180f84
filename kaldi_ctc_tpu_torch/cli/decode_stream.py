"""Simulated online decoding — chunked streaming recognition.

Counterpart of ``kaldi_ctc_tpu/cli/decode_stream.py`` with the same
flags, defaults and output, plus ``--device`` (default ``cuda``; with no
card it raises).  Feeds each utterance to the StreamingRecognizer in
fixed-size chunks (as a live audio front end would), reports per-chunk
latency and RTF, and scores against reference text.  On the card each
chunk of a unidirectional LSTM stack is one launch of K7.  Results are
identical to offline greedy decoding for unidirectional models (state
carry is exact).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    from kaldi_ctc_tpu_torch.utils.options import expand_config_args
    argv = expand_config_args(argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats", required=True)
    p.add_argument("--cmvn", default=None)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--dir", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--chunk-frames", type=int, default=50,
                   help="frames per chunk (50 = 0.5 s at 10 ms)")
    p.add_argument("--use-priors", type=int, default=0)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--frame-subsampling-factor", type=int, default=1)
    p.add_argument("--text", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the streamed forward; 'cuda' with "
                        "no card raises")
    return p.parse_args(argv)


def main(argv=None):
    from kaldi_ctc_tpu_torch.cli.common import (read_feature_examples,
                                                resolve_device)
    from kaldi_ctc_tpu_torch.decoding.streaming import StreamingRecognizer
    from kaldi_ctc_tpu_torch.models.artifact import load_acoustic_model
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.edit_distance import edit_distance
    from kaldi_ctc_tpu_torch.utils.kaldi_io import SequentialTextReader

    args = parse_args(argv)
    log = get_logger("decode_stream")
    device = resolve_device(args.device)

    try:
        params, cfg, loaded_priors, _ = load_acoustic_model(
            args.model, args.dir, args.step, device=device)
    except ValueError as e:
        log.error("%s", e); sys.exit(1)
    priors = loaded_priors if args.use_priors else None

    rec = StreamingRecognizer(params, cfg, priors=priors,
                              acoustic_scale=args.acoustic_scale,
                              device=device)

    hyps = {}
    chunk_times = []
    total_frames = 0
    for eg in read_feature_examples(args.feats, args.cmvn, args.utt2spk,
                                    args.frame_subsampling_factor):
        feats = eg.feats
        rec.reset()
        t = feats.shape[0]
        # real frames only: zero-padding the tail chunk would pollute the
        # carried state and emit spurious labels
        emitted: list = []
        for lo in range(0, t, args.chunk_frames):
            t0 = time.perf_counter()
            emitted += rec.process(feats[lo:lo + args.chunk_frames])
            chunk_times.append(time.perf_counter() - t0)
        hyps[eg.key] = emitted
        total_frames += t

    audio_s = total_frames * 0.01 * args.frame_subsampling_factor
    # skip the first (warm-up) chunk for latency stats
    lat = chunk_times[1:] if len(chunk_times) > 1 else chunk_times
    rtf = sum(chunk_times) / max(audio_s, 1e-9)
    log.info("streamed %d utts, %.1f audio-s; median chunk latency %.1f ms",
             len(hyps), audio_s, 1e3 * float(np.median(lat)))

    out_f = open(args.output, "w") if args.output else sys.stdout
    for k in sorted(hyps):
        print(k, " ".join(map(str, hyps[k])), file=out_f)
    if args.output:
        out_f.close()

    if args.text:
        refs = {k: v.split() for k, v in SequentialTextReader(args.text)}
        err = tot = 0
        for k, hyp in hyps.items():
            if k in refs:
                err += edit_distance(refs[k], [str(x) for x in hyp])
                tot += len(refs[k])
        print(json.dumps({
            "label_error_rate": err / max(tot, 1), "errors": err,
            "ref_tokens": tot, "rtf": rtf,
            "median_chunk_latency_ms": 1e3 * float(np.median(lat)),
        }))


if __name__ == "__main__":
    main()
