"""Feature extraction driver (compute-mfcc-feats / compute-fbank-feats).

Counterpart of ``kaldi_ctc_tpu/cli/compute_feats.py`` with the same
flags, defaults and archives, plus ``--device`` (default ``cuda``; with
no card it raises).  Reads wav.scp (plain paths or `cmd ... |` shell-pipe
entries), computes MFCC, fbank, PLP or spectrogram features on the device
(MFCC and fbank through the log-mel kernel K4 on the card, one launch per
utterance), pitch on the host, and writes a Kaldi feature archive (+scp),
optionally compressed like the reference recipes.  With --segments the
recordings are cut into utterances first (extract-segments:
'utt reco start-sec end-sec', end -1 = till the end).  ``--dither > 0``
draws from a ``torch.Generator`` seeded per utterance as the JAX package
seeds its key, so the dither noise differs from JAX's (features match at
``--dither 0``).
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--wav-scp", required=True)
    p.add_argument("--segments", default=None,
                   help="extract-segments file: 'utt reco start end' "
                        "(seconds; end -1 = recording end)")
    p.add_argument("--min-segment-length", type=float, default=0.1,
                   help="skip segments shorter than this (seconds)")
    p.add_argument("--type", choices=["mfcc", "fbank", "plp",
                                      "spectrogram", "pitch"],
                   default="mfcc",
                   help="pitch = compute-kaldi-pitch-feats | "
                        "process-kaldi-pitch-feats (3-dim)")
    p.add_argument("--add-pitch", type=int, default=0,
                   help="append 3-dim processed pitch to mfcc/fbank "
                        "(paste-feats analogue; rows matched by "
                        "truncation to the shorter stream)")
    p.add_argument("--config", choices=["default", "hires"], default="default")
    p.add_argument("--num-mel-bins", type=int, default=None)
    p.add_argument("--num-ceps", type=int, default=None)
    p.add_argument("--dither", type=float, default=0.0,
                   help="dither amount (deterministic seed per utterance)")
    p.add_argument("--htk-compat", type=int, default=0,
                   help="HTK output order: energy/C0 last; C0 scaled by "
                        "sqrt(2) when no energy (feature-mfcc.h:47-49)")
    p.add_argument("--vtln-warp", type=float, default=1.0,
                   help="VTLN warp factor (mel-computations.cc "
                        "VtlnWarpFreq)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True,
                   help="output like ark,scp:feats.ark,feats.scp")
    p.add_argument("--compress", type=int, default=1)
    p.add_argument("--speed-perturb", default=None,
                   help="comma list of speed factors, e.g. 0.9,1.0,1.1 "
                        "(the recipe's 3-way perturbation, "
                        "run_ctc_phone.sh stage 0); perturbed copies get "
                        "Kaldi-style 'spFACTOR-' key prefixes")
    p.add_argument("--device", default="cuda",
                   help="torch device the features are computed on; "
                        "'cuda' with no card raises")
    return p.parse_args(argv)


def main(argv=None):
    import zlib

    import torch

    from kaldi_ctc_tpu_torch.cli.common import resolve_device
    from kaldi_ctc_tpu_torch.features import (
        FbankOptions, FrameOptions, MfccOptions, compute_fbank, compute_mfcc,
        read_wave)
    from kaldi_ctc_tpu_torch.features.mel import MelOptions
    from kaldi_ctc_tpu_torch.utils import get_logger
    from kaldi_ctc_tpu_torch.utils.kaldi_io import MatrixWriter, SequentialTextReader

    args = parse_args(argv)
    log = get_logger("compute_feats")
    device = resolve_device(args.device)
    frame_opts = FrameOptions(dither=args.dither)

    from kaldi_ctc_tpu_torch.features.pitch import compute_and_process_pitch

    if args.type == "pitch":
        opts = None
        compute = None
    elif args.type == "mfcc":
        opts = MfccOptions.hires() if args.config == "hires" else MfccOptions()
        if args.num_mel_bins or args.num_ceps:
            opts = MfccOptions(
                frame_opts=frame_opts,
                mel_opts=MelOptions(
                    num_bins=args.num_mel_bins or opts.mel_opts.num_bins,
                    low_freq=opts.mel_opts.low_freq,
                    high_freq=opts.mel_opts.high_freq),
                num_ceps=args.num_ceps or opts.num_ceps,
                use_energy=opts.use_energy)
        else:
            opts = MfccOptions(frame_opts=frame_opts, mel_opts=opts.mel_opts,
                               num_ceps=opts.num_ceps,
                               use_energy=opts.use_energy)
        if args.htk_compat:
            opts = MfccOptions(**{**opts.__dict__, "htk_compat": True})
        compute = compute_mfcc
    elif args.type == "plp":
        from kaldi_ctc_tpu_torch.features.plp import PlpOptions, compute_plp
        mel = MelOptions(num_bins=args.num_mel_bins or 23)
        opts = PlpOptions(frame_opts=frame_opts, mel_opts=mel,
                          num_ceps=args.num_ceps or 13,
                          htk_compat=bool(args.htk_compat))
        compute = compute_plp
    elif args.type == "spectrogram":
        from kaldi_ctc_tpu_torch.features.spectrogram import (
            SpectrogramOptions, compute_spectrogram)
        opts = SpectrogramOptions(frame_opts=frame_opts)
        compute = compute_spectrogram
    else:
        mel = MelOptions(num_bins=args.num_mel_bins or 23)
        opts = FbankOptions(frame_opts=frame_opts, mel_opts=mel,
                            htk_compat=bool(args.htk_compat))
        compute = compute_fbank

    factors = ([float(x) for x in args.speed_perturb.split(",")]
               if args.speed_perturb else [1.0])

    from kaldi_ctc_tpu_torch.features.resample import speed_perturb

    segments = None
    if args.segments:
        # reco -> [(utt, start_sec, end_sec)], preserving file order
        segments = {}
        with open(args.segments) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                utt, reco, start, end = parts
                segments.setdefault(reco, []).append(
                    (utt, float(start), float(end)))

    def _utterances():
        """Yield (utt_key, samples, rate): whole recordings, or slices
        per the segments file (one read per recording)."""
        n_short = 0
        for key, path in SequentialTextReader(args.wav_scp):
            samples, rate = read_wave(path.strip())
            if segments is None:
                yield key, samples[0], rate
                continue
            for utt, start, end in segments.get(key, ()):
                b = int(round(start * rate))
                e = (samples.shape[1] if end < 0
                     else min(int(round(end * rate)), samples.shape[1]))
                if e - b < args.min_segment_length * rate:
                    n_short += 1
                    continue
                yield utt, samples[0, b:e], rate
        if n_short:
            log.warning("skipped %d segments shorter than %.2fs",
                        n_short, args.min_segment_length)

    n = 0
    with MatrixWriter(args.out, compress=bool(args.compress)) as w:
        for key, utt_samples, rate in _utterances():
            for factor in factors:
                wave_np = speed_perturb(utt_samples, rate, factor)
                wave = torch.as_tensor(wave_np, device=device)
                out_key = (key if factor == 1.0
                           else f"sp{factor:g}-{key}")
                if args.type == "pitch":
                    feats = compute_and_process_pitch(wave_np,
                                                      seed=args.seed)
                else:
                    # stable per-utterance seed: Python's hash() is
                    # salted per process and would make dither
                    # irreproducible across runs/jobs
                    generator = (torch.Generator(device=device).manual_seed(
                        args.seed + zlib.crc32(out_key.encode()))
                        if args.dither > 0 else None)
                    feats = compute(wave, opts, generator=generator,
                                    vtln_warp=args.vtln_warp).cpu().numpy()
                    if args.add_pitch:
                        pf = compute_and_process_pitch(wave_np,
                                                       seed=args.seed)
                        t = min(feats.shape[0], pf.shape[0])
                        feats = np.concatenate([feats[:t], pf[:t]], axis=1)
                w[out_key] = feats
                n += 1
    log.info("wrote %d feature matrices", n)


if __name__ == "__main__":
    main()
