#!/usr/bin/env python3
"""Synthesize a Kaldi-format mini corpus so run.sh executes END TO END.

Counterpart of ``recipes/librispeech_ctc/make_synth_data.py`` on the
port's CLIs: the same corpus, fixtures and printed line; ``--device``
(default ``cuda``, as the port's CLIs) is where ``compute_feats`` runs.

The librispeech recipe's data contract (run.sh header) assumes fixtures
prepared with Kaldi tooling; no Librispeech audio ships with the repo,
so this script manufactures every fixture from scratch — the real stage
chain, synthetic audio:

  wav.scp of GENERATED WAVEFORMS (per-phone two-formant tones + noise,
      per-speaker formant warp)
    → cli.compute_feats (40-d hires MFCC, the real feature extractor)
    → cli.compute_cmvn (per-speaker stats)
  frame-level pdf alignments from the known synthesis timing
      → $ali/ali.pdf.ark (prepare_egs applies the ali-to-pdf collapse)
  lexicon + pruned-trigram ARPA (data/synth_lang.make_language)
      → cli.graph_tool make-tlg → $graph/CTC.fst + words.txt

After this, `data=... ali=... graph=... num_targets=N bash run.sh`
exercises egs → train → diagnostics/priors → WFST lattice decode →
score — run.sh's full stage contract — with the audio itself being
the only non-real thing.  WER on this corpus is reported by run.sh
as usual (the corpus is easy by design; the HARD synthetic WER
benchmark lives in kaldi_ctc_tpu_torch/recipes/hard).

Usage:
  python make_synth_data.py --out /tmp/ls_synth [--vocab 150]
  data=/tmp/ls_synth/data ali=/tmp/ls_synth/ali \
    graph=/tmp/ls_synth/graph exp=/tmp/ls_synth/exp \
    num_targets=<printed> epochs=4 bash run.sh
"""

import argparse
import io
import json
import os
import subprocess
import sys
import wave

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
sys.path.insert(0, REPO)

SR = 16000
FRAME = 160          # 10 ms shift
WINDOW = 400         # 25 ms window


def synth_utterance(prons, rng, warp):
    """Phone-id pron sequence → (waveform int16, per-frame phone ids)."""
    frames = []
    for pron in prons:
        for p in pron:
            frames.extend([int(p)] * int(rng.integers(9, 17)))
    n_frames = len(frames)
    n_samp = WINDOW + FRAME * (n_frames - 1)
    t = np.arange(n_samp) / SR
    sig = np.zeros(n_samp, np.float64)
    # per-phone two-formant tone over its frame span (sample-accurate)
    for i, p in enumerate(frames):
        lo = i * FRAME
        hi = min(n_samp, lo + FRAME if i + 1 < n_frames else n_samp)
        f1 = (260.0 + 167.0 * p) * warp
        f2 = (1050.0 + 233.0 * ((p * 7) % 23)) * warp
        seg = t[lo:hi]
        sig[lo:hi] = (np.sin(2 * np.pi * f1 * seg)
                      + 0.6 * np.sin(2 * np.pi * f2 * seg))
    sig += 0.03 * rng.standard_normal(n_samp)
    # gentle fade to avoid clicks
    ramp = min(200, n_samp // 4)
    sig[:ramp] *= np.linspace(0, 1, ramp)
    sig[-ramp:] *= np.linspace(1, 0, ramp)
    pcm = np.clip(sig * 0.25 * 32767, -32767, 32767).astype(np.int16)
    return pcm, np.asarray(frames, np.int32)


def _env():
    """The stages' environment: the repo first on PYTHONPATH, the
    caller's entries kept behind it (as run.sh keeps them)."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def write_wav(path, pcm):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab", type=int, default=150)
    ap.add_argument("--train-utts", type=int, default=80)
    ap.add_argument("--test-utts", type=int, default=16)
    ap.add_argument("--words-per-utt", type=int, default=6)
    ap.add_argument("--speakers", type=int, default=5)
    ap.add_argument("--num-phones", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device compute_feats runs on")
    args = ap.parse_args()

    from kaldi_ctc_tpu_torch.data.synth_lang import make_language
    from kaldi_ctc_tpu_torch.utils.kaldi_io import IntVectorWriter

    rng = np.random.default_rng(args.seed)
    lang = make_language(vocab=args.vocab, num_phones=args.num_phones,
                         seed=args.seed)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)

    # language fixtures
    with open(os.path.join(out, "lexicon.txt"), "w") as f:
        for w, pron in lang.lexicon:
            f.write(w + " " + " ".join(pron) + "\n")
    with open(os.path.join(out, "lm.arpa"), "w") as f:
        f.write(lang.arpa_text)
    with open(os.path.join(out, "phones.txt"), "w") as f:
        f.write("<eps> 0\n")
        for i in range(1, args.num_phones + 1):
            f.write(f"p{i:02d} {i}\n")

    # Zipf word sampler (matches the LM's unigram shape)
    p = 1.0 / (np.arange(args.vocab) + 2.7)
    p /= p.sum()

    ali_dir = os.path.join(out, "ali")
    os.makedirs(ali_dir, exist_ok=True)
    ali_writer = IntVectorWriter(
        f"ark:{os.path.join(ali_dir, 'ali.pdf.ark')}")

    for split, n_utts in (("train", args.train_utts),
                          ("test_clean", args.test_utts)):
        d = os.path.join(out, "data", split)
        wav_dir = os.path.join(d, "wav")
        os.makedirs(wav_dir, exist_ok=True)
        wav_scp, texts, utt2spk = [], [], []
        for u in range(n_utts):
            spk = int(rng.integers(args.speakers))
            warp = 0.9 + 0.2 * spk / max(args.speakers - 1, 1)
            uid = f"{split[:2]}-{spk:02d}-{u:04d}"
            wids = rng.choice(args.vocab, size=args.words_per_utt, p=p)
            words = [lang.words[i] for i in wids]
            prons = [lang.prons[i] for i in wids]
            pcm, frames = synth_utterance(prons, rng, warp)
            wp = os.path.join(wav_dir, uid + ".wav")
            write_wav(wp, pcm)
            wav_scp.append(f"{uid} {wp}")
            texts.append(f"{uid} " + " ".join(words))
            utt2spk.append(f"{uid} spk{spk}")
            if split == "train":
                ali_writer.write(uid, frames - 1)  # pdf = phone_id - 1
        for name, lines in (("wav.scp", wav_scp), ("text", texts),
                            ("utt2spk", utt2spk)):
            with open(os.path.join(d, name), "w") as f:
                f.write("\n".join(lines) + "\n")

        # real feature chain: hires MFCC then per-speaker CMVN
        env = _env()
        subprocess.run(
            [sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.compute_feats",
             "--wav-scp", os.path.join(d, "wav.scp"),
             "--type", "mfcc", "--config", "hires",
             "--out", f"ark,scp:{d}/feats.ark,{d}/feats.scp",
             "--device", args.device],
            check=True, env=env)
        subprocess.run(
            [sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.compute_cmvn",
             "--feats", f"scp:{d}/feats.scp",
             "--utt2spk", os.path.join(d, "utt2spk"),
             "--out", f"ark,scp:{d}/cmvn.ark,{d}/cmvn.scp"],
            check=True, env=env)
    ali_writer.close()

    # decoding graph: the native mkgraph chain, CTC transform included
    graph = os.path.join(out, "graph")
    os.makedirs(graph, exist_ok=True)
    env = _env()
    subprocess.run(
        [sys.executable, "-m", "kaldi_ctc_tpu_torch.cli.graph_tool",
         "make-tlg",
         "--lexicon", os.path.join(out, "lexicon.txt"),
         "--arpa", os.path.join(out, "lm.arpa"),
         "--phones", os.path.join(out, "phones.txt"),
         "--output", os.path.join(graph, "CTC.fst"),
         "--write-words", os.path.join(graph, "words.txt")],
        check=True, env=env)

    num_targets = args.num_phones + 1
    print(json.dumps({
        "out": out, "vocab": args.vocab, "num_phones": args.num_phones,
        "num_targets": num_targets,
        "train_utts": args.train_utts, "test_utts": args.test_utts,
        "run": (f"data={out}/data ali={out}/ali graph={graph} "
                f"exp={out}/exp num_targets={num_targets} bash run.sh"),
    }))


if __name__ == "__main__":
    main()
