"""The traffic generator: deterministic from the seed, the same sizes
for every seed, length models that match their stated means and ranges,
and archives the program reads back as written."""

import json
import os
import sys

import numpy as np

from asrbench import batches, featgen, traffic as tr

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TRAFFIC = os.path.join(ROOT, "asrbench", "traffic")


def _load(name):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


def test_histogram_quantiles_hand_count():
    # one bin [0, 10]: quantiles (i + 0.5) / 4 -> 1.25, 3.75, 6.25, 8.75
    q = tr.histogram_quantiles([[0.0, 10.0, 1.0]], 4)
    np.testing.assert_allclose(q, [1.25, 3.75, 6.25, 8.75])
    # two bins of weight 1 and 3: a quarter of the mass in [0, 1]; the
    # quantiles 0.375, 0.625, 0.875 lie 1/6, 1/2, 5/6 into [1, 2]
    q = tr.histogram_quantiles([[0.0, 1.0, 1.0], [1.0, 2.0, 3.0]], 4)
    np.testing.assert_allclose(q, [0.5, 1.0 + 1 / 6, 1.5, 1.0 + 5 / 6])


def test_train_pool_is_deterministic_and_seed_permutes_sizes():
    t = _load("train960")
    a, b = tr.train_pool(t, 7, "train"), tr.train_pool(t, 7, "train")
    c = tr.train_pool(t, 2 ** 31 + 11, "train")
    assert a == b
    assert a != c
    assert sorted(u.frames for u in a) == sorted(u.frames for u in c)
    u = a[5]
    np.testing.assert_array_equal(tr.utterance_features(u, 7, 40),
                                  tr.utterance_features(u, 7, 40))
    np.testing.assert_array_equal(tr.utterance_alignment(u, t, 7),
                                  tr.utterance_alignment(u, t, 7))
    assert not np.array_equal(tr.utterance_features(u, 7, 40),
                              tr.utterance_features(u, 8, 40))


def test_train960_lengths_match_librispeech():
    """Mean 12.3 s after the 700-frame filter (21 s of audio at fs 3),
    most 10-17 s, a tail down to ~1.5 s, 10-12 phones a second."""
    t = _load("train960")
    pool = tr.train_pool(t, 3, "train")
    f = t["train_flags"]
    kept = [u for u in pool if batches.example_ok(
        tr.subsampled_frames(u.frames, 3, 0), u.phones,
        f["max-allow-frames"])]
    secs = np.array([u.seconds for u in kept])
    assert 12.0 <= secs.mean() <= 12.6
    assert secs.max() <= 21.0 and secs.min() < 2.0
    assert 0.5 <= np.mean((secs >= 10) & (secs <= 17)) <= 0.8
    assert len(kept) >= 0.97 * len(pool)
    rates = np.array([u.phones / u.seconds for u in pool])
    assert 9.5 <= rates.min() and rates.max() <= 12.5


def test_test_clean_lengths_and_poisson_schedule():
    """Mean 7.4 s, 1.3-35 s; round(rate * seconds) requests inside the
    window, the same sizes and gaps for every seed."""
    t = dict(_load("test_clean_poisson"), rate_per_s=50.0)
    a = tr.request_schedule(t, 1, 30.0)
    b = tr.request_schedule(t, 2, 30.0)
    assert len(a) == 1500
    secs = np.array([r.samples for r in a]) / 16000.0
    assert 7.2 <= secs.mean() <= 7.6
    assert 1.3 <= secs.min() and secs.max() <= 35.0
    assert sorted(r.samples for r in a) == sorted(r.samples for r in b)
    offs = np.array([r.offset_s for r in a])
    assert offs[0] == 0.0 and offs[-1] < 30.0 and np.all(np.diff(offs) > 0)
    gaps = np.diff(offs)
    # exponential gaps: the coefficient of variation is about 1
    assert 0.9 <= gaps.std() / gaps.mean() <= 1.1
    pool = tr.pcm_pool(t, 1)
    assert pool.dtype == np.int16
    assert np.array_equal(pool, tr.pcm_pool(t, 1))
    assert all(r.start + r.samples <= pool.shape[0] for r in a)


def test_alignment_collapses_to_its_phones():
    t = _load("train960")
    for u in tr.train_pool(t, 5, "valid")[:20]:
        ali = tr.utterance_alignment(u, t, 5)
        assert ali.shape == (u.frames,)
        assert ali.min() >= 0 and ali.max() < t["num_pdfs"]
        assert int(np.sum(ali[1:] != ali[:-1])) + 1 == u.phones


def test_archives_read_back_by_the_program(tmp_path, monkeypatch):
    """featgen's archives, through a piped rspecifier as train_ctc reads
    them: the same keys, features and collapsed labels."""
    from kaldi_ctc_tpu_torch.data import load_examples

    t = dict(_load("train960"), valid_utterances=6)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(t))
    cmd = (f"{sys.executable} -m asrbench.featgen --traffic {path} "
           f"--seed 9 --part valid --what")
    monkeypatch.setenv("PYTHONPATH", ROOT)
    exs = list(load_examples(f"ark:{cmd} feats |", f"ark:{cmd} ali |"))
    pool = tr.train_pool(t, 9, "valid")
    assert [e.key for e in exs] == [u.key for u in pool]
    for e, u in zip(exs, pool):
        np.testing.assert_array_equal(e.feats,
                                      tr.utterance_features(u, 9, 40))
        assert e.labels.shape == (u.phones,)


def test_batches_equal_the_programs_pipeline():
    """The frozen copy of the batch rules gives the batches that the
    program's EgsPipeline gives, epoch after epoch."""
    from kaldi_ctc_tpu_torch.data import CtcExample, EgsPipeline

    t = dict(_load("train960"), utterances=300)
    pool = tr.train_pool(t, 4, "train")
    exs = [CtcExample(u.key, np.zeros((u.frames, 1), np.float32),
                      np.ones(u.phones, np.int32)) for u in pool]
    pipe = EgsPipeline(exs, minibatch_size=48, max_allow_frames=700,
                       frame_subsampling_factor=3, seed=123)
    for epoch in range(3):
        theirs = [b["keys"] for b in pipe.epoch(epoch)]
        mine = [[pool[i].key for i in b] for b in batches.epoch_batches(
            pool, 123, epoch, 48, 700, 3)]
        assert mine == theirs
