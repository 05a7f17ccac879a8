"""The traffic generator: the same seed gives the same corpus, and every
seed the same set of lengths."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from gpubench import corpus

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(folder, name):
    with open(os.path.join(HERE, folder, f"{name}.json")) as f:
        return json.load(f)


CONFIG = load("configs", "w2l_mfcc39")


@pytest.mark.parametrize("traffic,mean_s,lo_s,hi_s", [
    ("librispeech_train", 12.61, 1.5, 21.2),
])
def test_lengths(traffic, mean_s, lo_s, hi_s):
    t = load("traffic", traffic)
    seconds = corpus.quantile_seconds(t)
    assert len(seconds) == t["utterances"]
    assert abs(seconds.mean() - mean_s) < 0.05
    assert seconds.min() >= lo_s - 1e-9 and seconds.max() <= hi_s + 1e-9
    a = corpus.draw(t, CONFIG, 2**31 + 11)
    b = corpus.draw(t, CONFIG, 2**31 + 12)
    np.testing.assert_array_equal(np.sort(a.frames), np.sort(b.frames))
    assert not np.array_equal(a.frames, b.frames)
    rates = np.array([len(x) for x in a.labels]) / (a.frames * CONFIG["hop"] / CONFIG["sample_rate"])
    assert rates.min() > 11.5 and rates.max() < 18.5
    assert all(x.min() >= 0 and x.max() <= 27 for x in a.labels)
    a.index()  # no two utterances alike


def test_same_seed_same_corpus():
    t = dict(load("traffic", "librispeech_train"), utterances=40)
    a, b = corpus.draw(t, CONFIG, 5), corpus.draw(t, CONFIG, 5)
    np.testing.assert_array_equal(a.frames, b.frames)
    assert all(np.array_equal(x, y) for x, y in zip(a.labels, b.labels))
    fa = corpus.draw_features(a, CONFIG, 5, torch.device("cpu"))
    fb = corpus.draw_features(b, CONFIG, 5, torch.device("cpu"))
    assert fa.shape == (a.offsets[-1], 39)
    np.testing.assert_array_equal(fa, fb)
    assert abs(fa.mean()) < 0.05 and abs(fa.std() - 1) < 0.05


def test_cache_is_the_ports_layout(tmp_path):
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    t = dict(load("traffic", "librispeech_train"), utterances=6)
    data = corpus.draw(t, CONFIG, 9)
    feats = corpus.draw_features(data, CONFIG, 9, torch.device("cpu"))
    corpus.write_cache(str(tmp_path), data, feats, CONFIG)
    read = list(SpeechCorpusReader(str(tmp_path)).load_samples("train", feature_type="mfcc", seed=0))
    table = data.index()
    for f, labels in read:
        i = table[(f.shape[0], np.asarray(labels, np.int32).tobytes())]
        np.testing.assert_array_equal(f, feats[data.offsets[i]: data.offsets[i + 1]])
    rows = [0, 3]
    batch, lengths, labels = corpus.pad_batch(data, feats, rows, 256)
    assert batch.shape[1] % 256 == 0 and (batch[1, lengths[1]:] == 0).all()
