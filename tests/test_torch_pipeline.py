"""The port's batches and corpus order against the JAX package's.

``build_batch`` and ``batch_iterator`` must give identical arrays, and
``load_samples`` the same files in the same order for the same seed.
"""

import numpy as np
import pytest
import torch

from speecht_tpu.data import pipeline as jpipeline
from speecht_tpu.data import reader as jreader
from speecht_tpu_torch.data import pipeline, reader
from speecht_tpu_torch.data.features import feature_size


def _samples(seed, n, t_range=(20, 700), f=5):
    rng = np.random.RandomState(seed)
    return [
        (
            rng.randn(rng.randint(*t_range), f).astype(np.float32),
            rng.randint(0, 28, size=rng.randint(0, 80)).astype(np.int64),
        )
        for _ in range(n)
    ]


def _assert_batches_equal(got, want):
    for name in ("features", "seq_lengths", "labels", "label_lengths"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"pad_to_batch": 9}, {"label_bucket": 16}, {"time_bucket": 128}],
)
def test_build_batch_matches_jax(kwargs):
    samples = _samples(0, 5)
    _assert_batches_equal(
        pipeline.build_batch(samples, **kwargs),
        jpipeline.build_batch(samples, **kwargs),
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"max_steps": 2},
        {"drop_remainder": True},
        {"group_by_length": True},
        {"group_by_length": True, "max_steps": 3},
    ],
)
def test_batch_iterator_matches_jax(kwargs):
    samples = _samples(1, 23)
    got = list(pipeline.batch_iterator(iter(samples), 4, **kwargs))
    want = list(jpipeline.batch_iterator(iter(samples), 4, **kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    d = root / "preprocessed-power" / "test" / "speaker"
    d.mkdir(parents=True)
    for i, (feat, transcript) in enumerate(_samples(2, 12, f=feature_size("power"))):
        np.savez(d / f"u{i:02d}", audio_fragments=feat, transcript=transcript)
    with open(root / "a.trans.txt", "w") as f:
        f.write("u00 HELLO WORLD\nu01 IT'S\n")
    return str(root)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"seed": 3},
        {"seed": 4, "limit_count": 5},
        {"seed": 5, "max_size": 300},
    ],
)
def test_load_samples_order_matches_jax(corpus, kwargs):
    got = list(
        reader.SpeechCorpusReader(corpus).load_samples(
            "test", feature_type="power", **kwargs
        )
    )
    want = list(
        jreader.SpeechCorpusReader(corpus).load_samples(
            "test", feature_type="power", **kwargs
        )
    )
    assert len(got) == len(want) > 0
    for (gf, gt), (wf, wt) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gt, wt)


def test_transcripts_and_cache_directories_match_jax(corpus):
    ours, theirs = reader.SpeechCorpusReader(corpus), jreader.SpeechCorpusReader(corpus)
    assert ours._transcript_dict == theirs._transcript_dict
    for feature_type in ("power", "mfcc"):
        assert ours._get_directory(feature_type, "dev") == theirs._get_directory(
            feature_type, "dev"
        )
    assert sorted(reader.iglob_recursive(corpus, "*.npz")) == sorted(
        jreader.iglob_recursive(corpus, "*.npz")
    )


def test_prefetch_loader_on_cpu_casts_features(corpus):
    loader = pipeline.PrefetchLoader(
        lambda: reader.SpeechCorpusReader(corpus).load_samples(
            "test", feature_type="power", seed=0
        ),
        batch_size=5,
        device=torch.device("cpu"),
        max_steps=2,
    )
    pairs = list(loader)
    assert len(pairs) == 2
    for host, dev in pairs:
        assert dev.features.dtype == torch.bfloat16
        torch.testing.assert_close(
            dev.features, torch.from_numpy(host.features).to(torch.bfloat16)
        )
        np.testing.assert_array_equal(dev.labels.numpy(), host.labels)
        np.testing.assert_array_equal(dev.seq_lengths.numpy(), host.seq_lengths)


def test_prefetch_loader_raises_producer_errors():
    def broken():
        yield from _samples(3, 2)
        raise OSError("disk gone")

    loader = pipeline.PrefetchLoader(broken, 4, torch.device("cpu"))
    with pytest.raises(OSError, match="disk gone"):
        list(loader)


def test_prefetch_loader_abandoned_builds_no_further_batch():
    """Closing an iteration retires the producer without another build. On
    several ranks a build is a collective (``sync_bucket_dims``), so a rank
    that stops at a step boundary must not start one its stopped peer will
    never join: here such a build blocks, and the close must not wait on it."""
    import threading
    import time

    closing = threading.Event()
    builds, late_builds = [], []

    def builder(bucket, time_bucket, label_bucket):
        if closing.is_set():
            late_builds.append(len(bucket))
            time.sleep(30)  # a collective whose peer is gone
        builds.append(len(bucket))
        return pipeline.build_batch(bucket, time_bucket, label_bucket)

    def samples():
        while True:
            yield from _samples(4, 8)

    loader = pipeline.PrefetchLoader(samples, 2, torch.device("cpu"),
                                     batch_builder=builder)
    it = iter(loader)
    next(it)
    # the producer fills the queue and waits on its put with one more batch
    deadline = time.time() + 30
    while len(builds) < loader._QUEUE_CAPACITY + 2 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    closing.set()
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 5.0
    assert late_builds == []
