"""The general traffic generator: a traffic file's parameters and a seed
-> a corpus of utterances, written as the port's npz feature cache.

The set of lengths is fixed by the traffic file alone: each part of
``length_mix`` contributes its share of ``utterances``, at its quantiles
``(i + 0.5) / n``, so every seed trains on the same amount of audio in the
same buckets. The seed permutes the lengths, gives each utterance a
transcript rate (a stratified set over ``chars_per_s``, permuted apart),
draws the transcripts' ids and the features. Features are N(0, 1), as the
normalised cache holds them, drawn on the device in a few large calls.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import statistics

import numpy as np
import torch

# values a call of the device's normal generator draws (128 MB of float32)
CHUNK_VALUES = 1 << 25
# threads that write and sync the cache's files
WRITERS = 4


def seed_streams(seed: int, n: int) -> list[np.random.SeedSequence]:
    """``n`` independent streams from a run's seed (any whole number)."""
    return np.random.SeedSequence(seed % (1 << 64)).spawn(n)


def torch_seed(stream: np.random.SeedSequence) -> int:
    return int(stream.generate_state(1, np.uint64)[0] >> np.uint64(1))


def quantile_seconds(traffic: dict) -> np.ndarray:
    """The traffic's fixed set of utterance lengths in seconds, unpermuted."""
    n = traffic["utterances"]
    parts = traffic["length_mix"]
    counts = [int(round(p["share"] * n)) for p in parts]
    counts[0] += n - sum(counts)
    out = []
    for part, k in zip(parts, counts):
        q = (np.arange(k) + 0.5) / k
        if part["kind"] == "normal":
            dist = statistics.NormalDist(part["mean_s"], part["std_s"])
            s = np.array([dist.inv_cdf(float(x)) for x in q])
        elif part["kind"] == "uniform":
            s = part["min_s"] + (part["max_s"] - part["min_s"]) * q
        else:
            raise ValueError(f"unknown length kind {part['kind']!r}")
        out.append(np.clip(s, part["min_s"], part["max_s"]))
    return np.concatenate(out)


@dataclasses.dataclass
class Corpus:
    """Utterances in file order: ``frames[i]`` feature frames and the
    transcript ``labels[i]`` (int32); ``offsets`` index the rows of the
    features array, which is kept apart (:func:`draw_features`)."""

    frames: np.ndarray
    labels: list
    offsets: np.ndarray

    def __len__(self) -> int:
        return len(self.frames)

    def index(self) -> dict:
        """(frames, transcript bytes) -> utterance: how a batch's rows are
        told apart without reading the program's tensors."""
        table = {}
        for i, (n, lab) in enumerate(zip(self.frames, self.labels)):
            key = (int(n), lab.tobytes())
            if key in table:
                raise ValueError(f"utterances {table[key]} and {i} are alike")
            table[key] = i
        return table


def draw(traffic: dict, config: dict, seed: int) -> Corpus:
    """The corpus's lengths and transcripts for ``seed``."""
    rng = np.random.default_rng(seed_streams(seed, 3)[0])
    seconds = rng.permutation(quantile_seconds(traffic))
    n = len(seconds)
    lo, hi = traffic["chars_per_s"]
    rates = rng.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
    samples = np.rint(seconds * config["sample_rate"]).astype(np.int64)
    frames = 1 + samples // config["hop"]
    id_lo, id_hi = traffic["label_ids"]
    labels = []
    for s, r in zip(seconds, rates):
        k = max(1, int(round(s * r)))
        labels.append(rng.integers(id_lo, id_hi + 1, size=k).astype(np.int32))
    offsets = np.concatenate([[0], np.cumsum(frames)]).astype(np.int64)
    return Corpus(frames=frames, labels=labels, offsets=offsets)


def draw_features(corpus: Corpus, config: dict, seed: int, device) -> np.ndarray:
    """All utterances' features, ``[total frames, input_size]`` float32 on
    the host, drawn from ``seed`` on ``device`` in chunks of at most
    ``CHUNK_VALUES`` values (the chunking is part of the draw)."""
    width = config["input_size"]
    total = int(corpus.offsets[-1])
    host = np.empty((total, width), dtype=np.float32)
    out = torch.from_numpy(host)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed_streams(seed, 3)[1]))
    rows = max(1, CHUNK_VALUES // width)
    for a in range(0, total, rows):
        b = min(total, a + rows)
        chunk = torch.randn((b - a, width), generator=gen, device=device)
        out[a:b].copy_(chunk)
    return host


def weight_seed(seed: int) -> int:
    return torch_seed(seed_streams(seed, 3)[2])


def cache_dir(data_dir: str, config: dict, split: str = "train") -> str:
    """Where the port's reader looks for this feature type's cache."""
    name = "preprocessed-power" if config["feature_type"] == "power" else "preprocessed"
    return os.path.join(data_dir, name, split)


def write_cache(data_dir: str, corpus: Corpus, features: np.ndarray, config: dict) -> str:
    """One ``utt-<i>.npz`` a utterance (``audio_fragments`` float32 [T, F],
    ``transcript`` int64), the port's cache layout; returns the directory.
    Each file is synced to the disk before the window, so no write-back of
    the corpus competes with the loader there; its pages stay cached."""
    out = cache_dir(data_dir, config)
    os.makedirs(out)

    def write(i: int) -> None:
        a, b = corpus.offsets[i], corpus.offsets[i + 1]
        with open(os.path.join(out, f"utt-{i:05d}.npz"), "wb") as f:
            np.savez(f, audio_fragments=features[a:b],
                     transcript=corpus.labels[i].astype(np.int64))
            f.flush()
            os.fsync(f.fileno())

    with concurrent.futures.ThreadPoolExecutor(WRITERS) as pool:
        for f in [pool.submit(write, i) for i in range(len(corpus))]:
            f.result()
    return out


def pad_batch(corpus: Corpus, features: np.ndarray, rows: list, bucket: int):
    """The reference's own batch of ``rows``: features zero-padded to the
    longest row rounded up to ``bucket`` frames, ``[B, T, F]`` float32,
    the frame counts, and the transcripts unpadded."""
    lengths = corpus.frames[rows]
    t = int(-(-int(lengths.max()) // bucket) * bucket)
    batch = np.zeros((len(rows), t, features.shape[1]), dtype=np.float32)
    for j, i in enumerate(rows):
        a, b = corpus.offsets[i], corpus.offsets[i + 1]
        batch[j, : b - a] = features[a:b]
    return batch, lengths.astype(np.int64), [corpus.labels[i] for i in rows]
