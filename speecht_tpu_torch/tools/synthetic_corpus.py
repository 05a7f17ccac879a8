"""The synthetic tone-speech corpus and its language model.

The port's own copy of ``tools/synthetic_convergence.py``'s corpus: each
character is a 120 ms tone burst of its own pitch, sentences are 2-4 words
of a 20-word list, and the features go through the port's
``calc_power_spectrogram`` into the cache layout that ``train`` and
``evaluate`` read (``<root>/data/preprocessed-power/{train,test}``). The
same ``(n_train, n_test, seed)`` draws the same sentences and noise in the
same order as the JAX tool, so both write the same files.
"""

from __future__ import annotations

import math
import os

import numpy as np

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data import features

SR = 22050
WORDS = [
    "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
    "pack", "my", "box", "with", "five", "dozen", "liquor", "jugs",
    "how", "vexingly", "daft", "zebras",
]


def char_tone(char_id: int, rng: np.random.RandomState) -> np.ndarray:
    """A 120 ms tone burst unique to each character id."""
    dur = int(0.12 * SR)
    t = np.arange(dur) / SR
    f0 = 250.0 + 95.0 * char_id
    x = 0.6 * np.sin(2 * np.pi * f0 * t) + 0.25 * np.sin(2 * np.pi * 2 * f0 * t)
    env = np.minimum(1.0, np.minimum(t / 0.015, (dur / SR - t) / 0.015) / 1.0)
    x = x * env + rng.randn(dur) * 0.01
    return x.astype(np.float32)


def synth_utterance(sentence: str, rng: np.random.RandomState) -> np.ndarray:
    """The sentence's tones, each between 20 ms gaps."""
    gap = np.zeros(int(0.02 * SR), np.float32)
    parts = [gap]
    for char_id in vocabulary.sentence_to_ids(sentence):
        parts.append(char_tone(char_id, rng))
        parts.append(gap)
    return np.concatenate(parts)


def make_corpus(root: str, n_train: int, n_test: int, seed: int = 0) -> None:
    """``n_train`` + ``n_test`` cached utterances under ``<root>/data``:
    ``synth-00000.npz``... in train, ``synth-100000.npz``... in test."""
    rng = np.random.RandomState(seed)

    def write_split(split, n, offset):
        out = os.path.join(root, "data", "preprocessed-power", split)
        os.makedirs(out, exist_ok=True)
        for i in range(n):
            n_words = rng.randint(2, 5)
            sentence = " ".join(
                WORDS[rng.randint(len(WORDS))] for _ in range(n_words)
            )
            audio = synth_utterance(sentence, rng)
            feats = features.calc_power_spectrogram(audio, SR)
            np.savez(
                os.path.join(out, f"synth-{offset + i:05d}"),
                audio_fragments=feats,
                transcript=np.asarray(
                    vocabulary.sentence_to_ids(sentence), np.int64
                ),
            )

    write_split("train", n_train, 0)
    write_split("test", n_test, 100000)


def write_lm(root: str) -> str:
    """A unigram ARPA over the word list and a vocabulary file, in
    ``<root>/lm``; returns that directory."""
    lm_dir = os.path.join(root, "lm")
    os.makedirs(lm_dir, exist_ok=True)
    logp = -math.log10(len(WORDS) + 1)
    lines = ["\\data\\", f"ngram 1={len(WORDS) + 1}", "", "\\1-grams:"]
    lines.append(f"{logp:.4f}\t<unk>")
    for w in WORDS:
        lines.append(f"{logp:.4f}\t{w}")
    lines += ["", "\\end\\", ""]
    with open(os.path.join(lm_dir, "model.arpa"), "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(lm_dir, "vocabulary"), "w") as f:
        f.write("\n".join(WORDS) + "\n")
    return lm_dir
