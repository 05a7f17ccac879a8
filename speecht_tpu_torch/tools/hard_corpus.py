"""Hard-mode synthetic speech: a quality proxy that does not saturate.

The port's own copy of ``tools/hard_corpus.py``. PR 15's tone corpus
renders each character as a fixed, noise-free tone, so a trained model
decodes it without error and the LM, ``--rescore`` and ``search`` have
nothing to improve. This corpus adds the three difficulty axes of the
JAX tool:

1. **Speaker variation** (per utterance): a pitch factor whose range
   (+-14 %) exceeds the 10.7 % spacing between adjacent character tones,
   so absolute frequency is ambiguous across speakers; a speaking rate of
   0.8-1.3x; a per-speaker harmonic profile; per-character jitter of
   duration and pitch.
2. **Additive noise** at a per-utterance SNR drawn uniformly in dB.
3. **Confusable speech and a minimal-pair lexicon**: with probability
   ``swap_prob`` a character is rendered as an alphabet-adjacent one (the
   transcript keeps the truth). Half the lexicon are minimal pairs (the
   corrupted form is another word of the vocabulary, so the LM cannot
   repair it), the rest loners (every adjacent flip is out of the
   vocabulary, so the valid-word bonus can). Word frequencies are
   Zipfian, and the unigram ARPA LM is written from the same
   distribution.

The lexicon, the sentences, the audio, the features (the port's
``data/features.calc_power_spectrogram``) and the LM are the JAX tool's
for the same seed, bit for bit: the same draws in the same order.

**One addition.** :func:`make_corpus_hard` takes ``n_test`` (default 0)
and ``pilot`` takes ``--n-test``: ``hard_search_drill`` confirms the
search on a held-out ``test`` split, which JAX's pilot does not write
(JAX's soak writes it at offset 2,000,000 after dev,
``tools/librispeech_scale_soak.py:134-136``). With 0 the files equal
JAX's; with more, ``hard-{2_000_000 + i:06d}`` follow dev on the same
generator.

Pilot (a short train and a greedy and LM decode of dev, through the
port's CLI in this process):

    python -m speecht_tpu_torch.tools.hard_corpus pilot [--n-train 2000]
        [--n-dev 128] [--n-test 0] [--steps 1500] [--segments 3]
        [--swap-prob 0.05] [--snr-lo 6 --snr-hi 18] [--keep DIR]
        [--device {cuda,cpu}] [--base-channels N ...]

runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data import features
from speecht_tpu_torch.tools import synthetic_convergence as sc

SR = 22050
RUN_NAME = "pilot"
LM_FLAGS = ["--lm-weight", "0.6", "--valid-word-count-weight", "2.3", "--device-beam"]
TEST_OFFSET = 2_000_000

# ---------------------------------------------------------------- lexicon


@dataclass(frozen=True)
class Lexicon:
    words: tuple  # all words, index = frequency rank
    probs: tuple  # Zipfian sampling probabilities, same order
    pair_words: frozenset  # words with an in-vocab minimal pair
    loner_words: frozenset  # words whose every adjacent flip is OOV


def _adjacent_flips(word: str):
    """Every single-char substitution by an alphabet-adjacent letter:
    the corruptions ``swap_prob`` can produce acoustically."""
    for i, ch in enumerate(word):
        for d in (-1, 1):
            o = ord(ch) + d
            if ord("a") <= o <= ord("z"):
                yield word[:i] + chr(o) + word[i + 1:]


def build_lexicon(n_pairs: int = 14, n_loners: int = 16, seed: int = 7) -> Lexicon:
    """``n_pairs`` minimal pairs (both members in the vocabulary) and
    ``n_loners`` words whose adjacent flips are all out of it."""
    rng = np.random.RandomState(seed)
    vocab: list[str] = []
    vocab_set: set[str] = set()

    def random_word(lo=3, hi=6):
        n = rng.randint(lo, hi + 1)
        return "".join(chr(ord("a") + rng.randint(26)) for _ in range(n))

    pair_words: set[str] = set()
    while len(pair_words) < 2 * n_pairs:
        w = random_word()
        flips = [f for f in _adjacent_flips(w) if f not in vocab_set]
        if w in vocab_set or not flips:
            continue
        partner = flips[rng.randint(len(flips))]
        # neither member may collide with an existing word's flip set
        if any(f in vocab_set for f in (w, partner)):
            continue
        vocab += [w, partner]
        vocab_set |= {w, partner}
        pair_words |= {w, partner}

    loner_words: set[str] = set()
    while len(loner_words) < n_loners:
        w = random_word()
        if w in vocab_set:
            continue
        flips = set(_adjacent_flips(w))
        if flips & vocab_set:
            continue
        vocab.append(w)
        vocab_set |= {w}
        vocab_set |= flips  # reserve the flip neighbourhood
        loner_words.add(w)

    words = tuple(w for w in vocab if w in pair_words | loner_words)
    # Zipfian frequencies (rank = insertion order, shuffled)
    order = rng.permutation(len(words))
    ranked = tuple(words[i] for i in order)
    raw = np.array([1.0 / (r + 2.0) for r in range(len(ranked))])
    probs = tuple((raw / raw.sum()).tolist())
    return Lexicon(words=ranked, probs=probs, pair_words=frozenset(pair_words),
                   loner_words=frozenset(loner_words))


def sample_sentence_hard(rng, lex: Lexicon, target_seconds: float) -> str:
    """A Zipf-sampled word sequence lasting about ``target_seconds`` at
    the base rate (0.14 s a character and the word gaps)."""
    chars_needed = max(3, int(target_seconds / 0.14))
    idx = np.arange(len(lex.words))
    p = np.asarray(lex.probs)
    out, total = [], 0
    while total < chars_needed:
        w = lex.words[int(rng.choice(idx, p=p))]
        out.append(w)
        total += len(w) + 1
    return " ".join(out)


# -------------------------------------------------------------- synthesis


@dataclass(frozen=True)
class HardParams:
    """Difficulty knobs (defaults: the JAX tool's calibrated setting)."""

    f0: float = 300.0  # char 'a' tone at pitch factor 1.0
    spacing: float = 1.107  # adjacent-char frequency ratio (~10.7 %)
    pitch_lo: float = 0.87  # speaker pitch factor range (+-14 %,
    pitch_hi: float = 1.15  # wider than `spacing`)
    rate_lo: float = 0.8  # speaking-rate factor range
    rate_hi: float = 1.3
    snr_lo: float = 6.0  # additive-noise SNR range, dB
    snr_hi: float = 18.0
    swap_prob: float = 0.05  # P(char rendered as an adjacent char)
    char_dur: float = 0.12  # base seconds per char tone
    char_gap: float = 0.02  # base intra-word gap
    word_gap: float = 0.13  # base inter-word gap (space = silence)


def _speaker(rng, hp: HardParams) -> dict:
    return {
        "pitch": float(np.exp(rng.uniform(np.log(hp.pitch_lo), np.log(hp.pitch_hi)))),
        "rate": float(rng.uniform(hp.rate_lo, hp.rate_hi)),
        "amp2": float(rng.uniform(0.05, 0.45)),  # 2nd-harmonic level
        "amp3": float(rng.uniform(0.0, 0.25)),  # 3rd-harmonic level
        "snr_db": float(rng.uniform(hp.snr_lo, hp.snr_hi)),
    }


def _char_tone_hard(char_id: int, rng, spk: dict, hp: HardParams) -> np.ndarray:
    dur_s = hp.char_dur * spk["rate"] * rng.uniform(0.9, 1.1)
    dur = max(int(dur_s * SR), 8)
    t = np.arange(dur) / SR
    f0 = hp.f0 * (hp.spacing ** char_id) * spk["pitch"] * rng.uniform(0.985, 1.015)
    x = (
        0.6 * np.sin(2 * np.pi * f0 * t)
        + spk["amp2"] * np.sin(2 * np.pi * 2 * f0 * t)
        + spk["amp3"] * np.sin(2 * np.pi * 3 * f0 * t)
    )
    edge = max(int(0.015 * SR), 1)
    env = np.minimum(1.0, np.minimum(t * SR / edge, (dur - 1 - t * SR) / edge))
    return (x * np.maximum(env, 0.0)).astype(np.float32)


def synth_utterance_hard(sentence: str, rng, hp: HardParams, return_truth: bool = False):
    """Render ``sentence``; the audio may realize adjacent-char swaps (the
    transcript stays the truth). Spaces are silence whose length (against
    the intra-word gap) is the only word-boundary cue. With
    ``return_truth``, returns (audio, number of swapped characters)."""
    spk = _speaker(rng, hp)

    def gap(base):
        n = int(base * spk["rate"] * rng.uniform(0.8, 1.25) * SR)
        return np.zeros(max(n, 1), np.float32)

    parts = [gap(hp.char_gap)]
    n_swapped = 0
    for ch in sentence:
        if ch == " ":
            parts.append(gap(hp.word_gap))
            continue
        cid = vocabulary.sentence_to_ids(ch)[0]
        if rng.rand() < hp.swap_prob:
            cid = int(np.clip(cid + (1 if rng.rand() < 0.5 else -1), 0, 25))
            n_swapped += 1
        parts.append(_char_tone_hard(cid, rng, spk, hp))
        parts.append(gap(hp.char_gap))
    audio = np.concatenate(parts)

    sig_rms = float(np.sqrt(np.mean(audio**2)) + 1e-9)
    noise_rms = sig_rms / (10.0 ** (spk["snr_db"] / 20.0))
    audio = audio + rng.randn(len(audio)).astype(np.float32) * noise_rms
    if return_truth:
        return audio, n_swapped
    return audio


# --------------------------------------------------------------------- LM


def write_lm_hard(root: str, lex: Lexicon) -> str:
    """A unigram ARPA matched to the Zipfian sampling distribution and the
    vocabulary file the valid-word bonus reads, in ``<root>/lm``; returns
    that directory."""
    lm_dir = os.path.join(root, "lm")
    os.makedirs(lm_dir, exist_ok=True)
    unk_mass = 0.01
    lines = ["\\data\\", f"ngram 1={len(lex.words) + 1}", "", "\\1-grams:"]
    lines.append(f"{math.log10(unk_mass):.4f}\t<unk>")
    for w, p in zip(lex.words, lex.probs):
        lines.append(f"{math.log10(p * (1 - unk_mass)):.4f}\t{w}")
    lines += ["", "\\end\\", ""]
    with open(os.path.join(lm_dir, "model.arpa"), "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(lm_dir, "vocabulary"), "w") as f:
        f.write("\n".join(lex.words) + "\n")
    return lm_dir


# ------------------------------------------------------------------ pilot


def make_corpus_hard(root: str, n_train: int, n_dev: int, hp: HardParams,
                     seed: int = 0, median_s: float = 4.0, max_s: float = 10.0,
                     log_every: int = 0, n_test: int = 0) -> dict:
    """The corpus in the feature-cache layout (``<root>/data/
    preprocessed-power/{train,dev,test}``) and its LM; returns the share
    of characters realized as swaps and the lexicon's sizes."""
    rng = np.random.RandomState(seed)
    lex = build_lexicon()
    swapped = chars = 0

    def write_split(split, n, offset):
        nonlocal swapped, chars
        out = os.path.join(root, "data", "preprocessed-power", split)
        os.makedirs(out, exist_ok=True)
        t0 = time.time()
        for i in range(n):
            dur = float(np.clip(rng.lognormal(np.log(median_s), 0.45), 1.0, max_s))
            sentence = sample_sentence_hard(rng, lex, dur)
            audio, n_sw = synth_utterance_hard(sentence, rng, hp, return_truth=True)
            swapped += n_sw
            chars += sum(c != " " for c in sentence)
            feats = features.calc_power_spectrogram(audio, SR)
            np.savez(
                os.path.join(out, f"hard-{offset + i:06d}"),
                audio_fragments=feats,
                transcript=np.asarray(vocabulary.sentence_to_ids(sentence), np.int64),
            )
            if log_every and (i + 1) % log_every == 0:
                rate = (i + 1) / (time.time() - t0)
                print(f"  {split}: {i + 1}/{n} ({rate:.1f} utt/s)", flush=True)

    write_split("train", n_train, 0)
    write_split("dev", n_dev, 1_000_000)
    if n_test:
        write_split("test", n_test, TEST_OFFSET)
    write_lm_hard(root, lex)
    return {
        "realized_swap_frac": round(swapped / max(chars, 1), 4),
        "lexicon_pairs": len(lex.pair_words),
        "lexicon_loners": len(lex.loner_words),
    }


def common_flags(root: str, args, run_name: str = RUN_NAME, batch_size: int = 64,
                 bucket_step: int = 256) -> list[str]:
    """The data, train and log directories, the run name, the batch and
    bucket (B=64 on the 256-frame buckets: JAX's soak's shapes), and
    ``args``'s device and widths."""
    return [
        "--data-dir", os.path.join(root, "data"),
        "--train-dir", os.path.join(root, "train"),
        "--log-dir", os.path.join(root, "log"),
        "--run-name", run_name,
        "--batch-size", str(batch_size),
        "--bucket-step", str(bucket_step),
        "--device", args.device,
        *sc.model_flags(**{name: getattr(args, name, None) for name in sc.MODEL_FLAGS}),
    ]


def _stats_tail(out: str) -> list[str]:
    """The JAX tool's reading of an evaluate: its last line with "LER"."""
    return [line for line in out.splitlines() if "LER" in line][-1:]


def run_pilot(root: str, args) -> dict:
    """The pilot's training and decoding on the corpus under ``root``:
    ``args.segments`` runs of ``train`` (each ``args.steps // segments``
    steps, restoring the last), a greedy ``evaluate --dev --step-count 2``
    after each, then greedy and with the LM and ``--device-beam``. Returns
    each segment's interval losses, restored optimizer step and learning
    rate and seconds, and the two final decodes' rates
    (``synthetic_convergence.timed_eval``)."""
    from speecht_tpu_torch.train.checkpoint import CheckpointManager
    from speecht_tpu_torch.tools.train_features_check import read_checkpoint

    common = common_flags(root, args)
    run_dir = os.path.join(root, "train", RUN_NAME)
    evaluate = ["evaluate", "--dev", "--no-save", "--step-count", "2", *common]
    seg = max(args.steps // args.segments, 1)
    segments = []
    for s in range(args.segments):
        t0 = time.perf_counter()
        _state, out = sc.run_cli([
            "train", "--max-steps", str(seg), "--steps-per-checkpoint", str(min(250, seg)),
            "--learning-rate", "3e-4", "--learning-rate-decay-factor", "0.5",
            "--spec-augment", "--grad-accum", "2", "--group-by-length", *common])
        seconds = time.perf_counter() - t0
        step = CheckpointManager(run_dir).latest_step()
        saved = read_checkpoint(run_dir, step)
        dev = sc.timed_eval(evaluate)
        segments.append({"global_step": step, "optimizer_step": saved["step"],
                         "learning_rate": saved["learning_rate"],
                         "interval_losses": sc.interval_lines(out),
                         "train_seconds": seconds, "dev": dev})
        print(f"=== after segment {s + 1}/{args.segments} ({(s + 1) * seg} steps): "
              f"{_stats_tail(dev['output'])}")
        print(f"    checkpoint at global step {step}: optimizer step {saved['step']}, "
              f"learning rate {saved['learning_rate']!r}; held-out rates LER "
              f"{dev['ler']:.4f} WER {dev['wer']:.4f}")

    greedy = sc.timed_eval(evaluate)
    beam_lm = sc.timed_eval([*evaluate, "--language-model", os.path.join(root, "lm"),
                             *LM_FLAGS])
    print(f"\nPILOT greedy : {_stats_tail(greedy['output'])}")
    print(f"PILOT beam+LM: {_stats_tail(beam_lm['output'])}")
    print(f"PILOT greedy  held-out rates: LER {greedy['ler']:.4f} WER {greedy['wer']:.4f}")
    print(f"PILOT beam+LM held-out rates: LER {beam_lm['ler']:.4f} WER {beam_lm['wer']:.4f}")
    return {"segments": segments, "greedy": greedy, "beam_lm": beam_lm}


def write_pilot_corpus(root: str, args) -> dict:
    """The pilot's corpus under ``root``, with ``args``'s sizes and
    difficulty knobs (seed 0); returns :func:`make_corpus_hard`'s
    statistics."""
    hp = HardParams(swap_prob=args.swap_prob, snr_lo=args.snr_lo, snr_hi=args.snr_hi,
                    pitch_lo=args.pitch_lo, pitch_hi=args.pitch_hi)
    return make_corpus_hard(root, args.n_train, args.n_dev, hp, log_every=500,
                            n_test=args.n_test)


def pilot(args) -> tuple[int, dict]:
    """:func:`write_pilot_corpus`, then :func:`run_pilot`. Returns (exit
    code, its result and the corpus's statistics). Without ``args.keep``
    the corpus and checkpoints go to a temporary directory removed at the
    end."""
    from speecht_tpu_torch.execution import resolve_device

    resolve_device(args.device)  # no card: fail before the corpus is written
    root = args.keep or tempfile.mkdtemp(prefix="hardpilot_")
    os.makedirs(root, exist_ok=True)
    try:
        print(f"pilot corpus under {root}: {json.dumps(vars(args))}")
        stats = write_pilot_corpus(root, args)
        print(f"corpus: {json.dumps(stats)}")
        result = run_pilot(root, args)
        result["corpus"] = stats
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    return 0, result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pilot")
    p.add_argument("--n-train", type=int, default=2000)
    p.add_argument("--n-dev", type=int, default=128)
    p.add_argument("--n-test", type=int, default=0)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--segments", type=int, default=3)
    p.add_argument("--swap-prob", type=float, default=0.05)
    p.add_argument("--snr-lo", type=float, default=6.0)
    p.add_argument("--snr-hi", type=float, default=18.0)
    p.add_argument("--pitch-lo", type=float, default=0.87)
    p.add_argument("--pitch-hi", type=float, default=1.15)
    p.add_argument("--keep", type=str, default="",
                   help="persist the pilot corpus/checkpoints here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    for name in sc.MODEL_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), dest=name, type=int)
    return ap.parse_args(argv)


if __name__ == "__main__":
    sys.exit(pilot(parse_args())[0])
