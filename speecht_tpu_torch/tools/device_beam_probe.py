"""Device beam throughput on the card.

The port of ``tools/device_beam_probe.py``. Shapes mirror the LM
evaluate's after the blank collapse (B=64, T=136: about 27% of 512 logit
frames kept). The LM is synthetic but sized like a production one
(default 50k unigrams / 200k bigrams / 100k trigrams, the JAX tool's
generator and seed, so the same ARPA bytes), so the kernel's table
probes are measured at scale.

Prints the ARPA's write and the ``DeviceLM`` build times, the first call
(on the card it includes loading the kernel's library, built at its first
launch when not yet built), then 3 trials of 10 calls on emissions staged
on the device once, each trial ended by one synchronise: ms a batch and
utt/s.

    python -m speecht_tpu_torch.tools.device_beam_probe [--width 100] [--frames 136]

runs on the card (``csrc/beam_device.cu``); ``--device cpu`` runs the
plain search (``ops/beam_device.plain_beam_search``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.execution import device_name, resolve_device, synchronize
from speecht_tpu_torch.ops import beam_device

BEAM_WEIGHTS = (1.5, 0.5, 1.2)  # lm, word count, valid word count
TRIALS, ITERS = 3, 10


def synth_arpa(path, n_uni=50_000, n_bi=200_000, n_tri=100_000, seed=0):
    """The JAX tool's synthetic order-3 ARPA: the same ``RandomState``
    draws in the same order, so the same bytes for the same arguments."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(n_uni - 3)]
    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={n_uni}\nngram 2={n_bi}\nngram 3={n_tri}\n\n")
        f.write("\\1-grams:\n")
        f.write("-2.5\t<unk>\n-1.0\t<s>\t-0.5\n-1.2\t</s>\n")
        for w in words:
            f.write(f"-{rng.uniform(1, 6):.4f}\t{w}\t-{rng.uniform(0.1, 1):.4f}\n")
        f.write("\n\\2-grams:\n")
        seen = set()
        n = 0
        while n < n_bi:
            a, b = rng.randint(0, len(words), 2)
            if (a, b) in seen:
                continue
            seen.add((a, b))
            f.write(f"-{rng.uniform(0.5, 4):.4f}\t{words[a]} {words[b]}\t-{rng.uniform(0.1, 1):.4f}\n")
            n += 1
        f.write("\n\\3-grams:\n")
        seen = set()
        n = 0
        while n < n_tri:
            a, b, c = rng.randint(0, len(words), 3)
            if (a, b, c) in seen:
                continue
            seen.add((a, b, c))
            f.write(f"-{rng.uniform(0.5, 4):.4f}\t{words[a]} {words[b]} {words[c]}\n")
            n += 1
        f.write("\n\\end\\\n")


def probe_emissions(B: int, T: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's emissions: seeded logits with the blank raised by 2,
    as log-probs; every row T frames long."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(B, T, vocabulary.NUM_CLASSES) * 2.0).astype(np.float32)
    logits[:, :, vocabulary.BLANK_ID] += 2.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return logp, np.full(B, T, np.int32)


def build_lm(args, device):
    """The synthetic LM's device tables (None with ``--no-lm``), printing
    the ARPA's write and the build times."""
    if args.no_lm:
        return None
    with tempfile.TemporaryDirectory() as d:
        arpa = os.path.join(d, "model.arpa")
        t0 = time.perf_counter()
        synth_arpa(arpa, args.uni, args.bi, args.tri)
        t1 = time.perf_counter()
        lm = beam_device.DeviceLM(arpa, device=device)
        synchronize(device)
        t2 = time.perf_counter()
    print(f"synth ARPA write {t1 - t0:.2f}s, DeviceLM build {t2 - t1:.2f}s", flush=True)
    return lm


def run(fn, logp: torch.Tensor, lengths: torch.Tensor) -> dict:
    """The first call, then ``TRIALS`` trials of ``ITERS`` calls; returns
    the times and the last call's ids and lengths."""
    device = logp.device
    t0 = time.perf_counter()
    ids, lens = fn(logp, lengths, *BEAM_WEIGHTS)
    synchronize(device)
    first_s = time.perf_counter() - t0
    print(f"first call: {first_s:.2f}s", flush=True)
    B = logp.shape[0]
    trials = []
    for trial in range(TRIALS):
        start = time.perf_counter()
        for _ in range(ITERS):
            ids, lens = fn(logp, lengths, *BEAM_WEIGHTS)
        synchronize(device)
        dt = time.perf_counter() - start
        mean_len = float(lens.float().mean())
        trials.append({"ms": 1e3 * dt / ITERS, "utt_s": B * ITERS / dt})
        print(f"trial {trial}: {trials[-1]['ms']:.3f} ms/batch, "
              f"{trials[-1]['utt_s']:.0f} utt/s (mean len {mean_len:.1f})", flush=True)
    return {"first_s": first_s, "trials": trials, "ids": ids, "lens": lens}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.device_beam_probe")
    ap.add_argument("--width", type=int, default=100)
    ap.add_argument("--frames", type=int, default=136)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--no-lm", action="store_true")
    ap.add_argument("--uni", type=int, default=50_000)
    ap.add_argument("--bi", type=int, default=200_000)
    ap.add_argument("--tri", type=int, default=100_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def probe(args) -> dict:
    """The whole probe; returns :func:`run`'s result with the search
    function (``fn``, its ``plain`` twin) and the staged emissions."""
    device = resolve_device(args.device)  # no card: fail before any work
    print(f"device beam probe on {device_name(device)}: B={args.batch}, "
          f"T={args.frames}, W={args.width}", flush=True)
    lm = build_lm(args, device)
    fn = beam_device.make_device_beam_search(args.width, lm=lm)
    logp, lengths = probe_emissions(args.batch, args.frames)
    # staged on the device once: the decoders' emissions are device-resident
    logp = torch.from_numpy(logp).to(device)
    lengths = torch.from_numpy(lengths).to(device)
    result = run(fn, logp, lengths)
    result.update(fn=fn, logp=logp, lengths=lengths)
    return result


def main(argv=None) -> int:
    probe(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
