"""Production-scale LM probe of the device beam.

The port of ``tools/large_lm_probe.py``. The reference's released LM is
hundreds of MB; this probe synthesises an LM of that scale and runs the
whole binary path on the card:

1. synthesise an ``--ngrams``-entry ARPA (default 10^7: 100,000 words,
   orders 1-3; the JAX tool's generators, so the same bytes for the same
   seed) and convert it with the port's ARPA -> PROBING writer
   (``native.lm_write_binary``);
2. ``DeviceLM.cached`` cold (the binary's dump, the two-choice placement
   of every key and the npz save), then warm (the npz load and the upload,
   synchronised): the device-memory bytes, the arena's buckets and both
   two-choice flags (at this scale single-choice placement cannot bound a
   bucket's load, so both must be on);
3. the device scorer (``ops/beam_device.py::_make_lm_fns``) against the
   host scorer (``native.NGramLM.score_word``) on 30 contexts, within 1e-4;
4. the beam (W=100, top-k 8) on the JAX tool's seeded B=64 x T=128
   emissions with the large LM and with a tiny one: ms a batch by CUDA
   events and utt/s. The difference is what the tables' scale costs (on
   the H100 542 MB of tables against a 50 MB L2).

    python -m speecht_tpu_torch.tools.large_lm_probe [--ngrams N] [--smoke] [--keep DIR]

runs on the card; ``--device cpu`` runs the plain search on the CPU
(``--smoke``: 200,000 n-grams over 5,000 words). It prints the JAX tool's
JSON line, then ``PASS large LM probe`` or ``FAIL large LM probe`` (exit
1).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
BEAM_WIDTH, TOP_K = 100, 8
BEAM_WEIGHTS = (1.5, 0.5, 1.2)  # lm, word count, valid word count
SCORE_TOL = 1e-4


def gen_words(n: int, rng: np.random.RandomState) -> list[str]:
    words = set()
    while len(words) < n:
        lens = rng.randint(3, 9, size=n)
        for ln in lens:
            words.add("".join(rng.choice(LETTERS, size=ln)))
            if len(words) >= n:
                break
    return sorted(words)


def unique_tuples(rng, nvocab: int, count: int, width: int) -> np.ndarray:
    ids = rng.randint(0, nvocab, size=(int(count * 1.1), width)).astype(
        np.uint64
    )
    packed = np.zeros(len(ids), np.uint64)
    for c in range(width):
        packed = packed * np.uint64(nvocab) + ids[:, c]
    _, keep = np.unique(packed, return_index=True)
    return ids[np.sort(keep)][:count].astype(np.int64)


def write_arpa(path: str, words: list[str], n_bi: int, n_tri: int, rng):
    nvocab = len(words)
    bi = unique_tuples(rng, nvocab, n_bi, 2)
    tri = unique_tuples(rng, nvocab, n_tri, 3)
    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={nvocab + 3}\n")
        f.write(f"ngram 2={len(bi)}\n")
        f.write(f"ngram 3={len(tri)}\n\n")
        f.write("\\1-grams:\n")
        f.write("-3.5\t<unk>\n-2.0\t<s>\t-0.4\n-2.1\t</s>\n")
        probs = -1.5 - 3.0 * rng.rand(nvocab)
        backs = -0.1 - 0.4 * rng.rand(nvocab)
        lines = [
            f"{probs[i]:.4f}\t{words[i]}\t{backs[i]:.4f}"
            for i in range(nvocab)
        ]
        f.write("\n".join(lines) + "\n\n")
        f.write("\\2-grams:\n")
        probs = -0.5 - 3.0 * rng.rand(len(bi))
        backs = -0.1 - 0.3 * rng.rand(len(bi))
        for lo in range(0, len(bi), 1 << 19):
            hi = min(lo + (1 << 19), len(bi))
            f.write(
                "\n".join(
                    f"{probs[i]:.4f}\t{words[bi[i, 0]]} {words[bi[i, 1]]}"
                    f"\t{backs[i]:.4f}"
                    for i in range(lo, hi)
                )
                + "\n"
            )
        f.write("\n\\3-grams:\n")
        probs = -0.3 - 3.0 * rng.rand(len(tri))
        for lo in range(0, len(tri), 1 << 19):
            hi = min(lo + (1 << 19), len(tri))
            f.write(
                "\n".join(
                    f"{probs[i]:.4f}\t{words[tri[i, 0]]}"
                    f" {words[tri[i, 1]]} {words[tri[i, 2]]}"
                    for i in range(lo, hi)
                )
                + "\n"
            )
        f.write("\n\\end\\\n")


TINY_ARPA = """\\data\\
ngram 1=7
ngram 2=4

\\1-grams:
-1.0\t<unk>
-0.5\t<s>\t-0.4
-0.6\t</s>
-0.9\tthe\t-0.3
-1.2\tcat\t-0.2
-1.4\tsat\t-0.25
-1.6\tmat\t-0.1

\\2-grams:
-0.3\tthe cat\t-0.1
-0.25\t<s> the\t-0.2
-0.5\tcat sat\t-0.05
-0.6\tsat mat

\\end\\
"""


def synthesize(workdir: str, ngrams: int, vocab: int) -> tuple[str, dict]:
    """``<workdir>/kenlm-model.binary`` from a seeded ARPA of ``ngrams``
    entries over ``vocab`` words (kept if it exists). Returns (its path,
    the seconds and sizes of each step)."""
    from speecht_tpu_torch import native

    binary = os.path.join(workdir, "kenlm-model.binary")
    facts = {"reused": os.path.exists(binary)}
    if facts["reused"]:
        print(f"reusing {binary}", flush=True)
        return binary, facts
    rng = np.random.RandomState(0)
    arpa = os.path.join(workdir, "model.arpa")
    n_rest = max(ngrams - vocab - 3, 2)
    print(f"synthesizing ARPA: {vocab} unigrams + {n_rest // 2} bigrams + "
          f"{n_rest - n_rest // 2} trigrams", flush=True)
    t0 = time.perf_counter()
    words = gen_words(vocab, rng)
    write_arpa(arpa, words, n_rest // 2, n_rest - n_rest // 2, rng)
    facts["arpa_s"] = time.perf_counter() - t0
    facts["arpa_mb"] = os.path.getsize(arpa) / 1e6
    print(f"ARPA written in {facts['arpa_s']:.1f}s ({facts['arpa_mb']:.0f} MB)", flush=True)
    t0 = time.perf_counter()
    native.lm_write_binary(arpa, binary)
    facts["convert_s"] = time.perf_counter() - t0
    facts["binary_mb"] = os.path.getsize(binary) / 1e6
    print(f"converted to PROBING binary in {facts['convert_s']:.1f}s "
          f"({facts['binary_mb']:.0f} MB)", flush=True)
    os.remove(arpa)  # the binary is the artifact under test
    return binary, facts


def sync(lm) -> None:
    """Waits for the LM's uploads."""
    import torch

    device = lm.tables["uni"].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_timed(binary: str, cache_dir: str, device):
    """(the LM, cold seconds, warm seconds): ``DeviceLM.cached`` twice, the
    uploads synchronised."""
    from speecht_tpu_torch.ops import beam_device

    t0 = time.perf_counter()
    lm = beam_device.DeviceLM.cached(binary, cache_dir=cache_dir, device=device)
    sync(lm)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = beam_device.DeviceLM.cached(binary, cache_dir=cache_dir, device=device)
    sync(warm)
    warm_s = time.perf_counter() - t0
    return lm, cold_s, warm_s


def spot_check(lm, binary: str) -> tuple[int, int]:
    """The device scorer against the host binary scorer on the JAX tool's
    30 contexts: histories of 0-2 words (of 40 seeded words, mostly not
    in the LM) before each of 10 words. Returns (checked, mismatched)."""
    import torch

    from speecht_tpu_torch import native
    from speecht_tpu_torch.ops import beam_device

    host = native.NGramLM(binary)
    wl, ns = beam_device._make_lm_fns(lm)
    device = lm.tables["uni"].device
    checked = bad = 0
    sample_words = gen_words(40, np.random.RandomState(9))
    H = lm.hist_len

    def word_id(word):
        wh = beam_device._np_word_hash(np.array(beam_device._word_char_ids(word), np.int64))
        wid, _ = wl(torch.tensor([int(wh[0])], device=device),
                    torch.tensor([int(wh[1])], device=device))
        return wid

    for hw, w in itertools.product(
        [(), (sample_words[0],), (sample_words[1], sample_words[2])],
        sample_words[:10],
    ):
        toks = [lm.bos_id] if lm.bos_id >= 0 else []
        toks += [int(word_id(x)[0]) for x in hw]
        toks = toks[-H:]
        hist = np.zeros(H, np.int64)
        hist[H - len(toks):] = toks
        got = float(ns(torch.from_numpy(hist)[None].to(device),
                       torch.tensor([len(toks)], device=device), word_id(w))[0])
        want = host.score_word(" ".join(hw), w)
        checked += 1
        if abs(got - want) > SCORE_TOL:
            bad += 1
            print(f"MISMATCH {hw} {w}: dev {got} host {want}")
    print(f"scorer spot-check: {checked - bad}/{checked} match", flush=True)
    return checked, bad


def probe_emissions(B: int = 64, T: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's word-ish emissions: seeded logits with a boost on
    the chars of "the", "cats", "m", space and blank, as log-probs, every
    row of length T."""
    from speecht_tpu_torch import vocabulary

    rng = np.random.RandomState(11)
    favored = [0, 19, 2, 7, 4, 18, 12, 27, 28]
    logits = (rng.randn(B, T, vocabulary.NUM_CLASSES) * 2.0).astype(np.float32)
    logits[:, :, favored] += rng.rand(B, T, len(favored)).astype(np.float32) * 4.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return logp, np.full(B, T, np.int32)


def beam_ms(lm, label: str, device, iters: int = 8) -> float:
    """ms a batch of the beam on ``probe_emissions`` (staged on the device
    once): CUDA events on the card, the host clock on the CPU."""
    import torch

    from speecht_tpu_torch.ops import beam_device

    logp, lengths = probe_emissions()
    fn = beam_device.make_device_beam_search(BEAM_WIDTH, lm=lm, prune_top_k=TOP_K)
    x = torch.from_numpy(logp).to(device)
    n = torch.from_numpy(lengths).to(device)
    fn(x, n, *BEAM_WEIGHTS)  # warm-up
    if x.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x, n, *BEAM_WEIGHTS)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x, n, *BEAM_WEIGHTS)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    print(f"{label}: {ms:.3f} ms a batch, {len(lengths) * 1e3 / ms:.1f} utt/s "
          f"({iters} iters)", flush=True)
    return ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.large_lm_probe")
    ap.add_argument("--ngrams", type=int, default=10_000_000)
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, a quick functional check")
    ap.add_argument("--keep", type=str, default=None,
                    help="directory to keep the generated LM in (reused "
                    "across runs if the binary already exists)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.ngrams, args.vocab = 200_000, 5_000
    return args


def main(argv=None) -> int:
    from speecht_tpu_torch.execution import resolve_device
    from speecht_tpu_torch.ops import beam_device

    args = parse_args(argv)
    device = resolve_device(args.device)  # no card: fail before the build
    workdir = args.keep or tempfile.mkdtemp(prefix="large_lm_")
    os.makedirs(workdir, exist_ok=True)
    try:
        binary, _facts = synthesize(workdir, args.ngrams, args.vocab)
        lm, build_s, warm_s = load_timed(binary, os.path.join(workdir, "lm_cache"), device)
        hbm_mb = lm.hbm_bytes() / 1e6
        arena_buckets = int(lm.tables["arena_k"].shape[0])
        print(f"DeviceLM.cached cold (build+save): {build_s:.1f}s, warm (load+upload): "
              f"{warm_s:.1f}s, {hbm_mb:.0f} MB on {device} ({arena_buckets} arena buckets, "
              f"arena two_choice={lm.arena_two_choice}, words two_choice="
              f"{lm.words_two_choice})", flush=True)
        _checked, bad = spot_check(lm, binary)
        large_ms = beam_ms(lm, f"device beam, {args.ngrams} n-grams", device)
        tiny_path = os.path.join(workdir, "tiny.arpa")
        with open(tiny_path, "w") as f:
            f.write(TINY_ARPA)
        tiny_ms = beam_ms(beam_device.DeviceLM(tiny_path, device=device),
                          "device beam, tiny LM", device)
        binary_mb = os.path.getsize(binary) / 1e6
    finally:
        if not args.keep:
            # the generated binary is hundreds of MB
            shutil.rmtree(workdir, ignore_errors=True)
    ok = bad == 0
    print(json.dumps({
        "ngrams": args.ngrams,
        "binary_mb": round(binary_mb, 1),
        "device_lm_build_s": round(build_s, 1),
        "device_lm_cache_warm_s": round(warm_s, 1),
        "hbm_mb": round(hbm_mb, 1),
        "arena_two_choice": lm.arena_two_choice,
        "beam_utt_per_sec_large_lm": round(64e3 / large_ms, 1),
        "beam_utt_per_sec_tiny_lm": round(64e3 / tiny_ms, 1),
        "scorer_ok": ok,
        "words_two_choice": lm.words_two_choice,
        "arena_buckets": arena_buckets,
        "beam_ms_large_lm": large_ms,
        "beam_ms_tiny_lm": tiny_ms,
        "device": str(device),
    }))
    print("PASS large LM probe" if ok else "FAIL large LM probe")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
