"""LibriSpeech-scale synthetic soak: sustained training of the port at corpus scale.

The port of ``tools/librispeech_scale_soak.py``. Every convergence drill
before it trains on at most a few thousand utterances of at most ~2,000
frames; what a long run on a real-sized corpus does (bucket skew up to
5,000-frame rows, a ~10 GB feature cache, prefetch headroom, checkpoint
rotation, the plateau decay over thousands of steps) shows only here.
This tool:

1. synthesizes a corpus with LibriSpeech-like statistics: N (default
   20,000) train + 256 dev + 256 test tone-speech utterances whose
   durations follow a lognormal clipped to [1, 30] s (mean ~= 7 s, the
   test-clean mean), written through the real feature-cache layout. The
   draws are the JAX tool's for the same seed, so the files are the same
   bit for bit; the spectrograms may be computed in a pool of spawned
   processes, the utterances still drawn one after another in one
   generator's order;
2. records the corpus duration histogram and the bucket-occupancy
   histogram the bucketed batcher will see;
3. runs a sustained ``train`` through the port's CLI in segments (plateau
   lr decay, --spec-augment, --grad-accum, --group-by-length, checkpoint
   rotation: ``train/checkpoint.py`` keeps the newest 5), each segment a
   fresh process that resumes from the newest checkpoint exactly like a
   restarted job. One process a segment is the point: every segment and
   every evaluate goes through the restart path (restore, the step count
   and learning rate carried over, the loader built anew), which a run
   in one process would exercise once;
4. after each segment: dev-set greedy evaluate (LER/WER trajectory) and,
   every third segment, a ``--device-beam`` evaluate with the LM; records
   checkpoint directory sizes (rotation) and the train stdout's step-time
   / loss / prefetch-stall lines;
5. writes everything as JSON lines to <out>/soak_log.jsonl plus a final
   summary <out>/soak_summary.json (``soak_report`` renders both).

Usage:
  python -m speecht_tpu_torch.tools.librispeech_scale_soak [--n-train 20000]
      [--hours 3] [--segment-steps 1000] [--batch-size 64] [--out DIR]
      [--hard] [--device {cuda,cpu}] [--base-channels N ...]
  # resume after a crash: same --out DIR plus --skip-gen (training
  # restores from the checkpoint dir inside --out automatically)

Each CLI process runs on the card unless ``--device cpu`` is given; one
that cannot reach it fails its segment and the soak. ``--launcher`` runs
each CLI process through another module, for instance
``--launcher "speecht_tpu_torch.tools.multiprocess_drill rank DIR/{name}.json"``,
whose ``rank`` entry writes the process's kernel launches and peak card
memory to a file at exit (``{name}``: ``seg1-train``, ``seg1-dev``,
``seg3-dev-beam``, ``final-test``, ``final-test-beam``...).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import re
import shlex
import subprocess
import sys
import tempfile
import time
from collections import Counter, deque

import numpy as np

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data import features
from speecht_tpu_torch.tools import hard_corpus
from speecht_tpu_torch.tools import synthetic_convergence as sc
from speecht_tpu_torch.tools.synthetic_corpus import SR, WORDS, synth_utterance, write_lm

CLI_MODULE = "speecht_tpu_torch"
# the directory that holds the package: the CLI processes import it from there
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the dev and test splits' sizes (the JAX tool's)
N_DEV = N_TEST = 256
# a spectrogram worker pays for its start-up after about this many files
FILES_PER_WORKER = 500
MAX_WORKERS = 8
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def sample_sentence(rng, target_seconds: float) -> str:
    """Word sequence whose tone rendering lasts ~target_seconds.

    Tone alphabet: 120 ms per char + 20 ms gaps -> ~0.14 s per char plus
    a word's space char between words.
    """
    chars_needed = max(3, int(target_seconds / 0.14))
    words = []
    total = 0
    while total < chars_needed:
        w = WORDS[rng.randint(len(WORDS))]
        words.append(w)
        total += len(w) + 1
    return " ".join(words)


def _write_utterance(path: str, audio: np.ndarray, sentence: str) -> int:
    """One cache file: the audio's power spectrogram and the transcript's
    ids. Returns its frame count."""
    feats = features.calc_power_spectrogram(audio, SR)
    np.savez(
        path,
        audio_fragments=feats,
        transcript=np.asarray(vocabulary.sentence_to_ids(sentence), np.int64),
    )
    return int(feats.shape[0])


@contextlib.contextmanager
def _spectrogram_pool(workers: int):
    """A pool of ``workers`` spawned processes (None for 0). Each starts
    with one BLAS and OpenMP thread: the mel product, multi-threaded in
    every worker, oversubscribes the cores (a pool of 3 wrote features
    slower than one process)."""
    if workers <= 0:
        yield None
        return
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield pool
    finally:
        pool.shutdown(cancel_futures=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def corpus_workers(n_files: int) -> int:
    """Spectrogram processes for a corpus of ``n_files``: one a
    ``FILES_PER_WORKER`` files, at most one a spare core and ``MAX_WORKERS``;
    0 (this process alone) for a small corpus."""
    return max(0, min(n_files // FILES_PER_WORKER, (os.cpu_count() or 1) - 1, MAX_WORKERS))


def make_corpus(root: str, n_train: int, n_dev: int, n_test: int,
                seed: int = 0, hard_params=None, workers: int = 0) -> dict:
    """Write the feature cache directly; returns corpus statistics.

    ``hard_params`` (a ``hard_corpus.HardParams``) switches synthesis to
    the hard-mode generator: speaker pitch/rate jitter, additive noise,
    and adjacent-char swap corruption over a confusable minimal-pair
    lexicon, so the quality trajectory does not saturate to 0.000.
    Duration statistics stay LibriSpeech-like either way. ``workers`` > 0
    computes and writes the spectrograms in that many spawned processes;
    the files are the same.
    """
    rng = np.random.RandomState(seed)
    durations = []
    frames_all = []
    lex = None
    swapped = chars = 0
    if hard_params is not None:
        lex = hard_corpus.build_lexicon()

    def write_split(split, n, offset):
        nonlocal swapped, chars
        out = os.path.join(root, "data", "preprocessed-power", split)
        os.makedirs(out, exist_ok=True)
        t0 = time.time()
        pending: deque = deque()

        def collect(block: bool):
            while pending and (block or pending[0].done()
                               or len(pending) > 4 * workers):
                frames = pending.popleft().result()
                if split == "train":
                    frames_all.append(frames)

        for i in range(n):
            # lognormal clipped to [1, 30] s, median ~6 s (LibriSpeech-like
            # long tail; test-clean mean ~7.4 s)
            dur = float(np.clip(rng.lognormal(np.log(6.0), 0.55), 1.0, 30.0))
            if hard_params is not None:
                sentence = hard_corpus.sample_sentence_hard(rng, lex, dur)
                audio, n_sw = hard_corpus.synth_utterance_hard(
                    sentence, rng, hard_params, return_truth=True)
                swapped += n_sw
                chars += sum(c != " " for c in sentence)
            else:
                sentence = sample_sentence(rng, dur)
                audio = synth_utterance(sentence, rng)
            if split == "train":
                durations.append(len(audio) / SR)
            path = os.path.join(out, f"synth-{offset + i:06d}")
            if pool is None:
                frames = _write_utterance(path, audio, sentence)
                if split == "train":
                    frames_all.append(frames)
            else:
                pending.append(pool.submit(_write_utterance, path, audio, sentence))
                collect(block=False)
            if (i + 1) % 2000 == 0:
                rate = (i + 1) / (time.time() - t0)
                print(f"  {split}: {i + 1}/{n} ({rate:.1f} utt/s)", flush=True)
        collect(block=True)

    with _spectrogram_pool(workers) as pool:
        write_split("train", n_train, 0)
        write_split("dev", n_dev, 1_000_000)
        write_split("test", n_test, 2_000_000)

    durations = np.asarray(durations)
    frames = np.asarray(frames_all)
    dur_hist, _dur_edges = np.histogram(durations, bins=list(range(0, 32, 2)))
    stats = {
        "n_train": n_train,
        "duration_mean_s": round(float(durations.mean()), 2),
        "duration_p50_s": round(float(np.median(durations)), 2),
        "duration_max_s": round(float(durations.max()), 2),
        "duration_hist_2s_bins": dur_hist.tolist(),
        "frames_mean": int(frames.mean()),
        "frames_max": int(frames.max()),
    }
    if hard_params is not None:
        stats["hard"] = True
        stats["swap_prob"] = hard_params.swap_prob
        stats["realized_swap_frac"] = round(swapped / max(chars, 1), 4)
        stats["lexicon_pairs"] = len(lex.pair_words)
        stats["lexicon_loners"] = len(lex.loner_words)
    return stats


def bucket_occupancy(root: str, bucket_step: int) -> dict:
    """Histogram of padded-time buckets over the cached train split — the
    shape-reuse profile the bucketed batcher will see."""
    split = os.path.join(root, "data", "preprocessed-power", "train")
    counts: Counter = Counter()
    waste_num = 0.0
    waste_den = 0.0
    for name in os.listdir(split):
        with np.load(os.path.join(split, name)) as z:
            t = int(z["audio_fragments"].shape[0])
        bucket = -(-t // bucket_step) * bucket_step
        counts[bucket] += 1
        waste_num += bucket - t
        waste_den += bucket
    return {
        "bucket_step": bucket_step,
        "occupancy": {str(k): v for k, v in sorted(counts.items())},
        "n_buckets": len(counts),
        "pad_waste_frac": round(waste_num / max(waste_den, 1.0), 4),
    }


def dir_size_mb(path: str) -> float:
    total = 0
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            with contextlib.suppress(OSError):
                total += os.path.getsize(os.path.join(dirpath, f))
    return round(total / (1 << 20), 1)


_STEP_RE = re.compile(
    r"global step (\d+) learning rate ([\d.e-]+) step-time ([\d.]+) "
    r"average loss ([\d.]+)"
)
_STALL_RE = re.compile(r"prefetch stalled (\d+) times \(([\d.]+)s\)")

_GLOBAL_STATS_RE = re.compile(
    r"LED: ([\d.]+) LER: ([\d.]+) WED: ([\d.]+) WER: ([\d.]+)"
)
_PRECISE_STATS_RE = re.compile(r"precise: LER ([\d.]+) WER ([\d.]+)")


def run_cli_subprocess(argv, device: str | None = None, launcher=(CLI_MODULE,)) -> str:
    """Run one CLI command in a fresh OS process; tee + return stdout.

    The process is ``python -u -m <launcher> <argv>`` (``launcher``: the
    port's CLI module, or a module and its arguments that run the CLI on
    the arguments after them), with ``--device`` appended when ``device``
    is given. Raises RuntimeError when it exits with another code than 0.
    """
    cmd = [sys.executable, "-u", "-m", *launcher, *argv]
    if device:
        cmd += ["--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
    lines = []
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        lines.append(line)
    rc = proc.wait()
    out = "".join(lines)
    if rc != 0:
        raise RuntimeError(f"CLI {argv[0]!r} exited with {rc}")
    return out


def parse_global_stats(out: str) -> tuple[float, float]:
    """(LER, WER) from evaluate stdout — the LAST stats line is the
    'Global statistics' block's. Prefers the 4-decimal ``precise:`` twin
    when present; falls back to the reference-parity 2-decimal summary."""
    p = _PRECISE_STATS_RE.findall(out)
    if p:
        return float(p[-1][0]), float(p[-1][1])
    m = _GLOBAL_STATS_RE.findall(out)
    if not m:
        raise RuntimeError("no LED/LER/WED/WER line in evaluate output")
    _led, ler, _wed, wer = m[-1]
    return float(ler), float(wer)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m speecht_tpu_torch.tools.librispeech_scale_soak")
    ap.add_argument("--n-train", type=int, default=20000)
    ap.add_argument("--hours", type=float, default=3.0)
    ap.add_argument("--segment-steps", type=int, default=1000)
    ap.add_argument("--steps-per-checkpoint", type=int, default=250)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--bucket-step", type=int, default=256)
    ap.add_argument("--max-segments", type=int, default=1000)
    ap.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "soak"))
    ap.add_argument("--skip-gen", action="store_true",
                    help="Corpus already generated under --out.")
    ap.add_argument("--gen-only", action="store_true",
                    help="Generate the corpus and exit (so generation can "
                    "overlap other card work before the train starts).")
    ap.add_argument("--hard", action="store_true",
                    help="Hard-mode corpus (hard_corpus.py): speaker "
                    "jitter + noise + adjacent-char swaps over a "
                    "minimal-pair lexicon, so dev/test WER does not "
                    "saturate to 0.000 and LM fusion has a measurable "
                    "delta.")
    ap.add_argument("--swap-prob", type=float, default=0.05)
    ap.add_argument("--snr-lo", type=float, default=6.0)
    ap.add_argument("--snr-hi", type=float, default=18.0)
    ap.add_argument("--lm-weight", type=float, default=None,
                    help="Beam-eval LM weight (default: 0.4 plain, "
                    "0.6 hard).")
    ap.add_argument("--valid-word-count-weight", type=float, default=2.3,
                    help="Beam-eval word-validity bonus (hard mode only).")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    for name in sc.MODEL_FLAGS:
        ap.add_argument("--" + name.replace("_", "-"), dest=name, type=int)
    ap.add_argument("--launcher", type=str, default=CLI_MODULE,
                    help="MODULE [ARGS...] each CLI process runs in place of "
                    f"{CLI_MODULE}, its CLI arguments after ARGS; '{{name}}' "
                    "in ARGS becomes the process's name (seg1-train, seg1-dev, "
                    "seg3-dev-beam, final-test, final-test-beam, ...)")
    return ap.parse_args(argv)


def main(argv=None) -> dict | None:
    """The soak; returns the ``final`` record (None with ``--gen-only``)."""
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")

    root = args.out
    os.makedirs(root, exist_ok=True)
    # the device beam's LM tables are cached beside the run, not in $HOME
    os.environ.setdefault("SPEECHT_DEVICE_LM_CACHE", os.path.join(root, "device_lm"))
    log_path = os.path.join(root, "soak_log.jsonl")

    def log(kind: str, payload: dict):
        rec = {"t": round(time.time(), 1), "kind": kind, **payload}
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def cli(name: str, cli_argv: list[str]) -> str:
        launcher = shlex.split(args.launcher.replace("{name}", name))
        return run_cli_subprocess(cli_argv, args.device, launcher)

    hard_params = None
    if args.hard:
        hard_params = hard_corpus.HardParams(
            swap_prob=args.swap_prob, snr_lo=args.snr_lo, snr_hi=args.snr_hi)

    if not args.skip_gen:
        print(f"Generating {args.n_train}+{N_DEV}+{N_TEST} utterances under {root}"
              + (" (hard mode)" if args.hard else ""))
        t0 = time.time()
        stats = make_corpus(root, args.n_train, N_DEV, N_TEST, hard_params=hard_params,
                            workers=corpus_workers(args.n_train + N_DEV + N_TEST))
        stats["gen_wall_s"] = round(time.time() - t0, 1)
        cache_mb = dir_size_mb(
            os.path.join(root, "data", "preprocessed-power")
        )
        stats["cache_mb"] = cache_mb
        print(f"corpus: {json.dumps(stats)}")
        log("corpus", stats)
        occ = bucket_occupancy(root, args.bucket_step)
        print(f"bucket occupancy: {json.dumps(occ)}")
        log("buckets", occ)
    if args.gen_only:
        print("corpus generated; exiting (--gen-only)")
        return None

    if args.hard:
        lm_dir = hard_corpus.write_lm_hard(root, hard_corpus.build_lexicon())
        beam_flags = ["--lm-weight", str(args.lm_weight or 0.6),
                      "--valid-word-count-weight",
                      str(args.valid_word_count_weight)]
    else:
        lm_dir = write_lm(root)
        beam_flags = ["--lm-weight", str(args.lm_weight or 0.4)]
    common = [
        "--data-dir", os.path.join(root, "data"),
        "--train-dir", os.path.join(root, "train"),
        "--log-dir", os.path.join(root, "log"),
        "--run-name", "soak",
        "--batch-size", str(args.batch_size),
        "--bucket-step", str(args.bucket_step),
        *sc.model_flags(**{name: getattr(args, name) for name in sc.MODEL_FLAGS}),
    ]
    ckpt_dir = os.path.join(root, "train", "soak")

    deadline = time.time() + args.hours * 3600
    total_steps = 0
    # resume support: continue the step count from the checkpoint
    if os.path.isdir(ckpt_dir):
        from speecht_tpu_torch.train.checkpoint import CheckpointManager

        total_steps = CheckpointManager(ckpt_dir).latest_step() or 0
        print(f"resuming at step {total_steps}")

    segment = 0
    while time.time() < deadline and segment < args.max_segments:
        segment += 1
        total_steps += args.segment_steps
        print(f"\n=== segment {segment}: train to step {total_steps} ===",
              flush=True)
        t0 = time.time()
        out = cli(f"seg{segment}-train", [
            "train",
            "--max-steps", str(args.segment_steps),
            "--steps-per-checkpoint", str(args.steps_per_checkpoint),
            "--learning-rate", "3e-4",
            "--learning-rate-decay-factor", "0.5",
            "--spec-augment",
            "--grad-accum", "2",
            "--group-by-length",
            *common,
        ])
        train_wall = time.time() - t0
        intervals = [
            {
                "step": int(m.group(1)),
                "lr": float(m.group(2)),
                "step_time_s": float(m.group(3)),
                "loss": float(m.group(4)),
            }
            for m in _STEP_RE.finditer(out)
        ]
        stalls = [
            {"n": int(m.group(1)), "s": float(m.group(2))}
            for m in _STALL_RE.finditer(out)
        ]
        log(
            "train_segment",
            {
                "segment": segment,
                "target_step": total_steps,
                "wall_s": round(train_wall, 1),
                "intervals": intervals,
                "stall_events": stalls,
                "ckpt_mb": dir_size_mb(ckpt_dir),
            },
        )

        t0 = time.time()
        out = cli(f"seg{segment}-dev",
                  ["evaluate", "--dev", "--no-save", "--step-count", "2", *common])
        ler, wer = parse_global_stats(out)
        dev = {
            "segment": segment,
            "step": total_steps,
            "ler": round(ler, 4),
            "wer": round(wer, 4),
            "wall_s": round(time.time() - t0, 1),
        }
        print(f"dev greedy: {json.dumps(dev)}", flush=True)
        log("dev_greedy", dev)

        if segment % 3 == 0:
            t0 = time.time()
            out = cli(f"seg{segment}-dev-beam", [
                "evaluate", "--dev", "--no-save", "--step-count", "2",
                "--language-model", lm_dir,
                "--device-beam",
                *beam_flags,
                *common,
            ])
            ler, wer = parse_global_stats(out)
            beam = {
                "segment": segment,
                "step": total_steps,
                "ler": round(ler, 4),
                "wer": round(wer, 4),
                "wall_s": round(time.time() - t0, 1),
            }
            print(f"dev device-beam+LM: {json.dumps(beam)}", flush=True)
            log("dev_beam_lm", beam)

    # final held-out test evaluate, greedy + device beam
    out = cli("final-test", ["evaluate", "--test", "--no-save", *common])
    ler, wer = parse_global_stats(out)
    final = {
        "steps": total_steps,
        "test_ler": round(ler, 4),
        "test_wer": round(wer, 4),
    }
    if args.hard:
        # the held-out LM-fusion delta: greedy vs device-beam+LM on the
        # same test split
        out = cli("final-test-beam", [
            "evaluate", "--test", "--no-save",
            "--language-model", lm_dir, "--device-beam",
            *beam_flags, *common,
        ])
        ler, wer = parse_global_stats(out)
        final["test_beam_lm_ler"] = round(ler, 4)
        final["test_beam_lm_wer"] = round(wer, 4)
    log("final", final)
    with open(os.path.join(root, "soak_summary.json"), "w") as f:
        json.dump(final, f)
    print(f"\nSOAK DONE: {json.dumps(final)}")
    return final


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
