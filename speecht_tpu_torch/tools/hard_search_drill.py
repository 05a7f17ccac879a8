"""LM-weight search drill on the hard corpus: show that ``search`` optimizes.

The port of ``tools/hard_search_drill.py``. On the hard corpus
(``hard_corpus.py``) dev WER has signal, so the evolutionary search over
(lm_weight, word_count_weight, valid_word_count_weight) has something to
climb. The drill:

1. runs the port's ``search --generations N`` on a trained hard-corpus
   checkpoint (score ``-(LER+WER)``, Gaussian mutations, a sorted capped
   population, seeded with Candidate(1.0, 0.0, 0.0); the mutations are
   unseeded, as in both CLIs);
2. parses the candidates (the 4-decimal ``candidate-precise`` lines where
   printed), checks that the first is the seed and records the best-so-far
   score after each;
3. evaluates the held-out ``test`` split with the seed's weights and with
   the best candidate's, in the search's decode mode, and compares them
   by ``synthetic_convergence.held_out_rates``: the CLI's global rates add
   the rows in the order the reader shuffled, so two runs may differ in
   the last bit for the same decodes.

It passes only if the best beats the seed on dev and its test LER+WER is
below the seed's (the JAX tool's two gates), prints ``PASS hard-corpus
search drill`` or ``FAIL hard-corpus search drill``, and writes
``<root>/search_drill.json`` with the JAX tool's keys.

    python -m speecht_tpu_torch.tools.hard_search_drill --root DIR
        [--generations 60] [--noise-std 0.3] [--device-beam]
        [--run-name pilot] [--device {cuda,cpu}] [--base-channels N ...]

runs on the card unless ``--device cpu`` is given; it exits 1 on a fail.
``DIR`` holds a corpus with dev and test splits, its ``lm`` and a
checkpoint under ``train/<run-name>`` (``hard_corpus pilot --n-test 128
--keep DIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from speecht_tpu_torch.tools import hard_corpus
from speecht_tpu_torch.tools import synthetic_convergence as sc

SEED_WEIGHTS = (1.0, 0.0, 0.0)
_CAND_RE = re.compile(
    r"^(-?[\d.]+) Candidate \(lm_weight=(-?[\d.]+), wc_weight=(-?[\d.]+), "
    r"valid_wc_weight=(-?[\d.]+)\) has LER: ([\d.]+) WER: ([\d.]+)",
    re.M,
)
_CAND_PRECISE_RE = re.compile(
    r"^candidate-precise: score (-?[\d.]+) lm_weight (-?[\d.]+) "
    r"wc_weight (-?[\d.]+) valid_wc_weight (-?[\d.]+) "
    r"LER ([\d.]+) WER ([\d.]+)",
    re.M,
)


def parse_candidates(out: str) -> list[dict]:
    """Each candidate ``search`` printed, in order: the 4-decimal
    ``candidate-precise`` lines where there are any (near an error floor
    the 2-decimal lines collapse distinct scores onto one value)."""
    rx = _CAND_PRECISE_RE if _CAND_PRECISE_RE.search(out) else _CAND_RE
    return [
        {
            "score": float(m.group(1)),
            "lm_weight": float(m.group(2)),
            "word_count_weight": float(m.group(3)),
            "valid_word_count_weight": float(m.group(4)),
            "ler": float(m.group(5)),
            "wer": float(m.group(6)),
        }
        for m in rx.finditer(out)
    ]


def best_so_far(cands: list[dict]) -> tuple[dict, list[float]]:
    """The best candidate (the first of the highest score) and the best
    score after each candidate, rounded to 4 decimals."""
    best, trajectory = None, []
    for c in cands:
        if best is None or c["score"] > best["score"]:
            best = c
        trajectory.append(round(best["score"], 4))
    return best, trajectory


def gates(seed_score: float, best_score: float, seed_test: tuple[float, float],
          best_test: tuple[float, float]) -> dict[str, bool]:
    """The JAX tool's two gates: the best beats the seed on dev, and its
    held-out LER+WER is below the seed's."""
    return {
        "dev improved": best_score > seed_score,
        "test improved": sum(best_test) < sum(seed_test),
    }


def weight_flags(c: dict) -> list[str]:
    return ["--lm-weight", str(c["lm_weight"]),
            "--word-count-weight", str(c["word_count_weight"]),
            "--valid-word-count-weight", str(c["valid_word_count_weight"])]


def run(args) -> dict:
    """Runs the drill; returns the record written to
    ``<root>/search_drill.json``, with the two test evaluates in full
    (``test_runs``: held-out and CLI rates, seconds), the gates and
    ``ok``."""
    from speecht_tpu_torch.execution import resolve_device

    resolve_device(args.device)
    root = args.root
    lm_dir = os.path.join(root, "lm")
    common = hard_corpus.common_flags(root, args, args.run_name, args.batch_size,
                                      args.bucket_step)
    beam_mode = ["--device-beam"] if args.device_beam else []

    print(f"== search: {args.generations} generations on the hard dev landscape ==",
          flush=True)
    t0 = time.perf_counter()
    _candidates, out = sc.run_cli([
        "search", "--generations", str(args.generations),
        "--noise-std", str(args.noise_std),
        "--population-size", str(args.population_size),
        "--step-count", str(args.step_count),
        "--language-model", lm_dir, *beam_mode, *common])
    search_wall = time.perf_counter() - t0
    cands = parse_candidates(out)
    if len(cands) != args.generations + 1:
        print(f"note: parsed {len(cands)} candidate lines (expected {args.generations + 1})")
    if not cands:
        raise RuntimeError("search printed no candidates")
    seed = cands[0]
    weights = (seed["lm_weight"], seed["word_count_weight"], seed["valid_word_count_weight"])
    if weights != SEED_WEIGHTS:
        raise RuntimeError(f"the first candidate is not the seed {SEED_WEIGHTS}: {seed}")
    best, trajectory = best_so_far(cands)

    print(f"\nseed  score {seed['score']:.4f} (LER {seed['ler']:.2f} WER {seed['wer']:.2f})")
    print(f"best  score {best['score']:.4f} (LER {best['ler']:.2f} WER {best['wer']:.2f}) at "
          f"lm={best['lm_weight']:.2f} wc={best['word_count_weight']:.2f} "
          f"vwc={best['valid_word_count_weight']:.2f}")

    evaluate = ["evaluate", "--test", "--no-save", "--language-model", lm_dir,
                *beam_mode, *common]
    print("\n== held-out test evaluate: seed weights ==", flush=True)
    test_seed = sc.timed_eval([*evaluate, *weight_flags(seed)])
    print("\n== held-out test evaluate: found weights ==", flush=True)
    test_best = sc.timed_eval([*evaluate, *weight_flags(best)])
    seed_rates = (test_seed["ler"], test_seed["wer"])
    best_rates = (test_best["ler"], test_best["wer"])

    record = {
        "generations": args.generations,
        "noise_std": args.noise_std,
        "dev_utterances": args.step_count * args.batch_size,
        "decode": "device-beam" if args.device_beam else "host-beam",
        "search_wall_s": round(search_wall, 1),
        "seed": seed,
        "best": best,
        "best_score_trajectory": trajectory,
        "test_seed": {"ler": seed_rates[0], "wer": seed_rates[1]},
        "test_best": {"ler": best_rates[0], "wer": best_rates[1]},
    }
    with open(os.path.join(root, "search_drill.json"), "w") as f:
        json.dump(record, f, indent=1)

    passed = gates(seed["score"], best["score"], seed_rates, best_rates)
    print(f"\ndev:  seed {seed['score']:.4f} -> best {best['score']:.4f} "
          f"({'improved' if passed['dev improved'] else 'NO IMPROVEMENT'})")
    print(f"test: seed LER+WER {sum(seed_rates):.4f} -> found {sum(best_rates):.4f} "
          f"({'improved' if passed['test improved'] else 'NO IMPROVEMENT'}; the rows' "
          f"rates; the CLI's sums {test_seed['cli_ler'] + test_seed['cli_wer']:.4f} -> "
          f"{test_best['cli_ler'] + test_best['cli_wer']:.4f})")
    ok = all(passed.values())
    if ok:
        print("PASS hard-corpus search drill: the search optimizes and the found "
              "weights generalize to the held-out split")
    else:
        print("FAIL hard-corpus search drill")
    for r in (test_seed, test_best):
        r.pop("output")
    return {**record, "test_runs": {"seed": test_seed, "best": test_best},
            "gates": passed, "ok": ok}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, required=True)
    ap.add_argument("--generations", type=int, default=60)
    ap.add_argument("--noise-std", type=float, default=0.3)
    ap.add_argument("--population-size", type=int, default=10)
    ap.add_argument("--step-count", type=int, default=2,
                    help="dev batches the search scores candidates on")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--bucket-step", type=int, default=256)
    ap.add_argument("--device-beam", action="store_true")
    # JAX's default is its soak's run name; the port's is the pilot's
    ap.add_argument("--run-name", type=str, default=hard_corpus.RUN_NAME)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    for name in sc.MODEL_FLAGS:
        ap.add_argument("--" + name.replace("_", "-"), dest=name, type=int)
    return ap.parse_args(argv)


if __name__ == "__main__":
    sys.exit(0 if run(parse_args())["ok"] else 1)
