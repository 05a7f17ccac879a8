"""Summarize a ``librispeech_scale_soak`` run into markdown.

The port of ``tools/soak_report.py``: the same report of the same log.
Reads <out>/soak_log.jsonl (written incrementally by
``speecht_tpu_torch.tools.librispeech_scale_soak``) and prints:

- corpus + bucket-occupancy recap,
- a per-segment table: wall time, step-time median/p95 over the reported
  intervals, loss at segment end, learning rate, prefetch stalls,
  checkpoint-dir size (rotation evidence),
- the plateau learning-rate decays,
- the dev LER/WER trajectory (greedy every segment, device-beam+LM every
  third), and the final held-out test stats if the run reached them.

Works on a live run (partial log) so interim progress can be inspected
while the soak is still training.

Usage: python -m speecht_tpu_torch.tools.soak_report [--out DIR | --out LOG.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def load(path):
    """Parse the JSONL log, tolerating a live run: a trailing line that is
    still being written (or was truncated by a crash) is skipped with a
    note instead of killing the report."""
    if not os.path.exists(path):
        raise SystemExit(
            f"no soak log at {path} yet -- start "
            "speecht_tpu_torch.tools.librispeech_scale_soak first (or pass --out)"
        )
    recs = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"  (skipping unparseable line {n} -- "
                      "partial write from a live or crashed run)")
    return recs


def pct(xs, q):
    """Linearly interpolated quantile (numpy.percentile semantics) — the
    intervals per segment are coarse (~4-10 samples), where nearest-rank
    'p95' degenerates to the max and overstates the tail."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def report(recs) -> None:
    """Print the markdown report of the log records ``recs``."""
    by = {}
    for r in recs:
        by.setdefault(r["kind"], []).append(r)

    for c in by.get("corpus", []):
        print(
            f"corpus: {c['n_train']} train utts, mean {c['duration_mean_s']}s "
            f"(p50 {c['duration_p50_s']}, max {c['duration_max_s']}), "
            f"cache {c['cache_mb'] / 1024:.1f} GB, generated in "
            f"{c.get('gen_wall_s', 0) / 60:.1f} min"
        )
    for b in by.get("buckets", []):
        occ = b["occupancy"]
        top = sorted(occ.items(), key=lambda kv: -kv[1])[:3]
        print(
            f"buckets: {b['n_buckets']} (step {b['bucket_step']}), "
            f"pad waste {b['pad_waste_frac'] * 100:.1f}%, "
            "top occupancy "
            + ", ".join(f"T{k}:{v}" for k, v in top)
            + f", widest T{max(int(k) for k in occ)}"
        )

    segs = by.get("train_segment", [])
    if segs:
        print()
        print(
            "| seg | to step | wall | step-time p50/p95 (s) | loss@end | lr | "
            "stalls (n / s) | ckpt MB |"
        )
        print("|---|---|---|---|---|---|---|---|")
    # renumber sequentially: each soak invocation restarts its segment
    # counter, so an appended continuation run would repeat "seg 1"
    for seg_no, s in enumerate(segs, start=1):
        times = [i["step_time_s"] for i in s["intervals"]]
        losses = [i["loss"] for i in s["intervals"]]
        lrs = [i["lr"] for i in s["intervals"]]
        stall_n = sum(e["n"] for e in s["stall_events"])
        stall_s = sum(e["s"] for e in s["stall_events"])
        print(
            f"| {seg_no} | {s['target_step']} "
            f"| {s['wall_s'] / 60:.1f} min "
            f"| {pct(times, 0.5):.3f} / {pct(times, 0.95):.3f} "
            f"| {losses[-1] if losses else float('nan'):.2f} "
            f"| {lrs[-1] if lrs else float('nan'):.2e} "
            f"| {stall_n} / {stall_s:.0f} "
            f"| {s['ckpt_mb']:.0f} |"
        )

    # plateau-decay events: any lr drop between consecutive printed
    # intervals (the training loop's plateau decay firing in a real run)
    seq = [i for s in segs for i in s["intervals"]]
    decays = [
        (b["step"], a["lr"], b["lr"])
        for a, b in zip(seq, seq[1:])
        if b["lr"] < a["lr"]
    ]
    if decays:
        print()
        print("plateau lr-decay events:")
        for step, before, after in decays:
            print(f"  step {step}: {before:.2e} -> {after:.2e}")

    traj = by.get("dev_greedy", [])
    if traj:
        print()
        print("dev greedy LER/WER by step:")
        print(
            "  "
            + "  ".join(
                f"{d['step']}: {d['ler']:.3f}/{d['wer']:.3f}" for d in traj
            )
        )
    beam = by.get("dev_beam_lm", [])
    if beam:
        print("dev device-beam+LM LER/WER by step:")
        print(
            "  "
            + "  ".join(
                f"{d['step']}: {d['ler']:.3f}/{d['wer']:.3f}" for d in beam
            )
        )
    for f in by.get("final", []):
        print(
            f"\nfinal held-out test @ step {f['steps']}: "
            f"LER {f['test_ler']:.4f} WER {f['test_wer']:.4f}"
        )
        if "test_beam_lm_wer" in f:  # hard-mode LM-fusion delta
            print(
                f"final held-out test, device-beam+LM: "
                f"LER {f['test_beam_lm_ler']:.4f} "
                f"WER {f['test_beam_lm_wer']:.4f} "
                f"(greedy-relative WER delta "
                f"{f['test_wer'] - f['test_beam_lm_wer']:+.4f})"
            )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.soak_report")
    ap.add_argument(
        "--out",
        default=os.path.join(tempfile.gettempdir(), "soak"),
        help="soak run directory, or a soak_log.jsonl path directly "
        "(e.g. the committed copy docs/records/soak_log.jsonl)",
    )
    args = ap.parse_args(argv)
    path = args.out
    if not path.endswith(".jsonl"):
        path = os.path.join(path, "soak_log.jsonl")
    report(load(path))


if __name__ == "__main__":
    main()
