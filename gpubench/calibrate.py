"""The readings a training cell's limits are set from, on many seeds in
one process, at the cell's own size and on its own batches.

    python3 -m gpubench.calibrate --workload <name> --seeds <n> [<n> ...]

For each seed it makes what a run's set-up makes (the corpus, the program,
its checked steps through the window's step and loader; no window) and
prints one JSON line with the comparison's numbers (``check.py``) for:

- ``program``: the program against the reference, as a run compares them;
- ``control``: the reference computed in float8 (e4m3, one scale a tensor,
  at every point where the program rounds to bfloat16, on values and
  gradients), put in the program's place: the precision below the
  configuration's bfloat16;
- ``half_batch``: the reference with the second half of each batch left
  out and the mean taken over the rest, put in the program's place.

A step that leaves the state unchanged reads 1 on ``grad_norm_gap`` and
``update_norm_gap`` by their definition and needs no run. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from gpubench import check, manifest
from gpubench.kinds import train
from gpubench.reference import common


def half_batch(rows: int) -> list:
    return list(range(rows // 2))


def readings(spec: train.Spec) -> dict:
    program = train.Program(spec)
    got = program.readings()
    program.close()
    reference, _notes = train.reference_readings(
        spec, program.data, program.features, program.weights, program.check_rows)
    control, _ = train.reference_readings(
        spec, program.data, program.features, program.weights, program.check_rows,
        quantize=common.fp8_quantize)
    fault, _ = train.reference_readings(
        spec, program.data, program.features, program.weights, program.check_rows,
        rows=half_batch)
    return {"seed": spec.seed, "program": check.numbers(got, reference),
            "control": check.numbers(control, reference),
            "half_batch": check.numbers(fault, reference)}


def main(argv=None, device=None, package_dir: str = manifest.HERE) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    bench = manifest.Manifest.load(package_dir)
    cell = bench.workload(args.workload)
    config, traffic = bench.config(cell), bench.traffic(cell)
    manifest.architecture(config, cell["config"])
    if device is None:
        if not torch.cuda.is_available():
            print("error: no CUDA device", file=sys.stderr)
            return 2
        device = "cuda:0"
    rows = []
    for seed in args.seeds:
        work_dir = tempfile.mkdtemp(prefix="gpubench-calibrate-")
        t = time.perf_counter()
        try:
            spec = train.Spec(workload=args.workload, seed=seed, seconds=0.0, trace=False,
                              config=config, traffic=traffic, limits={},
                              device=torch.device(device), work_dir=work_dir, t_start=t)
            row = readings(spec)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for side in ("program", "control", "half_batch"):
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[side][k] for r in rows) for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "largest program, smallest control and fault": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
