"""Runs one cell of the benchmark once, in a process of its own.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpubench/``
and the port (``speecht_tpu_torch/``), on a machine with the cards the
cell asks for. The last line of standard output is one JSON object:
``correct``, ``attempted`` and ``failed`` (train steps of the window),
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison read,
beside its limit. The same numbers close standard error. Lines before
the result say where the set-up and the window went.

No card, fewer cards than the cell asks for, or a module of JAX or of the
JAX package loaded in this process: a message on standard error, no
result, and an exit code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

from gpubench import check, manifest  # noqa: E402

# top-level module names this process may not hold once the window has
# closed: JAX, and the package the port was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "speecht_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class HostLoad:
    """The cores this process kept busy over a span (its user and system
    time over the wall time), with the machine's core count. The card's
    machine shows no other process in /proc, so no foreign load is read."""

    def __enter__(self):
        self.t, self.own = time.perf_counter(), sum(os.times()[:2])
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t
        self.line = (f"host: {os.cpu_count()} cores; this process kept "
                     f"{(sum(os.times()[:2]) - self.own) / wall:.2f} busy over the run")
        return False


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return "card: " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi gave nothing ({e})"


def device_record(result, cell: dict, device, traced: bool) -> dict:
    import torch

    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": result.memory_peak_bytes}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if traced:
        out["busy_s"] = result.trace.busy_s()
        out["window_s"] = result.trace.window_s
    return out


def breakdown(result) -> dict:
    gaps = sorted(result.trace.idle_gaps(), key=lambda g: -g[0])[:10]
    return {"device_ops": result.trace.top_device_ops(10),
            "idle_gaps": [[name, seconds] for seconds, name in gaps]}


def main(argv=None, device=None, package_dir: str = manifest.HERE) -> int:
    """One run; returns the exit code. ``device`` other than None runs the
    cell there without looking for a card (the CPU tests)."""
    args = parse_args(argv)
    bench = manifest.Manifest.load(package_dir)
    cell = bench.workload(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
                  f"this machine has {found}", file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    config, traffic = bench.config(cell), bench.traffic(cell)
    manifest.architecture(config, cell["config"])
    kind = manifest.kind(traffic["kind"])
    work_dir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        with HostLoad() as load:
            result = kind.run(kind.Spec(
                workload=args.workload, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), config=config, traffic=traffic,
                limits=check.load_limits(args.workload, package_dir), device=device,
                work_dir=work_dir, t_start=T_START))
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    ctx = types.SimpleNamespace(result=result, config=config, traffic=traffic, cell=cell)
    metrics = {}
    for m in bench.metrics(cell, "per_layer" if args.trace else "end_to_end"):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": bool(result.correct), "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics,
            "device": device_record(result, cell, device, bool(args.trace))}
    if args.trace:
        line["breakdown"] = breakdown(result)
    line["checks"] = result.checks

    found = forbidden_modules()
    if found:
        print(f"error: this process loaded {', '.join(found)}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    if device.type == "cuda":
        print(card_line())
    for text in result.lines + [load.line]:
        print(text)
    for name, entry in result.checks.items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
