"""Sustained train-loop step time on the card, through the port's loader.

The port of ``tools/pipeline_soak.py``. Writes a power-feature npz cache
of 512 utterances (400-559 frames of 128 features, 30-89 labels; the JAX
tool's draws in its order, so the same arrays) and no audio, so it times
the loader, the host-to-device copy and a loop that only launches work:
``Training(flags)``'s loader and model, ``execution.init_state`` and
``train/step.make_train_step_acc``, at B=64 with 256-frame buckets,
``--group-by-length``, the bf16 wire, learning rate 1e-4 and max norm 5.
121 steps: one synchronise after step 19 (the warm-up), one at the end,
nothing read back in between. Prints the sustained ms a step over the
last 101 steps and the average loss.

    python -m speecht_tpu_torch.tools.pipeline_soak

runs on the card; ``--device cpu`` on the CPU (``--utterances``,
``--batch-size``, ``--steps``, ``--warmup`` and the width flags make that
quick).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from speecht_tpu_torch.execution import device_name, init_state, resolve_device, synchronize
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.training import Training


def write_cache(root: str, n: int = 512, seed: int = 0) -> str:
    """The JAX tool's synthetic cache under ``root/preprocessed-power/train``."""
    cache = os.path.join(root, "preprocessed-power", "train")
    os.makedirs(cache)
    rng = np.random.RandomState(seed)
    for i in range(n):
        T = int(rng.randint(400, 560))
        np.savez(
            os.path.join(cache, f"utt-{i}.npz"),
            audio_fragments=rng.randn(T, 128).astype(np.float32),
            transcript=rng.randint(0, 28, size=rng.randint(30, 90)).astype(np.int32),
        )
    return cache


def soak_flags(root: str, args):
    """The port's own ``train`` flags (so every flag ``Training`` reads is
    there) with the JAX tool's values."""
    from speecht_tpu_torch.cli import CLI

    return CLI([
        "train", "--data-dir", root, "--train-dir", root, "--log-dir", root,
        "--run-name", "soak", "--power", "--batch-size", str(args.batch_size),
        "--bucket-step", "256", "--group-by-length", "--transfer-dtype", "bfloat16",
        "--compute-dtype", "bfloat16", "--learning-rate", "1e-4",
        "--max-gradient-norm", "5.0", "--device", args.device,
        "--base-channels", str(args.base_channels),
        "--wide-channels", str(args.wide_channels),
        "--num-body-layers", str(args.num_body_layers),
    ]).parsed


def soak(flags, steps: int = 121, warmup: int = 20) -> dict:
    """``steps`` train steps through the loader; the clock runs from the
    synchronise after step ``warmup - 1`` to the one after the last step.
    Returns the sustained ms a step, the last step's index, the average
    loss, the accumulated metrics, the final state, the loader's prefetch
    stalls and the ``time.perf_counter()`` at which the clock started."""
    t = Training(flags)
    t.model.to(t.device).train()
    state, tx = init_state(t.model, flags)
    train_step = tstep.make_train_step_acc(t.model, tx, mesh=t.mesh)
    acc = tstep.init_metrics_acc(t.device)
    loader = t.create_loader()
    start, n_timed = None, 0
    for i, (_host, batch) in enumerate(loader):
        state, acc = train_step(state, acc, batch)
        if i == warmup - 1:
            synchronize(t.device)  # drain the warm-up
            start = time.perf_counter()
        elif i >= warmup:
            n_timed += 1
        if i == steps - 1:
            break
    synchronize(t.device)  # one sync at the end: the loop only launched
    elapsed = time.perf_counter() - start
    return {
        "ms_per_step": 1e3 * elapsed / n_timed, "n_timed": n_timed, "last_step": i,
        "loss": float(acc["loss_sum"]) / max(float(acc["count"]), 1.0),
        "acc": acc, "state": state, "stalls": loader.stall_count,
        "device": t.device, "clock_start": start,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.pipeline_soak")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--utterances", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=121)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--base-channels", type=int, default=250)
    ap.add_argument("--wide-channels", type=int, default=2000)
    ap.add_argument("--num-body-layers", type=int, default=7)
    return ap.parse_args(argv)


def run(args) -> dict:
    """Writes the cache in a temporary directory, runs :func:`soak` and
    prints the JAX tool's two lines; returns :func:`soak`'s result and the
    seconds the cache took."""
    resolve_device(args.device)  # no card: fail before writing the cache
    root = tempfile.mkdtemp(prefix="pipeline_soak_")
    try:
        t0 = time.perf_counter()
        write_cache(root, args.utterances)
        cache_s = time.perf_counter() - t0
        r = soak(soak_flags(root, args), args.steps, args.warmup)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"sustained pipeline step: {r['ms_per_step']:.1f} ms over {r['n_timed']} steps "
          f"(B{args.batch_size}, ~512-frame utts, group-by-length, bf16 wire; "
          f"dispatch-only loop) on {device_name(r['device'])}")
    print(f"loss after {r['last_step']} steps: {r['loss']:.1f}")
    r["cache_s"] = cache_s
    return r


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
