"""Per-layer forward cost on the card: cumulative-prefix timing.

The port of ``tools/layer_breakdown.py``. Times Wav2Letter cut to its
first k layers (k = 1..11) at the bench shape (B=64, T=1024 input frames,
128 power features) and differences consecutive medians: each layer's ms,
beside its analytic FLOPs, the rate they give and that rate's share of
the card's dense peak for the compute dtype.

A prefix runs the model's own first k ``Conv1d`` modules
(``models/wav2letter.py``), so it times what the model runs: cuDNN's
conv1d, or the hand-written conv0 kernel for conv_0 under
``SPEECHT_PALLAS_CONV0=1`` (read at each call). The 11-layer prefix is the
whole forward.

    python -m speecht_tpu_torch.tools.layer_breakdown [--compute-dtype float32]

runs on the card; ``--device cpu`` times the CPU (the width flags, with
``--batch`` and ``--frames``, make that quick). Each trial of
``ITERS`` calls ends in one synchronise of the card.
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np
import torch

from speecht_tpu_torch.data.features import feature_size
from speecht_tpu_torch.execution import build_model, device_name, resolve_device, synchronize

TRIALS, ITERS = 5, 30
MIN_DELTA_MS = 0.01  # a smaller delta gives no rate (nan), as in JAX's tool
# the card's published dense peaks, TFLOP/s (H100 SXM data sheet)
PEAK_TFLOPS = {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}


def peak_tflops(compute_dtype: str) -> tuple[float, str]:
    """(peak TFLOP/s, its name) of the compute dtype's convolutions:
    float32 convolutions run on TF32 tensor cores while cuDNN may use
    them (``torch.backends.cudnn.allow_tf32``, on by default)."""
    if compute_dtype == "float32" and torch.backends.cudnn.allow_tf32:
        return PEAK_TFLOPS["tf32"], "tf32"
    return PEAK_TFLOPS[compute_dtype], compute_dtype


def prefix_forward(model, features: torch.Tensor, k: int) -> torch.Tensor:
    """The model's first ``k`` layers on ``features [B, T, F]``, in its
    compute dtype, cast to float32 in the ``[B, T', C]`` layout: for
    ``k = 11`` exactly ``model(features)``."""
    x = features.transpose(1, 2)
    for name in model.layer_names[:k]:
        x = getattr(model, name)(x, model.compute_dtype)
    return x.transpose(1, 2).float()


def flops_layer(config, B: int, T: int, i: int) -> float:
    """Layer ``i``'s multiply-adds times 2: 2 B t w c_in c_out, t the
    frames after the stride (JAX's formula)."""
    t, cin = T, config.input_size
    for j, (w, s, cout, _relu) in enumerate(config.layer_specs):
        t //= s
        if j == i:
            return 2.0 * B * t * w * cin * cout
        cin = cout
    return 0.0


def median_ms(fn, device, trials: int = TRIALS, iters: int = ITERS) -> float:
    """One warm call, then ``trials`` runs of ``iters`` calls, each run
    ended by one synchronise: the median ms a call."""
    fn()
    synchronize(device)
    times = []
    for _ in range(trials):
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        synchronize(device)
        times.append((time.perf_counter() - start) / iters)
    return float(np.median(times)) * 1e3


def breakdown(model, features, trials: int = TRIALS, iters: int = ITERS) -> list[dict]:
    """One row a layer: the k-layer prefix's median ms, the delta from the
    (k-1)-layer prefix, the FLOPs, TFLOP/s and the share of the peak."""
    cfg = model.config
    B, T, _F = features.shape
    peak, _name = peak_tflops(cfg.compute_dtype)
    rows, prev = [], 0.0
    with torch.inference_mode():
        for k in range(1, len(cfg.layer_specs) + 1):
            prefix_ms = median_ms(lambda: prefix_forward(model, features, k),
                                  features.device, trials, iters)
            d = prefix_ms - prev
            prev = prefix_ms
            w, s, f, _relu = cfg.layer_specs[k - 1]
            fl = flops_layer(cfg, B, T, k - 1)
            tfs = fl / (d / 1e3) / 1e12 if d > MIN_DELTA_MS else float("nan")
            rows.append({
                "layer": f"conv_{k - 1}", "spec": f"[{w},s{s}]->{f}",
                "prefix_ms": prefix_ms, "ms": d, "gflop": fl / 1e9,
                "tflops": tfs, "peak_share": 100 * tfs / peak,
            })
    return rows


def print_table(rows: list[dict], compute_dtype: str) -> None:
    peak, name = peak_tflops(compute_dtype)
    print(f"{'layer':<10}{'spec':<22}{'ms':>9}{'GFLOP':>10}{'TF/s':>8}"
          f"{'peak%':>7}  (peak {peak:g} TFLOP/s, {name})")
    for r in rows:
        print(f"{r['layer']:<10}{r['spec']:<22}{r['ms']:>9.3f}{r['gflop']:>10.2f}"
              f"{r['tflops']:>8.1f}{r['peak_share']:>7.1f}")
    print(f"{len(rows)}-layer prefix (the whole forward): {rows[-1]['prefix_ms']:.3f} ms, "
          f"{sum(r['gflop'] for r in rows):.2f} GFLOP")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.layer_breakdown")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--base-channels", type=int, default=250)
    ap.add_argument("--wide-channels", type=int, default=2000)
    ap.add_argument("--num-body-layers", type=int, default=7)
    return ap.parse_args(argv)


def setup(args):
    """(model, features) on the device: the port's seeded initial weights
    and JAX's seeded features (``RandomState(0)``, [B, T, 128])."""
    device = resolve_device(args.device)  # no card: fail before any work
    F = feature_size("power")
    flags = types.SimpleNamespace(
        compute_dtype=args.compute_dtype, base_channels=args.base_channels,
        wide_channels=args.wide_channels, num_body_layers=args.num_body_layers,
    )
    model = build_model(F, flags).to(device).eval()
    x = np.random.RandomState(0).randn(args.batch, args.frames, F).astype(np.float32)
    return model, torch.from_numpy(x).to(device)


def main(argv=None) -> int:
    args = parse_args(argv)
    model, x = setup(args)
    print(f"layer breakdown on {device_name(x.device)}: B={args.batch}, "
          f"T={args.frames}, {args.compute_dtype}")
    print_table(breakdown(model, x), args.compute_dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
