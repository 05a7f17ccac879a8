"""Per-component latency probe on the card.

The port of ``tools/perf_probe.py``, at its shapes, on the port's seeded
full-width model (128 power features in):

1. the greedy eval step (``train/step.py::make_eval_step``: the forward,
   the CTC loss and the greedy decode) at B=64, T=1024;
2. the bare forward at the same shape;
3. the beam decoder's device part at B=64, T=512: ``make_loss_fn`` (the
   forward and the CTC loss) followed by ``ops/decode.blank_collapse(...,
   0.999)``, with the collapsed shape and the first lengths;
4. ``os.cpu_count()``, then one utterance's collapsed log-probs through
   the host beam (``native.ctc_beam_search``, W=100, top-k 8);
5. the device part plus the device-to-host copy of its log-probs, with
   the payload in MB;
6. the front end (``data/features_device.batch_power_spectrogram``) on
   B=64 x 163,680 samples (1023 frames of 160).

    python -m speecht_tpu_torch.tools.perf_probe

runs on the card; ``--device cpu`` on the CPU, where ``--batch``,
``--frames`` and the width flags make it quick. A timed probe makes one
warm call, then ``--iters`` calls ended by one synchronise.
"""

from __future__ import annotations

import argparse
import os
import time
import types

import numpy as np
import torch

from speecht_tpu_torch import native
from speecht_tpu_torch.data import features_device
from speecht_tpu_torch.data.features import feature_size
from speecht_tpu_torch.data.pipeline import Batch
from speecht_tpu_torch.execution import build_model, device_name, resolve_device, synchronize
from speecht_tpu_torch.models.wav2letter import output_length
from speecht_tpu_torch.ops import decode
from speecht_tpu_torch.train import step as tstep

BLANK_THRESHOLD = 0.999
BEAM_WIDTH, TOP_K = 100, 8
FETCH_REPEATS = 5
HOP = 160  # front-end samples a frame


def timeit(name: str, fn, device, iters: int) -> float:
    """One warm call, then ``iters`` calls and one synchronise: ms a call."""
    fn()
    synchronize(device)
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    ms = (time.perf_counter() - start) * 1e3 / iters
    print(f"{name}: {ms:.3f} ms", flush=True)
    return ms


def make_inputs(B: int, T: int, device) -> dict:
    """JAX's draws in JAX's order from ``RandomState(0)``: features [B, T,
    128], the device part's features [B, T/2, 128] and labels [B, T/8]
    (100 of 128 letters long at T=1024), the front end's audio [B,
    (T-1) x 160]."""
    rng = np.random.RandomState(0)
    F = feature_size("power")
    feats = rng.randn(B, T, F).astype(np.float32)
    feats_half = rng.randn(B, T // 2, F).astype(np.float32)
    L = T // 8
    labels = rng.randint(0, 28, (B, L)).astype(np.int32)
    samples = (T - 1) * HOP
    audio = (rng.randn(B, samples) * 0.1).astype(np.float32)

    def on(x):
        return torch.from_numpy(x).to(device)

    def batch(f, n_labels):
        return Batch(
            features=on(f),
            seq_lengths=torch.full((B,), f.shape[1], dtype=torch.int32, device=device),
            labels=on(labels),
            label_lengths=torch.full((B,), n_labels, dtype=torch.int32, device=device),
        )

    n_labels = L * 100 // 128
    return {
        "eval": batch(feats, n_labels),
        "device_part": batch(feats_half, n_labels),
        "audio": on(audio),
        "num_samples": torch.full((B,), samples, dtype=torch.int32, device=device),
    }


def make_device_part(model):
    """batch -> (average loss, collapsed log-probs, their lengths), as the
    beam decoder's device part composes them."""
    loss_fn = tstep.make_loss_fn(model)

    @torch.inference_mode()
    def device_part(batch):
        avg_loss, logits = loss_fn(batch)
        logp, new_lengths = decode.blank_collapse(
            logits, output_length(batch.seq_lengths), BLANK_THRESHOLD)
        return avg_loss, logp, new_lengths

    return device_part


def probe(model, inputs: dict, device, iters: int = 10) -> dict:
    """Runs the six probes, printing a line each; returns their numbers."""
    B, T, _F = inputs["eval"].features.shape
    out = {}
    eval_step = tstep.make_eval_step(model)
    out["greedy_eval_ms"] = timeit(f"greedy_eval B{B}T{T}",
                                   lambda: eval_step(inputs["eval"]), device, iters)
    forward = tstep.make_forward_step(model)
    out["forward_ms"] = timeit(f"forward_only B{B}T{T}",
                               lambda: forward(inputs["eval"].features), device, iters)

    part_batch = inputs["device_part"]
    device_part = make_device_part(model)
    out["device_part_ms"] = timeit(f"beam_device_part B{B}T{T // 2}",
                                   lambda: device_part(part_batch), device, iters)
    loss, logp, lens = device_part(part_batch)
    logp, lens = logp.cpu().numpy(), lens.cpu().numpy()
    out["loss"] = float(loss)
    out["collapsed_shape"] = logp.shape
    out["lengths_head"] = lens[:6].tolist()
    print("collapsed shape", logp.shape, "lengths head", lens[:6])
    out["cpu_count"] = os.cpu_count()
    print("cpu_count", out["cpu_count"])
    start = time.perf_counter()
    native.ctc_beam_search(logp[0, :lens[0]], beam_width=BEAM_WIDTH, prune_top_k=TOP_K)
    out["host_beam_ms"] = (time.perf_counter() - start) * 1e3
    print(f"host beam 1 utt: {out['host_beam_ms']:.1f} ms, T'={lens[0]}")

    # the readback: the D2H copy waits for the device part's work
    start = time.perf_counter()
    for _ in range(FETCH_REPEATS):
        device_part(part_batch)[1].cpu()
    out["fetch_ms"] = (time.perf_counter() - start) * 1e3 / FETCH_REPEATS
    out["payload_mb"] = logp.nbytes / 1e6
    print(f"device_part+fetch logp: {out['fetch_ms']:.1f} ms "
          f"(payload {out['payload_mb']:.2f} MB)")

    samples = inputs["audio"].shape[1]
    out["frontend_ms"] = timeit(
        f"frontend B{B} {samples / 1e3:.0f}k-samples",
        lambda: features_device.batch_power_spectrogram(inputs["audio"],
                                                        inputs["num_samples"]),
        device, iters)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.perf_probe")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--base-channels", type=int, default=250)
    ap.add_argument("--wide-channels", type=int, default=2000)
    ap.add_argument("--num-body-layers", type=int, default=7)
    return ap.parse_args(argv)


def setup(args):
    """(model, inputs, device): the port's seeded full-width model, eval
    mode, and :func:`make_inputs` on the device."""
    device = resolve_device(args.device)  # no card: fail before any work
    flags = types.SimpleNamespace(
        base_channels=args.base_channels, wide_channels=args.wide_channels,
        num_body_layers=args.num_body_layers,
    )
    model = build_model(feature_size("power"), flags).to(device).eval()
    return model, make_inputs(args.batch, args.frames, device), device


def main(argv=None) -> int:
    args = parse_args(argv)
    model, inputs, device = setup(args)
    print(f"perf probe on {device_name(device)}")
    probe(model, inputs, device, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
