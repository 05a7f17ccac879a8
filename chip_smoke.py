#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speecht_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). It builds the port's kernels from ``csrc/``,
drives the port's main path through its normal entry point, and fails
(non-zero exit, no result line) if anything is wrong. Phases:

1. Environment: card name and power limit (``nvidia-smi``), torch and
   CUDA versions, kernel build time (all sources compiled in parallel).
2. Each kernel against its plain PyTorch version on the card: the CTC
   alpha kernel at the evaluate shape (B=64, T=512 logit frames, L=256),
   at the largest corpus bucket (T=2176, L=1088) and on edge rows (empty
   label, infeasible row, logit length 0, ragged lengths), with its time,
   the plain version's, the ``F.ctc_loss`` yardstick's, and the bound.
2b. The CTC beta kernel (dlogits) against the plain ``_posterior_grad``
   times g on the same inputs and alpha history, at the train shape
   (B=64, T=512, L=256), the largest bucket and edge rows (empty label,
   infeasible row with g=0, logit length 0, the full odd width, one
   frame, repeated letters, non-uniform g); the loss of the whole
   autograd Function against autograd through the plain forward scan
   (``ctc_loss_autodiff``), and the gradients of the Function and of that
   autograd in float32 each against it in float64, to a bound per entry
   (see ``f64_witness``); times beside the plain version, the
   bound and ``F.ctc_loss`` (its backward alone, and forward+backward
   against alpha+beta).
3. The evaluate path: ``CLI(["evaluate", ...]).run()`` on a synthetic
   cached corpus (256 utterances of 600-1024 frames) with full-width
   random weights (128/250/2000/29, 11 layers) written as a
   reference-layout ``.npy`` directory; every kernel's launch count is set
   to 0 just before and read just after; ms per batch and utterances/s.
3b. The train path: the same weights written as a port checkpoint at
   step 0, then ``CLI(["train", "--max-steps", "8",
   "--steps-per-checkpoint", "4", "--batch-size", "64", ...]).run()`` on
   a synthetic cached train split (128 utterances of 600-1024 frames),
   launch counts reset just before and read just after (both kernels
   must run), finite losses, a checkpoint at step 8, then ``evaluate``
   without ``--reference-weights`` restoring it; ms per step, the train
   step's device time on one resident batch and its share of the card's
   dense bf16 peak, where that time goes (stages and each layer's
   backward by CUDA events, kernels by torch.profiler, and the step with
   ``cudnn.benchmark`` on for comparison); the F.conv1d time of conv_0
   (the layer of the TPU kernel conv0_pallas, not ported yet) beside its
   bound.
4. One batch through the eval step on the card and on the CPU, float32
   compute with TF32 off, loss and decoded tokens compared.
4b. One train step on the card and on the CPU, float32 with TF32 off,
   B=8, same weights and batch: loss, grad norm and updated parameters.
5. One JSON line listing every kernel, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits with code 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# CTC alpha kernel vs the plain version, both float32 on the card: the
# recursion runs up to 2176 dependent log-sum-exp steps, each within a
# few ulps, so allow 1e-4 relative (plus 1e-3 absolute near 0)
CTC_RTOL, CTC_ATOL = 1e-4, 1e-3
# per state and frame: 3 exp, 1 log, 3 subtractions, 3 maxima, 2 adds
# for the sum, 1 add of the max back, 1 add of the emission
CTC_OPS_PER_STATE_FRAME = 14

# CTC beta kernel vs the plain version on the same alpha history: the
# same float32 recursion, but the kernel adds the posteriors onto their
# classes with float atomics in another order than the plain scatter
BETA_RTOL, BETA_ATOL = 1e-4, 1e-5
# the autograd Function (posterior form, float32) and float32 autograd
# through the plain forward scan, each against that autograd in float64.
# A posterior exp(alpha + beta - logP) carries the rounding of its
# exponent: two random walks of at most T float32 roundings of log-space
# sums, each at most ulp(|logP|)/2 (standard deviation at most
# sqrt(T/6) * ulp). So an entry [b, t, c] may be off by its posterior
# mass g_b * post times WITNESS_ULPS * sqrt(T_b) * ulp(|logP_b|) (about
# 7 standard deviations), plus the float32 softmax's rounding
# (WITNESS_ATOL). A posterior put on the wrong state, frame or class is
# off by the whole mass.
WITNESS_ULPS, WITNESS_ATOL = 3.0, 1e-5


def f64_witness(got, ref, logits, g, logit_lengths, loss):
    """(max |got - ref|, largest share of its entry's bound) for float32
    dlogits ``got`` against the float64 ``ref``; ``loss`` in float64."""
    mass = (g[:, None, None] * torch.softmax(logits, -1) - ref).clamp(min=0)
    feasible = (loss < 1e29).cpu().numpy()
    ulp = np.where(feasible, np.spacing(
        np.abs(np.where(feasible, loss.cpu().numpy(), 0.0)).astype(np.float32)
    ), 0.0)
    frames = logit_lengths.cpu().numpy().clip(1, None)
    delta = torch.from_numpy(WITNESS_ULPS * np.sqrt(frames) * ulp).to(ref)
    err = (got.double() - ref).abs()
    bound = delta[:, None, None] * mass + WITNESS_ATOL
    return float(err.max()), float((err / bound).max())


# per needed state and frame: beta (3 adds, 2 maxima, 3 subtractions, 3
# exp, 2 adds, 1 log, 1 add) + posterior (2 adds, 1 exp) + scatter (1 add)
BETA_OPS_PER_STATE_FRAME = 19
# per needed class and frame: exp, subtract, multiply by g
BETA_OPS_PER_CLASS_FRAME = 3

# one batch, card vs CPU, float32 with TF32 off: sums in another order
# through 11 conv layers and the CTC recursion
PARITY_LOSS_RTOL = 1e-4
PARITY_MIN_TOKEN_SHARE = 0.99
# one train step, card vs CPU: the grad norm sums the same gradients in
# another order; parameters move by about lr (1e-4) in the step, so 1e-6
# is 1% of the update
PARITY_GRAD_NORM_RTOL = 1e-4
PARITY_PARAM_ATOL = 1e-6

# the card's dense bf16 tensor-core peak (H100 SXM data sheet) and the
# model's forward cost at the 1024-frame bucket (PERF.md section 5,
# computed: 25.3 GFLOP per utterance); a train step is about 3 forwards
PEAK_BF16_OPS_PER_S = 989e12
FORWARD_FLOP_PER_UTT = 25.3e9

MAIN_BATCH, MAIN_STEPS = 64, 4
TRAIN_STEPS, TRAIN_INTERVAL, TRAIN_UTTERANCES = 8, 4, 128


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: the CTC alpha kernel against its plain version -------------


def ctc_inputs(seed, B, T, L, label_range, frame_range):
    """Random log-probs [B, T, 29] and labels shaped like the corpus's."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, 29).astype(np.float32) * 2.0
    label_lengths = rng.randint(*label_range, size=B).astype(np.int32)
    labels = np.full((B, L), -1, dtype=np.int32)
    for b in range(B):
        labels[b, : label_lengths[b]] = rng.randint(0, 28, size=label_lengths[b])
    logit_lengths = rng.randint(*frame_range, size=B).astype(np.int32)
    return logits, logit_lengths, labels, label_lengths


def edge_inputs():
    logits, logit_lengths, labels, label_lengths = ctc_inputs(
        7, B=7, T=101, L=40, label_range=(10, 40), frame_range=(60, 102)
    )
    labels[0], label_lengths[0] = -1, 0  # empty label
    labels[1], label_lengths[1], logit_lengths[1] = 5, 40, 50  # infeasible
    logit_lengths[2] = 0  # no frames at all
    logit_lengths[3] = 101  # the full (odd) width
    labels[4], label_lengths[4], logit_lengths[4] = -1, 1, 1  # one frame
    labels[4, 0] = 3
    labels[5, :12] = [4, 4, 4, 9, 9, 4, 4, 2, 2, 2, 2, 7]  # repeated letters
    labels[5, 12:], label_lengths[5], logit_lengths[5] = -1, 12, 90
    return logits, logit_lengths, labels, label_lengths


def edge_grad(B):
    """A non-uniform cotangent for edge_inputs, 0 where the loss mask puts
    0: the infeasible row 1 and row 2, whose loss is 1e30 too (no frames
    for a non-empty label)."""
    g = np.linspace(0.25, 2.0, B).astype(np.float32)
    g[1:3] = 0.0
    return g


def ctc_bound_ms(logit_lengths, label_lengths, L, C=29):
    """Least time for this data: each needed log-prob row read once, the
    labels and lengths read once, the losses written once; 14 float32
    operations per needed state and frame. Returns (ms, bound_by)."""
    frames = np.maximum(logit_lengths.astype(np.int64), 1)
    states = 2 * label_lengths.astype(np.int64) + 1
    B = len(frames)
    nbytes = 4 * (int(frames.sum()) * C + B * L + 2 * B + B)
    ops = CTC_OPS_PER_STATE_FRAME * int((frames * states).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_ctc(name, inputs, device, time_it=True, history=False):
    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.ops import ctc, ctc_cuda

    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(device) for a in inputs
    )
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    B, T, C = logp.shape
    L = labels.shape[1]
    kernel = ctc_cuda.CTC_ALPHA

    def run_kernel(alpha_out=None):
        return kernel(logp, logit_lengths, labels, label_lengths, alpha_out)

    def run_plain():
        return ctc.ctc_loss_log_probs(logp, logit_lengths, labels, label_lengths)

    got = run_kernel()
    torch.cuda.synchronize()
    want = run_plain()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=CTC_RTOL, atol=CTC_ATOL))
    check(bool(torch.isfinite(got).all()), f"ctc_alpha {name}: non-finite loss")
    if history:
        alpha = torch.empty(T, B, 2 * L + 1, device=device)
        run_kernel(alpha)
        torch.cuda.synchronize()
        ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
        alphas, _ = ctc.ctc_alpha(
            logp, logit_lengths, ext,
            ctc._transition_masks(ext, vocabulary.BLANK_ID),
        )
        hist_err = float((alpha - alphas).abs().max())
        ok = ok and bool(torch.allclose(alpha, alphas, rtol=CTC_RTOL, atol=CTC_ATOL))
        print(f"ctc_alpha {name}: alpha history max abs err {hist_err!r}")
    result = {
        "shape": f"B={B} T={T} L={L} S={2 * L + 1}",
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "ok": ok,
    }
    print(
        f"ctc_alpha {name} [{result['shape']}]: max abs err {max_abs!r}, "
        f"max rel err {max_rel!r} (tolerance rtol {CTC_RTOL} atol {CTC_ATOL}): "
        + ("ok" if ok else "DISAGREES")
    )
    check(ok, f"ctc_alpha {name} disagrees with the plain version")
    if not time_it:
        return result

    ms = time_ms(run_kernel, iters=20)
    plain_ms = time_ms(run_plain, iters=2)
    targets = labels.clamp(min=0).long()
    log_probs_tbc = logp.transpose(0, 1)
    lengths64, label_lengths64 = logit_lengths.long(), label_lengths.long()

    def run_library():
        return torch.nn.functional.ctc_loss(
            log_probs_tbc, targets, lengths64, label_lengths64,
            blank=vocabulary.BLANK_ID, reduction="none", zero_infinity=False,
        )

    library_ms = time_ms(run_library, iters=10)
    lib = run_library()
    torch.cuda.synchronize()
    lib_err = float((lib - got).abs().max())
    bound_ms, bound_by = ctc_bound_ms(inputs[1], inputs[3], L, C)
    print(
        f"ctc_alpha {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"F.ctc_loss {library_ms!r} ms (agrees within {lib_err!r}), "
        f"bound {bound_ms!r} ms ({bound_by})"
    )
    result.update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by,
    )
    return result


def beta_bound_ms(logit_lengths, label_lengths, T, C=29):
    """Least time for this data: the alpha history and log-prob rows each
    row needs, read once, and the dlogits [B, T, C] written once; 19
    float32 operations per needed state and frame and 3 per class and
    frame. A row needs its frames t < T_b and its states s <= 2 L_b: past
    them beta keeps its -1e30 fill, so the posterior there is 0 and the
    alpha value never reaches dlogits. Returns (ms, bound_by)."""
    frames = logit_lengths.astype(np.int64).clip(0, None)
    states = 2 * label_lengths.astype(np.int64) + 1
    B = len(frames)
    nbytes = 4 * (int((frames * states).sum()) + int(frames.sum()) * C + B * T * C)
    ops = (BETA_OPS_PER_STATE_FRAME * int((frames * states).sum())
           + BETA_OPS_PER_CLASS_FRAME * int(frames.sum()) * C)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_beta(name, inputs, g, device, time_it=True):
    """ctc_beta against the plain _posterior_grad * g on the same alpha
    history, and the whole autograd Function against ctc_loss_autodiff."""
    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.ops import ctc, ctc_cuda

    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(device) for a in inputs
    )
    g = torch.from_numpy(g).to(device)
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    B, T, C = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    alpha = torch.empty(T, B, S, device=device)
    loss = ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, alpha)
    ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
    allow = ctc._transition_masks(ext, vocabulary.BLANK_ID)

    def run_kernel():
        return ctc_cuda.CTC_BETA(
            logp, logit_lengths, labels, label_lengths, alpha, loss, g
        )

    def run_plain():
        return ctc._posterior_grad(
            logp, logit_lengths, ext, allow, label_lengths, alpha, -loss
        ) * g[:, None, None]

    got = run_kernel()
    want = run_plain()
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=BETA_RTOL, atol=BETA_ATOL))
    check(bool(torch.isfinite(got).all()), f"ctc_beta {name}: non-finite dlogits")
    mask = torch.arange(T, device=device)[None, :] >= logit_lengths[:, None]
    check(not bool(got[mask].any()), f"ctc_beta {name}: frames past the length not 0")
    check(not bool(got[g == 0].any()), f"ctc_beta {name}: a row with g=0 not 0")

    # the whole Function (alpha with history, then beta), float32 autodiff
    # and float64 autodiff, the witness independent of the posterior form
    def grad_of(fn, x, cot):
        x = x.clone().requires_grad_(True)
        loss_x = fn(x, logit_lengths, labels, label_lengths)
        return loss_x.detach(), torch.autograd.grad(loss_x, x, grad_outputs=cot)[0]

    f_loss, f_grad = grad_of(ctc_cuda.ctc_loss, logits, g)
    a_loss, a_grad = grad_of(ctc.ctc_loss_autodiff, logits, g)
    logits64, g64 = logits.double(), g.double()
    r_loss, r_grad = grad_of(ctc.ctc_loss_autodiff, logits64, g64)
    torch.cuda.synchronize()
    loss_ok = bool(torch.allclose(f_loss, a_loss, rtol=CTC_RTOL, atol=CTC_ATOL))
    witness = {
        side: f64_witness(grad, r_grad, logits64, g64, logit_lengths, r_loss)
        for side, grad in (("Function", f_grad), ("float32 autodiff", a_grad))
    }
    witness_ok = all(share <= 1.0 for _err, share in witness.values())
    result = {
        "shape": f"B={B} T={T} L={L} S={S}",
        "max_abs_err": max_abs,
        "f64_witness": witness,
        "ok": ok and loss_ok and witness_ok,
    }
    print(
        f"ctc_beta {name} [{result['shape']}]: dlogits vs plain max abs err "
        f"{max_abs!r} (tolerance rtol {BETA_RTOL} atol {BETA_ATOL}): "
        + ("ok" if ok else "DISAGREES")
        + f"; Function loss vs autodiff max abs "
        f"{float((f_loss - a_loss).abs().max())!r}: "
        + ("ok" if loss_ok else "DISAGREES")
        + "; grads vs float64 autodiff (bound: mass x "
        f"{WITNESS_ULPS} sqrt(T) ulp(|logP|) + {WITNESS_ATOL}): "
        + ", ".join(f"{side} max abs {err!r}, {share!r} of its bound"
                    for side, (err, share) in witness.items())
        + (": ok" if witness_ok else ": DISAGREES")
    )
    check(result["ok"], f"ctc_beta {name} disagrees")
    if not time_it:
        return result

    ms = time_ms(run_kernel, iters=20)
    plain_ms = time_ms(run_plain, iters=1)
    lp_tbc = logp.transpose(0, 1).detach().requires_grad_(True)
    targets = labels.clamp(min=0).long()
    lengths64, label_lengths64 = logit_lengths.long(), label_lengths.long()

    def library_forward():
        return torch.nn.functional.ctc_loss(
            lp_tbc, targets, lengths64, label_lengths64,
            blank=vocabulary.BLANK_ID, reduction="none", zero_infinity=False,
        )

    lib_loss = library_forward()
    library_ms = time_ms(
        lambda: torch.autograd.grad(lib_loss, lp_tbc, g, retain_graph=True),
        iters=10,
    )
    (lib_grad,) = torch.autograd.grad(lib_loss, lp_tbc, g, retain_graph=True)
    lib_err = float((lib_grad.transpose(0, 1) - got).abs().max())

    def ours_pair():
        ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, alpha)
        return run_kernel()

    def library_pair():
        return torch.autograd.grad(library_forward(), lp_tbc, g)

    pair_ms = time_ms(ours_pair, iters=10)
    library_pair_ms = time_ms(library_pair, iters=10)
    bound_ms, bound_by = beta_bound_ms(inputs[1], inputs[3], T, C)
    print(
        f"ctc_beta {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"F.ctc_loss backward alone {library_ms!r} ms (its grad agrees within "
        f"{lib_err!r}), bound {bound_ms!r} ms ({bound_by}); alpha (with "
        f"history) + beta {pair_ms!r} ms vs F.ctc_loss forward+backward "
        f"{library_pair_ms!r} ms"
    )
    result.update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, pair_ms=pair_ms, library_pair_ms=library_pair_ms,
    )
    return result


# -- phase 3: the main path -----------------------------------------------


def write_corpus(root, n, feature_width, seed=0, split="test"):
    """``n`` cached utterances: 600-1024 frames, 60-200 letters."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "data", "preprocessed-power", split)
    os.makedirs(d)
    for i in range(n):
        frames = rng.randint(600, 1025)
        np.savez(
            os.path.join(d, f"utt{i:04d}"),
            audio_fragments=rng.randn(frames, feature_width).astype(np.float32),
            transcript=rng.randint(0, 28, size=rng.randint(60, 201)).astype(
                np.int64
            ),
        )
    return os.path.join(root, "data")


def write_weights(root, config, seed=0):
    """Glorot-uniform weights from a numpy seed, reference export layout."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "weights")
    in_ch = config.input_size
    for i, (width, _stride, out_ch, _relu) in enumerate(config.layer_specs):
        limit = math.sqrt(6.0 / (width * in_ch + width * out_ch))
        layer = os.path.join(d, f"convolution_layer_{i}")
        os.makedirs(layer)
        kernel = rng.uniform(-limit, limit, size=(width, in_ch, out_ch))
        np.save(os.path.join(layer, "filters:0.npy"), kernel.astype(np.float32))
        bias = rng.uniform(-0.05, 0.05, size=out_ch).astype(np.float32)
        np.save(os.path.join(layer, "bias:0.npy"), bias)
        in_ch = out_ch
    return d


def run_cli(argv):
    from speecht_tpu_torch.cli import CLI

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = CLI(argv).run()
    return stats, buf.getvalue()


def main_path(work, kernels, card):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.models.wav2letter import Wav2LetterConfig

    n = MAIN_BATCH * MAIN_STEPS
    t0 = time.perf_counter()
    data_dir = write_corpus(work, n, feature_size("power"))
    weights = write_weights(work, Wav2LetterConfig())
    print(f"main path: wrote {n} utterances and full-width weights in "
          f"{time.perf_counter() - t0:.1f} s")
    argv = [
        "evaluate", "--test", "--no-save",
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", os.path.join(work, "log"),
        "--reference-weights", weights,
        "--batch-size", str(MAIN_BATCH),
    ]
    # warm-up run (CUDA context, cuDNN plans, first allocations)
    run_cli(argv + ["--step-count", "1"])

    # steady-state batch period: when each batch's metrics start, i.e.
    # after its results reached the host. The last interval is left out:
    # no batch is loaded or launched behind the last one.
    from speecht_tpu_torch import evaluation

    marks = []
    track = evaluation.Evaluation._track_batch

    def timed_track(*args, **kwargs):
        marks.append(time.perf_counter())
        return track(*args, **kwargs)

    evaluation.Evaluation._track_batch = staticmethod(timed_track)
    try:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, out = run_cli(argv + ["--step-count", str(MAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        evaluation.Evaluation._track_batch = staticmethod(track)
    launches = {k.name: k.launches for k in kernels}

    lines = out.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("validation average loss")]
    n_expected = sum(ln.startswith("expected: ") for ln in lines)
    print("main path: " + " | ".join(lines[lines.index("Begin evaluation") + 1:][:3]))
    print("main path: " + " | ".join(lines[lines.index("Global statistics"):]))
    print(f"main path: losses {losses}")
    check(stats.decodings_counter == n and n_expected == n,
          f"evaluate tracked {stats.decodings_counter} of {n} utterances")
    check(len(losses) == MAIN_STEPS and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
          f"evaluate losses not well formed: {losses}")
    check(0 <= stats.global_letter_error_rate < 100, "LER not well formed")
    check("precise: LER" in out, "no precise statistics line")
    check(launches["ctc_alpha"] > 0, "ctc_alpha was not launched by evaluate")
    # inference_mode: no gradient, so no alpha history and no backward
    check(launches["ctc_beta"] == 0, "evaluate launched the backward kernel")
    print(f"main path: kernel launches {launches}")
    steady_ms = (marks[-2] - marks[0]) / (len(marks) - 2) * 1e3
    print(
        f"main path: evaluate B={MAIN_BATCH} x {MAIN_STEPS} batches (T=1024 "
        f"frame bucket), whole run with set-up: {wall / MAIN_STEPS * 1e3!r} "
        f"ms/batch, {n / wall!r} utt/s; steady state: {steady_ms!r} ms/batch, "
        f"{MAIN_BATCH / steady_ms * 1e3!r} utt/s; on {card}"
    )
    return launches, data_dir, weights, steady_ms


def breakdown(data_dir, weights, steady_ms, card):
    """Where one batch's time goes: each host stage of the main path timed
    alone on the host clock, the eval step (forward, CTC, decode) on the
    card by CUDA events, beside the steady-state batch period."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.metrics import EvalStatistics
    from speecht_tpu_torch.train.step import make_eval_step
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    step = make_eval_step(model.cuda().eval())
    stages = {}
    t0 = time.perf_counter()
    samples = list(
        SpeechCorpusReader(data_dir).load_samples(
            "test", feature_type="power", seed=0, limit_count=MAIN_BATCH
        )
    )
    t1 = time.perf_counter()
    batch = build_batch(samples)
    t2 = time.perf_counter()
    dev = to_device(batch, torch.device("cuda"))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages["read npz (host)"] = (t1 - t0) * 1e3
    stages["build_batch (host)"] = (t2 - t1) * 1e3
    stages["bf16 cast + pin + H2D"] = (t3 - t2) * 1e3
    stages["eval step (device)"] = time_ms(lambda: step(dev), iters=10)
    _loss, decoded, lengths = step(dev)
    decoded, lengths = decoded.cpu().numpy(), lengths.cpu().numpy()
    t4 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        Evaluation._track_batch(
            EvalStatistics(), batch, decoded, lengths, verbose=True
        )
    stages["metrics + prints (host)"] = (time.perf_counter() - t4) * 1e3
    print(
        f"breakdown B={MAIN_BATCH} T={batch.features.shape[1]}: "
        + ", ".join(f"{k} {v!r} ms" for k, v in stages.items())
        + f"; steady-state batch period {steady_ms!r} ms, device busy "
        f"{stages['eval step (device)'] / steady_ms * 100:.1f}% of it; on {card}"
    )


# -- phase 3b: the train path ---------------------------------------------


def write_port_checkpoint(train_dir, weights):
    """The phase-3 weights as the port's checkpoint at step 0 (fresh Adam
    moments, lr 1e-4), so train starts from them."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train.checkpoint import CheckpointManager
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    state = create_train_state(dict(model.named_parameters()), make_optimizer(), 1e-4)
    CheckpointManager(train_dir).save(state, step=0)


def train_path(work, data_dir, weights, kernels, card):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    write_corpus(work, TRAIN_UTTERANCES, feature_size("power"), seed=1, split="train")
    run_dir = os.path.join(work, "train", "smoke")
    write_port_checkpoint(run_dir, weights)
    print(f"train path: wrote {TRAIN_UTTERANCES} utterances and a step-0 "
          f"checkpoint of the phase-3 weights in {time.perf_counter() - t0:.1f} s")
    common = [
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", os.path.join(work, "log"),
        "--run-name", "smoke",
        "--batch-size", str(MAIN_BATCH),
    ]

    # host time of each step's call: the batch period in steady state
    marks = []
    make = tstep.make_train_step_acc

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a):
            marks.append(time.perf_counter())
            return step(*a)

        return timed

    tstep.make_train_step_acc = timed_make
    try:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _state, out = run_cli(["train", "--max-steps", str(TRAIN_STEPS),
                               "--steps-per-checkpoint", str(TRAIN_INTERVAL),
                               *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tstep.make_train_step_acc = make
    launches = {k.name: k.launches for k in kernels}

    lines = out.splitlines()
    step_lines = [ln for ln in lines if ln.startswith("global step")]
    print("train path: " + " | ".join(
        ln for ln in lines if ln.startswith(("Restored", "global step", "Done"))
    ))
    losses = [float(ln.split()[10]) for ln in step_lines]
    check("Restored model at step 0" in lines, "train did not start from the checkpoint")
    check(len(losses) == TRAIN_STEPS // TRAIN_INTERVAL
          and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
          f"train losses not well formed: {losses}")
    check(lines[-1] == "Done training -- step limit reached", "train did not finish")
    mgr = CheckpointManager(run_dir)
    check(mgr.latest_step() == TRAIN_STEPS, f"no checkpoint at step {TRAIN_STEPS}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the train path")
    print(f"train path: kernel launches {launches}; losses {losses}; "
          f"checkpoints {mgr.all_steps()}")
    steady_ms = (marks[-1] - marks[1]) / (len(marks) - 2) * 1e3
    print(f"train path: B={MAIN_BATCH} x {TRAIN_STEPS} steps, whole run with "
          f"set-up {wall / TRAIN_STEPS * 1e3!r} ms/step; steady state (step "
          f"calls 2-{len(marks)}) {steady_ms!r} ms/step; on {card}")

    # evaluate restores the port's own checkpoint (no --reference-weights)
    argv = ["evaluate", "--test", "--no-save", "--step-count", "1", *common]
    stats, out = run_cli(argv)
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("validation average loss")]
    check(len(losses) == 1 and math.isfinite(losses[0]) and 0 < losses[0] < 1e29,
          f"evaluate after train: losses {losses}")
    ev = Evaluation(parsed_flags(argv))
    restored_step = ev.load_weights()
    check(restored_step == TRAIN_STEPS, f"evaluate restored step {restored_step}")
    print(f"train path: evaluate restored the step-{restored_step} checkpoint, "
          f"loss {losses[0]!r}, LER {stats.global_letter_error_rate!r}")
    return launches, steady_ms


def parsed_flags(argv):
    from speecht_tpu_torch.cli import CLI

    return CLI(argv).parsed


def train_step_breakdown(model, tx, state, batch, step_ms, card):
    """Where one train step's device time goes: its stages timed apart by
    CUDA events (the step's own functions, called in its order), then
    the kernels by device time from torch.profiler."""
    from speecht_tpu_torch.train import step as tstep

    params = state.params
    stages = {"forward (bf16 convs)": 0.0, "CTC loss (alpha, with history)": 0.0,
              "backward (CTC beta + conv grads)": 0.0,
              "clip + Adam + update": 0.0}
    n = 3
    for i in range(n + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        logits = model(batch.features)
        ev[1].record()
        with torch.enable_grad():
            losses = ctc_loss_masked(logits, batch)
        ev[2].record()
        grads = dict(zip(params, torch.autograd.grad(losses, list(params.values()))))
        ev[3].record()
        state, _norm = tstep._apply_grads(state, grads, tx)
        ev[4].record()
        torch.cuda.synchronize()
        if i:  # the first round warms up
            for k, name in enumerate(stages):
                stages[name] += ev[k].elapsed_time(ev[k + 1]) / n
    print(f"train step breakdown B={MAIN_BATCH} (CUDA events, mean of {n}): "
          + ", ".join(f"{k} {v!r} ms" for k, v in stages.items())
          + f"; sum {sum(stages.values())!r} ms vs the step {step_ms!r} ms; on {card}")

    # each layer's backward alone: its input, weight and bias gradients
    # (no input gradient for conv_0: the features need none)
    x = batch.features.transpose(1, 2)
    per_layer = []
    for i, name in enumerate(model.layer_names):
        layer = getattr(model, name)
        x_in = x.detach().requires_grad_(i > 0)
        with torch.enable_grad():
            y = layer(x_in, model.compute_dtype)
        dy = torch.randn_like(y)
        wrt = ([x_in] if i > 0 else []) + [layer.weight, layer.bias]
        ms_i = time_ms(
            lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True), iters=3
        )
        per_layer.append(f"{name} (w{layer.width}, {layer.weight.shape[1]}->"
                         f"{layer.weight.shape[0]}) {ms_i:.3f}")
        x = y.detach()
    print("train step backward by layer (ms, CUDA events): " + ", ".join(per_layer))

    step = tstep.make_train_step(model, tx)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(2):
            state, _m = step(state, batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 2 / 1e3, e.count // 2, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"train step profile: device time {total!r} ms per step over "
          f"{len(rows)} kernels/ops (torch.profiler, 2 steps); top 12:")
    for t, count, key in rows[:12]:
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:110]}")


def ctc_loss_masked(logits, batch):
    """The train loss from logits: the loss function's CTC and masking."""
    from speecht_tpu_torch.models.wav2letter import output_length
    from speecht_tpu_torch.ops import ctc_cuda

    losses = ctc_cuda.ctc_loss(
        logits, output_length(batch.seq_lengths), batch.labels, batch.label_lengths
    )
    real = (batch.seq_lengths > 0) & (losses < 1e29)
    return torch.where(real, losses, 0.0).sum() / real.sum().clamp(min=1)


def train_step_device(data_dir, weights, card):
    """One train step on a resident batch by CUDA events, its share of the
    dense bf16 peak, and conv_0's F.conv1d time beside its bound."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    model.cuda().train()
    tx = make_optimizer()
    state = create_train_state(dict(model.named_parameters()), tx, 1e-4)
    samples = SpeechCorpusReader(data_dir).load_samples(
        "train", feature_type="power", seed=0, limit_count=MAIN_BATCH
    )
    batch = to_device(build_batch(list(samples)), torch.device("cuda"))
    step = tstep.make_train_step_acc(model, tx)
    acc = tstep.init_metrics_acc(torch.device("cuda"))
    box = [state, acc]

    def one():
        box[0], box[1] = step(box[0], box[1], batch)

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(one, iters=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_step_breakdown(model, tx, box[0], batch, ms, card)
    # the port leaves cuDNN's algorithm choice at its default; how much a
    # benchmarked choice would change the step (measured, not used)
    torch.backends.cudnn.benchmark = True
    try:
        bench_ms = time_ms(one, iters=5, warmup=2)
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"train step (device) with torch.backends.cudnn.benchmark = True: "
          f"{bench_ms!r} ms (default: {ms!r} ms); on {card}")
    flop = 3 * FORWARD_FLOP_PER_UTT * MAIN_BATCH
    share = flop / (ms * 1e-3) / PEAK_BF16_OPS_PER_S
    print(
        f"train step (device) B={MAIN_BATCH} T={batch.features.shape[1]} bf16: "
        f"{ms!r} ms by CUDA events, {flop / 1e12:.2f} TFLOP (computed: 3 x 25.3 "
        f"GFLOP per utterance) = {share * 100:.2f}% of 989 TFLOP/s dense bf16; "
        f"peak memory {peak_gb:.2f} GB; on {card}"
    )

    # conv_0 as F.conv1d: the layer TPU kernel #3 (conv0_pallas) computes
    conv0 = model.conv_0
    x = batch.features.transpose(1, 2).contiguous()
    with torch.no_grad():
        conv_ms = time_ms(lambda: conv0(x, torch.bfloat16), iters=20)
    T = x.shape[-1]
    flop0 = 2 * MAIN_BATCH * (T // 2) * 48 * x.shape[1] * conv0.weight.shape[0]
    bytes0 = 2 * (x.numel() + MAIN_BATCH * (T // 2) * conv0.weight.shape[0]
                  + conv0.weight.numel() + conv0.bias.numel())
    t_ops, t_bytes = flop0 / PEAK_BF16_OPS_PER_S, bytes0 / PEAK_BYTES_PER_S
    print(
        f"conv_0 (width 48, stride 2, {x.shape[1]}->{conv0.weight.shape[0]}, "
        f"B={MAIN_BATCH} T={T}) + bias + ReLU as F.conv1d bf16: {conv_ms!r} ms; "
        f"bound {max(t_ops, t_bytes) * 1e3!r} ms ("
        f"{'operations' if t_ops >= t_bytes else 'bytes'}: {flop0 / 1e12:.3f} "
        f"TFLOP, {bytes0 / 1e6:.1f} MB); on {card}"
    )
    return ms, share, conv_ms


# -- phase 4: one batch, card vs CPU ----------------------------------------


def parity(data_dir, weights):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train.step import make_eval_step
    from speecht_tpu_torch.weights import load_weight_dir

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("parity: float32 compute, torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    samples = SpeechCorpusReader(data_dir).load_samples(
        "test", feature_type="power", seed=0, limit_count=8
    )
    batch = build_batch(list(samples))

    flags = types.SimpleNamespace(compute_dtype="float32")
    outs = {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        model = build_model(feature_size("power"), flags)
        model.load_state_dict(load_weight_dir(weights, model))
        step = make_eval_step(model.to(device).eval())
        loss, decoded, lengths = step(to_device(batch, device, "float32"))
        outs[name] = (float(loss), decoded.cpu().numpy(), lengths.cpu().numpy())
    (lg, dg, ng), (lc, dc, nc) = outs["cuda"], outs["cpu"]
    total = same = 0
    for i in range(dg.shape[0]):
        width = int(max(ng[i], nc[i]))
        total += width
        same += int((dg[i, :width] == dc[i, :width]).sum())
    share = same / max(total, 1)
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"parity: loss cuda {lg!r} cpu {lc!r} rel diff {loss_rel!r} "
          f"(tolerance {PARITY_LOSS_RTOL}); decoded tokens equal {same}/{total} "
          f"= {share!r} (at least {PARITY_MIN_TOKEN_SHARE})")
    check(loss_rel <= PARITY_LOSS_RTOL, "card and CPU losses disagree")
    check(share >= PARITY_MIN_TOKEN_SHARE, "card and CPU decodes disagree")


def parity_train(data_dir, weights):
    """One train step, card vs CPU: float32, TF32 off, B=8."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    samples = SpeechCorpusReader(data_dir).load_samples(
        "train", feature_type="power", seed=0, limit_count=8
    )
    batch = build_batch(list(samples))
    flags = types.SimpleNamespace(compute_dtype="float32")
    outs = {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        model = build_model(feature_size("power"), flags)
        model.load_state_dict(load_weight_dir(weights, model))
        model.to(device).train()
        tx = make_optimizer()
        state = create_train_state(dict(model.named_parameters()), tx, 1e-4)
        t0 = time.perf_counter()
        state, m = tstep.make_train_step(model, tx)(
            state, to_device(batch, device, "float32")
        )
        params = {k: v.detach().cpu() for k, v in state.params.items()}
        outs[name] = (float(m["loss"]), float(m["grad_norm"]), params)
        print(f"parity train: {name} step {time.perf_counter() - t0:.1f} s")
    (lg, ng, pg), (lc, nc, pc) = outs["cuda"], outs["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    norm_rel = abs(ng - nc) / abs(nc)
    param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pg)
    print(f"parity train: B=8 T={batch.features.shape[1]}: loss cuda {lg!r} cpu "
          f"{lc!r} rel diff {loss_rel!r} (tolerance {PARITY_LOSS_RTOL}); grad "
          f"norm cuda {ng!r} cpu {nc!r} rel diff {norm_rel!r} (tolerance "
          f"{PARITY_GRAD_NORM_RTOL}); updated parameters max abs diff "
          f"{param_err!r} (tolerance {PARITY_PARAM_ATOL})")
    check(loss_rel <= PARITY_LOSS_RTOL, "card and CPU train losses disagree")
    check(norm_rel <= PARITY_GRAD_NORM_RTOL, "card and CPU grad norms disagree")
    check(param_err <= PARITY_PARAM_ATOL, "card and CPU updated parameters disagree")


def kernel_entry(name, source, replaces, launches, r):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "shape": r["shape"],
        "check": "ok" if r["ok"] else "failed",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    from speecht_tpu_torch.ops import ctc_cuda, cuda_build

    kernels = list(ctc_cuda.KERNELS)
    device = torch.device("cuda")

    # 1. environment
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda_build.build([k.name for k in kernels])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {[k.name for k in kernels]}")
    for k in kernels:
        with open(cuda_build.log_path(k.name)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"ptxas {k.name}: {line.strip()}")

    # 2. the alpha kernel against its plain version
    train_inputs = ctc_inputs(
        0, B=64, T=512, L=256, label_range=(60, 201), frame_range=(300, 513)
    )
    largest = ctc_inputs(
        1, B=8, T=2176, L=1088, label_range=(300, 1001), frame_range=(1500, 2177)
    )
    alpha_main = check_ctc("evaluate shape", train_inputs, device)
    check_ctc("largest bucket", largest, device)
    check_ctc("edge rows", edge_inputs(), device, time_it=False, history=True)

    # 2b. the beta kernel against its plain version
    rng = np.random.RandomState(2)
    beta_main = check_beta(
        "train shape", train_inputs,
        rng.uniform(0.5, 1.5, 64).astype(np.float32), device,
    )
    check_beta("largest bucket", largest,
               rng.uniform(0.5, 1.5, 8).astype(np.float32), device)
    check_beta("edge rows", edge_inputs(), edge_grad(7), device, time_it=False)
    print("kernel launches in the comparisons: "
          + str({k.name: k.launches for k in kernels}))

    # 3. evaluate; 3b. train; 4. and 4b. card vs CPU
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        eval_launches, data_dir, weights, steady_ms = main_path(work, kernels, card)
        breakdown(data_dir, weights, steady_ms, card)
        train_launches, _train_ms = train_path(work, data_dir, weights, kernels, card)
        train_step_device(data_dir, weights, card)
        parity(data_dir, weights)
        parity_train(data_dir, weights)

    # 5. kernels line, then the result line
    alpha_entry = kernel_entry(
        "ctc_alpha", "speecht_tpu_torch/csrc/ctc_alpha.cu",
        "speecht_tpu/ops/ctc_pallas.py:145", eval_launches["ctc_alpha"], alpha_main,
    )
    alpha_entry["launches_by_path"] = {
        "evaluate": eval_launches["ctc_alpha"], "train": train_launches["ctc_alpha"],
    }
    beta_entry = kernel_entry(
        "ctc_beta", "speecht_tpu_torch/csrc/ctc_beta.cu",
        "speecht_tpu/ops/ctc_pallas.py:200", train_launches["ctc_beta"], beta_main,
    )
    beta_entry["launches_by_path"] = {
        "evaluate": eval_launches["ctc_beta"], "train": train_launches["ctc_beta"],
    }
    print(f"card: {card}")
    print(json.dumps({"kernels": [alpha_entry, beta_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
