"""The benchmark's yardstick: the card's peaks, the model's operations
counted from shapes, and the CTC kernels' least times.

Nothing here imports the program. The layer list is the reference's, from
the configuration file; the counts are those the algorithm needs, never
what a kernel happens to do.
"""

from __future__ import annotations

import numpy as np

from gpubench.reference.wav2letter import layer_specs as layers

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12

# per CTC state and frame: 3 exp, 1 log, 3 subtractions, 3 maxima, 2 adds
# for the sum, 1 add of the max back, 1 add of the emission
CTC_ALPHA_OPS_PER_STATE_FRAME = 14
# per needed state and frame: beta (3 adds, 2 maxima, 3 subtractions, 3
# exp, 2 adds, 1 log, 1 add) + posterior (2 adds, 1 exp) + scatter (1 add)
CTC_BETA_OPS_PER_STATE_FRAME = 19
# per needed class and frame: exp, subtract, multiply by the cotangent
CTC_BETA_OPS_PER_CLASS_FRAME = 3


def conv_macs_per_output_frame(config: dict) -> list[int]:
    """Multiply-adds of each layer for one output frame of one row."""
    return [width * cin * cout for width, _s, cin, cout, _r in layers(config)]


def train_flops_valid(config: dict, seq_lengths) -> float:
    """Operations one train step needs for these rows' valid frames: the
    forward, the weight gradients and the input gradients of every layer
    but the first (the features need none). A row of ``n`` input frames
    has ``n // 2`` valid frames after the stride-2 first layer, and every
    later layer keeps that count."""
    macs = conv_macs_per_output_frame(config)
    per_frame = 2.0 * (3 * sum(macs) - macs[0])
    frames = int((np.asarray(seq_lengths, dtype=np.int64) // 2).sum())
    return per_frame * frames


def conv_flops_padded(config: dict, batch: int, frames: int) -> tuple[float, float]:
    """(forward, backward) operations of the convolutions at the padded
    shape as run: ``batch`` rows of ``frames`` input frames, every output
    frame of every layer computed, SAME padding. The backward is the weight
    gradient of every layer and the input gradient of every layer but the
    first."""
    fwd = bwd = 0.0
    t = frames
    for i, (width, stride, cin, cout, _relu) in enumerate(layers(config)):
        t = -(-t // stride)
        f = 2.0 * batch * t * width * cin * cout
        fwd += f
        bwd += f if i == 0 else 2 * f
    return fwd, bwd


def ctc_alpha_bound_s(logit_lengths, label_lengths, frames: int, label_width: int,
                      classes: int) -> float:
    """Least time of one alpha launch that writes its history: each needed
    log-prob row read once, the labels and lengths read once, the losses
    written once, the ``[frames, B, 2L+1]`` history written once; 14 float32
    operations per needed state and frame. The larger of the byte time and
    the operation time."""
    n = np.maximum(np.asarray(logit_lengths, dtype=np.int64), 1)
    states = 2 * np.asarray(label_lengths, dtype=np.int64) + 1
    b = len(n)
    nbytes = 4 * (int(n.sum()) * classes + b * label_width + 3 * b
                  + frames * b * (2 * label_width + 1))
    ops = CTC_ALPHA_OPS_PER_STATE_FRAME * int((n * states).sum())
    return max(nbytes / PEAK_HBM_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def ctc_beta_bound_s(logit_lengths, label_lengths, frames: int, classes: int) -> float:
    """Least time of one beta launch: the history and log-prob rows each
    row needs, read once, and the ``[B, frames, C]`` gradient written once;
    19 float32 operations per needed state and frame and 3 per class and
    frame. A row needs its frames below its length and its states up to
    ``2 L_b``."""
    n = np.asarray(logit_lengths, dtype=np.int64).clip(0, None)
    states = 2 * np.asarray(label_lengths, dtype=np.int64) + 1
    b = len(n)
    nbytes = 4 * (int((n * states).sum()) + int(n.sum()) * classes + b * frames * classes)
    ops = (CTC_BETA_OPS_PER_STATE_FRAME * int((n * states).sum())
           + CTC_BETA_OPS_PER_CLASS_FRAME * int(n.sum()) * classes)
    return max(nbytes / PEAK_HBM_BYTES_PER_S, ops / PEAK_F32_FLOPS)
