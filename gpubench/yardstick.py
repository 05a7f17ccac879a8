"""The benchmark's yardstick: the card's peaks and the CTC kernels' least
times, which take the logit lengths as arguments and know no model.

Nothing here imports the program. A model's operations are counted from
its shapes by its reference module (``train_flops_valid``,
``conv_flops_padded``: ``reference/__init__.py``); the counts are those
the algorithm needs, never what a kernel happens to do.
"""

from __future__ import annotations

import numpy as np

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
