"""The yardstick's counts, and the Wav2Letter reference's, against brute
counts at tiny shapes."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import yardstick
from gpubench.reference import wav2letter as ref

CONFIG = {"input_size": 8, "first_width": 48, "first_stride": 2, "base_channels": 6,
          "body_width": 7, "num_body_layers": 2, "wide_width": 32, "wide_channels": 10,
          "num_classes": 29}


def counted_conv_flops(batch: int, frames: int) -> tuple[float, float]:
    """(forward, backward) convolution FLOPs torch's own counter sees."""
    params = {k: v.requires_grad_(True) for k, v in ref.make_weights(CONFIG, 0, "cpu").items()}
    x = torch.randn(batch, frames, CONFIG["input_size"])
    with FlopCounterMode(display=False) as fwd:
        out = ref.forward(params, x, CONFIG)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(out.sum(), list(params.values()))
    return float(fwd.get_total_flops()), float(bwd.get_total_flops())


@pytest.mark.parametrize("batch,frames", [(1, 64), (3, 100), (2, 257)])
def test_padded_conv_flops(batch, frames):
    assert ref.conv_flops_padded(CONFIG, batch, frames) == counted_conv_flops(batch, frames)


def test_valid_flops_are_each_rows_own():
    lengths = [64, 100, 132]
    want = sum(sum(counted_conv_flops(1, n)) for n in lengths)
    assert ref.train_flops_valid(CONFIG, lengths) == want


def test_layers_are_the_published_stack():
    cfg = dict(CONFIG, input_size=39, base_channels=250, wide_channels=2000, num_body_layers=7)
    specs = ref.layer_specs(cfg)
    assert len(specs) == 11 and specs[0] == (48, 2, 39, 250, True) and specs[-1][3:] == (29, False)
    params = sum(w * cin * cout + cout for w, _s, cin, cout, _r in specs)
    assert 22e6 < params < 24e6


def brute_ctc(logit_lengths, label_lengths, frames, width, classes):
    """Loops over every row, frame and state."""
    a_bytes = 4 * (len(logit_lengths) * width + 3 * len(logit_lengths)
                   + frames * len(logit_lengths) * (2 * width + 1))
    a_ops = b_ops = 0
    b_bytes = 4 * len(logit_lengths) * frames * classes
    for n, lab in zip(logit_lengths, label_lengths):
        for _t in range(max(n, 1)):
            a_bytes += 4 * classes
            for _s in range(2 * lab + 1):
                a_ops += yardstick.CTC_ALPHA_OPS_PER_STATE_FRAME
        for _t in range(n):
            b_bytes += 4 * classes
            b_ops += yardstick.CTC_BETA_OPS_PER_CLASS_FRAME * classes
            for _s in range(2 * lab + 1):
                b_bytes += 4
                b_ops += yardstick.CTC_BETA_OPS_PER_STATE_FRAME
    alpha = max(a_bytes / yardstick.PEAK_HBM_BYTES_PER_S, a_ops / yardstick.PEAK_F32_FLOPS)
    beta = max(b_bytes / yardstick.PEAK_HBM_BYTES_PER_S, b_ops / yardstick.PEAK_F32_FLOPS)
    return alpha, beta


@pytest.mark.parametrize("width", [4, 40])
def test_ctc_bounds(width):
    logit_lengths, label_lengths = np.array([30, 0, 17]), np.array([3, 0, 4])
    alpha, beta = brute_ctc(logit_lengths, label_lengths, 32, width, 29)
    assert yardstick.ctc_alpha_bound_s(logit_lengths, label_lengths, 32, width, 29) == pytest.approx(alpha)
    assert yardstick.ctc_beta_bound_s(logit_lengths, label_lengths, 32, 29) == pytest.approx(beta)
