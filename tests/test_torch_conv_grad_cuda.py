"""The wide layer's input gradient as a forward conv, on the card.

Marked ``cuda``: skipped where there is no card. This file imports torch
and the port only (no JAX):

    python -m pytest tests/test_torch_conv_grad_cuda.py -m cuda -q

At the benchmark's shapes (B=64, conv_8: width 32, 250 -> 2,000 channels,
SAME padding, bf16; 930 frames, the mean bucket's, and 1,536) the input
gradient of ``ops/conv_grad.py::ForwardDgradConv1d`` is held to a float32
reference (``torch.nn.grad.conv1d_input`` on the same bf16 values, TF32
off) and to cuDNN's own bf16 input gradient. Then the counter through
``make_train_step_acc`` at full width: one input gradient a step.

Tolerances: the forward form sums exact bf16 products in float32 and
rounds once, so it lies within one bf16 spacing (2^-7 relative at most)
of the float32 reference, plus 1e-4 of the largest value where a sum
cancels near 0 (64,000 products summed in another order). cuDNN's bf16
input gradient at this width (``dgrad_engine``) is coarser: against
float64 its error reads 4 times the rms of one rounding, and up to 1.6%
of the largest value (NVIDIA H100, cuDNN 9.22). So the forward form is
held to it by 3% of the largest value, and its rms error against the
float32 reference may not exceed cuDNN's.
"""

import math

import numpy as np
import pytest
import torch

from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops import conv_grad
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep

B, I, O, K = 64, 250, 2000, 32
LEFT, RIGHT = (K - 1) // 2, K - 1 - (K - 1) // 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


def _rms(a, b):
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [930, 1536])
def test_bf16_input_grad_matches_reference(cuda_device, T):
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    limit = math.sqrt(6.0 / (K * I + K * O))
    w = ((torch.rand(O, I, K, generator=gen, device=cuda_device) * 2 - 1) * limit
         ).to(torch.bfloat16).requires_grad_()
    x = torch.randn(B, I, T, generator=gen, device=cuda_device
                    ).to(torch.bfloat16).requires_grad_()
    dy = torch.randn(B, O, T, generator=gen, device=cuda_device).to(torch.bfloat16)
    before = conv_grad.input_grads
    assert conv_grad.engages(w, 1)
    y = conv_grad.conv1d(x, w, 1, (LEFT, RIGHT))
    got, = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert conv_grad.input_grads == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    padded = (B, I, T + K - 1)
    cudnn = torch.nn.grad.conv1d_input(padded, w.detach(), dy)[..., LEFT:LEFT + T]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = torch.nn.grad.conv1d_input(padded, w.detach().float(), dy.float())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = want[..., LEFT:LEFT + T]
    scale = want.abs().max()
    eps = torch.finfo(torch.bfloat16).eps
    off = (got.float() - want).abs() - (eps * want.abs() + 1e-4 * scale)
    assert off.max().item() <= 0, f"off by {off.max().item()} beyond one spacing"
    assert (got.float() - cudnn.float()).abs().max() <= 0.03 * scale
    assert _rms(got, want) <= _rms(cudnn, want)


@pytest.mark.cuda
def test_counter_one_per_train_step(cuda_device):
    config = Wav2LetterConfig(input_size=39)
    model = Wav2Letter(config).to(cuda_device)
    tx = tstate.make_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-4)
    step = tstep.make_train_step_acc(model, tx)
    acc = tstep.init_metrics_acc(cuda_device)
    rng = np.random.RandomState(0)
    before = conv_grad.input_grads
    for n in range(3):
        batch = Batch(
            features=rng.randn(4, 256, 39).astype(np.float32),
            seq_lengths=np.array([256, 250, 200, 128], np.int32),
            labels=rng.randint(0, 28, (4, 20)).astype(np.int32),
            label_lengths=np.full(4, 20, np.int32),
        )
        state, acc = step(state, acc, to_device(batch, cuda_device))
        assert conv_grad.input_grads == before + n + 1
    torch.cuda.synchronize()
    assert float(acc["updates"]) == 3.0
    assert math.isfinite(float(acc["loss_sum"]))
