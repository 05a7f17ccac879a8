"""The conv0 CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped where there is no card. This file imports torch
and the port only (no JAX), so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_conv0_cuda.py -m cuda -q

Tolerances: float32, the same products summed in another order (6400 a
sum, outputs of order 1): rtol 1e-5 / atol 1e-4. bfloat16: both sides sum
exact products in float32 and round once, so they may differ by one
bfloat16 spacing of the output (2^-7 relative at most), plus 1e-4 where a
sum near 0 has another sign under the ReLU.
"""

import math

import numpy as np
import pytest
import torch

from speecht_tpu_torch.ops import conv0, conv0_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


def _inputs(seed, B, T, I, O, dtype, device):
    rng = np.random.RandomState(seed)
    limit = math.sqrt(6.0 / (48 * I + 48 * O))
    arrays = (rng.randn(B, T, I), rng.uniform(-limit, limit, (O, I, 48)),
              rng.uniform(-0.05, 0.05, O))
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype) for a in arrays]


SHAPES = [(2, 96, 128, 250), (1, 48, 128, 29), (3, 50, 64, 250), (2, 512, 128, 250)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,I,O", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, dtype, B, T, I, O):
    x, w, b = _inputs(B * T + O, B, T, I, O, dtype, cuda_device)
    before = conv0_cuda.CONV0.launches
    got = conv0_cuda.CONV0(x, w, b)
    torch.cuda.synchronize()
    assert conv0_cuda.CONV0.launches == before + 1
    assert got.shape == (B, O, T // 2) and got.dtype == dtype
    want = conv0.conv0_plain(x, w, b).transpose(1, 2).float()
    got = got.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        spacing = torch.finfo(torch.bfloat16).eps * torch.maximum(got.abs(), want.abs())
        assert bool(((got - want).abs() <= spacing + 1e-4).all())


@pytest.mark.cuda
def test_function_grads_on_card(cuda_device, monkeypatch):
    """Conv0Function's gradients (transpose convs, TF32 off) against
    autograd through conv0_plain, float32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w, b = _inputs(1, 2, 96, 128, 64, torch.float32, cuda_device)
    g = torch.randn(2, 48, 64, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    grads = []
    for fn in (conv0_cuda.conv0, conv0.conv0_plain):
        args = [t.clone().requires_grad_(True) for t in (x, w, b)]
        grads.append(torch.autograd.grad(fn(*args), args, g))
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_model_takes_the_kernel_with_the_env_var(cuda_device, monkeypatch):
    from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig

    model = Wav2Letter(Wav2LetterConfig(base_channels=16, wide_channels=32,
                                        num_body_layers=1)).to(cuda_device)
    x = torch.randn(2, 256, 128, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    before = conv0_cuda.CONV0.launches
    with torch.no_grad():
        default = model(x)
        monkeypatch.setenv("SPEECHT_PALLAS_CONV0", "1")
        kernel = model(x)
    assert conv0_cuda.CONV0.launches == before + 1
    assert bool(torch.isfinite(kernel).all())
    # bf16 compute; the two paths round conv_0 at different places
    torch.testing.assert_close(kernel, default, rtol=0.1, atol=0.1)
