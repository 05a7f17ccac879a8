"""The conv0 CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped where there is no card. This file imports torch
and the port only (no JAX), so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_conv0_cuda.py -m cuda -q

The quick check of the bf16 kernel's operand layouts (the ``ldmatrix``
fragments at the tap's row shift, the swizzled weight descriptor) before a
full smoke run:

    python -m pytest tests/test_torch_conv0_cuda.py -m cuda -q -k one_tap

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


# the bf16 kernel's tiles are 128 rows u by 256 channels o, K chunks of
# 64 phase-stacked channels: U below one tile (T=48, T=50), U not a
# multiple of 128 (T=1000), O above one tile (300), narrow O (16, 29),
# 2I = 128 (two chunks) and 512 (eight)
SHAPES = [(2, 96, 128, 250), (1, 48, 128, 29), (3, 50, 64, 250), (2, 512, 128, 250),
          (1, 1000, 128, 250), (2, 96, 128, 300), (2, 256, 128, 16), (2, 256, 64, 250),
          (1, 256, 256, 250)]


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
    _assert_agrees(got, want, dtype)


def _assert_agrees(got, want, dtype):
    got = got.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        spacing = torch.finfo(torch.bfloat16).eps * torch.maximum(got.abs(), want.abs())
        assert bool(((got - want).abs() <= spacing + 1e-4).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tap", [1, 12, 24])
def test_one_tap_one_chunk_layout(cuda_device, tap):
    """One CTA (U=128, O=256), one tap, one K chunk: the odd frames are 0,
    so of 2I=128 phase-stacked channels only the first chunk of 64 (the
    even frames) is nonzero, and the weight is nonzero only at the
    original tap 2*tap - 1, which lands in that chunk of phase tap `tap`.
    All values are positive, so the ReLU passes every entry and a wrong
    A fragment (row shift, k order) or B swizzle shows in every row."""
    B, T, I, O = 1, 256, 64, 256
    rng = np.random.RandomState(tap)
    x = rng.uniform(0, 1, (B, T, I))
    x[:, 1::2] = 0
    w = np.zeros((O, I, 48))
    w[:, :, 2 * tap - 1] = rng.uniform(0, 0.1, (O, I))
    x, w, b = [torch.from_numpy(a.astype(np.float32)).to(cuda_device, torch.bfloat16)
               for a in (x, w, np.zeros(O))]
    got = conv0_cuda.CONV0(x, w, b).transpose(1, 2)
    torch.cuda.synchronize()
    # the one product, written out: y[u] = x[2(u + tap - 12)] @ w[..., 2 tap - 1]^T
    U = T // 2
    rows = torch.arange(U, device=cuda_device) + tap - conv0.HALO
    inside = (rows >= 0) & (rows < U)
    xe = x[0, 0::2].float()[rows.clamp(0, U - 1)] * inside[:, None]
    want = (xe @ w[:, :, 2 * tap - 1].float().T)[None]
    assert bool((want[0, inside] > 0).all())
    _assert_agrees(got, want, torch.bfloat16)
    _assert_agrees(got, conv0.conv0_plain(x, w, b).float(), torch.bfloat16)


@pytest.mark.cuda
def test_bf16_calls_are_bit_equal(cuda_device):
    """No atomics: two calls on the same inputs must be bit-equal, or a
    stage of the weight ring or a slab buffer is overwritten while read."""
    x, w, b = _inputs(7, 64, 1024, 128, 250, torch.bfloat16, cuda_device)
    first = conv0_cuda.CONV0(x, w, b)
    second = conv0_cuda.CONV0(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
