"""Wav2Letter's first layer (width 48, stride 2, SAME) + bias + ReLU:
the plain version and the shape gate.

Counterpart of ``speecht_tpu/ops/conv0_pallas.py`` without the kernel
(that is ``csrc/conv0.cu``, wrapped by ``ops/conv0_cuda.py``).

**Phase stacking.** With stride 2, even and odd input frames feed
disjoint taps. Viewing the input as ``xp[u] = concat(x[2u], x[2u+1])``
(a free reshape ``[B, T, I] -> [B, T/2, 2I]``), the convolution becomes a
25-tap stride-1 filter over ``xp``:

    y[u] = sum_a xp[u + a - 12] @ V[a],   a in [0, 25)

where ``V`` ``[25, 2I, O]`` is an exact rearrangement of the weights
(:func:`phase_weights`): tap ``a`` holds original tap ``2a - 1`` in its
even-phase half and ``2a`` in its odd-phase half (SAME padding for width
48, stride 2 and even T is 23 left, 23 right).

:func:`conv0_plain` computes what the TPU kernel ``_kernel`` computes,
step by step and in float32: inputs upcast (so bf16 products are exact),
25 matmuls summed without rounding between taps, the bias (already in the
compute dtype, as the JAX model passes it) added in float32, ReLU, and one
cast to the input dtype. The JAX model's default (lax) path rounds the
conv to the compute dtype before it adds the bias; this path, like the
Pallas one, rounds once.

The layout at these functions is the JAX package's, ``x [B, T, I]`` and
``y [B, T/2, O]``; the weight is the port's ``[O, I, 48]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WIDTH = 48
STRIDE = 2
PAD_LEFT = 23  # SAME for width 48, stride 2 and even T: total 46, split 23/23
HALO = 12  # taps a - 12 in [-12, 12] over phase-stacked rows
NTAPS = 2 * HALO + 1

# the JAX kernel's VMEM guard, kept as the gate: input frames T <= 6144
MAX_U = 3072

ENV_VAR = "SPEECHT_PALLAS_CONV0"


def phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """``[O, I, 48]`` conv taps -> ``[25, 2I, O]`` phase-stacked taps (exact).

    Tap ``a`` holds original tap ``2a - 1`` in its even-phase half (zero
    at ``a = 0``) and ``2a`` in its odd-phase half (zero at ``a = 24``).
    """
    out_f, in_f, w = weight.shape
    assert w == WIDTH
    kernel = weight.permute(2, 1, 0)  # [48, I, O], the JAX layout
    zero = kernel.new_zeros(1, in_f, out_f)
    even_half = torch.cat([zero, kernel[1::2]], dim=0)
    odd_half = torch.cat([kernel[0::2], zero], dim=0)
    return torch.cat([even_half, odd_half], dim=1)


def reference_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The linear map the kernel implements (no bias, no ReLU), for any T:
    ``x [B, T, I]``, ``weight [O, I, 48]`` -> ``[B, ceil(T/2), O]``."""
    t = x.shape[1]
    total = max((-(-t // STRIDE) - 1) * STRIDE + WIDTH - t, 0)
    xt = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return F.conv1d(xt, weight, stride=STRIDE).transpose(1, 2)


def supported(x_shape, width: int, stride: int, relu: bool, device) -> bool:
    """True when the conv_0 kernel path covers this call.

    The JAX package's shape gates (T even, ``48 <= T``, ``T/2 <= 3072``,
    ``2I % 128 == 0``; width 48, stride 2, ReLU). Its backend test becomes
    "the tensor is on CUDA (the kernel) or the CPU (the plain version)".
    """
    if width != WIDTH or stride != STRIDE or not relu:
        return False
    if torch.device(device).type not in ("cuda", "cpu"):
        return False
    _b, t, i = x_shape
    if t % 2 or t // 2 > MAX_U or t < WIDTH:
        return False
    return (2 * i) % 128 == 0


def conv0_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """``x [B, T, I]`` (T even), ``weight [O, I, 48]``, ``bias [O]`` ->
    ``relu(conv + bias)`` ``[B, T/2, O]`` in ``x``'s dtype."""
    b, t, i = x.shape
    u = t // STRIDE
    xp = x.float().reshape(b, u, 2 * i)
    xp = F.pad(xp, (0, 0, HALO, HALO))
    v = phase_weights(weight.float())
    acc = torch.zeros(b, u, weight.shape[0], dtype=torch.float32, device=x.device)
    for a in range(NTAPS):
        acc = acc + xp[:, a: a + u] @ v[a]
    acc = acc + bias.float()
    return torch.relu(acc).to(x.dtype)
