"""A stride-1 conv1d whose input gradient runs as a forward convolution.

For ``y = conv1d(pad(x, (left, right)), W)`` with ``W [O, I, K]`` and
stride 1, the input gradient is a forward convolution of the output
gradient with the weight flipped in time and its channel axes swapped:

    dx = conv1d(pad(dy, (K-1-left, K-1-right)), W.flip(-1).transpose(0, 1))

It comes out at x's own length: the gradient of the padded frames, which
a slice would throw away, is never computed. ``left = right = 0`` is the
VALID conv of the sequence-parallel path, whose halo frames keep theirs.

Why: on the H100, cuDNN takes the input gradient of Wav2Letter's width-32
layer (250 -> 2,000 channels, bf16) through its legacy ``dgrad_engine`` at
about 2% of the bf16 peak, while its forward engines run the same shapes
at about 30%; and its bf16 result is the coarser (against float64, 4
times the rms error of one rounding, which the forward form reads).
:func:`conv1d` takes :class:`ForwardDgradConv1d` only while a gradient is
being taken (grad mode on and the weight requiring grad) through a dense
stride-1 layer at least :data:`MIN_WIDTH` taps wide; evaluate, serving,
the export, the narrower layers and grouped convs (the Conformer's
depthwise one) keep plain ``F.conv1d``. The weight
gradient stays ``aten::convolution_backward`` (cuDNN's wgrad), so both
convs of the backward run under cuDNN's own operators.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The narrowest layer that takes the forward form: the narrowest width at
# which it won. cuDNN's input gradient (``torch.nn.grad.conv1d_input``)
# against the forward form, ms a call, B=64, bf16, T=930, on an NVIDIA H100
# 80GB HBM3 (700 W, torch 2.11, cuDNN 9.22):
#   250 -> 250:   width 7 0.27 / 0.35, 16 0.43 / 0.60, 24 0.76 / 0.75,
#                 32 50.9 / 0.97
#   250 -> 2000:  width 7 1.12 / 1.98, 16 1.98 / 3.71, 18 3.32 / 3.94,
#                 20 56.1 / 4.33, 22 3.94 / 4.79, 23 4.01 / 5.11,
#                 24 68.7 / 5.16, 32 101.5 / 6.77
# (T=1,536: width 7 at 250 0.41 / 0.52, width 32 at 2000 153.4 / 10.7).
# The slow readings are cuDNN's legacy ``dgrad_engine``; cuDNN's other
# dgrad kernels are level with the forward form or beat it by 1.2-1.9x.
# Of the model's layers only conv_8 (width 32) reaches the constant.
MIN_WIDTH = 20

# input gradients computed by ForwardDgradConv1d since import (the CPU's
# and the card's alike), as the hand-written kernels' wrappers count
# their launches
input_grads = 0


def engages(weight: torch.Tensor, stride: int, groups: int = 1) -> bool:
    """True when a conv of this weight and stride takes the forward form:
    a gradient is being taken, the layer is dense (one group: the form's
    transposed weight is a dense conv's), has stride 1 and is at least
    ``MIN_WIDTH`` taps wide."""
    return (
        stride == 1
        and groups == 1
        and weight.shape[-1] >= MIN_WIDTH
        and torch.is_grad_enabled()
        and weight.requires_grad
    )


class ForwardDgradConv1d(torch.autograd.Function):
    """``conv1d(pad(x, (left, right)), weight)`` at stride 1. It saves the
    padded input and the weight, as autograd does for ``F.conv1d``; the
    backward computes the input gradient as a forward conv (module
    docstring) and the weight gradient with ``aten::convolution_backward``."""

    @staticmethod
    def forward(ctx, x, weight, left: int, right: int):
        xp = F.pad(x, (left, right)) if left or right else x
        ctx.save_for_backward(xp, weight)
        ctx.pads = (left, right)
        return F.conv1d(xp, weight)

    @staticmethod
    def backward(ctx, dy):
        global input_grads
        xp, weight = ctx.saved_tensors
        left, right = ctx.pads
        dx = dw = None
        if ctx.needs_input_grad[0]:
            k = weight.shape[-1]
            flipped = weight.flip(-1).transpose(0, 1).contiguous()
            dx = F.conv1d(F.pad(dy, (k - 1 - left, k - 1 - right)), flipped)
            input_grads += 1
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                dy, xp, weight, None, [1], [0], [1], False, [0], 1,
                [False, True, False],
            )[1]
        return dx, dw, None, None


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: int,
    pads: tuple[int, int] | None = None,
    groups: int = 1,
) -> torch.Tensor:
    """``F.conv1d(F.pad(x, pads), weight, stride=stride, groups=groups)``
    (no pad when ``pads`` is None), through :class:`ForwardDgradConv1d`
    when :func:`engages` says so."""
    if engages(weight, stride, groups):
        return ForwardDgradConv1d.apply(x, weight, *(pads or (0, 0)))
    if pads is not None:
        x = F.pad(x, pads)
    return F.conv1d(x, weight, stride=stride, groups=groups)
