"""conv_0 on the card: the wrapper of the CUDA kernel and its autograd Function.

Counterpart of ``speecht_tpu/ops/conv0_pallas.py``'s ``conv0_fused`` and
its custom VJP: ``csrc/conv0.cu`` replaces the TPU kernel
``conv0_pallas.py::_kernel`` (width 48, stride 2, SAME, + bias + ReLU).

:func:`conv0` takes the plain version (``ops/conv0.py::conv0_plain``)
only for tensors on the CPU. For a CUDA tensor it launches the kernel or
raises: the caller (the model's conv_0 layer) has already asked the gate
(``conv0.supported``), and the wrapper refuses what the gate refuses.

The backward is not a kernel, as in JAX (``_bwd``, which leaves the two
transposes to XLA): the cotangent is masked by ``y > 0`` and cast to x's
dtype, then ``dx`` and ``dw`` are the transpose convolutions
(``torch.nn.grad.conv1d_input``/``conv1d_weight``, cuDNN on the card) and
``db`` is the float32 sum, cast.
"""

from __future__ import annotations

import ctypes

import torch

from speecht_tpu_torch.ops import conv0 as conv0_ops
from speecht_tpu_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Conv0Kernel(cuda_build.KernelLibrary):
    """``csrc/conv0.cu``: conv_0 + bias + ReLU, ``y [B, O, T/2]``.

    ``plain_calls`` counts the CPU route of :class:`Conv0Function` (the
    plain version), so a CPU run can show that the conv_0 path was taken;
    ``launches`` counts the kernel alone.
    """

    name = "conv0"
    signatures = (
        ("conv0_forward", [_P] * 5 + [_I] * 6 + [_P], _I),
        ("conv0_scratch_elements", [_I, _I], ctypes.c_size_t),
        ("conv0_smem_bytes", [_I], ctypes.c_size_t),
        ("conv0_error_string", [_I], ctypes.c_char_p),
    )

    def __init__(self):
        super().__init__()
        self.plain_calls = 0

    def __call__(
        self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
    ) -> torch.Tensor:
        """``x [B, T, I]``, ``weight [O, I, 48]``, ``bias [O]``, one dtype
        (bfloat16 or float32), contiguous, on one CUDA device -> ``y [B, O,
        T/2]`` in that dtype."""
        device = x.device
        if device.type != "cuda":
            raise ValueError(f"{self.name} runs on a CUDA device, not {device}")
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"{self.name} takes bfloat16 or float32, not {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"x must be [B, T, I], got {tuple(x.shape)}")
        B, T, I = x.shape
        O = weight.shape[0]
        if tuple(weight.shape) != (O, I, conv0_ops.WIDTH) or tuple(bias.shape) != (O,):
            raise ValueError(
                f"weight must be [O, {I}, {conv0_ops.WIDTH}] and bias [O], got "
                f"{tuple(weight.shape)} and {tuple(bias.shape)}"
            )
        for t in (x, weight, bias):
            if t.device != device or t.dtype != x.dtype or not t.is_contiguous():
                raise ValueError(
                    f"{self.name} needs contiguous tensors of one dtype on one device"
                )
            if t.data_ptr() % 16:
                raise ValueError(f"{self.name} needs 16-byte aligned tensors")
        if not conv0_ops.supported(
            x.shape, conv0_ops.WIDTH, conv0_ops.STRIDE, True, device
        ):
            raise ValueError(f"{self.name} does not cover x of shape {tuple(x.shape)}")

        scratch = torch.empty(
            self.lib.conv0_scratch_elements(I, O), dtype=x.dtype, device=device
        )
        y = torch.empty(B, O, T // conv0_ops.STRIDE, dtype=x.dtype, device=device)
        code = self.lib.conv0_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            scratch.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x.dtype], B, T, I, O,
            cuda_build.device_index(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
        self._raise_on(code)
        self.launches += 1
        return y


CONV0 = Conv0Kernel()
KERNELS = (CONV0,)


class Conv0Function(torch.autograd.Function):
    """conv_0 + bias + ReLU, ``[B, T, I] -> [B, T/2, O]``, differentiable.

    Forward: the kernel on CUDA (its ``[B, O, T/2]`` output returned as a
    transposed view, so the next channels-first layer reads it as it is),
    ``conv0_plain`` on the CPU. It saves ``(x, weight, y)``.
    """

    @staticmethod
    def forward(ctx, x, weight, bias):
        if x.device.type == "cpu":
            CONV0.plain_calls += 1
            y = conv0_ops.conv0_plain(x, weight, bias)
        else:
            y = CONV0(x, weight, bias).transpose(1, 2)
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, y = ctx.saved_tensors
        # the ReLU gate (y > 0 <=> pre-activation > 0), then the transposes
        g = (g * (y > 0)).to(x.dtype).transpose(1, 2)  # [B, O, T/2]
        xt = x.transpose(1, 2)  # [B, I, T]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(
                xt.shape, weight, g,
                stride=conv0_ops.STRIDE, padding=conv0_ops.PAD_LEFT,
            ).transpose(1, 2)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(
                xt, weight.shape, g,
                stride=conv0_ops.STRIDE, padding=conv0_ops.PAD_LEFT,
            )
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 2)).to(x.dtype)
        return dx, dw, db


def conv0(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv_0 + bias + ReLU: ``x [B, T, I]`` (a shape ``conv0.supported``
    admits), ``weight [O, I, 48]``, ``bias [O]`` -> ``[B, T/2, O]``."""
    return Conv0Function.apply(x.contiguous(), weight.contiguous(), bias.contiguous())
