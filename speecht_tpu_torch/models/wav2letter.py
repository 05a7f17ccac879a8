"""Wav2Letter acoustic model as a torch ``nn.Module``.

Counterpart of ``speecht_tpu/models/wav2letter.py``: 11 conv1d layers

  [width 48, stride 2]  input_size -> 250     + ReLU
  7 x [width 7, stride 1]  250 -> 250         + ReLU
  [width 32, stride 1]  250 -> 2000           + ReLU
  [width 1, stride 1]   2000 -> 2000          + ReLU
  [width 1, stride 1]   2000 -> num_classes   (no ReLU)

with TF/lax SAME padding, glorot-uniform kernels (fan = width x channels)
and zero bias. Parameters are float32. Each layer casts its input, kernel
and bias to ``compute_dtype`` (bf16 by default) and runs the conv, the
bias add and the ReLU in that dtype, as the JAX module does; logits come
out in float32 for the CTC loss.

The layout at the public boundary is the JAX one: ``[B, T, F]`` features
in, ``[B, T//2, num_classes]`` logits out. Inside, activations are
``[B, C, T]`` for ``F.conv1d`` (cuDNN on the card; the JAX package leaves
these convs to XLA the same way). While a gradient is taken, a wide
stride-1 layer (conv_8) computes its input gradient as a forward conv on
the flipped weight (``ops/conv_grad.py``).

conv_0 has a second path, opt-in as in JAX: with ``SPEECHT_PALLAS_CONV0=1``
and a shape ``ops/conv0.py::supported`` admits, it runs through
``ops/conv0_cuda.py::Conv0Function`` (the hand-written kernel on the card,
the plain version on the CPU) on the ``[B, T, F]`` features, rounding once
after the bias as the Pallas path does. Any other shape (odd T, mfcc's 39
features, T < 48) takes the cuDNN path, which is JAX's semantics.

Tensor parallelism (``--model-parallel N``, ``parallel/mesh.py``) splits
the wide layers Megatron's way: the first wide layer (``conv_8`` at the
reference's depth, ``1 + num_body_layers``) is column-parallel, each
model rank computing its ``wide_channels / N`` output channels; the
second (``conv_9``) is row-parallel, each rank convolving its channel
shard into a partial sum that is all-reduced (in float32) before the bias
and the ReLU; ``conv_10`` is replicated. :class:`CopyToModel` (identity
forward, all-reduce backward) in front of the column layer and
:class:`ReduceFromModel` (all-reduce forward, identity backward) after
the row layer make the backward right. Fresh weights are drawn at full
size and sliced, so a split model starts where one device's does; the
state dict holds the shards and ``weights.TensorSplit`` converts to and
from the one-device layout.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import torch
from torch import nn

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.ops import conv0, conv0_cuda, conv_grad
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.weights import TensorSplit


@dataclasses.dataclass(frozen=True)
class Wav2LetterConfig:
    input_size: int = 128
    num_classes: int = vocabulary.NUM_CLASSES
    base_channels: int = 250
    wide_channels: int = 2000
    num_body_layers: int = 7
    compute_dtype: str = "bfloat16"

    @property
    def layer_specs(self) -> Sequence[tuple[int, int, int, bool]]:
        """(width, stride, out_channels, relu) per layer."""
        c, w = self.base_channels, self.wide_channels
        specs = [(48, 2, c, True)]
        specs += [(7, 1, c, True)] * self.num_body_layers
        specs += [
            (32, 1, w, True),
            (1, 1, w, True),
            (1, 1, self.num_classes, False),
        ]
        return specs


def same_padding(length: int, width: int, stride: int) -> tuple[int, int]:
    """(left, right) TF/lax SAME padding; the odd pad goes on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + width - length, 0)
    return total // 2, total - total // 2


def _sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the model group, in float32, back in x's dtype."""
    total = comm.all_reduce_(x.float(), group)
    return total.to(x.dtype)


class CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward; the backward sums the input's
    gradient over the model group (each rank's column shard contributes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_over_model(g, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the forward sums the row shards' partial outputs
    over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over_model(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Conv1d(nn.Module):
    """One conv1d + bias (+ ReLU) layer. ``weight`` is ``[O, I, W]``.

    ``shard`` = ``(dim, index, parts, group)`` makes the layer hold part
    ``index`` of ``parts`` of the weight's dim ``dim``: 0 splits the output
    channels and the bias (column-parallel), 1 the input channels
    (row-parallel: the partial sums are reduced over ``group`` before the
    bias and the ReLU).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        width: int,
        stride: int,
        relu: bool,
        shard: tuple | None = None,
    ):
        super().__init__()
        self.width = width
        self.stride = stride
        self.relu = relu
        self.full_shape = (out_channels, in_channels, width)
        self.shard = shard
        shape = list(self.full_shape)
        if shard is not None:
            shape[shard[0]] //= shard[2]
        self.weight = nn.Parameter(torch.empty(*shape))
        self.bias = nn.Parameter(
            torch.zeros(shape[0] if shard and shard[0] == 0 else out_channels)
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot uniform with fan_in = W*I, fan_out = W*O; zero bias.
        A shard is cut from the full draw."""
        o, i, w = self.full_shape
        limit = math.sqrt(6.0 / (w * i + w * o))
        with torch.no_grad():
            if self.shard is None:
                self.weight.uniform_(-limit, limit, generator=generator)
            else:
                full = torch.empty(self.full_shape).uniform_(
                    -limit, limit, generator=generator
                )
                dim, index, parts, _group = self.shard
                self.weight.copy_(full.chunk(parts, dim=dim)[index])
            self.bias.zero_()

    def conv0_path(self, x: torch.Tensor) -> bool:
        """True when this call takes the conv_0 kernel path: the env var
        ``SPEECHT_PALLAS_CONV0=1``, read at each forward as JAX reads it at
        each trace, and a shape the gate admits."""
        return os.environ.get(conv0.ENV_VAR) == "1" and conv0.supported(
            (x.shape[0], x.shape[2], x.shape[1]), self.width, self.stride,
            self.relu, x.device,
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x [B, C, T]`` -> ``[B, O, T']``."""
        if self.conv0_path(x):
            # the kernel reads [B, T, I]: the features' own layout, so for
            # the model's input this transpose undoes the one in forward
            y = conv0_cuda.conv0(
                x.transpose(1, 2).to(dtype), self.weight.to(dtype),
                self.bias.to(dtype),
            )
            return y.transpose(1, 2)
        column = self.shard is not None and self.shard[0] == 0
        row = self.shard is not None and self.shard[0] == 1
        if column:
            x = CopyToModel.apply(x, self.shard[3])
        pads = same_padding(x.shape[-1], self.width, self.stride)
        y = conv_grad.conv1d(
            x.to(dtype), self.weight.to(dtype), self.stride, pads
        )
        if row:
            y = ReduceFromModel.apply(y, self.shard[3])
        y = y + self.bias.to(dtype)[:, None]
        if self.relu:
            y = torch.relu(y)
        return y


class Wav2Letter(nn.Module):
    """The Wav2Letter conv stack: [B, T, F] -> logits [B, T//2, C] f32."""

    def __init__(
        self,
        config: Wav2LetterConfig = Wav2LetterConfig(),
        generator: torch.Generator | None = None,
        mesh=None,
    ):
        """``mesh`` (``parallel/mesh.py``) with a model axis above 1 and no
        sequence parallelism splits the wide layers over its model group."""
        super().__init__()
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        wide = 1 + config.num_body_layers
        shards = {}
        self.split = TensorSplit()
        if mesh is not None and mesh.mp > 1 and not mesh.seq_parallel:
            if config.wide_channels % mesh.mp:
                raise ValueError(
                    f"--model-parallel {mesh.mp} must divide --wide-channels "
                    f"{config.wide_channels}"
                )
            shards = {wide: 0, wide + 1: 1}
            self.split = TensorSplit(
                dims={f"conv_{wide}.weight": 0, f"conv_{wide}.bias": 0,
                      f"conv_{wide + 1}.weight": 1},
                index=mesh.model_index, parts=mesh.mp, mesh=mesh,
            )
        in_channels = config.input_size
        self.layer_names = []
        for i, (width, stride, out_channels, relu) in enumerate(
            config.layer_specs
        ):
            name = f"conv_{i}"
            shard = None
            if i in shards:
                shard = (shards[i], mesh.model_index, mesh.mp, mesh.model_group)
            self.add_module(
                name, Conv1d(in_channels, out_channels, width, stride, relu, shard)
            )
            self.layer_names.append(name)
            in_channels = out_channels
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draws every layer anew from the CPU ``generator``, layer by
        layer on the CPU; each layer keeps its device."""
        for name in self.layer_names:
            layer = getattr(self, name)
            device = layer.weight.device
            layer.to("cpu").reset_parameters(generator)
            layer.to(device)

    def forward(
        self, features: torch.Tensor, seq_lengths: torch.Tensor | None = None
    ) -> torch.Tensor:
        """``seq_lengths`` is taken and not read: the convs need no mask,
        and a padded frame's logits are left out by :meth:`output_length`."""
        x = features.transpose(1, 2)
        for name in self.layer_names:
            x = getattr(self, name)(x, self.compute_dtype)
        return x.transpose(1, 2).float()

    @staticmethod
    def output_length(seq_lengths: torch.Tensor) -> torch.Tensor:
        return output_length(seq_lengths)


def output_length(seq_lengths: torch.Tensor) -> torch.Tensor:
    """Valid logit frames after the stride-2 layer (seq_len // 2)."""
    return seq_lengths // 2
