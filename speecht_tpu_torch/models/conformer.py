"""Conformer-CTC acoustic model as a torch ``nn.Module``.

Gulati et al., "Conformer: Convolution-augmented Transformer for Speech
Recognition" (arXiv:2005.08100, Table 1 and section 2), trained with a CTC
head over the port's classes as NVIDIA NeMo's Conformer-CTC and ESPnet's
CTC recipes train it. Conformer (L) is the default: 17 blocks at
``d_model`` 512, 8 heads, FFN 2,048, a depthwise kernel of 32.

- **Front end** (:class:`Subsampling`): Conv2d(1 -> C, 3x3, stride 2,
  padding 1), ReLU, Conv2d(C -> C, 3x3, stride 2, padding 1), ReLU, the
  channels and the remaining feature bins flattened channel-major into
  Linear(C * F'' -> d), then times sqrt(d) (NeMo's ``xscaling``). A row of
  ``n`` frames keeps ``ceil(n / 4)`` (:meth:`Conformer.output_length`).
- **Block** (:class:`Block`): ``x + FFN(x) / 2``, ``x + MHSA(x)``,
  ``x + Conv(x)``, ``x + FFN(x) / 2``, then LayerNorm. FFN is LN ->
  Linear(d, ffn) -> Swish -> Linear(ffn, d). MHSA is LN -> relative-position
  self-attention as Transformer-XL and ESPnet's/NeMo's
  ``RelPositionMultiHeadAttention`` compute it: ``p = P W_pos`` from the
  sinusoids of the relative distances ``T'-1 ... -(T'-1)``, scores
  ``((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_head)``, padded keys
  masked. Conv is LN -> pointwise d -> 2d -> GLU -> depthwise width K (TF
  SAME: ``(K-1)//2`` frames on the left, the rest on the right) ->
  BatchNorm -> Swish -> pointwise d -> d.
- **Head**: Linear(d -> num_classes); logits ``[B, ceil(T/4), C]`` float32.

A row's valid logits do not depend on how far its batch is padded: the
features and the first conv's output are zeroed past the row's frames,
attention masks the keys at or past its ``T'_n``, the depthwise conv
reads zeros there, and BatchNorm's training statistics are taken over the
valid frames alone (NeMo and ESPnet count the zeroed padding too). A row
of length 0 (the padded last batch) gives finite values: a masked score
is a large finite negative, never -inf. Masks and counts are built on the
device from ``seq_lengths``, so a forward reads nothing back.

Parameters are float32. Matmuls, convs, the attention core, GLU and Swish
run in ``compute_dtype`` (bf16 by default); the residual stream,
LayerNorm, BatchNorm's statistics and the logits stay float32. On the card
the positional term and the key mask enter
``F.scaled_dot_product_attention`` as one additive bias, and the memory-
efficient backend is pinned, so a fall-back to the math backend raises.
Dropout (``dropout``, the paper's 0.1 by default) follows each module's
output, the FFN's Swish and the attention probabilities.

While a profiler records, each forward marks ``conformer.subsample`` once
and, a block, ``conformer.ffn`` twice, ``conformer.mhsa`` and
``conformer.conv`` (``telemetry.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from speecht_tpu_torch import telemetry, vocabulary
from speecht_tpu_torch.ops import conv_grad
from speecht_tpu_torch.weights import TensorSplit

# a masked key's score: exp() of it is 0 beside any real score, and a row
# whose keys are all masked (length 0) still gives a finite softmax
MASKED = -1e9

# attention cores computed since import (the CPU's and the card's alike),
# as conv_grad.input_grads is counted: num_blocks a forward
attention_calls = 0


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    input_size: int = 39
    num_classes: int = vocabulary.NUM_CLASSES
    d_model: int = 512
    num_heads: int = 8
    ffn_dim: int = 2048
    num_blocks: int = 17
    conv_kernel: int = 32
    subsampling_channels: int = 512
    dropout: float = 0.1
    compute_dtype: str = "bfloat16"


def _halved(n: int) -> int:
    """A stride-2 conv's output length at padding 1, width 3: ceil(n / 2)."""
    return -(-n // 2)


def frame_mask(lengths: torch.Tensor, frames: int) -> torch.Tensor:
    """``[B, frames]`` bool: frame ``t`` of row ``b`` is below ``lengths[b]``."""
    return torch.arange(frames, device=lengths.device) < lengths[:, None]


def relative_positions(frames: int, d_model: int, device) -> torch.Tensor:
    """``[2 frames - 1, d_model]`` float32 sinusoids of the relative
    distances ``frames-1, ..., -(frames-1)``: sin at even, cos at odd
    channels (ESPnet's ``RelPositionalEncoding``)."""
    pos = torch.arange(frames - 1, -frames, -1, device=device, dtype=torch.float32)
    inv = torch.exp(torch.arange(0, d_model, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    angle = pos[:, None] * inv[None, :]
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(-1, d_model)


def rel_shift(raw: torch.Tensor) -> torch.Tensor:
    """``[..., T, 2T-1] -> [..., T, T]`` with ``out[..., i, j] = raw[..., i,
    T-1-i+j]``: the score of query ``i`` at relative distance ``i - j``.
    A strided view of ``raw`` (made contiguous), no copy."""
    raw = raw.contiguous()
    t, w = raw.shape[-2:]
    return raw.as_strided((*raw.shape[:-1], t), (*raw.stride()[:-2], w - 1, 1),
                          raw.storage_offset() + t - 1)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def _dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    return F.dropout(x, p, training) if p > 0 and training else x


def attention(q, k, v, bias, dropout: float, scale: float) -> torch.Tensor:
    """``softmax(q k^T scale + bias) v`` (``[B, H, T, d_head]``); on the
    card through the memory-efficient kernel alone."""
    global attention_calls
    attention_calls += 1
    pinned = (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if q.is_cuda
              else contextlib.nullcontext())
    with pinned:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, dropout_p=dropout,
                                              scale=scale)


class Subsampling(nn.Module):
    """[B, T, F] features -> [B, ceil(T/4), d] float32."""

    def __init__(self, input_size: int, channels: int, d_model: int):
        super().__init__()
        self.conv1 = nn.Conv2d(1, channels, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        bins = _halved(_halved(input_size))  # the feature bins after the convs
        self.linear = nn.Linear(channels * bins, d_model)
        self.scale = math.sqrt(d_model)

    def forward(self, features, seq_lengths, dtype):
        x = torch.where(frame_mask(seq_lengths, features.shape[1])[:, :, None],
                        features.to(dtype), 0)
        x = torch.relu(F.conv2d(x[:, None], self.conv1.weight.to(dtype),
                                self.conv1.bias.to(dtype), stride=2, padding=1))
        half = frame_mask((seq_lengths + 1) // 2, x.shape[2])
        x = torch.where(half[:, None, :, None], x, 0)
        x = torch.relu(F.conv2d(x, self.conv2.weight.to(dtype), self.conv2.bias.to(dtype),
                                stride=2, padding=1))
        b, c, t, f = x.shape
        x = _linear(x.permute(0, 2, 1, 3).reshape(b, t, c * f), self.linear, dtype)
        return x.float() * self.scale


class FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x, dtype, dropout: float):
        h = F.silu(_linear(_layer_norm(x, self.norm).to(dtype), self.linear1, dtype))
        return _linear(_dropout(h, dropout, self.training), self.linear2, dtype)


class RelPositionAttention(nn.Module):
    """LN, then multi-head self-attention with Transformer-XL's relative
    positions: the content term ``(q + u) k^T`` and the position term
    ``rel_shift((q + v) p^T)``, ``p`` the relative sinusoids through
    ``pos`` (no bias), ``u``/``v`` a bias a head."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.norm = nn.LayerNorm(d_model)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, pos_emb, key_bias, dtype, dropout: float):
        """``pos_emb [2T-1, d]`` and ``key_bias [B, 1, 1, T]`` (0 or
        :data:`MASKED`) in ``dtype``."""
        b, t, d = x.shape
        h, dh = self.num_heads, self.head_dim
        qkv = _linear(_layer_norm(x, self.norm).to(dtype), self.qkv, dtype)
        q, k, v = qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
        p = _linear(pos_emb, self.pos, dtype).view(2 * t - 1, h, dh).permute(1, 2, 0)
        scale = 1.0 / math.sqrt(dh)
        position = rel_shift(torch.matmul(q + self.pos_bias_v.to(dtype)[:, None], p))
        bias = position * scale + key_bias
        out = attention(q + self.pos_bias_u.to(dtype)[:, None], k, v, bias,
                        dropout if self.training else 0.0, scale)
        return _linear(out.transpose(1, 2).reshape(b, t, d), self.out, dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over channels whose training statistics count the valid
    frames alone; running statistics as ``nn.BatchNorm1d`` keeps them
    (momentum 0.1, the unbiased variance), used in eval mode."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, valid, count):
        """``x [B, C, T]``, ``valid [B, 1, T]`` float32 0/1, ``count`` the
        valid frames (a float32 scalar, at least 1); float32 out."""
        x = x.float()
        if self.training:
            mean = (x * valid).sum((0, 2)) / count
            centered = x - mean[:, None]
            var = (centered.square() * valid).sum((0, 2)) / count
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                unbiased = var * (count / (count - 1).clamp(min=1))
                self.running_var.lerp_(unbiased, self.momentum)
        else:
            centered = x - self.running_mean[:, None]
            var = self.running_var
        return centered * (torch.rsqrt(var + self.eps) * self.weight)[:, None] \
            + self.bias[:, None]


class ConvModule(nn.Module):
    def __init__(self, d_model: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.norm = nn.LayerNorm(d_model)
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel, groups=d_model)
        self.batch_norm = MaskedBatchNorm(d_model)
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, x, valid, count, dtype):
        """``valid [B, T]`` bool, ``count`` as :class:`MaskedBatchNorm`'s."""
        h = F.glu(_linear(_layer_norm(x, self.norm).to(dtype), self.pointwise1, dtype), dim=-1)
        h = torch.where(valid[:, :, None], h, 0).transpose(1, 2)
        left = (self.kernel - 1) // 2
        h = conv_grad.conv1d(h, self.depthwise.weight.to(dtype), 1,
                             (left, self.kernel - 1 - left), groups=h.shape[1])
        h = h + self.depthwise.bias.to(dtype)[:, None]
        h = self.batch_norm(h, valid[:, None].float(), count)
        h = F.silu(h.to(dtype)).transpose(1, 2)
        return _linear(h, self.pointwise2, dtype)


class Block(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.dropout = cfg.dropout
        self.ffn1 = FeedForward(cfg.d_model, cfg.ffn_dim)
        self.mhsa = RelPositionAttention(cfg.d_model, cfg.num_heads)
        self.conv = ConvModule(cfg.d_model, cfg.conv_kernel)
        self.ffn2 = FeedForward(cfg.d_model, cfg.ffn_dim)
        self.norm = nn.LayerNorm(cfg.d_model)

    def _residual(self, x, out, alpha: float = 1.0):
        """x + alpha * dropout(out), in float32 (``out`` in the compute dtype)."""
        return torch.add(x, _dropout(out, self.dropout, self.training), alpha=alpha)

    def forward(self, x, pos_emb, key_bias, valid, count, dtype):
        p = self.dropout
        with telemetry.span("conformer.ffn"):
            x = self._residual(x, self.ffn1(x, dtype, p), 0.5)
        with telemetry.span("conformer.mhsa"):
            x = self._residual(x, self.mhsa(x, pos_emb, key_bias, dtype, p))
        with telemetry.span("conformer.conv"):
            x = self._residual(x, self.conv(x, valid, count, dtype))
        with telemetry.span("conformer.ffn"):
            x = self._residual(x, self.ffn2(x, dtype, p), 0.5)
        return _layer_norm(x, self.norm)


class Conformer(nn.Module):
    """Conformer-CTC: ``([B, T, F] features, [B] lengths)`` -> logits
    ``[B, ceil(T/4), C]`` float32."""

    def __init__(self, config: ConformerConfig = ConformerConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.d_model % config.num_heads:
            raise ValueError(f"--num-heads {config.num_heads} must divide "
                             f"--d-model {config.d_model}")
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.split = TensorSplit()  # nothing is split over ranks
        self.subsample = Subsampling(config.input_size, config.subsampling_channels,
                                     config.d_model)
        self.blocks = nn.ModuleList(Block(config) for _ in range(config.num_blocks))
        self.head = nn.Linear(config.d_model, config.num_classes)
        # the modules whose outputs the activation summaries show (the
        # head's are the logits)
        self.layer_names = ["subsample", *(f"blocks.{i}" for i in range(config.num_blocks))]
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draws every parameter from the CPU ``generator``, in the order of
        ``named_parameters``, and keeps each on its device: weights of
        linear and conv layers uniform in +-1/sqrt(fan_in), their biases
        and the position biases zero, norms' scales one and shifts zero.
        BatchNorm's running statistics start at mean 0, variance 1."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rpartition(".")[2]
                module = self.get_submodule(name.rpartition(".")[0])
                if leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(p[0].numel())
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
                elif leaf == "weight":
                    p.fill_(1.0)
                else:
                    p.zero_()
            for name, buf in self.named_buffers():
                buf.fill_(1.0 if name.endswith("running_var") else 0.0)

    @staticmethod
    def output_length(seq_lengths: torch.Tensor) -> torch.Tensor:
        """Valid logit frames after the two stride-2 convs: ceil(n / 4)."""
        return (seq_lengths + 3) // 4

    def forward(self, features: torch.Tensor, seq_lengths: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        with telemetry.span("conformer.subsample"):
            x = self.subsample(features, seq_lengths, dtype)
        t = x.shape[1]
        lengths = self.output_length(seq_lengths)
        valid = frame_mask(lengths, t)
        key_bias = torch.where(valid, 0.0, MASKED).to(dtype)[:, None, None, :]
        count = lengths.sum().clamp(min=1).float()
        pos_emb = relative_positions(t, self.config.d_model, x.device).to(dtype)
        for block in self.blocks:
            x = block(x, pos_emb, key_bias, valid, count, dtype)
        return _linear(x.to(dtype), self.head, dtype).float()

