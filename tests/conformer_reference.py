"""A plain float32 Conformer-CTC for the tests, independent of the port.

Gulati et al. 2020 (arXiv:2005.08100) with a CTC head, written from the
paper and ESPnet's ``RelPositionMultiHeadedAttention``: the weights are a
dict named as the port's ``state_dict`` (``subsample.conv1.weight``,
``blocks.0.mhsa.qkv.weight``, ...), the attention is einsums and a
softmax, the relative shift is ESPnet's pad-and-reshape, BatchNorm takes
the batch's statistics over the valid frames. It imports nothing of the
port and nothing of JAX, so the card's tests can use it too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ceil_div(n, k: int):
    return -(-n // k)


def valid_frames(lengths: torch.Tensor, frames: int) -> torch.Tensor:
    return torch.arange(frames, device=lengths.device)[None, :] < lengths[:, None]


def sinusoids(frames: int, d: int, device) -> torch.Tensor:
    """Rows for the distances frames-1 down to -(frames-1); even channels
    sin, odd cos, at the rates 10000^(-2i/d)."""
    dist = torch.arange(frames - 1, -frames, -1, dtype=torch.float32, device=device)
    rates = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                      * (-math.log(10000.0) / d))
    table = torch.zeros(2 * frames - 1, d, device=device)
    table[:, 0::2] = torch.sin(dist[:, None] * rates)
    table[:, 1::2] = torch.cos(dist[:, None] * rates)
    return table


def espnet_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """ESPnet's shift of ``[B, H, T, 2T-1]`` scores to ``[B, H, T, T]``."""
    b, h, t, w = x.shape
    padded = torch.cat([x.new_zeros(b, h, t, 1), x], dim=-1).view(b, h, w + 1, t)
    return padded[:, :, 1:].reshape(b, h, t, w)[:, :, :, : w // 2 + 1]


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-5)


def linear(x, p, name):
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def forward(p: dict, features: torch.Tensor, lengths: torch.Tensor, heads: int,
            kernel: int) -> torch.Tensor:
    """``[B, T, F]`` features and their lengths -> ``[B, ceil(T/4), C]``
    logits, everything in float32 (BatchNorm in training mode)."""
    x = features * valid_frames(lengths, features.shape[1])[:, :, None]
    x = F.relu(F.conv2d(x.unsqueeze(1), p["subsample.conv1.weight"],
                        p["subsample.conv1.bias"], stride=2, padding=1))
    x = x * valid_frames(ceil_div(lengths, 2), x.shape[2])[:, None, :, None]
    x = F.relu(F.conv2d(x, p["subsample.conv2.weight"], p["subsample.conv2.bias"],
                        stride=2, padding=1))
    b, c, t, f = x.shape
    x = linear(x.transpose(1, 2).reshape(b, t, c * f), p, "subsample.linear")
    d = x.shape[-1]
    x = x * math.sqrt(d)
    n = ceil_div(lengths, 4)
    valid = valid_frames(n, t)
    table = sinusoids(t, d, x.device)
    dh = d // heads
    i = 0
    while f"blocks.{i}.norm.weight" in p:
        pre = f"blocks.{i}."
        for part in ("ffn1", "mhsa", "conv", "ffn2"):
            y = layer_norm(x, p, pre + part + ".norm")
            if part.startswith("ffn"):
                y = linear(F.silu(linear(y, p, pre + part + ".linear1")), p,
                           pre + part + ".linear2")
                x = x + 0.5 * y
            elif part == "mhsa":
                q, k, v = linear(y, p, pre + "mhsa.qkv").chunk(3, dim=-1)
                q, k, v = (z.view(b, t, heads, dh) for z in (q, k, v))
                pos = linear(table, p, pre + "mhsa.pos").view(2 * t - 1, heads, dh)
                ac = torch.einsum("bihd,bjhd->bhij", q + p[pre + "mhsa.pos_bias_u"], k)
                bd = torch.einsum("bihd,jhd->bhij", q + p[pre + "mhsa.pos_bias_v"], pos)
                scores = (ac + espnet_rel_shift(bd)) / math.sqrt(dh)
                scores = scores.masked_fill(~valid[:, None, None, :], -1e9)
                att = torch.einsum("bhij,bjhd->bihd", scores.softmax(-1), v)
                x = x + linear(att.reshape(b, t, d), p, pre + "mhsa.out")
            else:
                y = F.glu(linear(y, p, pre + "conv.pointwise1"), dim=-1)
                y = (y * valid[:, :, None]).transpose(1, 2)
                y = F.conv1d(F.pad(y, ((kernel - 1) // 2, kernel // 2)),
                             p[pre + "conv.depthwise.weight"], p[pre + "conv.depthwise.bias"],
                             groups=d)
                m = valid[:, None, :].float()
                mean = (y * m).sum((0, 2), keepdim=True) / m.sum()
                var = ((y - mean) ** 2 * m).sum((0, 2), keepdim=True) / m.sum()
                y = (y - mean) / torch.sqrt(var + 1e-5)
                y = y * p[pre + "conv.batch_norm.weight"][:, None] \
                    + p[pre + "conv.batch_norm.bias"][:, None]
                x = x + linear(F.silu(y).transpose(1, 2), p, pre + "conv.pointwise2")
        x = layer_norm(x, p, pre + "norm")
        i += 1
    return linear(x, p, "head")


def ctc_loss(logits, lengths, labels, label_lengths, blank: int) -> torch.Tensor:
    """The mean CTC loss of the rows whose loss is finite (the port's
    average), from ``[B, T', C]`` logits and the input lengths."""
    per_row = F.ctc_loss(logits.log_softmax(-1).transpose(0, 1), labels.long(),
                         ceil_div(lengths, 4).long(), label_lengths.long(), blank=blank,
                         reduction="none", zero_infinity=False)
    real = torch.isfinite(per_row) & (lengths > 0)
    return torch.where(real, per_row, 0.0).sum() / real.sum().clamp(min=1)
