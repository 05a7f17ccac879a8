"""The plain reference of one Conformer-CTC training step, in float32, and
the architecture's counts for the yardstick (the interface is in
``reference/__init__.py``).

A frozen, independent writing of Gulati et al. 2020 (arXiv:2005.08100,
Table 1 and section 2) with a CTC head, as the benchmark's Conformer cells
train it:

- front end: Conv2d(1 -> C, 3x3, stride 2, padding 1), ReLU, Conv2d(C ->
  C, 3x3, stride 2, padding 1), ReLU, flattened channel-major into
  Linear(C * F'' -> d), times sqrt(d); a row of ``n`` frames keeps
  ``ceil(n / 4)``;
- each block: ``x + FFN(x) / 2``, ``x + MHSA(x)``, ``x + Conv(x)``,
  ``x + FFN(x) / 2``, LayerNorm. FFN: LN, Linear(d, ffn), Swish,
  Linear(ffn, d). MHSA: LN, one projection to q, k and v, the relative
  sinusoids of the distances ``T'-1 ... -(T'-1)`` through ``pos`` (no
  bias), scores ``((q + u) k^T + shift((q + v) p^T)) / sqrt(d_head)`` with
  ``shift(raw)[i, j] = raw[i, T'-1-i+j]``, keys at or past the row's
  length masked, softmax, the values, the output projection. Conv: LN,
  Linear(d, 2d), GLU, zeroed past the row's length, depthwise conv of
  width K (``(K-1)//2`` frames of zeros on the left, the rest on the
  right), BatchNorm with the batch's statistics over the valid frames,
  Swish, Linear(d, d);
- head: Linear(d, classes); the CTC loss by ``F.ctc_loss``, averaged over
  the rows whose loss is finite; clip + Adam from ``common.py``.

It imports nothing of the program and nothing of JAX; every size comes
from the configuration file. Departures from the program, each on
purpose:

- Everything is float32 with TF32 off (``common.float32_exact``), and the
  attention is written out as matmuls and a softmax (no fused kernel).
- ``quantize`` rounds where the program rounds to its compute precision:
  the inputs, weights and outputs of every matmul and conv, the GLU's and
  Swish's outputs, the position term before the mask is added. The
  residual stream, the norms' statistics, the softmax and the logits'
  float32 are left alone, as in the program.
- Each block and the front end are recomputed in the backward
  (``torch.utils.checkpoint``), so three steps at the longest bucket fit
  the card once the program is freed. The batch is never split by rows:
  BatchNorm couples them.
- Dropout is not drawn: the configurations that use this module set it
  to 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference.common import Adam, identity

# a masked key's score (its softmax weight is 0; a row with no key left
# stays finite)
MASKED = -1e9
BN_EPS = 1e-5
LN_EPS = 1e-5


def program_flags(config: dict) -> list[str]:
    """The port's ``train`` flags that give the model its shape."""
    return ["--model", "conformer",
            "--d-model", str(config["d_model"]),
            "--num-heads", str(config["num_heads"]),
            "--ffn-dim", str(config["ffn_dim"]),
            "--num-blocks", str(config["num_blocks"]),
            "--conv-kernel", str(config["conv_kernel"]),
            "--subsampling-channels", str(config["subsampling_channels"]),
            "--dropout", repr(config["dropout"])]


def _half(n):
    """ceil(n / 2): a stride-2, width-3 conv's output at padding 1."""
    return -(-n // 2)


def logit_lengths(config: dict, seq_lengths):
    """``ceil(n / 4)``, the two stride-2 convs' valid frames (an array or
    a tensor)."""
    return (seq_lengths + 3) // 4


def logit_frames(config: dict, frames: int) -> int:
    return _half(_half(frames))


def leaf_shapes(config: dict) -> dict[str, tuple]:
    """Every parameter's shape, named as the port's ``state.params``."""
    c, d, f = config["subsampling_channels"], config["d_model"], config["ffn_dim"]
    h, k = config["num_heads"], config["conv_kernel"]
    bins = _half(_half(config["input_size"]))
    shapes = {"subsample.conv1.weight": (c, 1, 3, 3), "subsample.conv1.bias": (c,),
              "subsample.conv2.weight": (c, c, 3, 3), "subsample.conv2.bias": (c,),
              "subsample.linear.weight": (d, c * bins), "subsample.linear.bias": (d,)}
    for i in range(config["num_blocks"]):
        b = f"blocks.{i}."
        for ffn in ("ffn1", "ffn2"):
            shapes.update({b + ffn + ".norm.weight": (d,), b + ffn + ".norm.bias": (d,),
                           b + ffn + ".linear1.weight": (f, d), b + ffn + ".linear1.bias": (f,),
                           b + ffn + ".linear2.weight": (d, f), b + ffn + ".linear2.bias": (d,)})
        shapes.update({
            b + "mhsa.norm.weight": (d,), b + "mhsa.norm.bias": (d,),
            b + "mhsa.qkv.weight": (3 * d, d), b + "mhsa.qkv.bias": (3 * d,),
            b + "mhsa.pos.weight": (d, d),
            b + "mhsa.pos_bias_u": (h, d // h), b + "mhsa.pos_bias_v": (h, d // h),
            b + "mhsa.out.weight": (d, d), b + "mhsa.out.bias": (d,),
            b + "conv.norm.weight": (d,), b + "conv.norm.bias": (d,),
            b + "conv.pointwise1.weight": (2 * d, d), b + "conv.pointwise1.bias": (2 * d,),
            b + "conv.depthwise.weight": (d, 1, k), b + "conv.depthwise.bias": (d,),
            b + "conv.batch_norm.weight": (d,), b + "conv.batch_norm.bias": (d,),
            b + "conv.pointwise2.weight": (d, d), b + "conv.pointwise2.bias": (d,),
            b + "norm.weight": (d,), b + "norm.bias": (d,)})
    shapes.update({"head.weight": (config["num_classes"], d),
                   "head.bias": (config["num_classes"],)})
    return shapes


def make_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights of linear and conv layers uniform in +-1/sqrt(fan_in), drawn
    on ``device`` in one call; biases and the position biases zero; the
    norms' scales one and shifts zero."""
    shapes = leaf_shapes(config)
    drawn = {k: s for k, s in shapes.items() if len(s) > 1 and "pos_bias" not in k}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(sum(math.prod(s) for s in drawn.values()), device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    params, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            n = math.prod(shape)
            params[name] = (flat[at: at + n] / math.sqrt(n // shape[0])).view(shape)
            at += n
        elif name.endswith("norm.weight"):
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


# ---- the counts ----------------------------------------------------------

def _forward_macs(config: dict, n: np.ndarray) -> tuple:
    """(every multiply-add of a forward, the first conv's, the position
    projection's) for rows of ``n`` input frames, each at its own length."""
    c, d, f = config["subsampling_channels"], config["d_model"], config["ffn_dim"]
    k, classes = config["conv_kernel"], config["num_classes"]
    bins1 = _half(config["input_size"])
    bins2 = _half(bins1)
    t = logit_lengths(config, n).astype(np.float64)
    conv1 = _half(n).astype(np.float64) * bins1 * 9 * c
    front = conv1 + t * (bins2 * 9 * c * c + c * bins2 * d)
    position = (2 * t - 1).clip(0) * d * d
    block = (t * (2 * 2 * d * f + 3 * d * d + d * d + 2 * d * d + k * d + d * d)
             + 2 * t * t * d + t * (2 * t - 1).clip(0) * d + position)
    total = front + config["num_blocks"] * block + t * d * classes
    return total.sum(), conv1.sum(), config["num_blocks"] * position.sum()


def train_flops_valid(config: dict, seq_lengths) -> float:
    """Operations one train step needs on these rows' valid frames, each
    row at its own length: the forward, and twice it backward (input and
    weight gradients) but for the inputs that need no gradient (the
    features into the first conv, the sinusoids into the position
    projection). Attention counts ``QK^T``, ``PV`` and the position term
    ``(q + v) p^T`` at the row's frames."""
    total, conv1, position = _forward_macs(config, np.asarray(seq_lengths, dtype=np.int64))
    return 2.0 * (3 * total - conv1 - position)


def conv_flops_padded(config: dict, batch: int, frames: int) -> tuple[float, float]:
    """(forward, backward) operations, at the padded shape as run, of the
    convolutions whose device time the profiler puts under
    ``aten::cudnn_convolution`` and ``aten::convolution_backward``. On the
    H100 (torch 2.11) those are the front end's two Conv2d, forward and
    backward (both weight gradients, the second's input gradient: the
    features need none), and the depthwise convs' backward (input and
    weight gradients, 2 B T' d K each): their forward runs under
    ``aten::_conv_depthwise2d`` and is not counted."""
    c, d = config["subsampling_channels"], config["d_model"]
    t = logit_frames(config, frames)
    bins1 = _half(config["input_size"])
    conv1 = 2.0 * batch * _half(frames) * bins1 * 9 * c
    conv2 = 2.0 * batch * t * _half(bins1) * 9 * c * c
    depthwise = 2.0 * batch * t * d * config["conv_kernel"] * config["num_blocks"]
    return conv1 + conv2, conv1 + 2 * conv2 + 2 * depthwise


def attention_flops_padded(config: dict, batch: int, frames: int) -> tuple[float, float]:
    """(forward, backward) operations of the fused attention cores at the
    padded shape as run: ``QK^T`` and ``PV`` forward, 4 B H T'^2 d_head a
    block; ``dQ``, ``dK``, ``dV`` and ``dP`` backward, 8 B H T'^2 d_head."""
    t = logit_frames(config, frames)
    unit = float(batch) * t * t * config["d_model"] * config["num_blocks"]
    return 4.0 * unit, 8.0 * unit


# ---- the forward ---------------------------------------------------------

def relative_positions(frames: int, d: int, device) -> torch.Tensor:
    """``[2 frames - 1, d]``: row ``r`` is distance ``frames - 1 - r``;
    channel ``2i`` its sine and ``2i + 1`` its cosine at ``10000^(-2i/d)``."""
    dist = torch.arange(frames - 1, -frames, -1, device=device, dtype=torch.float32)
    rate = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                     * (-math.log(10000.0) / d))
    out = torch.empty(2 * frames - 1, d, device=device)
    out[:, 0::2] = torch.sin(dist[:, None] * rate)
    out[:, 1::2] = torch.cos(dist[:, None] * rate)
    return out


def shift(raw: torch.Tensor) -> torch.Tensor:
    """``shift(raw)[..., i, j] = raw[..., i, T-1-i+j]``, by gathering."""
    t = raw.shape[-2]
    i = torch.arange(t, device=raw.device)
    index = (t - 1 - i[:, None] + i[None, :]).expand(*raw.shape[:-1], t)
    return torch.gather(raw, -1, index)


def _dense(x, w, b, q):
    return q(F.linear(x, q(w), None if b is None else q(b)))


def _norm(x, w, b):
    return F.layer_norm(x, x.shape[-1:], w, b, LN_EPS)


def _front_end(features, seq_lengths, p, q):
    frames = torch.arange(features.shape[1], device=features.device)
    x = q(features * (frames[None, :] < seq_lengths[:, None])[:, :, None])
    x = torch.relu(q(F.conv2d(x[:, None], q(p["subsample.conv1.weight"]),
                              q(p["subsample.conv1.bias"]), stride=2, padding=1)))
    half = torch.arange(x.shape[2], device=x.device) < _half(seq_lengths)[:, None]
    x = x * half[:, None, :, None]
    x = torch.relu(q(F.conv2d(x, q(p["subsample.conv2.weight"]),
                              q(p["subsample.conv2.bias"]), stride=2, padding=1)))
    b, c, t, f = x.shape
    x = _dense(x.permute(0, 2, 1, 3).reshape(b, t, c * f), p["subsample.linear.weight"],
               p["subsample.linear.bias"], q)
    return x * math.sqrt(p["subsample.linear.weight"].shape[0])


def _ffn(x, p, pre, q):
    h = q(_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"]))
    h = q(F.silu(_dense(h, p[pre + "linear1.weight"], p[pre + "linear1.bias"], q)))
    return _dense(h, p[pre + "linear2.weight"], p[pre + "linear2.bias"], q)


def _mhsa(x, positions, key_mask, p, pre, heads, q):
    b, t, d = x.shape
    dh = d // heads
    h = q(_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"]))
    qkv = _dense(h, p[pre + "qkv.weight"], p[pre + "qkv.bias"], q)
    qh, kh, vh = (z.reshape(b, t, heads, dh).transpose(1, 2) for z in qkv.split(d, dim=-1))
    pos = _dense(q(positions), p[pre + "pos.weight"], None, q)
    pos = pos.reshape(2 * t - 1, heads, dh).permute(1, 2, 0)  # [H, dh, 2T-1]
    with_u = q(qh + q(p[pre + "pos_bias_u"])[:, None])
    with_v = q(qh + q(p[pre + "pos_bias_v"])[:, None])
    scale = 1.0 / math.sqrt(dh)
    position = q(shift(q(with_v @ pos)) * scale)
    scores = (with_u @ kh.transpose(-1, -2)) * scale + position
    scores = scores.masked_fill(~key_mask[:, None, None, :], MASKED)
    out = q(torch.softmax(scores, dim=-1) @ vh)
    return _dense(out.transpose(1, 2).reshape(b, t, d), p[pre + "out.weight"],
                  p[pre + "out.bias"], q)


def _conv(x, valid, p, pre, kernel, q):
    h = q(_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"]))
    h = q(F.glu(_dense(h, p[pre + "pointwise1.weight"], p[pre + "pointwise1.bias"], q)))
    h = (h * valid[:, :, None]).transpose(1, 2)  # [B, d, T]
    left = (kernel - 1) // 2
    h = q(F.conv1d(F.pad(h, (left, kernel - 1 - left)), q(p[pre + "depthwise.weight"]),
                   groups=h.shape[1]))
    h = q(h + q(p[pre + "depthwise.bias"])[:, None])
    m = valid[:, None, :].float()
    count = m.sum().clamp(min=1)
    mean = (h * m).sum((0, 2)) / count
    var = (((h - mean[:, None]) * m) ** 2).sum((0, 2)) / count
    h = (h - mean[:, None]) / torch.sqrt(var + BN_EPS)[:, None]
    h = h * p[pre + "batch_norm.weight"][:, None] + p[pre + "batch_norm.bias"][:, None]
    h = q(F.silu(q(h))).transpose(1, 2)
    return _dense(h, p[pre + "pointwise2.weight"], p[pre + "pointwise2.bias"], q)


def _block(x, positions, valid, p, pre, config, q):
    x = x + 0.5 * _ffn(x, p, pre + "ffn1.", q)
    x = x + _mhsa(x, positions, valid, p, pre + "mhsa.", config["num_heads"], q)
    x = x + _conv(x, valid, p, pre + "conv.", config["conv_kernel"], q)
    x = x + 0.5 * _ffn(x, p, pre + "ffn2.", q)
    return _norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"])


def forward(params: dict, features: torch.Tensor, seq_lengths: torch.Tensor, config: dict,
            quantize=identity) -> torch.Tensor:
    """``[B, T, F]`` float32 features -> ``[B, ceil(T/4), C]`` logits; each
    block and the front end recomputed in the backward."""
    x = checkpoint(_front_end, features, seq_lengths, params, quantize, use_reentrant=False)
    t = x.shape[1]
    valid = torch.arange(t, device=x.device) < logit_lengths(config, seq_lengths)[:, None]
    positions = relative_positions(t, config["d_model"], x.device)
    for i in range(config["num_blocks"]):
        x = checkpoint(_block, x, positions, valid, params, f"blocks.{i}.", config,
                       quantize, use_reentrant=False)
    return _dense(quantize(x), params["head.weight"], params["head.bias"], quantize)


def loss(params: dict, features: torch.Tensor, seq_lengths: torch.Tensor,
         labels: list, config: dict, quantize=identity) -> torch.Tensor:
    """The mean CTC loss of the rows whose loss is finite."""
    logits = forward(params, features, seq_lengths, config, quantize)
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    device = features.device
    targets = torch.cat([torch.as_tensor(lab, dtype=torch.long) for lab in labels]).to(device)
    target_lengths = torch.tensor([len(lab) for lab in labels], dtype=torch.long, device=device)
    per_row = F.ctc_loss(log_probs, targets, logit_lengths(config, seq_lengths).long(),
                         target_lengths, blank=config["blank_id"], reduction="none",
                         zero_infinity=False)
    finite = torch.isfinite(per_row)
    return torch.where(finite, per_row, 0.0).sum() / finite.sum().clamp(min=1)


def train_steps(params: dict, batches: list, config: dict, quantize=identity,
                rows=None) -> dict:
    """Runs the steps of ``batches`` (each ``(features [B, T, F] float32,
    seq_lengths [B], transcripts)`` on one device) from ``params``, which
    it copies. Returns each step's loss, the per-leaf norms of the first
    step's clipped gradient and of each leaf's change after the last
    step. ``rows`` (a function of the batch size) picks the rows a step
    trains on."""
    start = {k: p.detach().clone() for k, p in params.items()}
    live = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
    opt = Adam(live, config)
    losses, first_grad = [], None
    for features, seq_lengths, labels in batches:
        keep = list(range(len(labels))) if rows is None else rows(len(labels))
        value = loss(live, features[keep], seq_lengths[keep],
                     [labels[i] for i in keep], config, quantize)
        grads = torch.autograd.grad(value, list(live.values()))
        clipped = opt.step(live, dict(zip(live, grads)))
        if first_grad is None:
            first_grad = {k: float(torch.linalg.vector_norm(g.double()))
                          for k, g in clipped.items()}
        losses.append(float(value.detach()))
    change = {k: float(torch.linalg.vector_norm((live[k].detach() - start[k]).double()))
              for k in live}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}
