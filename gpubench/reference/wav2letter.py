"""The plain reference of one Wav2Letter training step, in float32, and
the architecture's counts for the yardstick (the interface is in
``reference/__init__.py``).

A frozen, independent writing of what the benchmark's training cells
compute: the Wav2Letter forward (Collobert et al. 2016: a stride-2 conv
of width 48, the body convs of width 7, a wide conv of width 32 and two
1x1 convs, ReLU after all but the last), TensorFlow/lax SAME padding, the
CTC loss by ``F.ctc_loss``, averaged over the rows whose loss is finite,
and one update of clip-by-global-norm, Adam and the learning rate. It
imports nothing of the program and nothing of JAX; every size and setting
comes from the configuration file.

Departures from the program, each on purpose:

- Everything is float32, and TF32 is off (``common.float32_exact``). The
  program runs its convolutions, bias adds and ReLUs in bfloat16 and
  sends the features as bfloat16; the gap between the two is what the
  benchmark's limits are set on. With TF32 on, cuDNN would round each
  float32 convolution's inputs to 10 mantissa bits, and the reference
  would no longer be the float32 model.
- The CTC loss is ``F.ctc_loss`` (PyTorch's own kernels), not the
  program's kernels, and its gradient is autograd's.
- The optimizer is written out from its definition (optax's
  ``clip_by_global_norm`` then ``scale_by_adam``, then ``-lr`` times the
  update): a gradient is kept whole when its global norm is below the
  maximum, else scaled to it.
- ``quantize`` puts a rounding step at each point where the program
  rounds to its compute precision: the layer's input, kernel and bias,
  its output and the sum after the bias, and each gradient flowing back
  into a layer. The reference itself passes none. The benchmark's control
  passes ``common.fp8_quantize``, the step below bfloat16.

The optimizer and the control live in ``common.py``, shared with every
architecture.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.common import Adam, identity


def program_flags(config: dict) -> list[str]:
    """The port's ``train`` flags that give the model its shape."""
    return ["--base-channels", str(config["base_channels"]),
            "--wide-channels", str(config["wide_channels"]),
            "--num-body-layers", str(config["num_body_layers"])]


def logit_lengths(config: dict, seq_lengths):
    """The logit frames of rows of ``seq_lengths`` input frames (an array
    or a tensor): the stride-2 first layer's ``n // 2``, as the port's
    ``output_length`` gives them to the CTC loss."""
    return seq_lengths // 2


def logit_frames(config: dict, frames: int) -> int:
    """The logits' padded length at ``frames`` padded input frames: SAME
    padding at stride 2."""
    return -(-frames // 2)


def layer_specs(config: dict) -> list[tuple[int, int, int, int, bool]]:
    """(width, stride, in_channels, out_channels, relu) of each layer."""
    c, w = config["base_channels"], config["wide_channels"]
    specs = [(config["first_width"], config["first_stride"], c, True)]
    specs += [(config["body_width"], 1, c, True)] * config["num_body_layers"]
    specs += [(config["wide_width"], 1, w, True), (1, 1, w, True),
              (1, 1, config["num_classes"], False)]
    out, cin = [], config["input_size"]
    for width, stride, cout, relu in specs:
        out.append((width, stride, cin, cout, relu))
        cin = cout
    return out


def make_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Glorot-uniform kernels ``[out, in, width]`` (fan = width x
    channels) and zero biases, float32, drawn on ``device`` in one call."""
    specs = layer_specs(config)
    sizes = [cout * cin * width for width, _s, cin, cout, _r in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    params, at = {}, 0
    for i, ((width, _s, cin, cout, _r), n) in enumerate(zip(specs, sizes)):
        limit = math.sqrt(6.0 / (width * cin + width * cout))
        params[f"conv_{i}.weight"] = (flat[at: at + n] * limit).view(cout, cin, width)
        params[f"conv_{i}.bias"] = torch.zeros(cout, device=device)
        at += n
    return params


def conv_macs_per_output_frame(config: dict) -> list[int]:
    """Multiply-adds of each layer for one output frame of one row."""
    return [width * cin * cout for width, _s, cin, cout, _r in layer_specs(config)]


def train_flops_valid(config: dict, seq_lengths) -> float:
    """Operations one train step needs for these rows' valid frames: the
    forward, the weight gradients and the input gradients of every layer
    but the first (the features need none). A row of ``n`` input frames
    has ``n // 2`` valid frames after the stride-2 first layer, and every
    later layer keeps that count."""
    macs = conv_macs_per_output_frame(config)
    per_frame = 2.0 * (3 * sum(macs) - macs[0])
    frames = int(logit_lengths(config, np.asarray(seq_lengths, dtype=np.int64)).sum())
    return per_frame * frames


def conv_flops_padded(config: dict, batch: int, frames: int) -> tuple[float, float]:
    """(forward, backward) operations of the convolutions at the padded
    shape as run: ``batch`` rows of ``frames`` input frames, every output
    frame of every layer computed, SAME padding. The backward is the weight
    gradient of every layer and the input gradient of every layer but the
    first."""
    fwd = bwd = 0.0
    t = frames
    for i, (width, stride, cin, cout, _relu) in enumerate(layer_specs(config)):
        t = -(-t // stride)
        f = 2.0 * batch * t * width * cin * cout
        fwd += f
        bwd += f if i == 0 else 2 * f
    return fwd, bwd


def same_padding(length: int, width: int, stride: int) -> tuple[int, int]:
    """TensorFlow SAME: (left, right), the odd pad on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + width - length, 0)
    return total // 2, total - total // 2


def forward(params: dict, features: torch.Tensor, config: dict,
            quantize=identity) -> torch.Tensor:
    """``[B, T, F]`` float32 features -> ``[B, ceil(T/2), C]`` logits."""
    x = features.transpose(1, 2)
    for i, (width, stride, _cin, _cout, relu) in enumerate(layer_specs(config)):
        left, right = same_padding(x.shape[-1], width, stride)
        x = F.pad(quantize(x), (left, right))
        x = quantize(F.conv1d(x, quantize(params[f"conv_{i}.weight"]), stride=stride))
        x = quantize(x + quantize(params[f"conv_{i}.bias"])[:, None])
        if relu:
            x = torch.relu(x)
    return x.transpose(1, 2)


def loss(params: dict, features: torch.Tensor, seq_lengths: torch.Tensor,
         labels: list, config: dict, quantize=identity) -> torch.Tensor:
    """The mean CTC loss of the rows whose loss is finite. ``labels`` are
    the rows' unpadded transcripts; a row's logit frames are
    :func:`logit_lengths`."""
    logits = forward(params, features, config, quantize)
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
    step's clipped gradient and of each leaf's change after the last step.
    ``rows`` (a function of the batch size) picks the rows a step trains
    on: the benchmark's fault of half a batch left out."""
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
            first_grad = {k: float(torch.linalg.vector_norm(g.double())) for k, g in clipped.items()}
        losses.append(float(value.detach()))
    change = {k: float(torch.linalg.vector_norm((live[k].detach() - start[k]).double()))
              for k in live}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}
