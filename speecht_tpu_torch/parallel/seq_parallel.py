"""Sequence-parallel Wav2Letter: the time axis sharded over ranks, with halo exchanges.

Counterpart of ``speecht_tpu/parallel/seq_parallel.py``. Under
``--seq-parallel N`` the mesh's model axis holds N ranks that each take a
contiguous slab of ``T / N`` frames of the same rows. Before each conv of
width W > 1 a rank receives the last ``(W-1)//2`` frames of its left
neighbour and the first ``W//2`` of its right one (:class:`HaloExchange`);
the edge ranks receive zeros, which is SAME padding. The conv then runs
with VALID padding (``F.conv1d``, as JAX's SP path uses ``lax.conv`` and
not the conv0 kernel), so the stride-2 first layer needs an even slab.
The wide layer's input gradient, halo frames included, is a forward conv
on the flipped weight while training, as on one device
(``ops/conv_grad.py``).

The loss gathers the logits over time (:class:`GatherTime`) and every rank
of the group runs the port's CTC (the alpha and beta kernels) on the whole
sequence, as JAX's does. Each rank so holds the same loss, and the
gather's backward hands each rank its own slice of the incoming gradient
(a summing all-gather backward would multiply it by N). Each slab then
contributes part of every parameter's gradient: the train step sums them
over the sequence group and the data group (``train/step.py``).
"""

from __future__ import annotations

import torch

from speecht_tpu_torch.ops import conv_grad
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.parallel import mesh as pmesh
from speecht_tpu_torch.parallel.mesh import Mesh


def _neighbours(mesh: Mesh) -> tuple[int | None, int | None]:
    """Global ranks of this rank's left and right neighbours in time."""
    ranks = mesh.model_ranks()
    s = mesh.model_index
    return (ranks[s - 1] if s > 0 else None,
            ranks[s + 1] if s + 1 < len(ranks) else None)


class HaloExchange(torch.autograd.Function):
    """``x [B, C, T]`` -> ``[B, C, left + T + right]`` with the neighbours'
    edge frames (zeros at the sequence's ends). The backward sends each
    halo's gradient back to its owner, which adds it at its own edge."""

    @staticmethod
    def forward(ctx, x, left, right, mesh):
        prev, nxt = _neighbours(mesh)
        ctx.left, ctx.right, ctx.peers = left, right, (prev, nxt)
        B, C, T = x.shape
        from_prev, from_next = comm.exchange(
            x[..., :right], x[..., T - left:], prev, nxt,
            ((B, C, left), (B, C, right)), x,
        )
        return torch.cat([from_prev, x, from_next], dim=-1)

    @staticmethod
    def backward(ctx, g):
        left, right, (prev, nxt) = ctx.left, ctx.right, ctx.peers
        B, C, total = g.shape
        T = total - left - right
        # the left halo's gradient belongs to prev's last frames, the
        # right halo's to next's first frames
        from_prev, from_next = comm.exchange(
            g[..., :left], g[..., left + T:], prev, nxt,
            ((B, C, right), (B, C, left)), g,
        )
        gx = g[..., left: left + T].clone()
        gx[..., :right] += from_prev
        gx[..., T - left:] += from_next
        return gx, None, None, None


class GatherTime(torch.autograd.Function):
    """Logit slabs ``[B, T_local, C]`` -> the whole ``[B, T, C]`` on every
    rank of the sequence group; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.index, ctx.length = mesh.model_index, y.shape[1]
        return mesh.all_gather(y, pmesh.MODEL_AXIS, dim=1)

    @staticmethod
    def backward(ctx, g):
        start = ctx.index * ctx.length
        return g[:, start: start + ctx.length], None


def _sp_conv(x, layer, mesh, dtype):
    """One SAME conv layer over a time-sharded activation ``[B, C, T]``."""
    if layer.width > 1:
        x = HaloExchange.apply(x, (layer.width - 1) // 2, layer.width // 2, mesh)
    y = conv_grad.conv1d(x.to(dtype), layer.weight.to(dtype), layer.stride)
    y = y + layer.bias.to(dtype)[:, None]
    if layer.relu:
        y = torch.relu(y)
    return y


def sp_forward_local(model, x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slab ``[B, T_local, F]`` -> its logits ``[B, T_local/2, C]``
    in float32."""
    y = x_local.transpose(1, 2)
    for name in model.layer_names:
        y = _sp_conv(y, getattr(model, name), mesh, model.compute_dtype)
    return y.transpose(1, 2).float()


def validate_sp_length(T: int, n: int, config) -> None:
    """Shape preconditions for an n-way time shard (raises ValueError)."""
    max_width = max(w for w, _s, _f, _r in config.layer_specs)
    if T % (2 * n):
        raise ValueError(
            f"time length {T} must be divisible by 2*{n} for SP"
        )
    # halos come from the immediate neighbour only: the slab (after the
    # stride-2 layer it halves) must cover the widest kernel
    if T // (2 * n) < max_width:
        raise ValueError(
            f"local slab after the stride-2 layer ({T // (2 * n)} frames) "
            f"is too short for the widest kernel ({max_width}); need "
            f"T >= {2 * n * max_width}"
        )


def make_sp_mesh(flags, n: int) -> Mesh:
    """The ``--seq-parallel N`` mesh shared by train and evaluate.

    Slabs must cover the widest kernel (48 frames) after the stride-2
    layer, so time buckets are floored at 96 frames a rank (this raises
    ``flags.bucket_step``). Ranks the sequence axis does not take become
    data-parallel replicas (auto: gcd(ranks // n, batch size);
    ``--data-parallel`` pins it).
    """
    min_bucket = 96 * n
    if flags.bucket_step < min_bucket:
        print(f"seq-parallel {n}: raising --bucket-step to {min_bucket}")
        flags.bucket_step = min_bucket
    mesh = pmesh.auto_mesh(
        batch_size=flags.batch_size,
        data_parallel=getattr(flags, "data_parallel", 0),
        model_parallel=n,
    )
    mesh.seq_parallel = True
    return mesh


def sp_data_axis(mesh: Mesh) -> str | None:
    """The batch-sharding axis of SP steps: 'data' when the mesh has
    data-parallel replicas, else None (every rank holds the batch)."""
    return pmesh.DATA_AXIS if mesh.dp > 1 else None


def _slab(features: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n, s = mesh.mp, mesh.model_index
    T = features.shape[1] // n
    return features[:, s * T: (s + 1) * T]


def make_sp_forward(model, mesh: Mesh):
    """``features [B, T, F]`` -> the whole logits ``[B, T/2, C]`` on every
    rank of the sequence group, each computing its slab. T must divide by
    ``2 * mesh.mp``."""

    def run(features):
        validate_sp_length(features.shape[1], mesh.mp, model.config)
        local = sp_forward_local(model, _slab(features, mesh), mesh)
        return GatherTime.apply(local, mesh)

    return run


def make_sp_loss_fn(model, mesh: Mesh):
    """batch -> (CTC loss over the data group, logits): ``train/step.py``'s
    loss with the dense forward swapped for the time-sharded one, so the
    masking (padding and CTC-infeasible rows) lives in one place."""
    from speecht_tpu_torch.train.step import make_loss_fn

    forward = make_sp_forward(model, mesh)
    return make_loss_fn(model, mesh, logits_fn=lambda batch: forward(batch.features))


def make_sp_eval_step(model, mesh: Mesh):
    """batch -> (loss, decoded, decoded_lengths) with the conv stack
    sharded over time: ``evaluate --seq-parallel N``."""
    from speecht_tpu_torch.train.step import make_eval_step

    return make_eval_step(model, mesh, loss_fn=make_sp_loss_fn(model, mesh))


def make_sp_train_step(model, tx, mesh: Mesh):
    """(state, batch) -> (state, metrics) on SP gradients: ``train/step.py``'s
    update (clip -> Adam -> lr) with the loss swapped for the SP one."""
    from speecht_tpu_torch.train.step import make_train_step

    return make_train_step(model, tx, mesh, loss_fn=make_sp_loss_fn(model, mesh))
