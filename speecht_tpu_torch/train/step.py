"""Train and eval steps.

Counterpart of ``speecht_tpu/train/step.py`` (``make_loss_fn``,
``_apply_grads``, ``make_train_step``, ``init_metrics_acc``,
``init_grad_accum``, ``make_train_step_acc``, ``make_eval_step``,
``make_forward_step``, ``decay_learning_rate``) and of
``training.py::perplexity``.

The JAX eval and forward steps take ``(params, batch)`` and
``(params, features)``; here the module holds its parameters, so they
take the batch or the features alone and run under
``torch.inference_mode()``. The train steps take ``(state, ...)`` as in
JAX; ``state.params`` are the model's own parameters, which the step
updates in place. Nothing in a step reads a value back to the host: loss
and grad-norm sums stay in device tensors, and the gradient-accumulation
counter is a host int (it is known without asking the device, so no
device-side ``cond`` is needed as in JAX). With SpecAugment the masks'
key (optimizer step, micro-batch) is kept on the host too; the step reads
``state.step`` once, at its first call.

Every builder takes an optional ``mesh`` (``parallel/mesh.py``); without
one, or on a ``1 x 1`` mesh, nothing below communicates. On a grid of
ranks:

- the loss all-reduces the masked loss sum and the real-row count over
  the data group and divides once (an average of the ranks' averages is
  wrong when they hold different numbers of real rows);
- the gradients are summed over the data group (over every rank under
  sequence parallelism, whose slabs each give part of a gradient), after
  ``--grad-accum``'s accumulation, once an update. A tensor-parallel
  shard's gradient is its own; a replicated layer's is the same on every
  model rank and is not summed over the model axis;
- the clip's global norm sums the shards' squares over the model group
  and counts each replicated parameter once.

While a profiler records, the train steps mark their stages as spans
(``telemetry.py``): ``step.forward`` (SpecAugment when on, the model, the
CTC loss and the loss totals' all-reduce), ``step.backward`` (the
gradients) and ``step.optimizer`` (the gradients' reduce, the clip, Adam
and the update; once an update under ``--grad-accum``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from speecht_tpu_torch import telemetry
from speecht_tpu_torch.models.wav2letter import Wav2Letter, output_length
from speecht_tpu_torch.ops import ctc_cuda, decode
from speecht_tpu_torch.parallel.mesh import Mesh
from speecht_tpu_torch.train.state import ClipAdam, TrainState


def perplexity(loss: float) -> float:
    return math.exp(loss) if loss < 300 else float("inf")


def make_loss_fn(
    model: Wav2Letter, mesh: Mesh | None = None,
    logits_fn: Callable | None = None,
) -> Callable:
    """batch -> (average CTC loss, logits).

    The average runs over rows that are real (``seq_lengths > 0``; the
    all-zero rows of a padded last batch are not) and CTC-feasible (loss
    below the 1e29 sentinel), divided by ``max(count, 1)``, both summed
    over the mesh's data group: the value is the global average, and the
    gradient this rank's share of it (its own rows' sum over the global
    count), so the gradients summed over the data group are the global
    average's. ``logits_fn`` (batch -> logits) replaces the dense forward,
    as the sequence-parallel loss does.
    """
    mesh = mesh or Mesh()

    def loss_fn(batch):
        logits = logits_fn(batch) if logits_fn else model(batch.features)
        logit_lengths = output_length(batch.seq_lengths)
        # the CUDA alpha kernel on the card, the plain version on the CPU
        losses = ctc_cuda.ctc_loss(
            logits, logit_lengths, batch.labels, batch.label_lengths
        )
        real = (batch.seq_lengths > 0) & (losses < 1e29)
        local = torch.where(real, losses, 0.0).sum()
        totals = torch.stack([local.detach(), real.sum().to(local.dtype)])
        mesh.all_reduce_(totals, "data")
        # the value of the global sum, the gradient of this rank's
        # (the difference is 0 for one rank)
        avg_loss = (local + (totals[0] - local.detach())) / totals[1].clamp(
            min=1
        )
        return avg_loss, logits

    return loss_fn


def make_eval_step(
    model: Wav2Letter, mesh: Mesh | None = None, loss_fn: Callable | None = None
) -> Callable:
    """Returns batch -> (loss, decoded [B, T//2], decoded_lengths [B])."""
    loss_fn = loss_fn or make_loss_fn(model, mesh)

    @torch.inference_mode()
    def eval_step(batch):
        avg_loss, logits = loss_fn(batch)
        decoded, dec_lengths, _scores = decode.greedy_decode(
            logits, output_length(batch.seq_lengths)
        )
        return avg_loss, decoded, dec_lengths

    return eval_step


def make_forward_step(model: Wav2Letter) -> Callable:
    """Returns features [B, T, F] -> logits [B, T//2, C] float32 (the
    model's forward alone: streaming ``record`` and the serving export)."""

    @torch.inference_mode()
    def forward(features):
        return model(features)

    return forward


def make_audio_loss_fn(
    model: Wav2Letter, front_end: Callable, mesh: Mesh | None = None
) -> Callable:
    """AudioBatch -> (average CTC loss, logits, logit_lengths): the
    ``--from-audio`` twin of :func:`make_loss_fn`, with ``front_end``
    (``features_device.make_front_end``) ahead of the model; the loss sum
    and the real-row count are summed over the mesh's data group, so the
    value is the global average (evaluate only: no gradient).

    A padding row's features are NaN (0/0 in the masked normalisation), so
    its loss is NaN: the mask is a ``where``, never a multiply (NaN * 0 is
    NaN).
    """
    mesh = mesh or Mesh()

    def loss_fn(batch):
        feats, frame_lengths = front_end(batch.audio, batch.num_samples)
        logits = model(feats)
        logit_lengths = output_length(frame_lengths)
        losses = ctc_cuda.ctc_loss(
            logits, logit_lengths, batch.labels, batch.label_lengths
        )
        real = (batch.num_samples > 0) & (losses < 1e29)
        local = torch.where(real, losses, 0.0).sum()
        totals = mesh.all_reduce_(
            torch.stack([local, real.sum().to(local.dtype)]), "data"
        )
        return totals[0] / totals[1].clamp(min=1), logits, logit_lengths

    return loss_fn


def make_audio_eval_step(
    model: Wav2Letter, front_end: Callable, mesh: Mesh | None = None
) -> Callable:
    """AudioBatch -> (loss, decoded [B, T//2], decoded_lengths [B]); the
    decoded lengths of padding rows are 0."""
    loss_fn = make_audio_loss_fn(model, front_end, mesh)

    @torch.inference_mode()
    def eval_step(batch):
        avg_loss, logits, logit_lengths = loss_fn(batch)
        decoded, dec_lengths, _scores = decode.greedy_decode(
            logits, logit_lengths
        )
        dec_lengths = torch.where(batch.num_samples > 0, dec_lengths, 0)
        return avg_loss, decoded, dec_lengths

    return eval_step


def _make_grad_fn(model: Wav2Letter, mesh: Mesh | None, loss_fn=None) -> Callable:
    """(params, batch) -> (this rank's grads by name, average loss), loss
    detached."""
    loss_fn = loss_fn or make_loss_fn(model, mesh)

    def grad_fn(params, batch):
        with torch.enable_grad():
            with telemetry.span("step.forward"):
                avg_loss, _logits = loss_fn(batch)
            with telemetry.span("step.backward"):
                grads = torch.autograd.grad(avg_loss, list(params.values()))
        return dict(zip(params, grads)), avg_loss.detach()

    return grad_fn


def _reduce_grads(grads: dict, mesh: Mesh) -> dict:
    """Sums this rank's gradients over the data group (every rank under
    sequence parallelism), in one float32 bucket."""
    axis = "world" if mesh.seq_parallel else "data"
    if mesh.group(axis) is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    mesh.all_reduce_(flat, axis)
    out, at = {}, 0
    for name, g in grads.items():
        out[name] = flat[at: at + g.numel()].view_as(g)
        at += g.numel()
    return out


def _grad_norm(grads: dict, model: Wav2Letter, mesh: Mesh):
    """The global norm of the whole model's gradient: the tensor-parallel
    shards' squares summed over the model group, the replicated
    parameters counted once. None for an unsplit model (the optimizer
    computes it)."""
    split = model.split.dims
    if not split or mesh.model_group is None:
        return None
    sharded = torch.stack([torch.sum(grads[n] * grads[n]) for n in split]).sum()
    mesh.all_reduce_(sharded, "model")
    replicated = sum(torch.sum(g * g) for n, g in grads.items() if n not in split)
    return torch.sqrt(replicated + sharded)


def _apply_grads(state: TrainState, grads, tx: ClipAdam, norm=None):
    """clip -> Adam -> lr-scaled update on a (possibly accumulated) grad.

    ``norm`` is the gradient's global norm when the optimizer cannot see
    the whole gradient (tensor parallelism). Returns (new state, global
    norm of ``grads`` before the clip).
    """
    updates, opt_state, grad_norm = tx.update(grads, state.opt_state, norm)
    # the learning rate multiplies *after* clip+Adam, so the plateau decay
    # needs no optimizer rebuild
    with torch.no_grad():
        for name, p in state.params.items():
            p.add_(-state.learning_rate * updates[name])
    new_state = TrainState(
        params=state.params,
        opt_state=opt_state,
        step=state.step + 1,
        learning_rate=state.learning_rate,
    )
    return new_state, grad_norm


def _reduce_and_apply(state: TrainState, grads, tx: ClipAdam, model, mesh):
    with telemetry.span("step.optimizer"):
        grads = _reduce_grads(grads, mesh)
        return _apply_grads(state, grads, tx, _grad_norm(grads, model, mesh))


def _make_update_fn(model: Wav2Letter, tx: ClipAdam, mesh: Mesh, loss_fn=None):
    grad_fn = _make_grad_fn(model, mesh, loss_fn)

    def update(state: TrainState, batch):
        grads, avg_loss = grad_fn(state.params, batch)
        new_state, grad_norm = _reduce_and_apply(state, grads, tx, model, mesh)
        return new_state, avg_loss, grad_norm

    return update


def make_train_step(
    model: Wav2Letter, tx: ClipAdam, mesh: Mesh | None = None,
    loss_fn: Callable | None = None,
) -> Callable:
    """Returns (state, batch) -> (state, metrics); updates in place.
    ``loss_fn`` replaces :func:`make_loss_fn`'s (the sequence-parallel
    loss)."""
    update = _make_update_fn(model, tx, mesh or Mesh(), loss_fn)

    def train_step(state: TrainState, batch):
        learning_rate = state.learning_rate
        new_state, avg_loss, grad_norm = update(state, batch)
        metrics = {
            "loss": avg_loss,
            "grad_norm": grad_norm,
            "learning_rate": learning_rate,
        }
        return new_state, metrics

    return train_step


def init_metrics_acc(device=None) -> dict:
    """Device-resident running metrics for the accumulating train step.

    ``count`` counts micro-batches; ``updates`` counts optimizer applies
    (equal unless gradient accumulation is on: grad norms average over
    ``updates``, losses over ``count``). ``micro`` is ``count`` kept on
    the host, the SpecAugment key's micro-batch index.
    """
    acc = {
        k: torch.zeros((), dtype=torch.float32, device=device)
        for k in ("loss_sum", "grad_norm_sum", "count", "updates")
    }
    acc["micro"] = 0
    return acc


def _fold_metrics(acc, avg_loss, grad_norm, applied):
    return {
        "loss_sum": acc["loss_sum"] + avg_loss,
        "grad_norm_sum": acc["grad_norm_sum"] + grad_norm,
        "count": acc["count"] + 1.0,
        "updates": acc["updates"] + applied,
        "micro": acc["micro"] + 1,
    }


class _AugmentKey:
    """The SpecAugment key's optimizer step, kept on the host: read from
    ``state.step`` once, at the first call, then counted as applies run,
    so the step reads nothing back after it has started."""

    def __init__(self):
        self.step = None

    def __call__(self, state: TrainState) -> int:
        if self.step is None:
            self.step = int(state.step)
        return self.step

    def applied(self) -> None:
        """One optimizer apply ran."""
        if self.step is not None:
            self.step += 1


def init_grad_accum(params: dict[str, torch.Tensor]) -> dict:
    """Zeroed gradient-accumulation carry for ``accum_steps > 1``."""
    return {"gsum": {k: torch.zeros_like(p) for k, p in params.items()}, "k": 0}


def make_train_step_acc(
    model: Wav2Letter, tx: ClipAdam, accum_steps: int = 1, augment_fn=None,
    mesh: Mesh | None = None, loss_fn: Callable | None = None,
) -> Callable:
    """Accumulating train step: (state, acc, batch) -> (state, acc).

    With ``accum_steps`` G > 1 the signature becomes ``(state, gacc, acc,
    batch) -> (state, gacc, acc)``, ``gacc`` being :func:`init_grad_accum`'s
    carry: each micro-batch's gradients fold into ``gsum`` and the
    clip -> Adam -> lr update applies once per G micro-batches on the
    G-averaged gradient (the big-batch update). Loss and grad-norm fold
    into ``acc`` (:func:`init_metrics_acc`), which the training loop reads
    once per ``steps_per_checkpoint``.

    ``augment_fn`` (``ops/augment.py::make_augment_fn``) transforms each
    micro-batch before the loss, keyed on the optimizer step and the
    micro-batch index of the metrics window, as in JAX; both keys are host
    integers (:class:`_AugmentKey`, ``acc["micro"]``). ``mesh`` and
    ``loss_fn`` as in :func:`make_train_step`; the gradients are reduced
    over the ranks once an update, after the accumulation.
    """
    mesh = mesh or Mesh()
    key = _AugmentKey()

    def augment(state, acc, batch):
        if augment_fn is None:
            return batch
        with telemetry.span("step.forward"):
            return augment_fn(batch, key(state), acc["micro"])

    if accum_steps <= 1:
        update = _make_update_fn(model, tx, mesh, loss_fn)

        def train_step(state: TrainState, acc, batch):
            batch = augment(state, acc, batch)
            new_state, avg_loss, grad_norm = update(state, batch)
            key.applied()
            return new_state, _fold_metrics(acc, avg_loss, grad_norm, 1.0)

        return train_step

    grad_fn = _make_grad_fn(model, mesh, loss_fn)
    g = float(accum_steps)

    def train_step_accum(state: TrainState, gacc, acc, batch):
        batch = augment(state, acc, batch)
        grads, avg_loss = grad_fn(state.params, batch)
        gsum = {k: gacc["gsum"][k] + grads[k] for k in grads}
        k = gacc["k"] + 1
        grad_norm, applied = 0.0, 0.0
        if k >= accum_steps:
            gavg = {name: x / g for name, x in gsum.items()}
            state, grad_norm = _reduce_and_apply(state, gavg, tx, model, mesh)
            gsum = {name: torch.zeros_like(x) for name, x in gsum.items()}
            k, applied = 0, 1.0
            key.applied()
        return state, {"gsum": gsum, "k": k}, _fold_metrics(
            acc, avg_loss, grad_norm, applied
        )

    return train_step_accum


def decay_learning_rate(state: TrainState, factor: float) -> TrainState:
    """Plateau decay: lr <- lr * factor, on the device."""
    return dataclasses.replace(
        state, learning_rate=state.learning_rate * torch.tensor(
            factor, dtype=torch.float32, device=state.learning_rate.device
        )
    )
