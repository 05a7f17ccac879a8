"""Train and eval steps.

Counterpart of ``speecht_tpu/train/step.py`` (``make_loss_fn``,
``_apply_grads``, ``make_train_step``, ``init_metrics_acc``,
``init_grad_accum``, ``make_train_step_acc``, ``make_eval_step``,
``decay_learning_rate``) and of ``training.py::perplexity``.

The JAX eval step takes ``(params, batch)``; here the module holds its
parameters, so it takes the batch alone and runs under
``torch.inference_mode()``. The train steps take ``(state, ...)`` as in
JAX; ``state.params`` are the model's own parameters, which the step
updates in place. Nothing in a step reads a value back to the host: loss
and grad-norm sums stay in device tensors, and the gradient-accumulation
counter is a host int (it is known without asking the device, so no
device-side ``cond`` is needed as in JAX).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from speecht_tpu_torch.models.wav2letter import Wav2Letter, output_length
from speecht_tpu_torch.ops import ctc_cuda, decode
from speecht_tpu_torch.train.state import ClipAdam, TrainState


def perplexity(loss: float) -> float:
    return math.exp(loss) if loss < 300 else float("inf")


def make_loss_fn(model: Wav2Letter) -> Callable:
    """batch -> (average CTC loss, logits).

    The average runs over rows that are real (``seq_lengths > 0``; the
    all-zero rows of a padded last batch are not) and CTC-feasible (loss
    below the 1e29 sentinel), divided by ``max(count, 1)``.
    """

    def loss_fn(batch):
        logits = model(batch.features)
        logit_lengths = output_length(batch.seq_lengths)
        # the CUDA alpha kernel on the card, the plain version on the CPU
        losses = ctc_cuda.ctc_loss(
            logits, logit_lengths, batch.labels, batch.label_lengths
        )
        real = (batch.seq_lengths > 0) & (losses < 1e29)
        avg_loss = torch.where(real, losses, 0.0).sum() / real.sum().clamp(
            min=1
        )
        return avg_loss, logits

    return loss_fn


def make_eval_step(model: Wav2Letter) -> Callable:
    """Returns batch -> (loss, decoded [B, T//2], decoded_lengths [B])."""
    loss_fn = make_loss_fn(model)

    @torch.inference_mode()
    def eval_step(batch):
        avg_loss, logits = loss_fn(batch)
        decoded, dec_lengths, _scores = decode.greedy_decode(
            logits, output_length(batch.seq_lengths)
        )
        return avg_loss, decoded, dec_lengths

    return eval_step


def _make_grad_fn(model: Wav2Letter) -> Callable:
    """(params, batch) -> (grads by name, average loss), loss detached."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        with torch.enable_grad():
            avg_loss, _logits = loss_fn(batch)
            grads = torch.autograd.grad(avg_loss, list(params.values()))
        return dict(zip(params, grads)), avg_loss.detach()

    return grad_fn


def _apply_grads(state: TrainState, grads, tx: ClipAdam):
    """clip -> Adam -> lr-scaled update on a (possibly accumulated) grad.

    Returns (new state, global norm of ``grads`` before the clip).
    """
    updates, opt_state, grad_norm = tx.update(grads, state.opt_state)
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


def _make_update_fn(model: Wav2Letter, tx: ClipAdam):
    grad_fn = _make_grad_fn(model)

    def update(state: TrainState, batch):
        grads, avg_loss = grad_fn(state.params, batch)
        new_state, grad_norm = _apply_grads(state, grads, tx)
        return new_state, avg_loss, grad_norm

    return update


def make_train_step(model: Wav2Letter, tx: ClipAdam) -> Callable:
    """Returns (state, batch) -> (state, metrics); updates in place."""
    update = _make_update_fn(model, tx)

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


def init_metrics_acc(device=None) -> dict[str, torch.Tensor]:
    """Device-resident running metrics for the accumulating train step.

    ``count`` counts micro-batches; ``updates`` counts optimizer applies
    (equal unless gradient accumulation is on: grad norms average over
    ``updates``, losses over ``count``).
    """
    return {
        k: torch.zeros((), dtype=torch.float32, device=device)
        for k in ("loss_sum", "grad_norm_sum", "count", "updates")
    }


def init_grad_accum(params: dict[str, torch.Tensor]) -> dict:
    """Zeroed gradient-accumulation carry for ``accum_steps > 1``."""
    return {"gsum": {k: torch.zeros_like(p) for k, p in params.items()}, "k": 0}


def make_train_step_acc(
    model: Wav2Letter, tx: ClipAdam, accum_steps: int = 1
) -> Callable:
    """Accumulating train step: (state, acc, batch) -> (state, acc).

    With ``accum_steps`` G > 1 the signature becomes ``(state, gacc, acc,
    batch) -> (state, gacc, acc)``, ``gacc`` being :func:`init_grad_accum`'s
    carry: each micro-batch's gradients fold into ``gsum`` and the
    clip -> Adam -> lr update applies once per G micro-batches on the
    G-averaged gradient (the big-batch update). Loss and grad-norm fold
    into ``acc`` (:func:`init_metrics_acc`), which the training loop reads
    once per ``steps_per_checkpoint``.
    """
    if accum_steps <= 1:
        update = _make_update_fn(model, tx)

        def train_step(state: TrainState, acc, batch):
            new_state, avg_loss, grad_norm = update(state, batch)
            acc = {
                "loss_sum": acc["loss_sum"] + avg_loss,
                "grad_norm_sum": acc["grad_norm_sum"] + grad_norm,
                "count": acc["count"] + 1.0,
                "updates": acc["updates"] + 1.0,
            }
            return new_state, acc

        return train_step

    grad_fn = _make_grad_fn(model)
    g = float(accum_steps)

    def train_step_accum(state: TrainState, gacc, acc, batch):
        grads, avg_loss = grad_fn(state.params, batch)
        gsum = {k: gacc["gsum"][k] + grads[k] for k in grads}
        k = gacc["k"] + 1
        grad_norm, applied = 0.0, 0.0
        if k >= accum_steps:
            gavg = {name: x / g for name, x in gsum.items()}
            state, grad_norm = _apply_grads(state, gavg, tx)
            gsum = {name: torch.zeros_like(x) for name, x in gsum.items()}
            k, applied = 0, 1.0
        acc = {
            "loss_sum": acc["loss_sum"] + avg_loss,
            "grad_norm_sum": acc["grad_norm_sum"] + grad_norm,
            "count": acc["count"] + 1.0,
            "updates": acc["updates"] + applied,
        }
        return state, {"gsum": gsum, "k": k}, acc

    return train_step_accum


def decay_learning_rate(state: TrainState, factor: float) -> TrainState:
    """Plateau decay: lr <- lr * factor, on the device."""
    return dataclasses.replace(
        state, learning_rate=state.learning_rate * torch.tensor(
            factor, dtype=torch.float32, device=state.learning_rate.device
        )
    )
