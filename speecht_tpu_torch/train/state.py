"""Train state and optimizer: clip-by-global-norm, then Adam.

Counterpart of ``speecht_tpu/train/state.py`` (``TrainState``,
``make_optimizer``, ``create_train_state``), with the arithmetic of the
optax chain ``clip_by_global_norm(max_norm)`` -> ``scale_by_adam(b1, b2,
eps, eps_root=0)`` written out:

- clip: ``g`` is kept when ``||g|| < max_norm``, else ``g / ||g|| *
  max_norm``. (``torch.nn.utils.clip_grad_norm_`` divides by ``norm +
  1e-6`` and clips at equality, so it is not used.)
- Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  ``count += 1``, ``u = mu_hat / (sqrt(nu_hat) + eps)`` with the bias
  corrections ``1 - b^count`` in float32.

The learning rate is not part of the optimizer: the train step multiplies
the update by ``-learning_rate`` afterwards, so the plateau decay only
changes the state's ``learning_rate`` tensor.

Parameters are the model's own ``nn.Parameter`` tensors, held by name;
the step updates them in place (JAX donates and replaces the buffers).
Every tensor, the counters included, stays on the model's device, so a
step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the moments and the apply count."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: torch.Tensor  # int32 scalar


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: AdamState
    step: torch.Tensor  # int32 scalar: optimizer applies
    learning_rate: torch.Tensor  # float32 scalar, mutable via plateau decay


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tree.values()))


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """clip-by-global-norm -> Adam moments (lr applied in the train step)."""

    max_gradient_norm: float = 5.0
    eps: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(
        self, grads: dict[str, torch.Tensor], state: AdamState
    ) -> tuple[dict[str, torch.Tensor], AdamState, torch.Tensor]:
        """(grads, state) -> (updates, new state, norm of ``grads``).

        The first two are optax's ``tx.update``; the third is the global
        norm before the clip, which the clip computes and the train step
        reports as ``grad_norm``.
        """
        g_norm = global_norm(grads)
        trigger = g_norm < self.max_gradient_norm
        grads = {
            k: torch.where(trigger, g, (g / g_norm) * self.max_gradient_norm)
            for k, g in grads.items()
        }
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
        updates = {
            k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps) for k in grads
        }
        return updates, AdamState(mu=mu, nu=nu, count=count.to(torch.int32)), g_norm


def make_optimizer(
    max_gradient_norm: float = 5.0,
    epsilon: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
) -> ClipAdam:
    return ClipAdam(max_gradient_norm=max_gradient_norm, eps=epsilon, b1=b1, b2=b2)


def create_train_state(
    params: dict[str, torch.Tensor], tx: ClipAdam, learning_rate: float
) -> TrainState:
    device = next(iter(params.values())).device
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        step=torch.zeros((), dtype=torch.int32, device=device),
        learning_rate=torch.tensor(learning_rate, dtype=torch.float32, device=device),
    )
