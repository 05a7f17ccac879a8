"""What every architecture's reference shares: float32 without TF32, the
rounding of the float8 control, and the optimizer written out from its
definition. One copy, so that two architectures' limits are set against
the same optimizer and the same control.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _RoundBoth(torch.autograd.Function):
    """Rounds the value forward and the gradient backward with one rule."""

    @staticmethod
    def forward(ctx, x, rule):
        ctx.rule = rule
        return rule(x.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.rule(g), None


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_quantize(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude at 448,
    e4m3's largest), on the value and on the gradient."""
    return _RoundBoth.apply(x, _fp8_round)


class Adam:
    """clip-by-global-norm -> Adam -> ``-lr`` times the update."""

    def __init__(self, params: dict, config: dict):
        self.cfg = config
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def clip(self, grads: dict) -> dict:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        cap = self.cfg["max_gradient_norm"]
        if float(norm) < cap:
            return dict(grads)
        return {k: g / norm * cap for k, g in grads.items()}

    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        b1, b2 = self.cfg["adam_b1"], self.cfg["adam_b2"]
        eps, lr = self.cfg["adam_epsilon"], self.cfg["learning_rate"]
        clipped = self.clip(grads)
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        with torch.no_grad():
            for k, g in clipped.items():
                self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
                self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
                update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + eps)
                params[k].sub_(lr * update)
        return clipped
