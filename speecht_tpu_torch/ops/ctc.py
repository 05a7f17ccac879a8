"""CTC loss and its gradient in plain PyTorch.

Counterpart of ``speecht_tpu/ops/ctc.py`` (``_extend_labels``,
``_transition_masks``, ``ctc_alpha``, ``_final_log_prob``, ``ctc_beta``,
``_posterior_grad``, the custom VJP ``_core_fwd``/``_core_bwd``,
``ctc_loss`` and ``ctc_loss_autodiff``). This is the plain version of the
CUDA kernels in ``csrc/ctc_alpha.cu`` (forward) and ``csrc/ctc_beta.cu``
(backward): the CPU path, and what ``chip_smoke.py`` holds the kernels
against on the card. Semantics are TF's defaults: softmax applied
internally (in float32), repeats separated by blank, per-example loss =
total negative log probability, blank = ``vocabulary.BLANK_ID``.

The gradient goes to the logits through :class:`CtcLossFunction`, as the
JAX custom VJP computes it: ``g * (softmax - scatter(posteriors))``,
masked to ``t < logit_length``, with the posteriors from the alpha and
beta recursions. Autograd through a separate ``log_softmax`` would give
``dlogp - softmax * sum(dlogp)`` instead, which rounds differently
wherever the posteriors do not sum to exactly 1; that route is
:func:`ctc_loss_autodiff`, the testing reference.

The arithmetic keeps the JAX package's ``NEG_INF = -1e30`` sentinel rather
than ``-inf``: a CTC-infeasible row (label longer than its frames can
emit) comes out at about ``1e30``, which the loss mask filters with
``loss < 1e29``; with ``-inf`` the log-sum-exp would give ``inf - inf =
NaN``. Alpha is frozen for ``t >= logit_length``, and ``alpha[0]`` is set
from frame 0 even for a row whose ``logit_length`` is 0. Beta does not
clamp its running max (as in JAX), so an infeasible row's posteriors stay
finite; its cotangent is 0 (the loss mask drops it), so its gradient is
exactly 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speecht_tpu_torch import vocabulary

NEG_INF = -1e30


def _extend_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, L] labels -> [B, 2L+1] blank-interleaved extended labels.

    ext[:, 0::2] = blank, ext[:, 1::2] = labels. PAD positions keep blank.
    """
    B, L = labels.shape
    ext = torch.full(
        (B, 2 * L + 1), blank_id, dtype=torch.int64, device=labels.device
    )
    safe = torch.where(labels == vocabulary.PAD_ID, blank_id, labels)
    ext[:, 1::2] = safe.long()
    return ext


def _transition_masks(ext: torch.Tensor, blank_id: int) -> torch.Tensor:
    """allow_skip[b, s]: alpha may come from s-2 (distinct non-blank labels)."""
    skip_src = F.pad(ext[:, :-2], (2, 0), value=blank_id)
    s = torch.arange(ext.shape[1], device=ext.device)[None, :]
    return (ext != blank_id) & (ext != skip_src) & (s >= 2)


def _logsumexp3(a, b, c):
    stacked = torch.stack([a, b, c])
    m = stacked.max(dim=0).values.clamp(min=NEG_INF)
    return m + torch.log(torch.exp(stacked - m).sum(dim=0))


def ctc_alpha(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    ext: torch.Tensor,
    allow_skip: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward recursion. Returns (alpha [T, B, S], alpha at the end [B, S]).

    alpha[t, b, s] = log P(prefix of paths ending in state s at time t),
    frozen (carried) for t >= logit_lengths[b].
    """
    B, T, _C = log_probs.shape
    emit = torch.gather(
        log_probs, 2, ext[:, None, :].expand(B, T, ext.shape[1])
    ).transpose(0, 1)  # [T, B, S]

    alpha = torch.full_like(emit[0], NEG_INF)
    alpha[:, :2] = emit[0, :, :2]
    alphas = [alpha]
    for t in range(1, T):
        prev1 = F.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        prev2 = F.pad(alpha[:, :-2], (2, 0), value=NEG_INF)
        prev2 = torch.where(allow_skip, prev2, NEG_INF)
        new_alpha = _logsumexp3(alpha, prev1, prev2) + emit[t]
        active = (t < logit_lengths)[:, None]
        alpha = torch.where(active, new_alpha, alpha)
        alphas.append(alpha)
    return torch.stack(alphas), alpha


def _final_log_prob(
    alpha_last: torch.Tensor, label_lengths: torch.Tensor
) -> torch.Tensor:
    """logsumexp of the two terminal states s = 2L and s = 2L-1."""
    s_last = (2 * label_lengths).long()[:, None]
    a1 = alpha_last.gather(1, s_last)[:, 0]
    a2 = alpha_last.gather(1, (s_last - 1).clamp(min=0))[:, 0]
    a2 = torch.where(label_lengths > 0, a2, NEG_INF)
    m = torch.maximum(a1, a2)
    return m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m))


def ctc_loss_log_probs(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Per-example CTC loss from log-probs [B, T, C]: the kernel's function."""
    ext = _extend_labels(labels, vocabulary.BLANK_ID)
    allow_skip = _transition_masks(ext, vocabulary.BLANK_ID)
    _alphas, alpha_last = ctc_alpha(log_probs, logit_lengths, ext, allow_skip)
    return -_final_log_prob(alpha_last, label_lengths)


def ctc_beta(
    log_probs_ext: torch.Tensor,
    logit_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    allow_skip: torch.Tensor,
) -> torch.Tensor:
    """Backward recursion. Returns beta [T, B, S].

    beta[t, b, s] = log P(suffix of paths from state s at time t),
    *excluding* the emission at t (so alpha + beta = total path logprob).
    ``log_probs_ext`` is the emission of each state, [T, B, S]. Positions
    t >= logit_lengths[b] - 1 hold the terminal condition.
    """
    T, B, S = log_probs_ext.shape
    s_idx = torch.arange(S, device=log_probs_ext.device)[None, :]
    s_last = (2 * label_lengths).long()[:, None]
    beta_end = torch.where(
        (s_idx == s_last) | ((s_idx == s_last - 1) & (label_lengths[:, None] > 0)),
        0.0,
        NEG_INF,
    ).to(log_probs_ext.dtype)
    skip_ok = F.pad(allow_skip[:, 2:], (0, 2), value=False)

    beta = beta_end
    betas = [beta]
    for t in range(T - 2, -1, -1):
        val = beta + log_probs_ext[t + 1]
        nxt1 = F.pad(val[:, 1:], (0, 1), value=NEG_INF)
        nxt2 = F.pad(val[:, 2:], (0, 2), value=NEG_INF)
        nxt2 = torch.where(skip_ok, nxt2, NEG_INF)
        stacked = torch.stack([val, nxt1, nxt2])
        m = stacked.max(dim=0).values
        lse = m + torch.log(torch.exp(stacked - m).sum(dim=0))
        # at t == T_b - 1 the terminal condition (re)starts the recursion;
        # for t > T_b - 1 beta stays at the terminal condition
        at_or_past_end = (t >= logit_lengths - 1)[:, None]
        beta = torch.where(at_or_past_end, beta_end, lse)
        betas.append(beta)
    return torch.stack(betas[::-1])


def _posterior_grad(
    log_probs: torch.Tensor,
    logit_lengths: torch.Tensor,
    ext: torch.Tensor,
    allow_skip: torch.Tensor,
    label_lengths: torch.Tensor,
    alphas: torch.Tensor,
    log_p: torch.Tensor,
) -> torch.Tensor:
    """dL/dlogits [B, T, C] for L = -log p, via state posteriors.

    grad[b, t, c] = softmax[b, t, c] - sum_{s: ext[s]=c} P(state s at t | x)
    for t < T_b, else 0.
    """
    B, T, C = log_probs.shape
    S = ext.shape[1]
    emit = torch.gather(
        log_probs, 2, ext[:, None, :].expand(B, T, S)
    ).transpose(0, 1)  # [T, B, S]
    betas = ctc_beta(emit, logit_lengths, label_lengths, allow_skip)
    # alpha includes the emission at t and beta excludes it, so their sum
    # counts it exactly once
    post = torch.exp(alphas + betas - log_p[None, :, None])  # [T, B, S]
    # scatter the states' posteriors onto their classes (exact sums; JAX
    # uses a one-hot einsum at HIGHEST precision for the same values)
    post_c = torch.zeros_like(log_probs).scatter_add_(
        2, ext[:, None, :].expand(B, T, S), post.transpose(0, 1)
    )
    valid = torch.arange(T, device=log_probs.device)[None, :, None] < (
        logit_lengths[:, None, None]
    )
    return torch.where(valid, torch.exp(log_probs) - post_c, 0.0)


def _ctc_forward(logits, logit_lengths, labels, label_lengths):
    # float32 at least; float64 logits stay float64 (a testing reference)
    dtype = torch.promote_types(logits.dtype, torch.float32)
    log_probs = torch.log_softmax(logits.to(dtype), dim=-1)
    ext = _extend_labels(labels, vocabulary.BLANK_ID)
    allow_skip = _transition_masks(ext, vocabulary.BLANK_ID)
    alphas, alpha_last = ctc_alpha(log_probs, logit_lengths, ext, allow_skip)
    log_p = _final_log_prob(alpha_last, label_lengths)
    return -log_p, (log_probs, alphas, ext, allow_skip, log_p)


class CtcLossFunction(torch.autograd.Function):
    """Per-example CTC loss whose backward is :func:`_posterior_grad`.

    The counterpart of JAX's ``_ctc_loss_core`` custom VJP: forward saves
    the log-probs and the alpha history, backward runs the beta recursion
    and returns ``_posterior_grad * g[:, None, None]`` for the logits.
    """

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths):
        loss, (log_probs, alphas, ext, allow_skip, log_p) = _ctc_forward(
            logits, logit_lengths, labels, label_lengths
        )
        ctx.save_for_backward(
            log_probs, alphas, ext, allow_skip, log_p, logit_lengths,
            label_lengths,
        )
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        (log_probs, alphas, ext, allow_skip, log_p, logit_lengths,
         label_lengths) = ctx.saved_tensors
        dlogits = _posterior_grad(
            log_probs, logit_lengths, ext, allow_skip, label_lengths, alphas,
            log_p,
        )
        dlogits = dlogits * g[:, None, None]
        return dlogits.to(ctx.logits_dtype), None, None, None


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Per-example CTC loss (total -log p), blank = vocabulary.BLANK_ID.

    Args:
      logits: [B, T, C] unnormalised scores (log-softmax applied here).
      logit_lengths: [B] valid frames per example.
      labels: [B, L] dense label ids padded with vocabulary.PAD_ID.
      label_lengths: [B] valid labels per example.

    Returns:
      [B] float32 losses; about 1e30 for an infeasible row. Differentiable
      in ``logits`` through :class:`CtcLossFunction`.
    """
    return CtcLossFunction.apply(
        logits,
        logit_lengths.to(torch.int32),
        labels.to(torch.int32),
        label_lengths.to(torch.int32),
    )


def ctc_loss_autodiff(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Loss via plain autograd through the forward scan (testing reference).

    Float64 logits run the whole scan in float64: the reference that both
    float32 gradients are held against.
    """
    loss, _ = _ctc_forward(
        logits,
        logit_lengths.to(torch.int32),
        labels.to(torch.int32),
        label_lengths.to(torch.int32),
    )
    return loss
