"""The gradient of the port's CTC loss against the JAX package's.

The same numpy inputs and a non-uniform cotangent ``g`` (0 on the
infeasible row, as the loss mask makes it) go through:

- the port's plain autograd Function (speecht_tpu_torch/ops/ctc.py,
  ``CtcLossFunction``), and
- ``jax.vjp`` of the XLA scan (speecht_tpu.ops.ctc.ctc_loss) and of the
  Pallas kernel under the Mosaic interpreter (ctc_pallas.ctc_loss_pallas),
  as tests/test_ctc_pallas.py runs it.

Tolerance rtol 1e-4 / atol 1e-5: the one tests/test_ctc_pallas.py uses
between its two float32 gradient implementations (the posteriors are
exp(alpha + beta - logP), so a rounding of the log-space sums shows up
relatively in the gradient). The beta recursion alone is held to rtol
1e-5 / atol 1e-4, as the alpha history is in tests/test_torch_ctc.py. The
CUDA kernel runs only on the card: tests/test_torch_ctc_cuda.py.

The float64 witness holds the Function and float32 autodiff each against
autodiff in float64, entry by entry: a posterior exp(alpha + beta - logP)
carries the rounding of its exponent, two random walks of at most T
float32 roundings of at most ulp(|logP|)/2 each, so an entry may be off by
its posterior mass times 3 sqrt(T) ulp(|logP|) (about 7 standard
deviations) plus 1e-5 for the float32 softmax. chip_smoke.py applies the
same bound on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speecht_tpu import vocabulary as jvocab
from speecht_tpu.ops import ctc as jctc
from speecht_tpu.ops import ctc_pallas
from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.ops import ctc, ctc_cuda

RTOL, ATOL = 1e-4, 1e-5
BETA_RTOL, BETA_ATOL = 1e-5, 1e-4


def _base(seed, B, T, L):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, vocabulary.NUM_CLASSES).astype(np.float32)
    labels = np.full((B, L), vocabulary.PAD_ID, dtype=np.int32)
    label_lengths = rng.randint(1, L + 1, size=B).astype(np.int32)
    for b in range(B):
        labels[b, : label_lengths[b]] = rng.randint(0, 28, size=label_lengths[b])
    logit_lengths = rng.randint(2 * L, T + 1, size=B).astype(np.int32)
    return logits, logit_lengths, labels, label_lengths


def _case(name):
    """(logits, logit_lengths, labels, label_lengths, g) as numpy."""
    if name == "ragged":
        args = _base(0, B=5, T=70, L=4)
    elif name == "odd_time":
        args = _base(1, B=3, T=33, L=5)
    else:
        args = _base(2, B=4, T=41, L=6)
    logits, logit_lengths, labels, label_lengths = args
    if name == "empty_label":
        labels[0] = vocabulary.PAD_ID
        label_lengths[0] = 0
    elif name == "infeasible":
        labels[1, :4] = 3
        labels[1, 4:] = vocabulary.PAD_ID
        label_lengths[1] = 4
        logit_lengths[1] = 5
    elif name == "zero_length":
        logit_lengths[2] = 0
    elif name == "repeats":
        labels[0, :6] = [4, 4, 4, 9, 9, 4]
        label_lengths[0] = 6
        logit_lengths[0] = 41
    g = np.random.RandomState(7).uniform(0.2, 2.0, size=len(logits))
    g = g.astype(np.float32)
    if name == "infeasible":
        g[1] = 0.0
    return logits, logit_lengths, labels, label_lengths, g


CASES = ["ragged", "odd_time", "empty_label", "infeasible", "zero_length",
         "repeats"]


def _torch_grad(fn, args):
    logits, logit_lengths, labels, label_lengths, g = (
        torch.from_numpy(a) for a in args
    )
    logits.requires_grad_(True)
    loss = fn(logits, logit_lengths, labels, label_lengths)
    (dlogits,) = torch.autograd.grad(loss, logits, grad_outputs=g)
    return loss.detach().numpy(), dlogits.numpy()


def _jax_grad(fn, args):
    logits, logit_lengths, labels, label_lengths, g = (jnp.asarray(a) for a in args)
    loss, vjp = jax.vjp(
        lambda x: fn(x, logit_lengths, labels, label_lengths), logits
    )
    return np.asarray(loss), np.asarray(vjp(g)[0])


@pytest.mark.parametrize("name", CASES)
def test_dlogits_match_jax_scan(name):
    args = _case(name)
    loss_ref, grad_ref = _jax_grad(jctc.ctc_loss, args)
    loss, grad = _torch_grad(ctc.ctc_loss, args)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grad, grad_ref, rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(grad))
    logit_lengths, g = args[1], args[4]
    for b in range(len(g)):
        assert not grad[b, logit_lengths[b]:].any()  # masked frames
        if g[b] == 0.0:
            assert not grad[b].any()  # the infeasible row: exactly 0


@pytest.mark.parametrize("name", CASES)
def test_dlogits_match_pallas_interpret(name):
    args = _case(name)
    with pltpu.force_tpu_interpret_mode():
        _loss, grad_ref = _jax_grad(ctc_pallas.ctc_loss_pallas, args)
    _loss, grad = _torch_grad(ctc.ctc_loss, args)
    np.testing.assert_allclose(grad, grad_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ragged", "repeats", "zero_length"])
def test_function_matches_autodiff(name):
    """The posterior gradient against autograd through the forward scan
    (the port's own testing reference, as ctc_loss_autodiff is in JAX)."""
    args = _case(name)
    loss_f, grad_f = _torch_grad(ctc.ctc_loss, args)
    loss_a, grad_a = _torch_grad(ctc.ctc_loss_autodiff, args)
    np.testing.assert_array_equal(loss_f, loss_a)
    np.testing.assert_allclose(grad_f, grad_a, rtol=RTOL, atol=ATOL)


def _long_case():
    """Labels of 60-150 letters over 300-400 frames: |logP| near 1000."""
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 400, vocabulary.NUM_CLASSES).astype(np.float32) * 2.0
    label_lengths = rng.randint(60, 151, size=3).astype(np.int32)
    labels = np.full((3, 150), vocabulary.PAD_ID, dtype=np.int32)
    for b, n in enumerate(label_lengths):
        labels[b, :n] = rng.randint(0, 28, size=n)
    logit_lengths = rng.randint(300, 401, size=3).astype(np.int32)
    g = rng.uniform(0.5, 1.5, size=3).astype(np.float32)
    return logits, logit_lengths, labels, label_lengths, g


@pytest.mark.parametrize("name", ["long", "ragged", "repeats", "infeasible",
                                  "zero_length"])
def test_grads_within_float32_rounding_of_float64(name):
    args = _long_case() if name == "long" else _case(name)
    logits64 = torch.from_numpy(args[0]).double()
    g64 = torch.from_numpy(args[4]).double()
    loss64, ref = _torch_grad(ctc.ctc_loss_autodiff, (logits64.numpy(),) + args[1:4]
                              + (g64.numpy(),))
    assert ref.dtype == np.float64
    feasible = loss64 < 1e29
    ulp = np.where(feasible, np.spacing(
        np.abs(np.where(feasible, loss64, 0.0)).astype(np.float32)), 0.0)
    delta = 3.0 * np.sqrt(np.maximum(args[1], 1)) * ulp
    mass = np.clip(
        args[4][:, None, None] * torch.softmax(logits64, -1).numpy() - ref, 0, None
    )
    bound = delta[:, None, None] * mass + 1e-5
    for fn in (ctc.ctc_loss, ctc.ctc_loss_autodiff):
        _loss, grad = _torch_grad(fn, args)
        assert np.all(np.abs(grad - ref) <= bound), fn.__name__


@pytest.mark.parametrize("name", ["empty_label", "infeasible", "zero_length"])
def test_beta_matches_jax(name):
    logits, logit_lengths, labels, label_lengths, _g = _case(name)
    logp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    ext = ctc._extend_labels(torch.from_numpy(labels), vocabulary.BLANK_ID)
    allow = ctc._transition_masks(ext, vocabulary.BLANK_ID)
    emit = torch.gather(
        logp, 2, ext[:, None, :].expand(-1, logp.shape[1], -1)
    ).transpose(0, 1)
    got = ctc.ctc_beta(
        emit, torch.from_numpy(logit_lengths), torch.from_numpy(label_lengths),
        allow,
    )
    ext_j = jctc._extend_labels(jnp.asarray(labels), jvocab.BLANK_ID)
    allow_j = jctc._transition_masks(ext_j, jvocab.BLANK_ID)
    ref = jctc.ctc_beta(
        jnp.asarray(emit.numpy()), jnp.asarray(logit_lengths),
        jnp.asarray(label_lengths), allow_j,
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref), rtol=BETA_RTOL, atol=BETA_ATOL
    )


def test_cpu_wrapper_takes_plain_function():
    """The dispatching wrapper gives CPU tensors the plain Function: the
    same loss and gradient, and no kernel launch."""
    args = _case("ragged")
    before = (ctc_cuda.CTC_ALPHA.launches, ctc_cuda.CTC_BETA.launches)
    loss_w, grad_w = _torch_grad(ctc_cuda.ctc_loss, args)
    loss_p, grad_p = _torch_grad(ctc.ctc_loss, args)
    assert (ctc_cuda.CTC_ALPHA.launches, ctc_cuda.CTC_BETA.launches) == before
    np.testing.assert_array_equal(loss_w, loss_p)
    np.testing.assert_array_equal(grad_w, grad_p)


def test_beta_kernel_rejects_cpu_tensors():
    logits, logit_lengths, labels, label_lengths, g = (
        torch.from_numpy(a) for a in _case("ragged")
    )
    B, T, _C = logits.shape
    alpha = torch.zeros(T, B, 2 * labels.shape[1] + 1)
    with pytest.raises(ValueError, match="CUDA"):
        ctc_cuda.CTC_BETA(
            torch.log_softmax(logits, -1), logit_lengths, labels,
            label_lengths, alpha, torch.zeros(B), g,
        )
