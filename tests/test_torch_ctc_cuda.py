"""The CUDA CTC kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no card. This file imports torch
and the port only (no JAX), so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_ctc_cuda.py -m cuda -q

Tolerance rtol 1e-5 / atol 1e-4 for losses and alpha: both sides are the
same float32 recursion over at most 101 frames. dlogits rtol 1e-4 / atol
1e-5: the same recursion, but the kernel adds the posteriors onto their
classes with float atomics, in another order than the plain scatter.
"""

import numpy as np
import pytest
import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.ops import ctc, ctc_cuda

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


def _case(name, B=6, T=101, L=12):
    rng = np.random.RandomState(len(name))
    logits = rng.randn(B, T, vocabulary.NUM_CLASSES).astype(np.float32)
    label_lengths = rng.randint(1, L + 1, size=B).astype(np.int32)
    labels = np.full((B, L), vocabulary.PAD_ID, dtype=np.int32)
    for b in range(B):
        labels[b, : label_lengths[b]] = rng.randint(0, 28, size=label_lengths[b])
    logit_lengths = rng.randint(2 * L + 1, T + 1, size=B).astype(np.int32)
    if name == "empty_label":
        labels[0], label_lengths[0] = vocabulary.PAD_ID, 0
    elif name == "infeasible":
        labels[1], label_lengths[1], logit_lengths[1] = 3, L, L
    elif name == "zero_length":
        logit_lengths[2] = 0
    elif name == "repeats":
        labels[3, :L] = 7
        label_lengths[3] = L
        logit_lengths[3] = T
    elif name == "one_frame":
        labels[4], label_lengths[4], logit_lengths[4] = vocabulary.PAD_ID, 1, 1
        labels[4, 0] = 3
    return logits, logit_lengths, labels, label_lengths


CASES = ["ragged", "empty_label", "infeasible", "zero_length", "repeats",
         "one_frame"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name, cuda_device):
    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(cuda_device) for a in _case(name)
    )
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    want = ctc.ctc_loss_log_probs(logp, logit_lengths, labels, label_lengths)
    B, T, _C = logp.shape
    alpha = torch.empty(T, B, 2 * labels.shape[1] + 1, device=cuda_device)
    before = ctc_cuda.CTC_ALPHA.launches
    got = ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, alpha)
    torch.cuda.synchronize()
    assert ctc_cuda.CTC_ALPHA.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
    alphas, _ = ctc.ctc_alpha(
        logp, logit_lengths, ext, ctc._transition_masks(ext, vocabulary.BLANK_ID)
    )
    torch.testing.assert_close(alpha, alphas, rtol=RTOL, atol=ATOL)
    # the dispatching wrapper launches the kernel for CUDA tensors
    torch.testing.assert_close(
        ctc_cuda.ctc_loss(logits, logit_lengths, labels, label_lengths), got
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_beta_kernel_matches_plain_on_card(name, cuda_device):
    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(cuda_device) for a in _case(name)
    )
    B, T, _C = logits.shape
    g = torch.linspace(0.25, 2.0, B, device=cuda_device)
    if name == "infeasible":
        g[1] = 0.0  # what the loss mask gives that row

    # the autograd Function: one alpha launch forward, one beta backward
    x = logits.clone().requires_grad_(True)
    before = (ctc_cuda.CTC_ALPHA.launches, ctc_cuda.CTC_BETA.launches)
    loss = ctc_cuda.ctc_loss(x, logit_lengths, labels, label_lengths)
    assert ctc_cuda.CTC_ALPHA.launches == before[0] + 1
    (got,) = torch.autograd.grad(loss, x, grad_outputs=g)
    torch.cuda.synchronize()
    assert ctc_cuda.CTC_BETA.launches == before[1] + 1

    y = logits.clone().requires_grad_(True)
    want_loss = ctc.ctc_loss(y, logit_lengths, labels, label_lengths)
    (want,) = torch.autograd.grad(want_loss, y, grad_outputs=g)
    torch.testing.assert_close(loss.detach(), want_loss.detach(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert bool(torch.isfinite(got).all())
    for b in range(B):
        assert not bool(got[b, int(logit_lengths[b]):].any())
    if name == "infeasible":
        assert not bool(got[1].any())


@pytest.mark.cuda
def test_no_history_without_a_gradient(cuda_device):
    """Under inference_mode the wrapper launches the alpha kernel alone."""
    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(cuda_device) for a in _case("ragged")
    )
    before = (ctc_cuda.CTC_ALPHA.launches, ctc_cuda.CTC_BETA.launches)
    with torch.inference_mode():
        ctc_cuda.ctc_loss(logits.requires_grad_(True), logit_lengths, labels,
                          label_lengths)
    assert (ctc_cuda.CTC_ALPHA.launches, ctc_cuda.CTC_BETA.launches) == (
        before[0] + 1, before[1]
    )
