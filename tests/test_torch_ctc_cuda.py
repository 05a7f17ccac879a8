"""The CUDA CTC kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no card. This file imports torch
and the port only (no JAX), so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_ctc_cuda.py -m cuda -q

Tolerance rtol 1e-5 / atol 1e-4 for losses and alpha: both sides are the
same float32 recursion, which the alpha kernel rounds as the plain version
does. dlogits rtol 1e-4 / atol
1e-5: the same recursion, but the kernel sums the posteriors onto their
classes in another order than the plain scatter (blank states by lane,
then a butterfly across the warp; label states by per-class lists), and
folds the log-sum-exp's largest term as exactly 1. That order is fixed,
so two calls of the beta kernel on the same inputs are bit-equal.
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


def _alpha_inputs(seed, B, T, L, label_lengths, logit_lengths=None):
    """Log-probs [B, T, C] and labels of the given lengths on the card."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, vocabulary.NUM_CLASSES).astype(np.float32) * 2.0
    label_lengths = np.asarray(label_lengths, dtype=np.int32)
    labels = np.full((B, L), vocabulary.PAD_ID, dtype=np.int32)
    for b in range(B):
        labels[b, : label_lengths[b]] = rng.randint(0, 28, size=label_lengths[b])
    if logit_lengths is None:
        logit_lengths = [T] * B
    dev = torch.device("cuda")
    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(np.asarray(a)).to(dev)
        for a in (logits, np.asarray(logit_lengths, np.int32), labels, label_lengths)
    )
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    return logp, logit_lengths, labels, label_lengths


def _beta_inputs(seed, B, T, L, label_lengths, logit_lengths=None):
    """Log-probs, labels of the given lengths and the alpha history on the
    card, as the beta kernel takes them."""
    logp, logit_lengths, labels, label_lengths = _alpha_inputs(
        seed, B, T, L, label_lengths, logit_lengths
    )
    alpha = torch.empty(T, B, 2 * L + 1, device=logp.device)
    loss = ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, alpha)
    g = torch.linspace(0.5, 1.5, B, device=logp.device)
    return logp, logit_lengths, labels, label_lengths, alpha, loss, g


def _beta_plain(logp, logit_lengths, labels, label_lengths, alpha, loss, g):
    ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
    allow = ctc._transition_masks(ext, vocabulary.BLANK_ID)
    return ctc._posterior_grad(
        logp, logit_lengths, ext, allow, label_lengths, alpha, -loss
    ) * g[:, None, None]


# label widths at the edges of the kernel's state layout: a row of 2L+1
# states runs on W recursion warps of 32 lanes with K states a lane, K
# the smallest of 2, 4, 6, 8, 12, 16 with 8 * 32 * K >= 2L+1; so 2L+1 =
# 63 / 65 (one warp / two at K=2), 511 / 513 (K=2 on 8 warps / K=4 on
# 5), 1023 / 1025 (K=4 / K=6), and the largest bucket's L=1088 (K=12 on
# 6 warps)
EDGE_LABELS = [1, 31, 32, 255, 256, 511, 512, 1088]


@pytest.mark.cuda
@pytest.mark.parametrize("L", EDGE_LABELS)
def test_beta_kernel_state_layout_edges(L, cuda_device):
    """Every row at the label width L, and one row of half of it."""
    T = 2 * L + 40
    inputs = _beta_inputs(L, 2, T, L, [L, L // 2], [T, T - 7])
    got = ctc_cuda.CTC_BETA(*inputs)
    want = _beta_plain(*inputs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not bool(got[1, T - 7:].any())


@pytest.mark.cuda
def test_beta_kernel_largest_states(cuda_device):
    """The most states one block takes, and B = 1."""
    L = (ctc_cuda.CTC_BETA.lib.ctc_beta_max_states() - 1) // 2
    T = 2 * L + 8
    inputs = _beta_inputs(3, 1, T, L, [L])
    got = ctc_cuda.CTC_BETA(*inputs)
    want = _beta_plain(*inputs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_beta_kernel_all_labels_empty(cuda_device):
    inputs = _beta_inputs(4, 3, 50, 6, [0, 0, 0], [50, 17, 1])
    got = ctc_cuda.CTC_BETA(*inputs)
    want = _beta_plain(*inputs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_beta_kernel_every_width_fits(cuda_device):
    """Every label width up to the most states fits in shared memory."""
    lib = ctc_cuda.CTC_BETA.lib
    widths = range((lib.ctc_beta_max_states() - 1) // 2 + 1)
    assert max(lib.ctc_beta_smem_bytes(L, vocabulary.NUM_CLASSES) for L in widths) <= (
        ctc_cuda.MAX_SMEM_BYTES
    )


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ragged", "multi-warp"])
def test_beta_kernel_two_calls_bit_equal(shape, cuda_device):
    if shape == "ragged":
        inputs = _beta_inputs(5, 6, 101, 12, [12, 0, 7, 3, 12, 9],
                              [101, 60, 0, 1, 88, 101])
    else:
        inputs = _beta_inputs(6, 4, 2176, 1088, [1088, 700, 300, 1000],
                              [2176, 1600, 1500, 2100])
    first = ctc_cuda.CTC_BETA(*inputs)
    second = ctc_cuda.CTC_BETA(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _check_alpha_variants(logp, logit_lengths, labels, label_lengths):
    """Both variants of the alpha kernel against the plain version: the
    loss and the whole [T, B, S] history; the no-history loss bit-equal to
    the history variant's; two calls of each bit-equal."""
    B, T, _C = logp.shape
    S = 2 * labels.shape[1] + 1
    args = (logp, logit_lengths, labels, label_lengths)
    want = ctc.ctc_loss_log_probs(*args)
    ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
    alphas, _ = ctc.ctc_alpha(
        logp, logit_lengths, ext, ctc._transition_masks(ext, vocabulary.BLANK_ID)
    )
    loss = ctc_cuda.CTC_ALPHA(*args)
    loss_again = ctc_cuda.CTC_ALPHA(*args)
    hist = torch.full((T, B, S), float("nan"), device=logp.device)
    hist_again = torch.full_like(hist, float("nan"))
    hist_loss = ctc_cuda.CTC_ALPHA(*args, hist)
    hist_loss_again = ctc_cuda.CTC_ALPHA(*args, hist_again)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(hist, alphas, rtol=RTOL, atol=ATOL)
    assert torch.equal(loss, hist_loss)
    assert torch.equal(loss, loss_again)
    assert torch.equal(hist_loss, hist_loss_again)
    assert torch.equal(hist, hist_again)


def _alpha_layout(n):
    """(K, W) of a row of n states in the alpha kernel: W = ceil(n / 32K)
    of at most 14 warps, K the one of the least ceil(W / 4) * K, ties to
    the smaller K (csrc/ctc_alpha.cu, ctc_alpha_kernel)."""
    best = None
    for k in (2, 4, 6, 8, 12, 16, 24, 32):
        w = -(-n // (32 * k))
        if w <= 14 and (best is None or -(-w // 4) * k < best[0]):
            best = (-(-w // 4) * k, k, w)
    return best[1:]


def _layout_edges():
    """Label widths L whose 2L+1 states sit at both sides of every change
    of the alpha kernel's (K, W) below 4096 states (with the history a row
    runs all of them), then one width past 4095 and the widest the first,
    shared-memory version of the kernel took (S = 14295: K=32 on 14
    warps)."""
    states = {3, 4095, 4097, 14295}
    for s in range(5, 4096, 2):
        if _alpha_layout(s) != _alpha_layout(s - 2):
            states |= {s - 2, s}
    return sorted((s - 1) // 2 for s in states)


@pytest.mark.cuda
@pytest.mark.parametrize("L", _layout_edges())
def test_alpha_kernel_state_layout_edges(L, cuda_device):
    """A full-width row and one of half the width (its own, narrower
    layout without the history), the second shorter than T."""
    T = 2 * L + 40
    _check_alpha_variants(*_alpha_inputs(L, 2, T, L, [L, L // 2], [T, T - 7]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["B=1", "all_empty", "len_0", "short_rows", "neg_inf"])
def test_alpha_kernel_edge_rows(name, cuda_device):
    if name == "B=1":
        inputs = _alpha_inputs(11, 1, 70, 20, [20])
    elif name == "all_empty":
        inputs = _alpha_inputs(12, 3, 50, 6, [0, 0, 0], [50, 17, 1])
    elif name == "len_0":
        inputs = _alpha_inputs(13, 3, 40, 8, [8, 0, 3], [0, 0, 40])
    elif name == "short_rows":
        inputs = _alpha_inputs(14, 4, 90, 30, [30, 12, 29, 1], [90, 61, 40, 2])
    else:
        # frame 3 of row 0 is -inf for every class: every alpha is -inf
        # there, and at frame 4 each label state with a skip has all three
        # terms below NEG_INF (the clamp of the max)
        logp, *rest = _alpha_inputs(15, 2, 60, 10, [10, 7])
        logp[0, 3] = float("-inf")
        inputs = (logp, *rest)
    _check_alpha_variants(*inputs)


@pytest.mark.cuda
def test_alpha_kernel_two_calls_bit_equal_multi_warp(cuda_device):
    """The largest bucket's shape, ragged: rows on several warps each."""
    _check_alpha_variants(*_alpha_inputs(
        16, 4, 2176, 1088, [1088, 700, 300, 1000], [2176, 1600, 1500, 2100]
    ))


@pytest.mark.cuda
def test_alpha_kernel_every_width_fits(cuda_device):
    """Every label width the first version of the kernel took (S <=
    14295) fits in the states one block takes and in shared memory; past
    the most states the wrapper raises, naming the width."""
    lib = ctc_cuda.CTC_ALPHA.lib
    most = lib.ctc_alpha_max_states()
    assert most >= 14295
    widths = range((most - 1) // 2 + 1)
    assert max(lib.ctc_alpha_smem_bytes(L, vocabulary.NUM_CLASSES) for L in widths) <= (
        ctc_cuda.MAX_SMEM_BYTES
    )
    L = (most - 1) // 2 + 1
    logp, logit_lengths, labels, label_lengths = _alpha_inputs(17, 1, 4, L, [1])
    with pytest.raises(ValueError, match=f"label width {L}"):
        ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths)
