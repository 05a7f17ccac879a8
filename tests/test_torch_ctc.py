"""The port's CTC loss against the JAX package's.

The plain PyTorch version (speecht_tpu_torch/ops/ctc.py) is held against
both JAX functions on the same numpy inputs: the XLA scan
(speecht_tpu.ops.ctc.ctc_loss) and the Pallas kernel under the Mosaic
interpreter (ctc_pallas.ctc_loss_pallas), as tests/test_ctc_pallas.py runs
it. Tolerance rtol 1e-5 / atol 1e-4, the one test_ctc_pallas.py uses for
its two float32 implementations of the same recursion. The CUDA kernel
itself runs only on the card: tests/test_torch_ctc_cuda.py.
"""

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

RTOL, ATOL = 1e-5, 1e-4


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
    """(logits, logit_lengths, labels, label_lengths) as numpy."""
    if name == "ragged":
        return _base(0, B=5, T=70, L=4)
    if name == "odd_time":
        return _base(1, B=3, T=33, L=5)
    logits, logit_lengths, labels, label_lengths = _base(2, B=4, T=41, L=6)
    if name == "empty_label":
        labels[0] = vocabulary.PAD_ID
        label_lengths[0] = 0
    elif name == "infeasible":
        # 4 repeats need 7 frames (a blank between each pair); give 5
        labels[1, :4] = 3
        labels[1, 4:] = vocabulary.PAD_ID
        label_lengths[1] = 4
        logit_lengths[1] = 5
    elif name == "zero_length":
        logit_lengths[2] = 0
    return logits, logit_lengths, labels, label_lengths


CASES = ["ragged", "odd_time", "empty_label", "infeasible", "zero_length"]


def _torch_loss(args):
    return ctc.ctc_loss(*(torch.from_numpy(a) for a in args)).numpy()


def test_vocabulary_matches_jax():
    assert (vocabulary.BLANK_ID, vocabulary.NUM_CLASSES, vocabulary.PAD_ID) == (
        jvocab.BLANK_ID, jvocab.NUM_CLASSES, jvocab.PAD_ID
    )
    sentence = "it's a test"
    assert vocabulary.sentence_to_ids(sentence) == jvocab.sentence_to_ids(sentence)
    ids = [0, 28, 5, -1, 27, 26]
    assert vocabulary.ids_to_sentence(ids) == jvocab.ids_to_sentence(ids)


@pytest.mark.parametrize("name", CASES)
def test_loss_matches_jax_scan(name):
    args = _case(name)
    ref = np.asarray(jctc.ctc_loss(*(jnp.asarray(a) for a in args)))
    got = _torch_loss(args)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if name == "infeasible":
        assert got[1] > 1e29 and ref[1] > 1e29
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("name", CASES)
def test_loss_matches_pallas_interpret(name):
    args = _case(name)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            ctc_pallas.ctc_loss_pallas(*(jnp.asarray(a) for a in args))
        )
    np.testing.assert_allclose(_torch_loss(args), ref, rtol=RTOL, atol=ATOL)


def test_alpha_history_and_masks_match_jax():
    logits, logit_lengths, labels, label_lengths = _case("empty_label")
    ext_j = jctc._extend_labels(jnp.asarray(labels), jvocab.BLANK_ID)
    allow_j = jctc._transition_masks(ext_j, jvocab.BLANK_ID)
    ext_t = ctc._extend_labels(torch.from_numpy(labels), vocabulary.BLANK_ID)
    allow_t = ctc._transition_masks(ext_t, vocabulary.BLANK_ID)
    np.testing.assert_array_equal(ext_t.numpy(), np.asarray(ext_j))
    np.testing.assert_array_equal(allow_t.numpy(), np.asarray(allow_j))

    logp = np.asarray(
        torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()
    )
    alphas_j, last_j = jctc.ctc_alpha(
        jnp.asarray(logp), jnp.asarray(logit_lengths), ext_j, allow_j
    )
    alphas_t, last_t = ctc.ctc_alpha(
        torch.from_numpy(logp), torch.from_numpy(logit_lengths), ext_t, allow_t
    )
    np.testing.assert_allclose(
        alphas_t.numpy(), np.asarray(alphas_j), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(
        last_t.numpy(), np.asarray(last_j), rtol=RTOL, atol=ATOL
    )


def _own_states_loss(log_probs, logit_lengths, labels, label_lengths):
    """The plain recursion of each row alone on its own 2 ll + 1 states,
    as the alpha kernel runs a row when it writes no history (3 states at
    least: the plain recursion shifts by two)."""
    losses = []
    for b in range(log_probs.shape[0]):
        own = max(int(label_lengths[b]), 1)
        ext = ctc._extend_labels(labels[b : b + 1, :own], vocabulary.BLANK_ID)
        allow = ctc._transition_masks(ext, vocabulary.BLANK_ID)
        _alphas, last = ctc.ctc_alpha(
            log_probs[b : b + 1], logit_lengths[b : b + 1], ext, allow
        )
        losses.append(-ctc._final_log_prob(last, label_lengths[b : b + 1]))
    return torch.cat(losses)


@pytest.mark.parametrize("name", CASES)
def test_own_states_give_the_loss(name):
    """alpha[t, s] depends on states <= s only, so running a row's own
    states gives the loss of all S states bit for bit, and the JAX scan's
    within the file's tolerance."""
    args = _case(name)
    logits, logit_lengths, labels, label_lengths = (torch.from_numpy(a) for a in args)
    log_probs = torch.log_softmax(logits, dim=-1)
    got = _own_states_loss(log_probs, logit_lengths, labels, label_lengths)
    want = ctc.ctc_loss_log_probs(log_probs, logit_lengths, labels, label_lengths)
    assert torch.equal(got, want)
    ref = np.asarray(jctc.ctc_loss(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _case("ragged")]
    before = ctc_cuda.CTC_ALPHA.launches
    got = ctc_cuda.ctc_loss(*args)
    assert ctc_cuda.CTC_ALPHA.launches == before
    torch.testing.assert_close(got, ctc.ctc_loss(*args), rtol=0, atol=0)


def test_kernel_rejects_cpu_tensors():
    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a) for a in _case("ragged")
    )
    with pytest.raises(ValueError, match="CUDA"):
        ctc_cuda.CTC_ALPHA(
            torch.log_softmax(logits, -1), logit_lengths, labels, label_lengths
        )
