"""Conformer-CTC in bf16 on the card against the plain float32 reference.

Marked ``cuda``: skipped where there is no card. This file imports torch,
the port and ``tests/conformer_reference.py`` (no JAX):

    python -m pytest tests/test_torch_conformer_cuda.py -m cuda -q

At Conformer (L)'s widths (d = 512, 8 heads, FFN 2,048, kernel 32, 512
subsampling channels, 39 features) with 2 blocks, B = 8 rows of 1,000 to
3,072 frames padded to 3,072 (T' = 768): the port in bf16 (the
memory-efficient attention kernel pinned, so a fall-back raises) against
the reference in float32 with TF32 off, on the same weights and batch.
The numbers read and their tolerances:

- the logits on the valid frames, rms of the gap over rms of the
  reference's: under 2e-2 (bf16 keeps 8 bits, 3.9e-3 a rounding; about a
  dozen roundings in a row through two blocks);
- the loss's relative gap: under 5e-3 (the CTC loss averages over 5,600
  frames, so the logits' errors average out);
- each leaf's gradient, the norm of the gap over the larger of the
  reference leaf's norm and the median leaf's: under 5e-2 (bf16 gradients
  through the same dozen roundings each way).

The train step itself runs under torch's sync debug mode set to raise.
"""

import numpy as np
import pytest
import torch

import conformer_reference as ref
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models import conformer
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep

WIDE = dict(input_size=39, d_model=512, num_heads=8, ffn_dim=2048, num_blocks=2,
            conv_kernel=32, subsampling_channels=512, dropout=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


def _model(device, seed=0, dtype="bfloat16"):
    model = conformer.Conformer(conformer.ConformerConfig(**WIDE, compute_dtype=dtype),
                                generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # move the zero and one leaves off their start
        for name, p in model.named_parameters():
            if p.dim() == 1 or "pos_bias" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model.to(device).train()


def _batch(device, lengths, frames, seed=0):
    rng = np.random.RandomState(seed)
    n = np.asarray(lengths, np.int32)
    feats = rng.randn(len(n), frames, 39).astype(np.float32)
    feats[np.arange(frames)[None, :] >= n[:, None]] = 0
    label_lengths = (n // 4 * 0.4).astype(np.int32)
    labels = np.zeros((len(n), frames // 4), np.int32)
    for i, k in enumerate(label_lengths):
        labels[i, :k] = rng.randint(0, 28, k)
    return to_device(Batch(feats, n, labels, label_lengths), device, "float32")


def _gap(got, want):
    floor = np.median([float(w.norm()) for w in want.values()])
    return max(float((got[k].double() - want[k].double()).norm())
               / max(float(want[k].norm()), floor) for k in want)


@pytest.mark.cuda
def test_bf16_matches_the_float32_reference(cuda_device):
    model = _model(cuda_device)
    lengths = [3072, 2900, 2700, 2500, 2200, 1900, 1500, 1000]
    batch = _batch(cuda_device, lengths, 3072)
    params = dict(model.named_parameters())
    logits = model(batch.features, batch.seq_lengths)
    loss, _ = tstep.make_loss_fn(model)(batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    weights = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = ref.forward(weights, batch.features.float(), batch.seq_lengths.long(), 8, 32)
        want_loss = ref.ctc_loss(want, batch.seq_lengths, batch.labels, batch.label_lengths,
                                 28)
        want_grads = dict(zip(weights, torch.autograd.grad(want_loss, list(weights.values()))))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    valid = ref.valid_frames(ref.ceil_div(batch.seq_lengths, 4), logits.shape[1])
    diff = (logits.detach() - want.detach())[valid]
    logit_gap = float(diff.square().mean().sqrt() / want.detach()[valid].square().mean().sqrt())
    loss_gap = abs(float(loss) - float(want_loss)) / float(want_loss)
    grad_gap = _gap(grads, want_grads)
    print(f"logits rms gap {logit_gap:.3e}, loss gap {loss_gap:.3e}, "
          f"worst leaf gradient gap {grad_gap:.3e}")
    assert logits.shape == (8, 768, 29)
    assert logit_gap < 2e-2
    assert loss_gap < 5e-3
    assert grad_gap < 5e-2


@pytest.mark.cuda
def test_train_step_makes_no_host_sync(cuda_device):
    model = _model(cuda_device)
    tx = tstate.make_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-4)
    step = tstep.make_train_step_acc(model, tx)
    acc = tstep.init_metrics_acc(cuda_device)
    batches = [_batch(cuda_device, [512, 500, 300, 0], 512, seed) for seed in range(3)]
    for batch in batches[:2]:
        state, acc = step(state, acc, batch)
    torch.cuda.synchronize()
    calls = conformer.attention_calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, acc = step(state, acc, batches[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert conformer.attention_calls - calls == 2
    assert float(acc["updates"]) == 3.0
    assert np.isfinite(float(acc["loss_sum"]))
