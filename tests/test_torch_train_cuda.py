"""The port's train step on the card queues without a host sync.

Marked ``cuda``: skipped where there is no card. This file imports torch
and the port only (no JAX):

    python -m pytest tests/test_torch_train_cuda.py -m cuda -q

With no blocking call inside it, the host launches a step while the card
still runs the one before, so the host's own pace does not reach the
card's. The step runs under torch's sync debug mode set to raise on any
synchronizing CUDA call, after two warm steps (which load cuDNN's engines
and the CTC kernels).
"""

import numpy as np
import pytest
import torch

from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_makes_no_host_sync(cuda_device):
    model = Wav2Letter(Wav2LetterConfig(input_size=39)).to(cuda_device)
    tx = tstate.make_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-4)
    step = tstep.make_train_step_acc(model, tx)
    acc = tstep.init_metrics_acc(cuda_device)
    rng = np.random.RandomState(0)
    batches = [
        to_device(Batch(
            features=rng.randn(4, 256, 39).astype(np.float32),
            seq_lengths=np.array([256, 250, 200, 128], np.int32),
            labels=rng.randint(0, 28, (4, 20)).astype(np.int32),
            label_lengths=np.full(4, 20, np.int32),
        ), cuda_device)
        for _ in range(3)
    ]
    for batch in batches[:2]:
        state, acc = step(state, acc, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, acc = step(state, acc, batches[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert float(acc["updates"]) == 3.0


@pytest.mark.cuda
def test_clip_adam_list_ops_equal_the_per_leaf_formulas_on_the_card(cuda_device):
    """Given the global norm, the list ops' kernels on the card give the
    per-leaf ops' values bit for bit, clipped and not, over the kinds of
    the Conformer's leaf shapes."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(512,), (2048, 512), (512, 1, 32), (8, 64), (512, 512, 3, 3), (29,)]
    for max_norm in (0.5, 1e4):
        tx = tstate.make_optimizer(max_gradient_norm=max_norm, epsilon=1e-3)
        state = tx.init({f"p{i}": torch.zeros(s, device=cuda_device)
                         for i, s in enumerate(shapes)})
        mu = {k: torch.zeros_like(v) for k, v in state.mu.items()}
        nu = {k: torch.zeros_like(v) for k, v in state.nu.items()}
        for step in (1, 2):
            grads = {k: torch.randn(v.shape, generator=gen, device=cuda_device)
                     for k, v in mu.items()}
            updates, state, norm = tx.update(grads, state)
            # the norm of the leaves' norms: the sum of squares to float32's rounding
            want_norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
            assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
            c = torch.tensor(float(step), device=cuda_device)
            for k, g in grads.items():
                g = torch.where(norm < max_norm, g, (g / norm) * max_norm)
                mu[k] = (1 - 0.9) * g + 0.9 * mu[k]
                nu[k] = (1 - 0.999) * (g * g) + 0.999 * nu[k]
                want = (mu[k] / (1 - torch.pow(0.9, c))) / (
                    torch.sqrt(nu[k] / (1 - torch.pow(0.999, c))) + 1e-3)
                assert torch.equal(state.mu[k], mu[k]) and torch.equal(state.nu[k], nu[k]), k
                assert torch.equal(updates[k], want), k
