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
