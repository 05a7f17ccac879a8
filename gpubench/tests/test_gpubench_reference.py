"""The frozen reference against the port's train step, on the CPU at a
tiny width, both in float32."""

from __future__ import annotations

import numpy as np
import torch

from gpubench import check, corpus
from gpubench.reference import common
from gpubench.reference import wav2letter as ref

from conftest import TINY_CONFIG, TINY_TRAFFIC


def port_steps(config, weights, batches):
    """The port's model and ``make_train_step_acc`` on the port's own
    batches of the same utterances, float32 throughout."""
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer

    model = Wav2Letter(Wav2LetterConfig(
        input_size=config["input_size"], base_channels=config["base_channels"],
        wide_channels=config["wide_channels"], num_body_layers=config["num_body_layers"],
        compute_dtype="float32"))
    tx = make_optimizer(config["max_gradient_norm"], config["adam_epsilon"],
                        config["adam_b1"], config["adam_b2"])
    state = create_train_state(dict(model.named_parameters()), tx, config["learning_rate"])
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(weights[k])
    step = tstep.make_train_step_acc(model, tx)
    losses = []
    for samples in batches:
        batch = to_device(build_batch(samples, time_bucket=64), torch.device("cpu"), "float32")
        acc = tstep.init_metrics_acc()
        state, acc = step(state, acc, batch)
        losses.append(float(acc["loss_sum"]))
        if len(losses) == 1:
            grads = {k: float(torch.linalg.vector_norm(m.double())) / (1 - config["adam_b1"])
                     for k, m in state.opt_state.mu.items()}
    change = {k: float(torch.linalg.vector_norm((p.detach() - weights[k]).double()))
              for k, p in state.params.items()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def test_reference_follows_the_port_in_float32():
    config = dict(TINY_CONFIG, compute_dtype="float32", transfer_dtype="float32")
    data = corpus.draw(TINY_TRAFFIC, config, 17)
    feats = corpus.draw_features(data, config, 17, torch.device("cpu"))
    weights = ref.make_weights(config, 3, "cpu")
    rows = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    samples = [[(feats[data.offsets[i]: data.offsets[i + 1]], data.labels[i]) for i in r]
               for r in rows]
    port = port_steps(config, weights, samples)
    batches = []
    for r in rows:
        f, lengths, labels = corpus.pad_batch(data, feats, r, 64)
        batches.append((torch.from_numpy(f), torch.from_numpy(lengths), labels))
    reference = ref.train_steps(weights, batches, config)
    values = check.numbers(port, reference)
    # float32 on both sides: the sums run in other orders, nothing else
    assert values["loss_gap"] < 1e-5, values
    assert values["grad_norm_gap"] < 1e-4, values
    assert values["update_norm_gap"] < 1e-3, values
    assert np.all(np.isfinite(reference["losses"]))


def test_fp8_control_rounds_coarser_than_bf16():
    x = torch.randn(4096, dtype=torch.float64).float()
    fp8 = common.fp8_quantize(x)
    bf16 = x.bfloat16().float()
    e8 = ((fp8 - x).abs() / x.abs().clamp(min=1e-3)).median()
    e16 = ((bf16 - x).abs() / x.abs().clamp(min=1e-3)).median()
    assert 8 < float(e8 / e16) < 64
    g = torch.ones_like(x, requires_grad=True)
    (common.fp8_quantize(g * x) * 3.3).sum().backward()
    assert torch.equal(g.grad, x * common._fp8_round(torch.full_like(x, 3.3)))
