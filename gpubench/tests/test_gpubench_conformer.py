"""The Conformer architecture's module (``reference/conformer.py``), its
readers, and a tiny Conformer cell through the harness on the CPU."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import check, manifest, module_spans, run
from gpubench.reference import conformer

from conftest import TINY_LIMITS, add_tiny_cell, copy_harness

TINY = {"model": "conformer", "feature_type": "power", "input_size": 8, "sample_rate": 22050,
        "hop": 160, "num_blocks": 2, "d_model": 32, "num_heads": 2, "ffn_dim": 64,
        "conv_kernel": 8, "subsampling_channels": 8, "dropout": 0.0, "num_classes": 29,
        "blank_id": 28, "param_dtype": "float32", "compute_dtype": "float32",
        "transfer_dtype": "float32", "learning_rate": 0.0001, "max_gradient_norm": 5.0,
        "adam_b1": 0.9, "adam_b2": 0.999, "adam_epsilon": 0.001}


def test_the_configuration_resolves_to_this_module():
    bench = manifest.Manifest.load()
    config = bench.config(bench.workload("train_conformer_l_libri"))
    assert manifest.architecture(config) is conformer
    assert config["num_blocks"] == 17 and config["d_model"] == 512
    assert config["dropout"] == 0.0
    assert len(conformer.leaf_shapes(config)) == 569
    params = sum(int(np.prod(s)) for s in conformer.leaf_shapes(config).values())
    assert 112e6 < params < 113e6


def test_shift_is_its_definition():
    raw = torch.randn(2, 5, 9)
    got = conformer.shift(raw)
    for i in range(5):
        for j in range(5):
            assert torch.equal(got[:, i, j], raw[:, i, 4 - i + j])


@pytest.mark.parametrize("n", [64, 61, 5])
def test_forward_count_is_the_flop_counters(monkeypatch, n):
    """A row alone, unpadded: every multiply-add of the forward, as torch's
    flop counter counts the matmuls and convs the reference runs."""
    monkeypatch.setattr(conformer, "checkpoint", lambda f, *a, use_reentrant: f(*a))
    params = conformer.make_weights(TINY, 0, "cpu")
    with FlopCounterMode(display=False) as counter:
        conformer.forward(params, torch.randn(1, n, 8), torch.tensor([n]), TINY)
    total, _conv1, _position = conformer._forward_macs(TINY, np.array([n]))
    assert counter.get_total_flops() == 2 * total


def test_padded_counts():
    """The front end's convs and the attention cores at B = 64, 3,072
    frames (T' = 768), Conformer (L)'s widths."""
    config = dict(TINY, input_size=39, num_blocks=17, d_model=512, num_heads=8,
                  subsampling_channels=512)
    conv1 = 2.0 * 64 * 1536 * 20 * 9 * 512
    conv2 = 2.0 * 64 * 768 * 10 * 9 * 512 * 512
    depthwise = 2.0 * 64 * 768 * 512 * 8 * 17  # TINY's kernel of 8
    assert conformer.conv_flops_padded(config, 64, 3072) == (
        conv1 + conv2, conv1 + 2 * conv2 + 2 * depthwise)
    unit = 64 * 8 * 768 * 768 * 64 * 17
    assert conformer.attention_flops_padded(config, 64, 3072) == (4.0 * unit, 8.0 * unit)
    assert conformer.logit_frames(config, 3071) == 768
    assert list(conformer.logit_lengths(config, np.array([0, 1, 4, 5]))) == [0, 1, 1, 2]


def _trace_with_spans(spans):
    trace = types.SimpleNamespace(
        start_ns=0, end_ns=1000, device=[("k", 10, 20, 1), ("k", 30, 50, 2), ("k", 60, 61, 3)],
        _ops=[("aten::mm", 12, 13, 7, 1), ("aten::mm", 35, 36, 7, 2),
              ("aten::add", 70, 71, 7, 3)])
    return types.SimpleNamespace(trace=trace, spans=spans, steps=2)


def test_module_device_time_reads_the_spans(monkeypatch):
    span = types.SimpleNamespace
    spans = [span(name="step.forward", start_ns=0, end_ns=100),
             span(name="conformer.mhsa", start_ns=10, end_ns=20),
             span(name="conformer.ffn", start_ns=30, end_ns=40)]
    monkeypatch.setattr("gpubench.program_spans.read", lambda ctx: _trace_with_spans(spans))
    assert module_spans.device_ms_per_step(None, "conformer.mhsa") == 10 / 1e6 / 2
    assert module_spans.device_ms_per_step(None, "conformer.ffn") == 20 / 1e6 / 2
    assert module_spans.device_ms_per_step(None, "conformer.conv") is None
    monkeypatch.setattr("gpubench.program_spans.read", lambda ctx: None)
    assert module_spans.device_ms_per_step(None, "conformer.mhsa") is None


def test_a_tiny_conformer_cell_runs_correct(tmp_path, capsys):
    package = copy_harness(str(tmp_path))
    add_tiny_cell(str(tmp_path), package, name="tiny_conformer", config="tiny_conformer",
                  config_data=TINY)
    assert os.path.exists(os.path.join(package, "limits", "tiny_conformer.json"))
    for trace in (0, 1):
        code = run.main(["--workload", "tiny_conformer", "--seed", "2147483659",
                         "--seconds", "1", "--trace", str(trace)], device="cpu",
                        package_dir=package)
        assert code == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is True and line["failed"] == 0
        # float32 on both sides: far inside the tiny cell's limits
        assert line["checks"]["first_loss_gap"]["value"] < TINY_LIMITS["first_loss_gap"] / 100


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_and_half_batch_fail_on_the_card(card, seed):
    """The Conformer cell at its own size: the program passes its limits,
    the float8 control and half a batch left out each fail one."""
    from test_gpubench_control import fails, readings

    bench = manifest.Manifest.load()
    cell = bench.workload("train_conformer_l_libri")
    limits = check.load_limits(cell["name"])
    row = readings(bench.config(cell), bench.traffic(cell), seed, card)
    assert not fails(row["program"], limits), row
    assert fails(row["control"], limits), row
    assert fails(row["half_batch"], limits), row
