"""The benchmark's CPU tests: a copy of the harness with a tiny cell.

The tiny cell runs the port on the CPU at narrow widths (``tiny_root``);
tests marked ``cuda`` need a card and skip where there is none.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.dirname(HERE)
REPO = os.path.dirname(PACKAGE)

TINY_CONFIG = {
    "model": "wav2letter", "feature_type": "power", "input_size": 8,
    "sample_rate": 22050, "hop": 160, "first_width": 48, "first_stride": 2,
    "base_channels": 16, "body_width": 7, "num_body_layers": 2, "wide_width": 32,
    "wide_channels": 32, "num_classes": 29, "blank_id": 28, "param_dtype": "float32",
    "compute_dtype": "bfloat16", "transfer_dtype": "bfloat16", "learning_rate": 0.0001,
    "max_gradient_norm": 5.0, "adam_b1": 0.9, "adam_b2": 0.999, "adam_epsilon": 0.001,
}
TINY_TRAFFIC = {
    "kind": "train", "utterances": 24,
    "length_mix": [{"share": 1.0, "kind": "uniform", "min_s": 0.5, "max_s": 1.5}],
    "chars_per_s": [12.0, 18.0], "label_ids": [0, 27], "batch_size": 4,
    "bucket_step": 64, "group_by_length": True, "spec_augment": False,
    "grad_accum": 1, "loop": "closed", "check_steps": 3,
}
# the tiny cell's limits, from its readings on the CPU over 12 seeds
# (calibrate.py): sound runs at most 5.3e-5 / 1.5e-2 / 7.8e-3; half a batch
# left out at least 4.1e-3 on the first loss; a state left unchanged 1
TINY_LIMITS = {"first_loss_gap": 5e-4, "grad_norm_gap": 0.06, "update_norm_gap": 0.05}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where there is none")


def write_json(path: str, data) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def copy_harness(dest: str) -> str:
    """A checkout-like directory: the harness and ``BENCHMARK.json``
    (the port is imported from the repository). Returns the package dir."""
    package = os.path.join(dest, "gpubench")
    shutil.copytree(PACKAGE, package, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    return package


def add_tiny_cell(dest: str, package: str, name: str = "tiny_cell", config: str = "tiny_w2l",
                  config_data: dict = TINY_CONFIG) -> None:
    """A throwaway configuration, traffic mix and cell, added as files and
    as entries of the copy's ``BENCHMARK.json``."""
    write_json(os.path.join(package, "configs", f"{config}.json"), config_data)
    write_json(os.path.join(package, "traffic", "tiny_mix.json"), TINY_TRAFFIC)
    write_json(os.path.join(package, "limits", f"{name}.json"), {"limits": TINY_LIMITS})
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config, "source": "a test's narrow Wav2Letter",
                             "file": f"gpubench/configs/{config}.json", "reduced": [],
                             "why": "CPU test"})
    bench["workloads"].append({"name": name, "config": config, "traffic": "tiny_mix",
                               "chips": 1, "why": "CPU test"})
    write_json(path, bench)


@pytest.fixture
def tiny_root(tmp_path):
    package = copy_harness(str(tmp_path))
    add_tiny_cell(str(tmp_path), package)
    return package


@pytest.fixture
def card():
    """The card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
