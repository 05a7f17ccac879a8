"""The architecture a configuration names by its ``model``: what
``manifest.architecture`` refuses, and the Wav2Letter module's flags,
lengths and counts, held to the values the harness read before they moved
into ``reference/wav2letter.py`` (literals, compared exactly)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from gpubench import manifest
from gpubench.kinds import train
from gpubench.reference import wav2letter

from conftest import PACKAGE, TINY_CONFIG, TINY_TRAFFIC


def load(folder, name):
    with open(os.path.join(PACKAGE, folder, f"{name}.json")) as f:
        return json.load(f)


CONFIGS = {"w2l_mfcc39": load("configs", "w2l_mfcc39"), "tiny": TINY_CONFIG}
TRAFFIC = {"w2l_mfcc39": load("traffic", "librispeech_train"), "tiny": TINY_TRAFFIC}
LENGTHS = [1, 2, 3, 255, 256, 257, 930, 2916, 3071]

# train_flops_valid on LENGTHS; conv_flops_padded at (64, 3072) and (64, 256)
COUNTS = {
    "w2l_mfcc39": (540306585000.0, (4637687808000.0, 9183363072000.0),
                   (386473984000.0, 765280256000.0)),
    "tiny": (599876928.0, (5517606912.0, 9827254272.0), (459800576.0, 818937856.0)),
}

FLAGS = {
    "batch_size": 64, "bucket_step": 256, "command": "train", "compute_dtype": "bfloat16",
    "data_dir": "data", "data_parallel": 0, "device": "cuda", "feature_type": "mfcc",
    "grad_accum": 1, "group_by_length": True, "learning_rate": 0.0001,
    "learning_rate_decay_factor": 0, "limit_training_set": 0, "log_dir": "data/log",
    "max_gradient_norm": 5.0, "max_input_frames": 0, "max_steps": None, "model_parallel": 1,
    "momentum": 0.9, "profile_steps": None, "reset_learning_rate": False,
    "run_name": "gpubench", "run_train_dir": "data/train/gpubench", "run_type": "train",
    "seq_parallel": 0, "spec_augment": False, "spec_augment_freq_width": None,
    "spec_augment_time_frac": 0.05, "steps_per_checkpoint": 1000, "train_dir": "data/train",
    "transfer_dtype": "bfloat16", "verbose_summaries": False,
    "base_channels": 250, "wide_channels": 2000, "num_body_layers": 7,
}
PARSED = {
    "w2l_mfcc39": FLAGS,
    "tiny": dict(FLAGS, batch_size=4, bucket_step=64, feature_type="power", base_channels=16,
                 wide_channels=32, num_body_layers=2),
}


def test_the_configuration_names_its_architecture():
    for config in CONFIGS.values():
        assert manifest.architecture(config) is wav2letter


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_unchanged(name):
    config = CONFIGS[name]
    valid, long, short = COUNTS[name]
    assert wav2letter.train_flops_valid(config, LENGTHS) == valid
    assert wav2letter.train_flops_valid(config, np.array(LENGTHS)) == valid
    assert wav2letter.conv_flops_padded(config, 64, 3072) == long
    assert wav2letter.conv_flops_padded(config, 64, 256) == short


def test_ctc_lengths_are_unchanged():
    config = CONFIGS["w2l_mfcc39"]
    want = [0, 1, 1, 127, 128, 128, 465, 1458, 1535]
    assert wav2letter.logit_lengths(config, np.array(LENGTHS)).tolist() == want
    assert wav2letter.logit_lengths(config, torch.tensor(LENGTHS)).tolist() == want
    assert [wav2letter.logit_frames(config, t) for t in (256, 3072, 257, 1)] == [128, 1536, 129, 1]


@pytest.mark.parametrize("name", sorted(PARSED))
def test_parsed_train_flags_are_unchanged(name):
    flags = vars(train.program_flags(CONFIGS[name], TRAFFIC[name], "data", torch.device("cuda")))
    want = PARSED[name]
    assert {k: flags[k] for k in want} == want


@pytest.mark.parametrize("model,says", [
    ("no_such_model", "has no reference/no_such_model.py"),
    ("../wav2letter", "bad model"),
    ("wav2letter.forward", "bad model"),
    (None, "bad model"),
    ("common", "lacks program_flags"),
])
def test_a_model_that_is_no_architecture_is_refused(model, says):
    config = dict(TINY_CONFIG, model=model)
    with pytest.raises(ValueError, match="tiny_w2l") as err:
        manifest.architecture(config, "tiny_w2l")
    assert says in str(err.value)
