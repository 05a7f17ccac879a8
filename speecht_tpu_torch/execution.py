"""Executor scaffolding shared by the commands.

Counterpart of ``speecht_tpu/execution.py``: model construction from the
flags, the fresh train state (``init_state``), the corpus reader, the
input-size probe (width of the first cached sample), the batch loader
wired to a per-command sample generator and the run's checkpoint manager.
There is no mesh: the port runs on one device, named by ``--device``.
"""

from __future__ import annotations

import abc
from typing import Iterator

import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data.pipeline import PrefetchLoader
from speecht_tpu_torch.data.reader import SpeechCorpusReader
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.train.checkpoint import CheckpointManager
from speecht_tpu_torch.train.state import (
    ClipAdam,
    TrainState,
    create_train_state,
    make_optimizer,
)


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device. ``cuda`` without a card raises: the
    port never carries on on the CPU unless it was asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    return device


def build_model(input_size: int, flags, seed: int = 0) -> Wav2Letter:
    """Wav2Letter with the reference dimensions by default;
    --base-channels/--wide-channels/--num-body-layers scale it. Initial
    weights come from a CPU generator seeded with ``seed``."""
    cfg = Wav2LetterConfig(
        input_size=input_size,
        num_classes=vocabulary.NUM_CLASSES,
        base_channels=getattr(flags, "base_channels", 250),
        wide_channels=getattr(flags, "wide_channels", 2000),
        num_body_layers=getattr(flags, "num_body_layers", 7),
        compute_dtype=getattr(flags, "compute_dtype", "bfloat16"),
    )
    return Wav2Letter(cfg, generator=torch.Generator().manual_seed(seed))


def init_state(
    model: Wav2Letter, flags, generator: torch.Generator | None = None
) -> tuple[TrainState, ClipAdam]:
    """Fresh TrainState over ``model``'s parameters, reference optimizer
    settings. The parameters are drawn anew from ``generator`` (a CPU
    generator seeded with 0 by default) and keep the model's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = next(model.parameters()).device
    for name in model.layer_names:
        layer = getattr(model, name)
        layer.to("cpu").reset_parameters(generator)
        layer.to(device)
    tx = make_optimizer(
        max_gradient_norm=getattr(flags, "max_gradient_norm", 5.0),
        epsilon=getattr(flags, "epsilon", 1e-3),
    )
    lr = getattr(flags, "learning_rate", 1e-4)
    return create_train_state(dict(model.named_parameters()), tx, lr), tx


class DatasetExecutor(abc.ABC):
    """Base for executors that stream the cached corpus through the model."""

    def __init__(self, flags):
        self.flags = flags
        self.device = resolve_device(getattr(flags, "device", "cuda"))
        self.reader = SpeechCorpusReader(flags.data_dir)

        print("Determine input size from first sample")
        self.input_size = self.determine_input_size()
        self.model = build_model(self.input_size, flags)

    def determine_input_size(self) -> int:
        sample = next(
            self.reader.load_samples(
                self.dataset_name(),
                limit_count=1,
                feature_type=self.flags.feature_type,
            )
        )
        return int(sample[0].shape[1])

    def dataset_name(self) -> str:
        return "train"

    @abc.abstractmethod
    def create_sample_generator(self, limit_count: int) -> Iterator:
        raise NotImplementedError

    @abc.abstractmethod
    def get_loader_limit_count(self) -> int:
        raise NotImplementedError

    def get_max_steps(self):
        return None

    def create_loader(self) -> PrefetchLoader:
        return PrefetchLoader(
            lambda: self.create_sample_generator(self.get_loader_limit_count()),
            batch_size=self.flags.batch_size,
            device=self.device,
            time_bucket=getattr(self.flags, "bucket_step", 256),
            max_steps=self.get_max_steps(),
            group_by_length=getattr(self.flags, "group_by_length", False),
            transfer_dtype=getattr(self.flags, "transfer_dtype", "bfloat16"),
        )

    def checkpoint_manager(self) -> CheckpointManager:
        return CheckpointManager(self.flags.run_train_dir)

    @abc.abstractmethod
    def run(self):
        raise NotImplementedError
