"""Executor scaffolding shared by the commands.

Counterpart of ``speecht_tpu/execution.py``: model construction from the
flags (``--model``: Wav2Letter, or the Conformer-CTC the JAX package does
not have), the fresh train state (``init_state``), the corpus reader, the
input-size probe (width of the first cached sample), the grid of ranks
(``create_mesh``: ``--data-parallel``/``--model-parallel``, a ``1 x 1``
grid for one process), the batch loader wired to a per-command sample
generator, and the run's checkpoint manager. Each rank runs on the
device ``parallel/mesh.py::rank_device`` names for ``--device``.
``--batch-size`` is global: each data rank reads its own shard of the
corpus (``shard_kwargs``) and builds ``local_batch_size`` rows.
"""

from __future__ import annotations

import abc
import os
from typing import Iterator

import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data.pipeline import PrefetchLoader
from speecht_tpu_torch.data.reader import SpeechCorpusReader
from speecht_tpu_torch.models import conformer
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops import conv0
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.parallel import mesh as pmesh
from speecht_tpu_torch.train.checkpoint import CheckpointManager
from speecht_tpu_torch.train.state import (
    ClipAdam,
    TrainState,
    create_train_state,
    make_optimizer,
)


def resolve_device(name: str) -> torch.device:
    """``--device`` -> this rank's torch.device. ``cuda`` without a card
    raises: the port never carries on on the CPU unless it was asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    return pmesh.rank_device(name)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """What a measurement ran on: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def model_name(flags) -> str:
    """``--model`` (``wav2letter`` where the flags have none). A ValueError
    naming the path where the Conformer is asked of one that runs
    Wav2Letter alone."""
    name = getattr(flags, "model", "wav2letter")
    if name != "conformer":
        return name
    for asked, why in (
        (getattr(flags, "model_parallel", 1) > 1,
         "--model-parallel splits Wav2Letter's wide layers"),
        ((getattr(flags, "seq_parallel", 0) or 0) > 1,
         "--seq-parallel shards Wav2Letter's conv stack over time"),
        (os.environ.get(conv0.ENV_VAR) == "1",
         f"{conv0.ENV_VAR}=1 runs Wav2Letter's conv_0 kernel"),
        (bool(getattr(flags, "reference_weights", None)),
         "--reference-weights holds Wav2Letter's weights"),
    ):
        if asked:
            raise ValueError(f"--model conformer: {why}; it trains on one rank or on "
                             "--data-parallel ranks and evaluates greedy or with "
                             "--language-model")
    return name


def refuse_conformer(flags, path: str) -> None:
    """A ValueError where ``path`` (a command that runs Wav2Letter alone)
    is asked for ``--model conformer``."""
    if getattr(flags, "model", "wav2letter") != "wav2letter":
        raise ValueError(f"{path} runs Wav2Letter alone; --model {flags.model} "
                         "is not supported there")


def build_model(input_size: int, flags, seed: int = 0, mesh=None):
    """``--model``'s network. Wav2Letter with the reference dimensions by
    default; --base-channels/--wide-channels/--num-body-layers scale it,
    and ``mesh`` with a model axis splits the wide layers over it. The
    Conformer at Conformer (L)'s by default; --d-model, --num-heads,
    --ffn-dim, --num-blocks, --conv-kernel, --subsampling-channels and
    --dropout set it. Initial weights come from a CPU generator seeded
    with ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    if model_name(flags) == "conformer":
        default = conformer.ConformerConfig()
        return conformer.Conformer(conformer.ConformerConfig(
            input_size=input_size,
            num_classes=vocabulary.NUM_CLASSES,
            **{k: getattr(flags, k, getattr(default, k)) for k in (
                "d_model", "num_heads", "ffn_dim", "num_blocks", "conv_kernel",
                "subsampling_channels", "dropout", "compute_dtype")},
        ), generator=generator)
    cfg = Wav2LetterConfig(
        input_size=input_size,
        num_classes=vocabulary.NUM_CLASSES,
        base_channels=getattr(flags, "base_channels", 250),
        wide_channels=getattr(flags, "wide_channels", 2000),
        num_body_layers=getattr(flags, "num_body_layers", 7),
        compute_dtype=getattr(flags, "compute_dtype", "bfloat16"),
    )
    return Wav2Letter(cfg, generator=generator, mesh=mesh)


def init_state(
    model, flags, generator: torch.Generator | None = None
) -> tuple[TrainState, ClipAdam]:
    """Fresh TrainState over ``model``'s parameters, reference optimizer
    settings. The parameters are drawn anew from ``generator`` (a CPU
    generator seeded with 0 by default; the model's ``reset_parameters``)
    and keep the model's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    tx = make_optimizer(
        max_gradient_norm=getattr(flags, "max_gradient_norm", 5.0),
        epsilon=getattr(flags, "epsilon", 1e-3),
    )
    lr = getattr(flags, "learning_rate", 1e-4)
    return create_train_state(dict(model.named_parameters()), tx, lr), tx


def start_readback(tensors):
    """Start the device -> host copies of a step's outputs.

    On the card the copies go into pinned memory without blocking and an
    event marks their end, so work launched afterwards is not waited for.
    """
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    done = torch.cuda.Event()
    done.record()
    return host, done


def finish_readback(host, done):
    if done is not None:
        done.synchronize()
    return [t.numpy() for t in host]


class DatasetExecutor(abc.ABC):
    """Base for executors that stream the cached corpus through the model."""

    def __init__(self, flags):
        self.flags = flags
        model_name(flags)  # a path the model cannot take stops here
        self.device = resolve_device(getattr(flags, "device", "cuda"))
        self.reader = SpeechCorpusReader(flags.data_dir)

        print("Determine input size from first sample")
        self.input_size = self.determine_input_size()
        self.mesh = self.create_mesh()
        self.model = build_model(self.input_size, flags, mesh=self.mesh)

    def create_mesh(self) -> pmesh.Mesh:
        """The grid of ranks; ValueError when the flags cannot tile them."""
        return pmesh.auto_mesh(
            batch_size=self.flags.batch_size,
            data_parallel=getattr(self.flags, "data_parallel", 0),
            model_parallel=getattr(self.flags, "model_parallel", 1),
        )

    @property
    def shard_kwargs(self) -> dict:
        """The reader's arguments for this rank: the data rank's shard of
        the corpus, and one shuffle (seed 0) shared by every rank, since
        the ranks of a model group must read the same rows."""
        if comm.world_size() <= 1:
            return {}
        return {"seed": 0, "shard_index": self.mesh.data_index,
                "shard_count": self.mesh.dp}

    def local_batch_size(self) -> int:
        """--batch-size is GLOBAL; each data rank builds its share."""
        if self.flags.batch_size % self.mesh.dp:
            raise ValueError(
                f"--batch-size {self.flags.batch_size} must divide across "
                f"{self.mesh.dp} data-parallel ranks"
            )
        return self.flags.batch_size // self.mesh.dp

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
            batch_size=self.local_batch_size(),
            device=self.device,
            time_bucket=getattr(self.flags, "bucket_step", 256),
            max_steps=self.get_max_steps(),
            group_by_length=getattr(self.flags, "group_by_length", False),
            transfer_dtype=getattr(self.flags, "transfer_dtype", "bfloat16"),
        )

    def checkpoint_manager(self) -> CheckpointManager:
        return CheckpointManager(self.flags.run_train_dir, split=self.model.split,
                                 buffers=dict(self.model.named_buffers()))

    @abc.abstractmethod
    def run(self):
        raise NotImplementedError
