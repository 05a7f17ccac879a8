"""Checkpoints of the port, and the ``.npy`` weight export.

Counterpart of ``speecht_tpu/train/checkpoint.py`` (``CheckpointManager``,
``export_weights``). The JAX package writes orbax checkpoints, which the
port cannot read (orbax is a JAX library). The port's format:

  <directory>/ckpt-<step>.pt   torch.save of {"format", "step_label",
                                "params", "mu", "nu", "count", "step",
                                "learning_rate"}

with every tensor on the CPU and the params, ``mu`` and ``nu`` keyed by
the model's state-dict names (``conv_i.weight [O, I, W]``,
``conv_i.bias``). A model with buffers (the Conformer's BatchNorm running
statistics) also saves them, under ``"buffers"``, and restores them with
the parameters; Wav2Letter has none, and its files have no such key. A
save writes ``ckpt-<step>.pt.tmp-<pid>`` and publishes
it with ``os.replace``, so a crash mid-write leaves no file under a
checkpoint's name; leftover temporary files are ignored. The newest
``max_to_keep`` checkpoints are kept.

In a multi-process run the file is the same: every rank takes part in
gathering the tensor-parallel shards (``weights.TensorSplit``), rank 0
writes the one-device layout, and a barrier ends the save; a restore
waits at a barrier, then every rank reads the file and takes its shards.
So a checkpoint moves between world sizes and grids.

A directory that holds only the JAX package's orbax steps is refused with
a clear error rather than misread or trained over. The bridge from the
JAX package to the port is ``speecht-cli export --weights DIR`` and the
port's ``evaluate --reference-weights DIR``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.train.state import AdamState, TrainState
from speecht_tpu_torch.weights import TensorSplit, copy_into, params_to_jax

FORMAT = "speecht_tpu_torch/checkpoint/1"
_NAME = re.compile(r"ckpt-(\d+)\.pt$")


def _cpu(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _rank0_decides(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (``flag`` itself for one process)."""
    if not comm.initialized():
        return flag
    return bool(comm.host_all_gather(np.asarray([flag]))[0][0])


class CheckpointManager:
    def __init__(
        self, directory: str, max_to_keep: int = 5,
        split: TensorSplit = TensorSplit(),
        buffers: dict[str, torch.Tensor] | None = None,
    ):
        """``split``: the model's tensor-parallel split, so that the file
        holds full tensors and each rank restores its shards. ``buffers``:
        the model's buffers by name (``named_buffers``), saved from and
        restored into in place; none saves no ``"buffers"`` key."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.split = split
        self.buffers = buffers or {}
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(
            int(m.group(1))
            for m in map(_NAME.match, os.listdir(self.directory))
            if m
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: int | None = None):
        """Persist ``state`` under label ``step`` (default ``state.step``).

        The training loop passes its micro-batch counter, so labels,
        printed step lines and ``--max-steps`` share one unit under
        ``--grad-accum``. A label that exists already is not written
        again. Saves are synchronous. In a multi-process run every rank
        calls it at the same step (a collective).
        """
        if step is None:
            step = int(state.step)
        path = self.path(step)
        # one decision for every rank: a rank that looked after rank 0
        # wrote would see the file
        if _rank0_decides(os.path.exists(path)):
            return
        payload = {
            "format": FORMAT,
            "step_label": step,
            "params": _cpu(self.split.unshard(state.params)),
            "mu": _cpu(self.split.unshard(state.opt_state.mu)),
            "nu": _cpu(self.split.unshard(state.opt_state.nu)),
            "count": int(state.opt_state.count),
            "step": int(state.step),
            "learning_rate": float(state.learning_rate),
        }
        if self.buffers:
            payload["buffers"] = _cpu(self.buffers)
        if comm.rank() == 0:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self.path(old))
        comm.barrier()

    def _orbax_steps(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.directory)
            if d.isdigit() and os.path.isdir(os.path.join(self.directory, d))
        )

    def _load_latest(self, what: str) -> tuple[int, dict]:
        comm.barrier()  # no rank reads while another writes
        step = self.latest_step()
        if step is None:
            orbax = self._orbax_steps()
            if orbax:
                raise RuntimeError(
                    f"{self.directory} holds only checkpoints of the JAX "
                    f"package (orbax steps {orbax[-3:]}), which "
                    "speecht_tpu_torch cannot read. Export the weights with "
                    "`speecht-cli export --weights DIR` and pass "
                    "`--reference-weights DIR`, or train into another "
                    "--train-dir/--run-name."
                )
            raise FileNotFoundError(
                f"No checkpoint for {what} found in {self.directory}"
            )
        try:
            payload = torch.load(self.path(step), map_location="cpu", weights_only=True)
            if not isinstance(payload, dict) or payload.get("format") != FORMAT:
                raise ValueError(f"not a {FORMAT} checkpoint")
        except Exception as e:
            raise self._corrupt(step, e) from e
        return step, payload

    def _corrupt(self, step: int, e: Exception) -> RuntimeError:
        # a committed-but-unreadable checkpoint (torn disk, truncated file,
        # bit rot) fails with an actionable message; a checkpoint that was
        # being written when the process died never has a checkpoint name
        return RuntimeError(
            f"Checkpoint at step {step} in {self.directory} failed to "
            f"restore ({type(e).__name__}: {e}). The checkpoint files "
            f"are likely corrupt or truncated; remove {self.path(step)} "
            f"to fall back to the previous checkpoint."
        )

    def restore(
        self, template: TrainState, reset_learning_rate: float | None = None
    ) -> TrainState:
        """Restore the latest checkpoint into ``template``'s tensors.

        The template's tensors (the model's parameters among them) are
        overwritten in place and keep their device. Raises
        FileNotFoundError when no checkpoint exists.
        """
        step, payload = self._load_latest("evaluation")
        shard = self.split.shard
        try:
            copy_into(template.params, shard(payload["params"]), "params")
            self._restore_buffers(payload)
            copy_into(template.opt_state.mu, shard(payload["mu"]), "mu")
            copy_into(template.opt_state.nu, shard(payload["nu"]), "nu")
            device = template.step.device
            state = TrainState(
                params=template.params,
                opt_state=AdamState(
                    mu=template.opt_state.mu,
                    nu=template.opt_state.nu,
                    count=torch.tensor(payload["count"], dtype=torch.int32, device=device),
                ),
                step=torch.tensor(payload["step"], dtype=torch.int32, device=device),
                learning_rate=torch.tensor(
                    payload["learning_rate"], dtype=torch.float32, device=device
                ),
            )
        except Exception as e:
            raise self._corrupt(step, e) from e
        if reset_learning_rate is not None:
            state = dataclasses.replace(
                state,
                learning_rate=torch.tensor(
                    reset_learning_rate, dtype=torch.float32, device=state.step.device
                ),
            )
        return state

    def restore_params(self, params: dict[str, torch.Tensor]) -> int:
        """Restore only the parameters of the latest checkpoint into
        ``params`` (in place); returns its optimizer step."""
        step, payload = self._load_latest("evaluation")
        try:
            copy_into(params, self.split.shard(payload["params"]), "params")
            self._restore_buffers(payload)
        except Exception as e:
            raise self._corrupt(step, e) from e
        return int(payload["step"])

    def _restore_buffers(self, payload: dict) -> None:
        if self.buffers:
            copy_into(self.buffers, payload["buffers"], "buffers")

    def restore_or_create(
        self, template: TrainState, reset_learning_rate: float | None = None
    ) -> tuple[TrainState, bool]:
        """(state, restored?): the fresh template when no checkpoint exists."""
        try:
            return self.restore(template, reset_learning_rate), True
        except FileNotFoundError:
            print("Created model with fresh parameters.")
            return template, False


def export_weights(params: dict[str, torch.Tensor], out_dir: str) -> list[str]:
    """Save every parameter as ``<out_dir>/conv_i/{kernel,bias}.npy``.

    The names and layouts (kernel ``[W, I, O]``) are the JAX package's
    ``export_weights``, so ``weights.load_weight_dir`` and the JAX package
    read the result.
    """
    written = []
    for layer, leaves in params_to_jax(params).items():
        for leaf, value in leaves.items():
            path = os.path.join(out_dir, layer, leaf + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, value)
            written.append(path)
    return written
