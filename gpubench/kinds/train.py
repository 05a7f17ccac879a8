"""Training cells: the port's train loop, wired as ``Training.run`` wires it.

Set-up, in this order, all of it counted in ``setup_s``:

1. the corpus: the traffic's utterances drawn from the seed, the features
   on the device, written as the port's npz cache under the run's work
   directory (``corpus.py``);
2. the program: the flags from the port's own ``train`` parser, the
   port's ``Training`` executor (its reader and ``PrefetchLoader``; the
   reader's shuffle seeded from the run's seed, so a seed gives one order
   of batches), ``model.to(device).train()``, ``execution.init_state`` and
   ``train.step.make_train_step_acc(model, tx, accum_steps=1)``; the
   weights, drawn from the seed on the device, copied into the state's
   parameters;
3. the checked steps: the state's first ``check_steps`` steps, through the
   same loader iterator and the same step call the window uses, with the
   readings the comparison needs taken on the device between them;
4. the warm-up: one forward and backward of the loss (gradients dropped,
   the state untouched) at each bucket the corpus holds.

The window then runs the closed loop for ``seconds``: a step is launched
when the loader hands over its batch, a CUDA event is recorded after each
step, and the window ends at a synchronise. After it the loader is
stopped, the program's state freed, and the reference runs the checked
steps on the same utterances and weights (``check.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import os
import threading
import time
import warnings

import numpy as np
import torch

from gpubench import check, corpus, manifest, trace
from gpubench.reference import common


@dataclasses.dataclass
class Spec:
    """What ``run.py`` hands a kind of cell."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    limits: dict
    device: torch.device
    work_dir: str
    t_start: float  # time.perf_counter() at the process's start


@dataclasses.dataclass
class Step:
    """One step of the window: its padded shape and its rows' lengths."""

    frames: int  # padded input frames T
    label_width: int  # padded label width L
    seq_lengths: np.ndarray
    label_lengths: np.ndarray


@dataclasses.dataclass
class Result:
    setup_s: float
    window_s: float
    steps: list
    gaps_ms: list
    loader_wait_s: float
    syncs: int | None
    trace: object | None
    memory_peak_bytes: int
    attempted: int
    failed: int
    correct: bool
    checks: dict
    lines: list  # annotations printed before the result line


def program_flags(config: dict, traffic: dict, data_dir: str, device: torch.device):
    """The port's ``train`` flags: its own parser, its defaults, the
    configuration's and traffic's settings, and the architecture's own
    (``program_flags`` of its reference module)."""
    from speecht_tpu_torch.cli import CLI

    if traffic.get("spec_augment") or traffic.get("grad_accum", 1) != 1:
        raise ValueError("the train kind checks plain steps: no SpecAugment, "
                         "no gradient accumulation")
    argv = [
        "train", "--data-dir", data_dir, "--train-dir", os.path.join(data_dir, "train"),
        "--log-dir", os.path.join(data_dir, "log"), "--run-name", "gpubench",
        "--power" if config["feature_type"] == "power" else "--mfcc",
        "--batch-size", str(traffic["batch_size"]),
        "--bucket-step", str(traffic["bucket_step"]),
        "--compute-dtype", config["compute_dtype"],
        "--transfer-dtype", config["transfer_dtype"],
        "--learning-rate", repr(config["learning_rate"]),
        "--max-gradient-norm", repr(config["max_gradient_norm"]),
        "--device", device.type,
    ]
    if traffic["group_by_length"]:
        argv.append("--group-by-length")
    argv += manifest.architecture(config).program_flags(config)
    return CLI(argv).parsed


def seeded_training(flags, seed: int):
    """The port's ``Training`` with the reader's shuffle seeded."""
    from speecht_tpu_torch.training import Training

    class SeededTraining(Training):
        @property
        def shard_kwargs(self):
            return {**super().shard_kwargs, "seed": seed}

    return SeededTraining(flags)


class Clock:
    """Step completions: CUDA events on the card, the host clock on the
    CPU (whose steps end when the call returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def gaps_ms(self, marks: list) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rows_of(host, table: dict) -> list:
    """The corpus utterances of a host batch's rows, by frame count and
    transcript."""
    rows = []
    for i, n in enumerate(host.seq_lengths):
        if n == 0:
            continue
        lab = np.ascontiguousarray(host.labels[i, : host.label_lengths[i]], dtype=np.int32)
        rows.append(table[(int(n), lab.tobytes())])
    return rows


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    return {k: torch.linalg.vector_norm(t.detach().double()) * scale for k, t in tensors.items()}


def _read(norms: dict) -> dict:
    values = torch.stack(list(norms.values())).tolist()
    return dict(zip(norms, values))


def warm_up(model, mesh, spec: Spec, data: corpus.Corpus, features: np.ndarray) -> None:
    """One forward and backward of the loss at each bucket of the corpus,
    longest first; the gradients are dropped."""
    from speecht_tpu_torch.data import pipeline
    from speecht_tpu_torch.train import step as tstep

    bucket, batch = spec.traffic["bucket_step"], spec.traffic["batch_size"]
    keys = -(-data.frames // bucket) * bucket
    loss_fn = tstep.make_loss_fn(model, mesh)
    params = list(model.parameters())
    for key in sorted(set(keys.tolist()), reverse=True):
        idx = np.flatnonzero(keys == key).tolist()
        rows = (idx * math.ceil(batch / len(idx)))[:batch]
        samples = [(features[data.offsets[i]: data.offsets[i + 1]], data.labels[i]) for i in rows]
        host = pipeline.build_batch(samples, time_bucket=bucket)
        dev = pipeline.to_device(host, spec.device, spec.config["transfer_dtype"])
        with torch.enable_grad():
            value, _logits = loss_fn(dev)
            torch.autograd.grad(value, params)
    synchronize(spec.device)


class SyncCounter:
    """Counts the synchronizing CUDA operations that torch's sync debug
    mode reports on this thread while ``active``."""

    def __init__(self):
        self.count = 0
        self.active = False
        self._thread = threading.get_ident()
        self._stack = contextlib.ExitStack()

    def _record(self, message, category, filename, lineno, file=None, line=None):
        if self.active and threading.get_ident() == self._thread and "synchroniz" in str(message):
            self.count += 1

    def __enter__(self):
        self._stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("always")
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._stack.close()
        return False


class Program:
    """The program as set-up leaves it: the corpus on disk, the port's
    executor, state, step and loader iterator, after the checked steps."""

    def __init__(self, spec: Spec):
        from speecht_tpu_torch.execution import init_state
        from speecht_tpu_torch.train import step as tstep

        device, traffic, config = spec.device, spec.traffic, spec.config
        ref = manifest.architecture(config)
        self.spec, self.tstep = spec, tstep
        self.times = {}

        # 1. the corpus
        t = time.perf_counter()
        self.data = corpus.draw(traffic, config, spec.seed)
        self.features = corpus.draw_features(self.data, config, spec.seed, device)
        data_dir = os.path.join(spec.work_dir, "data")
        corpus.write_cache(data_dir, self.data, self.features, config)
        self.times["corpus"] = time.perf_counter() - t

        # 2. the program
        t = time.perf_counter()
        flags = program_flags(config, traffic, data_dir, device)
        self.training = seeded_training(flags, spec.seed)
        self.model = self.training.model
        self.model.to(device).train()
        self.state, tx = init_state(self.model, flags)
        self.weights = ref.make_weights(config, corpus.weight_seed(spec.seed), device)
        with torch.no_grad():
            for name, p in self.state.params.items():
                p.copy_(self.weights[name])
        self.train_step = tstep.make_train_step_acc(self.model, tx, accum_steps=1,
                                                    mesh=self.training.mesh)
        self.loader = self.training.create_loader()
        self.batches = iter(self.loader)
        self.times["program"] = time.perf_counter() - t

        # 3. the checked steps, through the window's own call and feed
        t = time.perf_counter()
        table = self.data.index()
        self.check_rows, losses = [], []
        for k in range(traffic["check_steps"]):
            host, batch = next(self.batches)
            self.check_rows.append((rows_of(host, table), host.features.shape[1]))
            acc = tstep.init_metrics_acc(device)
            self.state, acc = self.train_step(self.state, acc, batch)
            losses.append(acc["loss_sum"])
            if k == 0:
                # Adam's first moment after one step is (1 - b1) times the
                # clipped gradient
                grad_norms = _norms(self.state.opt_state.mu, 1.0 / (1.0 - config["adam_b1"]))
        change_norms = {k: torch.linalg.vector_norm((p.detach() - self.weights[k]).double())
                        for k, p in self.state.params.items()}
        self._readings = (losses, grad_norms, change_norms)
        checked = [u for utterances, _frames in self.check_rows for u in utterances]
        if len(set(checked)) != len(checked):
            raise ValueError("the checked steps repeat an utterance: the traffic's corpus "
                             "holds too few utterances a bucket for its batches")
        self.times["checked steps"] = time.perf_counter() - t

    def warm_up(self) -> None:
        t = time.perf_counter()
        warm_up(self.model, self.training.mesh, self.spec, self.data, self.features)
        self.times["warm-up"] = time.perf_counter() - t

    def readings(self) -> dict:
        """The checked steps' losses and norms (reads the device)."""
        losses, grad_norms, change_norms = self._readings
        return {"losses": torch.stack(losses).tolist(), "grad_norms": _read(grad_norms),
                "change_norms": _read(change_norms)}

    def close(self) -> None:
        """Stops the loader and frees the program's state."""
        self.batches.close()
        for name in ("state", "train_step", "model", "training", "loader", "batches",
                     "_readings"):
            setattr(self, name, None)
        gc.collect()
        if self.spec.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(spec: Spec, data: corpus.Corpus, features: np.ndarray, weights: dict,
                       check_rows: list, quantize=common.identity, rows=None) -> tuple:
    """The reference's steps on the checked batches' utterances, padded and
    batched anew; returns (readings, notes)."""
    ref = manifest.architecture(spec.config)
    notes, batches = [], []
    for utterances, frames in check_rows:
        feats, lengths, labels = corpus.pad_batch(data, features, utterances,
                                                  spec.traffic["bucket_step"])
        if feats.shape[1] != frames:
            notes.append(f"note: the reference pads a checked batch to {feats.shape[1]} "
                         f"frames, the program to {frames}")
        batches.append((torch.from_numpy(feats).to(spec.device),
                        torch.from_numpy(lengths).to(spec.device), labels))
    with common.float32_exact():
        return ref.train_steps(weights, batches, spec.config, quantize, rows), notes


def run(spec: Spec) -> Result:
    device = spec.device
    cuda = device.type == "cuda"
    program = Program(spec)
    program.warm_up()
    tstep, loader, batches = program.tstep, program.loader, program.batches
    state, train_step = program.state, program.train_step
    program.state = None

    # the window
    clock = Clock(device)
    span = trace.span if spec.trace else (lambda name: contextlib.nullcontext())
    counter = SyncCounter() if spec.trace and cuda else None
    prof = trace.start(device) if spec.trace else None
    acc = tstep.init_metrics_acc(device)
    stalls0 = (loader.stall_count, loader.stall_seconds)
    marks, steps, loss_sums, wait_s = [], [], [], 0.0
    with contextlib.ExitStack() as stack:
        if counter is not None:
            stack.enter_context(counter)
        with span("window"):
            synchronize(device)
            t0 = time.perf_counter()
            marks.append(clock.mark())
            if counter is not None:
                counter.active = True
            while True:
                tw = time.perf_counter()
                with span("loader_wait"):
                    host, batch = next(batches)
                wait_s += time.perf_counter() - tw
                with span("train_step"):
                    state, acc = train_step(state, acc, batch)
                marks.append(clock.mark())
                loss_sums.append(acc["loss_sum"])
                steps.append(Step(host.features.shape[1], host.labels.shape[1],
                                  host.seq_lengths.copy(), host.label_lengths.copy()))
                if time.perf_counter() - t0 >= spec.seconds:
                    break
            if counter is not None:
                counter.active = False
            with span("sync"):
                synchronize(device)
            window_s = time.perf_counter() - t0
    t = time.perf_counter()
    traced = None
    if prof is not None:
        prof.stop()
        traced = trace.Trace(prof)
        del prof
    trace_s = time.perf_counter() - t
    setup_s = t0 - spec.t_start
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gaps = clock.gaps_ms(marks)
    window_losses = np.diff(np.array([0.0] + torch.stack(loss_sums).tolist()))
    stalls = (loader.stall_count - stalls0[0], loader.stall_seconds - stalls0[1])
    readings = program.readings()
    del state, acc, batch, train_step, loader, batches
    program.close()

    t = time.perf_counter()
    reference, notes = reference_readings(spec, program.data, program.features,
                                          program.weights, program.check_rows)
    values = check.numbers(readings, reference)
    correct, checks = check.verdict(values, spec.limits)
    ref_s = time.perf_counter() - t

    buckets = collections.Counter(s.frames for s in steps)
    times = ", ".join(f"{k} {v:.3f} s" for k, v in program.times.items())
    lines = notes + [
        f"setup: {times}; {int(program.data.offsets[-1])} frames in {len(program.data)} "
        f"utterances; setup_s {setup_s:.3f} s",
        f"window: {len(steps)} steps in {window_s:.3f} s; steps by padded frames "
        f"{dict(sorted(buckets.items()))}; the loader's own stall count {stalls[0]} "
        f"({stalls[1]:.3f} s, waits over 2 ms); waits for a batch {wait_s:.3f} s; "
        f"the trace read in {trace_s:.3f} s",
        f"check: program losses {readings['losses']}, reference losses "
        f"{reference['losses']}; every number read {values}; the reference took "
        f"{ref_s:.3f} s",
    ]
    return Result(
        setup_s=setup_s, window_s=window_s, steps=steps, gaps_ms=gaps,
        loader_wait_s=wait_s, syncs=None if counter is None else counter.count,
        trace=traced, memory_peak_bytes=int(memory_peak), attempted=len(steps),
        failed=int((~np.isfinite(window_losses)).sum()), correct=correct,
        checks=checks, lines=lines,
    )
