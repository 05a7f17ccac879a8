"""Training executor.

Counterpart of ``speecht_tpu/training.py`` (``Training``,
``should_decay_learning_rate``, ``perplexity``):

- an infinite shuffled generator over the cached train split, with
  ``--limit-training-set`` and ``--max-input-frames``;
- restore-or-create from the run's train dir, ``--reset-learning-rate``;
- ``--spec-augment``: masks drawn on the device inside the train step,
  keyed on (optimizer step, micro-batch) (``ops/augment.py``);
- once per ``--steps-per-checkpoint``: the ``global step ... learning
  rate ... step-time ... average loss ... perplexity`` line, the scalars
  ``loss``/``learning_rate``/``grad_norm``/``step_time``/prefetch stalls,
  one histogram per parameter, with ``--verbose-summaries`` also the
  filter/bias images and, from a rerun of the forward on the interval's
  last batch, the activation and logits histograms and the logits image;
  then the plateau decay (when the interval's loss exceeds the max of
  the last three), a checkpoint and "Model saved";
- ``--profile-steps START:STOP`` (STOP defaults to START+5), counted from
  this launch: a ``torch.profiler`` trace (CPU, and CUDA on the card) of
  those steps, each from the wait for its batch on, written under
  ``<log_dir>/profile``, with the program's spans (``telemetry.py``):
  the step's and the loop's (``train.interval``, and ``checkpoint.save``
  inside it) and the loader thread's. The JAX loop falls
  back to wall-clock step times on backends that cannot host its
  profiler service; ``torch.profiler`` has no such backend, so that
  branch is not ported;
- ``--max-steps`` counted from this launch; SIGINT/SIGTERM request a
  deferred stop at a step boundary, then a crash-save.

The loss and grad-norm sums stay on the device; the loop reads them back
once per interval, never per step.

Several processes (``torchrun``; ``parallel/mesh.py``) run the same loop
in lockstep on a grid of ranks: ``--data-parallel``/``--model-parallel``
(``execution.py::create_mesh``) or ``--seq-parallel N`` (the time-sharded
conv stack of ``parallel/seq_parallel.py``, which raises
``--bucket-step`` to ``96 N``). Each data rank reads its shard; the step
reduces the loss and gradients over the ranks (``train/step.py``). Rank 0
prints the interval lines and writes the summaries (a
``NullSummaryWriter`` elsewhere); every rank takes part in the gathers of
the summaries and checkpoints. After an interrupt or a crash no rank
crash-saves alone: the ranks stop at different steps, and a relaunch
resumes from the last checkpoint they wrote together.
"""

from __future__ import annotations

import os
import signal
import sys
import time

import torch

from speecht_tpu_torch import telemetry
from speecht_tpu_torch.execution import DatasetExecutor, init_state
from speecht_tpu_torch.ops.augment import make_augment_fn
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train import summaries as tsummaries
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.train.metrics_writer import NullSummaryWriter, SummaryWriter
from speecht_tpu_torch.train.step import perplexity


def should_decay_learning_rate(
    previous_losses: list, current_loss: float, decay_factor: float
) -> bool:
    """Plateau rule: decay when no improvement over the last 3 checkpoints."""
    return (
        decay_factor > 0
        and len(previous_losses) > 2
        and current_loss > max(previous_losses[-3:])
    )


class Training(DatasetExecutor):
    @property
    def seq_parallel(self) -> int:
        return int(getattr(self.flags, "seq_parallel", 0) or 0)

    @property
    def grad_accum(self) -> int:
        """Micro-batches per optimizer update (``--grad-accum``)."""
        return int(getattr(self.flags, "grad_accum", 1) or 1)

    def create_mesh(self):
        if self.seq_parallel > 1:
            from speecht_tpu_torch.parallel.seq_parallel import make_sp_mesh

            return make_sp_mesh(self.flags, self.seq_parallel)
        return super().create_mesh()

    def create_sample_generator(self, limit_count: int):
        return self.reader.load_samples(
            "train",
            loop_infinitely=True,
            limit_count=limit_count,
            feature_type=self.flags.feature_type,
            max_size=getattr(self.flags, "max_input_frames", 0) or False,
            **self.shard_kwargs,
        )

    def get_loader_limit_count(self) -> int:
        return self.flags.limit_training_set

    def get_max_steps(self):
        return getattr(self.flags, "max_steps", None)

    def run(self):
        flags = self.flags
        self.model.to(self.device).train()
        state, tx = init_state(self.model, flags)
        ckpt = self.checkpoint_manager()
        state, restored = ckpt.restore_or_create(
            state,
            reset_learning_rate=(
                flags.learning_rate if flags.reset_learning_rate else None
            ),
        )
        if restored:
            # the checkpoint label is in the loop's unit (micro-batches)
            print(f"Restored model at step {ckpt.latest_step()}")
        if self.grad_accum > 1:
            print(
                f"gradient accumulation: {self.grad_accum} micro-batches "
                f"per update (effective batch "
                f"{flags.batch_size * self.grad_accum})"
            )
        augment_fn = None
        if getattr(flags, "spec_augment", False):
            fw = getattr(flags, "spec_augment_freq_width", None)
            if fw is None:
                # the mask budget scaled to the feature axis: 15 of 128
                # power bins, 4 of 39 mfcc coefficients
                fw = 4 if flags.feature_type == "mfcc" else 15
            tf_frac = getattr(flags, "spec_augment_time_frac", 0.05)
            augment_fn = make_augment_fn(freq_width=fw, time_frac=tf_frac)
            print(
                f"SpecAugment on: 2 freq masks (width <= {fw}), "
                f"2 time masks (width <= {tf_frac:.2f} x valid frames)"
            )
        sp_loss_fn = None
        if self.seq_parallel > 1:
            # long utterances: the conv stack sharded over time (halo
            # exchanges) instead of discarding what does not fit a card
            from speecht_tpu_torch.parallel.seq_parallel import make_sp_loss_fn

            sp_loss_fn = make_sp_loss_fn(self.model, self.mesh)
        train_step = tstep.make_train_step_acc(
            self.model, tx, accum_steps=self.grad_accum, augment_fn=augment_fn,
            mesh=self.mesh, loss_fn=sp_loss_fn,
        )
        # one event file a run, written by rank 0
        if self.mesh.primary:
            writer = SummaryWriter(
                os.path.join(flags.log_dir, f"{flags.run_name}_{flags.run_type}")
            )
        else:
            writer = NullSummaryWriter()

        print("Begin training")
        self._latest_state = state
        self._latest_global_step = None
        self._stop_requested = False
        self._in_step = False

        prev_handlers = []
        try:
            for sig in (signal.SIGINT, signal.SIGTERM):
                prev_handlers.append((sig, signal.signal(sig, self._request_stop)))
        except ValueError:
            pass  # not the main thread (tests); default handling applies

        try:
            state = self._train_loop(state, train_step, writer, ckpt)
        except KeyboardInterrupt:
            print("\nInterrupted -- saving checkpoint before exit")
            self._stop_requested = True
            state = self._latest_state
        finally:
            for sig, handler in prev_handlers:
                signal.signal(sig, handler)
            crashing = sys.exc_info()[0] is not None
            if (self._stop_requested or crashing) and comm.world_size() > 1:
                # the signal or the error lands at another step on each
                # rank, so a save (a collective) would wait for peers that
                # are training on or gone; every interval's checkpoint was
                # written by all ranks together
                print(
                    "distributed interrupt/crash: skipping solo "
                    f"crash-save; relaunch resumes from cooperative "
                    f"checkpoint step {ckpt.latest_step()}",
                    flush=True,
                )
            else:
                ckpt.save(self._latest_state, step=self._latest_global_step)
            writer.close()
        print("Done training -- step limit reached")
        return state

    def _request_stop(self, _signum, _frame):
        """SIGINT/SIGTERM handler: a *deferred* stop.

        The loop finishes the step in flight and exits at a step boundary.
        A second signal raises KeyboardInterrupt at once, except inside a
        step: the step updates the parameters in place, so an interrupt
        there would leave the crash-save half an update; the loop stops
        when that step ends instead.
        """
        if self._stop_requested and not self._in_step:
            raise KeyboardInterrupt
        self._stop_requested = True
        print("\nstop requested -- finishing the current step", flush=True)

    def _train_loop(self, state, train_step, writer, ckpt):
        flags = self.flags
        previous_losses: list[float] = []
        spc = flags.steps_per_checkpoint
        # the global step is counted on the host, in micro-batches (the
        # unit of --max-steps, the printed lines and checkpoint labels);
        # a resume continues from the restored checkpoint's label
        global_step = ckpt.latest_step()
        if global_step is None:
            global_step = int(state.step) * self.grad_accum
        self._latest_global_step = global_step
        acc = tstep.init_metrics_acc(self.device)
        gacc = (
            tstep.init_grad_accum(state.params) if self.grad_accum > 1 else None
        )
        verbose = bool(getattr(flags, "verbose_summaries", False))
        param_summarizer = tsummaries.make_param_summarizer(with_images=verbose)
        act_summarizer = (
            tsummaries.make_activation_summarizer(self.model) if verbose else None
        )
        profiler = None
        if getattr(flags, "profile_steps", None):
            profiler = StepProfiler(
                flags.profile_steps, flags.log_dir, flags.run_name, self.device
            )
        start_step = global_step  # --profile-steps counts from this launch
        window_start = time.perf_counter()
        stall_mark = (0, 0.0)  # (count, seconds) at the last interval

        loader = self.create_loader()
        try:
            if profiler is not None:
                profiler.before_step(0)
            for _host_batch, batch in loader:
                # from the step's in-place update until the crash-save's
                # state points at the result, a second signal waits
                # (_request_stop)
                self._in_step = True
                if gacc is None:
                    state, acc = train_step(state, acc, batch)
                else:
                    state, gacc, acc = train_step(state, gacc, acc, batch)
                self._latest_state = state
                global_step += 1
                self._latest_global_step = global_step
                self._in_step = False
                if self._stop_requested:
                    print("\nInterrupted -- saving checkpoint before exit", flush=True)
                    return state

                if global_step % spc == 0:
                    with telemetry.span("train.interval"):
                        state, window_start, stall_mark = self._end_interval(
                            state, acc, batch, global_step, writer, ckpt, loader,
                            previous_losses, window_start, stall_mark,
                            param_summarizer, act_summarizer,
                        )
                    acc = tstep.init_metrics_acc(self.device)
                if profiler is not None:
                    # closes the trace at STOP, or opens it before the
                    # next step's wait for its batch
                    profiler.after_step(global_step - start_step)
                    profiler.before_step(global_step - start_step)
        finally:
            if profiler is not None:
                profiler.close()
        return state

    def _end_interval(self, state, acc, batch, global_step, writer, ckpt,
                      loader, previous_losses, window_start, stall_mark,
                      param_summarizer, act_summarizer):
        """The once-per-interval work: the readback and the line, the
        summaries, the plateau decay and the checkpoint. Returns (state,
        the next window's start, the stall mark)."""
        flags = self.flags
        # the one readback per interval: four sums and the lr
        m = torch.stack(
            [acc["loss_sum"], acc["grad_norm_sum"], acc["count"],
             acc["updates"], state.learning_rate]
        ).tolist()
        loss_sum, grad_norm_sum, count, updates, lr = m
        avg_loss = loss_sum / max(count, 1.0)
        # grad norms exist only at optimizer applies
        avg_grad_norm = grad_norm_sum / max(updates, 1.0)
        step_time = (time.perf_counter() - window_start) / flags.steps_per_checkpoint
        primary = comm.rank() == 0
        if primary:
            print(
                "global step {:d} learning rate {:.4f} step-time "
                "{:.2f} average loss {:.2f} perplexity {:.2f}".format(
                    global_step, lr, step_time, avg_loss, perplexity(avg_loss)
                ),
                flush=True,
            )
        d_n = loader.stall_count - stall_mark[0]
        d_s = loader.stall_seconds - stall_mark[1]
        stall_mark = (loader.stall_count, loader.stall_seconds)
        if d_n and primary:
            print(
                f"prefetch stalled {d_n} times ({d_s:.2f}s) this interval",
                flush=True,
            )
        writer.add_scalars(global_step, {
            "loss": avg_loss,
            "learning_rate": lr,
            "grad_norm": avg_grad_norm,
            "step_time": step_time,
            "prefetch_stalls": float(d_n),
            "prefetch_stall_seconds": d_s,
        })
        # parameter histograms (+ filter/bias images when verbose), and the
        # activation summaries of the interval's last batch
        params = state.params
        if comm.world_size() > 1:
            # the one-device layout (tensor-parallel shards gathered on every rank)
            params = self.model.split.unshard(params)
        hists, images = param_summarizer(params)
        writer.add_raw_histograms(global_step, hists)
        if images:
            writer.add_images(global_step, images)
        if act_summarizer is not None:
            ahists, aimages = act_summarizer(batch.features, batch.seq_lengths)
            writer.add_raw_histograms(global_step, ahists)
            writer.add_images(global_step, aimages)
        writer.flush()

        if should_decay_learning_rate(
            previous_losses, avg_loss, flags.learning_rate_decay_factor
        ):
            state = tstep.decay_learning_rate(
                state, flags.learning_rate_decay_factor
            )
            self._latest_state = state
        previous_losses.append(avg_loss)

        with telemetry.span("checkpoint.save"):
            ckpt.save(state, step=global_step)
        if primary:
            print("Model saved", flush=True)
        return state, time.perf_counter(), stall_mark


class StepProfiler:
    """A ``torch.profiler`` trace over the steps [START, STOP) of this
    launch (``--profile-steps START:STOP``, STOP = START+5 when left out),
    CPU activity and, on the card, CUDA activity. The trace is written as
    Chrome trace JSON under ``<log_dir>/profile``, with the spans the
    program's other threads logged meanwhile (the loader's; the loop's
    own are ``record_function``s in it already)."""

    def __init__(self, spec: str, log_dir: str, run_name: str, device):
        lo, _, hi = spec.partition(":")
        self.start, self.stop = int(lo), int(hi or int(lo) + 5)
        self.log_dir = log_dir
        self.path = os.path.join(
            log_dir, "profile",
            f"{run_name}_steps_{self.start}-{self.stop}.pt.trace.json",
        )
        self.device = torch.device(device)
        self._prof = None
        self._first_span = None

    def before_step(self, done: int) -> None:
        """``done``: steps this launch has taken before the next one."""
        if self._prof is None and done == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._first_span = telemetry.LOG.new_id()

    def after_step(self, done: int) -> None:
        if self._prof is not None and done >= self.stop:
            self.close()

    def close(self) -> None:
        """Ends an open trace (at STOP, or where the loop ends) and writes it."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the window's kernels end in it
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        telemetry.add_to_chrome_trace(self.path, self._first_span)
        self._prof = None
        print(f"Profiler trace written to {self.log_dir}/profile", flush=True)
