"""Training executor.

Counterpart of ``speecht_tpu/training.py`` (``Training``,
``should_decay_learning_rate``, ``perplexity``), on one device:

- an infinite shuffled generator over the cached train split, with
  ``--limit-training-set`` and ``--max-input-frames``;
- restore-or-create from the run's train dir, ``--reset-learning-rate``;
- once per ``--steps-per-checkpoint``: the ``global step ... learning
  rate ... step-time ... average loss ... perplexity`` line, the scalars
  ``loss``/``learning_rate``/``grad_norm``/``step_time``/prefetch stalls,
  one histogram per parameter, the plateau decay (when the interval's
  loss exceeds the max of the last three), a checkpoint and
  "Model saved";
- ``--max-steps`` counted from this launch; SIGINT/SIGTERM request a
  deferred stop at a step boundary, then a crash-save.

The loss and grad-norm sums stay on the device; the loop reads them back
once per interval, never per step. The multi-process, mesh,
SpecAugment, profiler and image/activation-summary branches of the JAX
loop are not ported (the CLI refuses their flags).
"""

from __future__ import annotations

import os
import signal
import time

import torch

from speecht_tpu_torch.execution import DatasetExecutor, init_state
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train import summaries as tsummaries
from speecht_tpu_torch.train.metrics_writer import SummaryWriter
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
    def grad_accum(self) -> int:
        """Micro-batches per optimizer update (``--grad-accum``)."""
        return int(getattr(self.flags, "grad_accum", 1) or 1)

    def create_sample_generator(self, limit_count: int):
        return self.reader.load_samples(
            "train",
            loop_infinitely=True,
            limit_count=limit_count,
            feature_type=self.flags.feature_type,
            max_size=getattr(self.flags, "max_input_frames", 0) or False,
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
        train_step = tstep.make_train_step_acc(
            self.model, tx, accum_steps=self.grad_accum
        )
        writer = SummaryWriter(
            os.path.join(flags.log_dir, f"{flags.run_name}_{flags.run_type}")
        )

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
        param_summarizer = tsummaries.make_param_summarizer()
        window_start = time.time()
        stall_mark = (0, 0.0)  # (count, seconds) at the last interval

        loader = self.create_loader()
        for _host_batch, batch in loader:
            # from the step's in-place update until the crash-save's state
            # points at the result, a second signal waits (_request_stop)
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
                # the one readback per interval: four sums and the lr
                m = torch.stack(
                    [acc["loss_sum"], acc["grad_norm_sum"], acc["count"],
                     acc["updates"], state.learning_rate]
                ).tolist()
                loss_sum, grad_norm_sum, count, updates, lr = m
                acc = tstep.init_metrics_acc(self.device)
                avg_loss = loss_sum / max(count, 1.0)
                # grad norms exist only at optimizer applies
                avg_grad_norm = grad_norm_sum / max(updates, 1.0)
                step_time = (time.time() - window_start) / spc
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
                if d_n:
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
                writer.add_raw_histograms(global_step, param_summarizer(state.params))
                writer.flush()

                if should_decay_learning_rate(
                    previous_losses, avg_loss, flags.learning_rate_decay_factor
                ):
                    state = tstep.decay_learning_rate(
                        state, flags.learning_rate_decay_factor
                    )
                    self._latest_state = state
                previous_losses.append(avg_loss)

                ckpt.save(state, step=global_step)
                print("Model saved", flush=True)
                window_start = time.time()
        return state
