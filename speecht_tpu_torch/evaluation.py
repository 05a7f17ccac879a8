"""Evaluation executor: the cached-feature, greedy-decode branch.

Counterpart of ``speecht_tpu/evaluation.py`` (``run``,
``_result_iterator``, ``_track_batch``, ``print_global_statistics``):
runs the dev or test split (``--dev``/``--test``) for ``--step-count``
batches (0 = the whole split), computes the loss and the greedy decode on
the device, prints per-sample ``expected:``/``decoded:`` lines with
LED/LER/WED/WER, one ``validation average loss`` line per batch, then the
global statistics. Unless ``--no-save``, ``eval_loss`` of the first batch
goes to a TensorBoard event file.

Weights come from ``--reference-weights`` (a ``.npy`` directory, see
``weights.py``) or else from the latest of the port's own checkpoints in
``<train-dir>/<run-name>`` (``train/checkpoint.py``; parameters only).
Without either the run stops with the JAX package's missing-checkpoint
error; a directory that holds only the JAX package's orbax checkpoints
is refused (``speecht-cli export --weights`` is the bridge).
"""

from __future__ import annotations

import os

import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.execution import DatasetExecutor
from speecht_tpu_torch.metrics import EvalStatistics
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train.metrics_writer import SummaryWriter
from speecht_tpu_torch.weights import load_weight_dir


def _start_readback(tensors):
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


def _finish_readback(host, done):
    if done is not None:
        done.synchronize()
    return [t.numpy() for t in host]


class Evaluation(DatasetExecutor):
    def dataset_name(self) -> str:
        return self.flags.dataset

    def create_sample_generator(self, limit_count: int):
        return self.reader.load_samples(
            self.flags.dataset,
            loop_infinitely=False,
            limit_count=limit_count,
            feature_type=self.flags.feature_type,
            max_size=getattr(self.flags, "max_input_frames", 0) or False,
        )

    def get_loader_limit_count(self) -> int:
        return self.flags.step_count * self.flags.batch_size

    def get_max_steps(self):
        return self.flags.step_count or None

    def make_decoder(self):
        """Returns batch -> (loss, decoded_rows, decoded_lengths)."""
        return tstep.make_eval_step(self.model)

    def load_weights(self) -> int:
        """Loads the weights; returns the optimizer step they were saved
        at (0 for reference weights), the step of the ``eval_loss`` scalar."""
        ref_weights = getattr(self.flags, "reference_weights", None)
        if ref_weights:
            self.model.load_state_dict(load_weight_dir(ref_weights, self.model))
            return 0
        return self.checkpoint_manager().restore_params(
            dict(self.model.named_parameters())
        )

    def _result_iterator(self, eval_step, loader):
        """Yields (host batch, loss, decoded, lengths) as numpy, pipelined.

        Batch N+1's step is launched before batch N's results are read
        back, so the host-side metrics of batch N run while the card
        computes batch N+1.
        """
        pending = None
        for host_batch, device_batch in loader:
            out = _start_readback(eval_step(device_batch))
            if pending is not None:
                yield pending[0], *_finish_readback(*pending[1])
            pending = (host_batch, out)
        if pending is not None:
            yield pending[0], *_finish_readback(*pending[1])

    def run(self) -> EvalStatistics:
        flags = self.flags
        self.model.to(self.device).eval()
        weights_step = self.load_weights()
        eval_step = self.make_decoder()

        writer = None
        if getattr(flags, "should_save", False):
            writer = SummaryWriter(
                os.path.join(flags.log_dir, f"{flags.run_name}_{flags.run_type}")
            )

        stats = EvalStatistics()
        print("Begin evaluation")
        results = self._result_iterator(eval_step, self.create_loader())
        for step, (batch, avg_loss, decoded, dec_lengths) in enumerate(results):
            self._track_batch(stats, batch, decoded, dec_lengths, verbose=True)
            print(
                "validation average loss {:.2f} perplexity {:.2f}".format(
                    float(avg_loss), tstep.perplexity(float(avg_loss))
                )
            )
            if writer is not None and step == 0:
                writer.add_scalars(weights_step, {"eval_loss": float(avg_loss)})

        self.print_global_statistics(stats)
        if writer is not None:
            writer.close()
        return stats

    @staticmethod
    def _track_batch(stats: EvalStatistics, batch, decoded, dec_lengths,
                     verbose: bool = False):
        for i in range(decoded.shape[0]):
            if batch.seq_lengths[i] == 0:  # padded row of a partial batch
                continue
            expected_str = vocabulary.ids_to_sentence(
                batch.labels[i, : batch.label_lengths[i]]
            )
            decoded_str = vocabulary.ids_to_sentence(
                decoded[i, : dec_lengths[i]]
            )
            stats.track_decoding(decoded_str, expected_str)
            if verbose:
                print(f"expected: {expected_str}")
                print(f"decoded: {decoded_str}")
                print(
                    "LED: {} LER: {:.2f} WED: {} WER: {:.2f}".format(
                        stats.letter_edit_distance,
                        stats.letter_error_rate,
                        stats.word_edit_distance,
                        stats.word_error_rate,
                    )
                )

    @staticmethod
    def print_global_statistics(stats: EvalStatistics):
        print("Global statistics")
        print(stats.summary())
        print(
            "precise: LER {:.4f} WER {:.4f}".format(
                stats.global_letter_error_rate,
                stats.global_word_error_rate,
            )
        )
