"""Evaluation executor: greedy or beam decode, from the cache or the audio.

Counterpart of ``speecht_tpu/evaluation.py`` (``run``, ``make_decoder``,
``_result_iterator``, ``_track_batch``, ``print_global_statistics``, and
for ``--from-audio`` ``wire_sr``, ``determine_input_size``,
``create_sample_generator`` and ``create_loader``; its eval step is
``train/step.make_audio_eval_step``): runs the dev or test split
(``--dev``/``--test``) for ``--step-count`` batches (0 = the whole split),
computes the loss and the greedy decode on the device, or with
``--language-model`` the loss and the blank collapse on the device and
the LM-fused beam on the host, or with ``--device-beam`` on the device
(``ops/beam.py``). With ``--from-audio``
the batches are FLAC audio decoded on the host at the corpus's own rate
(when every file shares one with a polyphase plan to 22050 Hz; else
resampled to 22050 on the host), shipped as int16, and the front end
(resample, DSP) runs on the device ahead of the model. It prints
per-sample ``expected:``/``decoded:`` lines with LED/LER/WED/WER, one
``validation average loss`` line per batch, then the global statistics.
Unless ``--no-save``, ``eval_loss`` of the first batch goes to a
TensorBoard event file.

Several processes (``torchrun``) evaluate on a grid of ranks: each data
rank reads its shard of the cache or of the FLACs (``--data-parallel``;
``--model-parallel`` splits the wide layers) or, with ``--seq-parallel
N``, the conv stack is sharded over time (``parallel/seq_parallel.py``;
cached and greedy only). The loss is averaged over the data group. With
``--language-model`` the ranks share the search, the ranks of a model
group splitting their common rows (``ops/beam.py``), and the decoder
returns every row's decode. The labels and lengths of every batch, and
the greedy decodes, are gathered to every rank, which all track the
global statistics; rank 0 prints and saves.

Weights come from ``--reference-weights`` (a ``.npy`` directory or the
reference's TF checkpoint, see ``weights.py``) or else from the latest of
the port's own checkpoints in
``<train-dir>/<run-name>`` (``train/checkpoint.py``; parameters only).
Without either the run stops with the JAX package's missing-checkpoint
error; a directory that holds only the JAX package's orbax checkpoints
is refused (``speecht-cli export --weights`` is the bridge).
"""

from __future__ import annotations

import dataclasses
import os

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.execution import (
    DatasetExecutor,
    finish_readback,
    start_readback,
)
from speecht_tpu_torch.metrics import EvalStatistics
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.parallel import mesh as pmesh
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train.metrics_writer import SummaryWriter
from speecht_tpu_torch.weights import load_weight_dir


class Evaluation(DatasetExecutor):
    def dataset_name(self) -> str:
        return self.flags.dataset

    @property
    def from_audio(self) -> bool:
        return bool(getattr(self.flags, "from_audio", False))

    @property
    def seq_parallel(self) -> int:
        return int(getattr(self.flags, "seq_parallel", 0) or 0)

    def create_mesh(self):
        if self.seq_parallel > 1:
            lm = getattr(self.flags, "lm", None)
            if self.from_audio or (lm is not None and lm.language_model):
                raise ValueError(
                    "--seq-parallel combines only with the cached-feature "
                    "greedy evaluate (not --from-audio/--language-model)"
                )
            from speecht_tpu_torch.parallel.seq_parallel import make_sp_mesh

            return make_sp_mesh(self.flags, self.seq_parallel)
        return super().create_mesh()

    @property
    def wire_sr(self) -> int:
        """The rate ``--from-audio`` ships the audio at, probed once: the
        corpus's own rate when every file's STREAMINFO header gives the
        same one and it has a polyphase plan to 22050 Hz (the resample then
        runs on the device), else 22050 (the host resamples)."""
        if getattr(self, "_wire_sr", None) is None:
            from speecht_tpu_torch.native import DEFAULT_SR
            from speecht_tpu_torch.ops import resample as resample_mod

            native_sr = self.reader.probe_native_rate(self.flags.dataset)
            if (
                native_sr is not None
                and native_sr != DEFAULT_SR
                and resample_mod.is_rational(native_sr, DEFAULT_SR)
            ):
                self._wire_sr = native_sr
                if self.mesh.primary:
                    print(
                        f"from-audio: decoding at native {native_sr} Hz; "
                        f"resampling to {DEFAULT_SR} Hz on device"
                    )
            else:
                self._wire_sr = DEFAULT_SR
        return self._wire_sr

    def determine_input_size(self) -> int:
        if self.from_audio:
            from speecht_tpu_torch.data.features import feature_size

            return feature_size(self.flags.feature_type)
        return super().determine_input_size()

    def create_sample_generator(self, limit_count: int):
        if self.from_audio:
            return self.reader.load_raw_samples(
                self.flags.dataset,
                loop_infinitely=False,
                limit_count=limit_count,
                sample_rate=self.wire_sr,
                **self.shard_kwargs,
            )
        return self.reader.load_samples(
            self.flags.dataset,
            loop_infinitely=False,
            limit_count=limit_count,
            feature_type=self.flags.feature_type,
            max_size=getattr(self.flags, "max_input_frames", 0) or False,
            **self.shard_kwargs,
        )

    def create_loader(self):
        if not self.from_audio:
            return super().create_loader()
        from speecht_tpu_torch.data.pipeline import (
            PrefetchLoader,
            build_audio_batch,
        )
        from speecht_tpu_torch.native import DEFAULT_SR
        from speecht_tpu_torch.ops import resample as resample_mod

        # the sample bucket at the wire rate: a multiple of the polyphase
        # hop (batch_resample needs S % M == 0) that resamples to at least
        # the feature-frame bucket
        sample_bucket = resample_mod.input_bucket(
            160 * getattr(self.flags, "bucket_step", 256),
            self.wire_sr,
            DEFAULT_SR,
        )
        return PrefetchLoader(
            lambda: self.create_sample_generator(self.get_loader_limit_count()),
            batch_size=self.local_batch_size(),
            device=self.device,
            time_bucket=sample_bucket,
            max_steps=self.get_max_steps(),
            transfer_dtype=getattr(self.flags, "transfer_dtype", "bfloat16"),
            batch_builder=build_audio_batch,
        )

    def get_loader_limit_count(self) -> int:
        # a global budget: the reader cuts the file list before it shards
        # it, so each data rank keeps step_count local batches of it
        return self.flags.step_count * self.flags.batch_size

    def get_max_steps(self):
        return self.flags.step_count or None

    def make_decoder(self):
        """Returns batch -> (loss, decoded_rows, decoded_lengths).

        With ``--language-model`` the beam decoder is also kept on
        ``self._beam``, so the run loop can use its pipelined
        ``eval_batches``.
        """
        self._beam = None
        if self.flags.lm.language_model:
            from speecht_tpu_torch.ops.beam import BeamSearchDecoder

            self._beam = BeamSearchDecoder(
                self.model,
                self.flags.lm,
                feature_type=(
                    self.flags.feature_type if self.from_audio else None
                ),
                wire_sr=self.wire_sr if self.from_audio else None,
                mesh=self.mesh,
            )
            return self._beam.eval_step
        if self.from_audio:
            from speecht_tpu_torch.data import features_device

            return tstep.make_audio_eval_step(
                self.model,
                features_device.make_front_end(
                    self.flags.feature_type, wire_sr=self.wire_sr
                ),
                self.mesh,
            )
        if self.seq_parallel > 1:
            from speecht_tpu_torch.parallel.seq_parallel import make_sp_eval_step

            return make_sp_eval_step(self.model, self.mesh)
        return tstep.make_eval_step(self.model, self.mesh)

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

        Beam path: the decoder overlaps the device and the host itself.
        Greedy path: batch N+1's step is launched before batch N's results
        are read back, so the host-side metrics of batch N run while the
        card computes batch N+1.
        """
        if self._beam is not None:
            try:
                yield from self._beam.eval_batches(loader)
            finally:
                self._beam.close()
            return
        pending = None
        for host_batch, device_batch in loader:
            out = start_readback(eval_step(device_batch))
            if pending is not None:
                yield pending[0], *finish_readback(*pending[1])
            pending = (host_batch, out)
        if pending is not None:
            yield pending[0], *finish_readback(*pending[1])

    def run(self) -> EvalStatistics:
        flags = self.flags
        self.model.to(self.device).eval()
        weights_step = self.load_weights()
        eval_step = self.make_decoder()

        writer = None
        primary = self.mesh.primary
        # rank 0 only: one event file a run
        if getattr(flags, "should_save", False) and primary:
            writer = SummaryWriter(
                os.path.join(flags.log_dir, f"{flags.run_name}_{flags.run_type}")
            )

        stats = EvalStatistics()
        print("Begin evaluation")
        results = self._result_iterator(eval_step, self.create_loader())
        for step, (batch, avg_loss, decoded, dec_lengths) in enumerate(results):
            if comm.world_size() > 1:
                batch = self._global_batch(batch)
                if self._beam is None:  # the beam's decodes are global
                    decoded = pmesh.host_global(decoded, self.mesh)
                    dec_lengths = pmesh.host_global(dec_lengths, self.mesh)
            self._track_batch(stats, batch, decoded, dec_lengths, verbose=primary)
            if primary:
                print(
                    "validation average loss {:.2f} perplexity {:.2f}".format(
                        float(avg_loss), tstep.perplexity(float(avg_loss))
                    )
                )
            if writer is not None and step == 0:
                writer.add_scalars(weights_step, {"eval_loss": float(avg_loss)})

        if primary:
            self.print_global_statistics(stats)
        if writer is not None:
            writer.close()
        return stats

    def _global_batch(self, batch):
        """Every data rank's rows of a batch's labels and lengths (the
        padding-row marks: ``seq_lengths``, an AudioBatch's
        ``num_samples``), on every rank (a collective), so all ranks track
        the global statistics."""
        lengths = "num_samples" if hasattr(batch, "num_samples") else "seq_lengths"
        return dataclasses.replace(batch, **{
            name: pmesh.host_global(getattr(batch, name), self.mesh)
            for name in (lengths, "labels", "label_lengths")
        })

    @staticmethod
    def _track_batch(stats: EvalStatistics, batch, decoded, dec_lengths,
                     verbose: bool = False):
        # a Batch marks its padding rows with seq_lengths 0, an AudioBatch
        # with num_samples 0
        lengths = getattr(batch, "seq_lengths", None)
        if lengths is None:
            lengths = batch.num_samples
        for i in range(decoded.shape[0]):
            if lengths[i] == 0:  # padded row of a partial batch
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
