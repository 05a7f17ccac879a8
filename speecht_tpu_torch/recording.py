"""The ``record`` executor: microphone (or audio files) -> features ->
decode -> print.

Counterpart of ``speecht_tpu/recording.py``: a batch of one with the
input size from ``--input-size`` (no cache to probe), 16 kHz capture in
chunks of 4096 samples, the features of each utterance on the host, the
decode (greedy, or with ``--language-model`` the LM-fused beam on the
host or with ``--device-beam`` on the device), the transcript printed, in
an endless loop. Captured audio is resampled to ``--feature-rate``
(22050 by default, the rate the feature cache and so the weights were
made at) by ``native.resample`` before the features; ``--feature-rate
16000`` feeds the 16 kHz capture straight in.

``--streaming`` transcribes while audio arrives (``ops/streaming.py``),
through ``ops/resample.StreamResampler`` when the rates differ, with
LM-fused partials under ``--language-model``. ``--audio-source FILE...``
reads audio files through the microphone's interface
(``record_utils.FileAudioSource``), and the executor returns the printed
transcripts. The ``recorder`` argument is the same seam for tests.

The model runs on ``--device`` (default ``cuda``; without a card it
raises). Its weights come from ``--reference-weights`` or else from the
latest of the port's checkpoints in ``<train-dir>/<run-name>``, as in
``evaluate``. The one-shot decode is ``train/step.make_eval_step`` (its
CTC loss on the empty label runs the alpha kernel once an utterance) or
``ops/beam.BeamSearchDecoder.eval_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data import features as F
from speecht_tpu_torch.data.pipeline import single_batch, to_device
from speecht_tpu_torch.execution import build_model, refuse_conformer, resolve_device
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train.checkpoint import CheckpointManager
from speecht_tpu_torch.weights import load_weight_dir

CAPTURE_RATE = 16000
CHUNK_SIZE = 4 * 1024


def host_features(audio: np.ndarray, feature_type: str, rate: int) -> np.ndarray:
    """One utterance's features on the host, ``[T, F]`` float32."""
    if feature_type == "power":
        return F.calc_power_spectrogram(audio, rate)
    if feature_type == "mfcc":
        return F.calc_mfccs(audio, rate)
    raise NotImplementedError(
        "Only power and mfccs are supported for input types."
    )


class Recording:
    def __init__(self, flags, recorder=None):
        self.flags = flags
        refuse_conformer(flags, "record")
        self.device = resolve_device(getattr(flags, "device", "cuda"))
        # the seam: tests and `--audio-source` put a file-backed recorder
        # in the microphone's place
        self._recorder = recorder

    def _make_recorder(self, sample_rate: int, chunk_size: int):
        if self._recorder is not None:
            return self._recorder
        sources = getattr(self.flags, "audio_source", None)
        if sources:
            from speecht_tpu_torch.record_utils import FileAudioSource

            return FileAudioSource(sources, rate=sample_rate, chunk_size=chunk_size)
        from speecht_tpu_torch.record_utils import AudioRecorder

        return AudioRecorder(rate=sample_rate, chunk_size=chunk_size)

    def load_model(self):
        """The model on ``--device`` with ``--reference-weights`` or the
        latest port checkpoint's parameters."""
        model = build_model(self.flags.input_size, self.flags).to(self.device).eval()
        ref_weights = getattr(self.flags, "reference_weights", None)
        if ref_weights:
            model.load_state_dict(load_weight_dir(ref_weights, model))
        else:
            CheckpointManager(self.flags.run_train_dir).restore_params(
                dict(model.named_parameters())
            )
        return model

    def _make_beam(self, model):
        lm_flags = getattr(self.flags, "lm", None)
        if lm_flags is not None and lm_flags.language_model:
            from speecht_tpu_torch.ops.beam import BeamSearchDecoder

            return BeamSearchDecoder(model, lm_flags)
        return None

    def run(self):
        flags = self.flags
        # the weights were trained on features of the cache's rate (22050);
        # the microphone captures at 16 kHz, so the audio is resampled to
        # the feature rate first (16000 feeds the capture straight in)
        feature_rate = getattr(flags, "feature_rate", 22050)
        recorder = self._make_recorder(CAPTURE_RATE, chunk_size=CHUNK_SIZE)
        model = self.load_model()
        beam = self._make_beam(model)
        try:
            if getattr(flags, "streaming", False):
                return self._run_streaming(model, beam, recorder, feature_rate)
            return self._run_one_shot(model, beam, recorder, feature_rate)
        finally:
            if beam is not None:
                beam.close()

    def _run_one_shot(self, model, beam, recorder, feature_rate):
        from speecht_tpu_torch import native
        from speecht_tpu_torch.record_utils import AudioSourceExhausted

        decoder = beam.eval_step if beam is not None else tstep.make_eval_step(model)
        transcripts = []
        while True:
            print("Recording audio")
            try:
                raw_audio, _width = recorder.record()
            except AudioSourceExhausted:
                # a file source ends; the microphone loop does not
                return transcripts
            raw_audio = np.asarray(raw_audio)
            if feature_rate != CAPTURE_RATE:
                raw_audio = native.resample(raw_audio, CAPTURE_RATE, feature_rate)

            print("Generate MFCCs or power spectrogram")
            speech_input = host_features(raw_audio, self.flags.feature_type, feature_rate)

            print("Running speech recognition")
            batch = to_device(single_batch(speech_input), self.device, "float32")
            _loss, decoded, dec_lengths = decoder(batch)
            decoded, dec_lengths = (
                t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                for t in (decoded, dec_lengths)
            )
            decoded_str = vocabulary.ids_to_sentence(decoded[0, : dec_lengths[0]])
            print(f"decoded: {decoded_str}")
            transcripts.append(decoded_str)

    def _run_streaming(self, model, beam, recorder, feature_rate):
        """Transcription while audio arrives: raw chunks straight off the
        stream (no silence gate), the partial transcript refreshed after
        each chunk. When the feature rate is not the capture rate, chunks
        pass through the sample-exact ``StreamResampler``."""
        from speecht_tpu_torch.ops.streaming import StreamingRecognizer
        from speecht_tpu_torch.record_utils import AudioSourceExhausted

        resampler = None
        if feature_rate != CAPTURE_RATE:
            from speecht_tpu_torch.ops.resample import StreamResampler

            resampler = StreamResampler(CAPTURE_RATE, feature_rate)
        rec = StreamingRecognizer(
            model, sample_rate=feature_rate, feature_type=self.flags.feature_type
        )
        # with --language-model the partials are LM-fused too (a narrow
        # continuation beam over the tentative tail; committed text stays
        # frozen) and the final transcript goes through the full beam
        with recorder.open_input_stream() as read_chunk:
            print("Streaming transcription (ctrl-c to stop)")
            try:
                while True:
                    chunk = read_chunk()
                    if resampler is not None:
                        chunk = resampler.process(chunk)
                    partial = rec.accept_chunk(chunk)
                    if beam is not None and beam.lm is not None:
                        partial = rec.partial_text_fused(
                            beam.lm,
                            lm_weight=beam.lm_config.lm_weight,
                            word_count_weight=beam.lm_config.word_count_weight,
                            valid_word_count_weight=(
                                beam.lm_config.valid_word_count_weight
                            ),
                        )
                    print(f"\rpartial: {partial}", end="", flush=True)
            except (KeyboardInterrupt, AudioSourceExhausted):
                # ctrl-c on a microphone, the end of a file source
                print()
                if resampler is not None:
                    rec.accept_chunk(resampler.flush())
                final = rec.finalize(beam=beam)
                print(f"decoded: {final}")
                return final
