"""Command line of the port: ``python -m speecht_tpu_torch {preprocess,train,evaluate,record,search,export} ...``.

Counterpart of ``speecht_tpu/cli.py``. The six subcommands have the JAX
package's base and per-command flags, with the same names and defaults
but one (``export --export-platforms`` names torch devices and defaults to
``cuda,cpu``, not ``tpu,cpu``), plus ``--device`` and ``--model``
(``wav2letter``, the default, or ``conformer`` with its widths:
``train``, also on ``--data-parallel`` ranks, and ``evaluate``, greedy or
with ``--language-model``, take it; ``record``, ``export``,
``--model-parallel``, ``--seq-parallel``, ``--reference-weights`` and
``SPEECHT_PALLAS_CONV0=1`` refuse it). On every subcommand
but ``preprocess`` it is ``--device {cuda,cpu}`` (default ``cuda``;
without a card it raises). On ``preprocess`` it keeps
the JAX flag's meaning, the DSP on the accelerator: ``preprocess`` alone
runs the host DSP and touches no card, ``preprocess --device`` runs the
DSP on the card and ``preprocess --device cpu`` runs the same torch DSP
on the CPU. ``train`` has every flag of the JAX ``train`` on one device
(``--spec-augment``, ``--profile-steps`` and ``--verbose-summaries`` among
them); ``evaluate --language-model`` and ``search`` run the LM-fused
beam, on the host or with ``--device-beam`` on the device (``--rescore N``
and ``--device-lm-hbm-gb`` with it); ``evaluate --from-audio`` decodes the
FLACs and runs the front end on the device. ``record`` transcribes the
microphone (pyaudio) or ``--audio-source`` files, one-shot or
``--streaming``, greedy or with the LM (``recording.py``); it and
``evaluate`` also take ``--reference-weights``. ``export`` writes the
weights (``--weights``) and the serving artifact (``--stablehlo``, a
``torch.export`` program a platform, ``serving.py``). Launched on
several processes (``torchrun --nproc-per-node N -m speecht_tpu_torch
train --data-parallel N ...``), ``train`` and ``evaluate`` run on a grid
of ranks (``--data-parallel``, ``--model-parallel``, ``--seq-parallel``;
``parallel/``), ``evaluate --language-model`` and ``--from-audio`` too,
and ``run`` prints a ``distributed:`` line for each rank with its backend
and device.

``main`` prints a RuntimeError, a FileNotFoundError or a ValueError (a
flag's value refused, such as an odd ``--export-frames``) as one line and
exits 1; library callers use ``CLI(argv).run()`` and get the exception.
"""

from __future__ import annotations

import argparse
import os
import sys


class CLI:
    def __init__(self, argv=None):
        self.argv = argv
        self.parser = argparse.ArgumentParser(prog="python -m speecht_tpu_torch")
        self.subparsers = self.parser.add_subparsers(
            help="sub-command help", dest="command"
        )
        self.base_parser = self._create_base_parser()
        self._add_preprocess_parser()
        self._add_training_parser()
        self._add_evaluation_parser()
        self._add_recording_parser()
        self._add_parameter_search_parser()
        self._add_export_parser()
        self._parsed = None

    def _create_base_parser(
        self, device: bool = True, model: bool = True
    ) -> argparse.ArgumentParser:
        """The flags every subcommand shares; ``device=False`` leaves out
        ``--device``, which ``preprocess`` defines with its own meaning,
        and ``model=False`` the network's flags (``--model`` and the
        Conformer's widths), for ``preprocess``, which builds none."""
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument(
            "--mfcc", dest="feature_type", action="store_const", const="mfcc",
            help="Use mfccs as input.",
        )
        p.add_argument(
            "--power", dest="feature_type", action="store_const",
            const="power", help="Use a power spectrogram as input.",
        )
        p.add_argument("--batch-size", dest="batch_size", type=int, default=64)
        p.add_argument("--run-name", dest="run_name", type=str, default="noname")
        p.add_argument("--data-dir", dest="data_dir", type=str, default="data")
        p.add_argument("--train-dir", dest="train_dir", type=str, default="train")
        p.add_argument("--log-dir", dest="log_dir", type=str, default="log")
        p.add_argument(
            "--data-parallel", dest="data_parallel", type=int, default=0,
            help="Ranks on the data axis (0 = all remaining; one process "
            "a rank, launched by torchrun).",
        )
        p.add_argument(
            "--model-parallel", dest="model_parallel", type=int, default=1,
            help="Ranks on the model (tensor-parallel) axis: the wide "
            "layers' channels are split over them.",
        )
        p.add_argument(
            "--compute-dtype", dest="compute_dtype", type=str,
            default="bfloat16", choices=["bfloat16", "float32"],
        )
        p.add_argument(
            "--bucket-step", dest="bucket_step", type=int, default=256,
            help="Pad batch time length up to a multiple of this.",
        )
        p.add_argument(
            "--transfer-dtype", dest="transfer_dtype", type=str,
            default="bfloat16", choices=["bfloat16", "float32"],
            help="Dtype for the host->device feature transfer.",
        )
        p.add_argument(
            "--base-channels", dest="base_channels", type=int, default=250,
        )
        p.add_argument(
            "--wide-channels", dest="wide_channels", type=int, default=2000,
        )
        p.add_argument(
            "--num-body-layers", dest="num_body_layers", type=int, default=7,
        )
        if model:
            self._add_model_arguments(p)
        p.add_argument(
            "--group-by-length", dest="group_by_length", action="store_true",
            help="Batch similar-length utterances together.",
        )
        p.add_argument(
            "--max-input-frames", dest="max_input_frames", type=int,
            default=0,
            help="Skip cached utterances longer than this many feature "
            "frames (0 = unlimited).",
        )
        if device:
            p.add_argument(
                "--device", dest="device", type=str, default="cuda",
                choices=["cuda", "cpu"],
                help="Device to run on; cuda raises when no card is present.",
            )
        p.set_defaults(feature_type="power")
        return p

    @staticmethod
    def _add_model_arguments(p):
        """``--model`` and the Conformer's widths (Conformer (L)'s by
        default; Wav2Letter's are ``--base-channels`` and the two after it)."""
        p.add_argument(
            "--model", dest="model", type=str, default="wav2letter",
            choices=["wav2letter", "conformer"],
            help="The acoustic model: Wav2Letter's conv stack, or "
            "Conformer-CTC (train, and evaluate greedy or with "
            "--language-model; Conformer (L)'s widths by default).",
        )
        p.add_argument("--d-model", dest="d_model", type=int, default=512)
        p.add_argument("--num-heads", dest="num_heads", type=int, default=8)
        p.add_argument("--ffn-dim", dest="ffn_dim", type=int, default=2048)
        p.add_argument("--num-blocks", dest="num_blocks", type=int, default=17)
        p.add_argument("--conv-kernel", dest="conv_kernel", type=int, default=32)
        p.add_argument(
            "--subsampling-channels", dest="subsampling_channels", type=int,
            default=512,
        )
        p.add_argument(
            "--dropout", dest="dropout", type=float, default=0.1,
            help="The Conformer's dropout (each module's output, the FFN's "
            "Swish, the attention probabilities).",
        )

    def _add_language_model_arguments(self, parser):
        parser.add_argument(
            "--language-model", dest="language_model", type=str,
            help="Directory of the n-gram language model (ARPA or KenLM "
            "binary, and an optional vocabulary file) for the beam search.",
        )
        parser.add_argument("--lm-weight", dest="lm_weight", type=float, default=0.8)
        parser.add_argument(
            "--word-count-weight", dest="word_count_weight", type=float, default=0.0
        )
        parser.add_argument(
            "--valid-word-count-weight", dest="valid_word_count_weight",
            type=float, default=2.3,
        )
        parser.add_argument(
            "--beam-width", dest="beam_width", type=int, default=100
        )
        parser.add_argument(
            "--blank-threshold", dest="blank_threshold", type=float,
            default=0.999,
        )
        parser.add_argument(
            "--device-beam", dest="device_beam", action="store_true",
            help="Run the LM-fused beam search on the device itself "
            "(batch-parallel) instead of the host C++ beam; the "
            "language-model directory may hold the ARPA source or a KenLM "
            "PROBING binary. Note: with an LM and pruning, near-tied "
            "hypotheses can resolve differently than the host beam (f32 "
            "device vs f64 host tie-breaking); divergences are "
            "score-bounded (see ops/beam_device.py).",
        )
        parser.add_argument(
            "--device-lm-hbm-gb", dest="device_lm_hbm_gb", type=float,
            default=8.0,
            help="With --device-beam: HBM budget for the LM tables; a "
            "larger LM falls back to the host beam with a message.",
        )
        parser.add_argument(
            "--rescore", dest="rescore_n", type=int, default=0,
            help="With --device-beam: pure-acoustic device beam keeps N "
            "hypotheses, the host LM rescores and picks the best — faster "
            "than fused search and compatible with KenLM binary LMs. "
            "0 = fused search (default).",
        )

    def _add_preprocess_parser(self):
        p = self.subparsers.add_parser(
            "preprocess", help="Preprocess and cache all audio.",
            parents=[self._create_base_parser(device=False, model=False)],
        )
        p.add_argument("--train-only", dest="train_only", action="store_true")
        p.add_argument("--test-only", dest="test_only", action="store_true")
        p.add_argument("--dev-only", dest="dev_only", action="store_true")
        p.add_argument("--num-workers", dest="num_workers", type=int, default=0)
        p.add_argument(
            "--device", dest="device", nargs="?", const="cuda", default=None,
            choices=["cuda", "cpu"],
            help="Run the DSP (resample, framing, FFT, mel, normalize, MFCC "
            "deltas) in batches on the card (or, given cpu, in torch on the "
            "CPU) instead of the per-file host DSP; the npz cache layout is "
            "identical.",
        )

    def _add_training_parser(self):
        p = self.subparsers.add_parser(
            "train", help="Train the wav2letter weights.",
            parents=[self.base_parser],
        )
        p.add_argument("--learning-rate", dest="learning_rate", type=float, default=1e-4)
        p.add_argument(
            "--reset-learning-rate", dest="reset_learning_rate",
            action="store_true",
        )
        p.add_argument(
            "--learning-rate-decay-factor", dest="learning_rate_decay_factor",
            type=float, default=0,
        )
        p.add_argument("--momentum", dest="momentum", type=float, default=0.9)
        p.add_argument(
            "--max-gradient-norm", dest="max_gradient_norm", type=float, default=5.0
        )
        p.add_argument(
            "--limit-training-set", dest="limit_training_set", type=int, default=0
        )
        p.add_argument(
            "--steps-per-checkpoint", dest="steps_per_checkpoint", type=int,
            default=1000,
        )
        p.add_argument(
            "--max-steps", dest="max_steps", type=int, default=None,
            help="Exit cleanly (checkpoint saved) after this many steps "
            "counted from this launch; default: run forever.",
        )
        p.add_argument(
            "--spec-augment", dest="spec_augment", action="store_true",
            help="SpecAugment on the device: 2 frequency and 2 time masks "
            "per utterance.",
        )
        p.add_argument(
            "--spec-augment-freq-width", dest="spec_augment_freq_width",
            type=int, default=None,
            help="Frequency-mask width bound (default 15, or 4 for mfcc).",
        )
        p.add_argument(
            "--spec-augment-time-frac", dest="spec_augment_time_frac",
            type=float, default=0.05,
            help="Time-mask width bound as a share of the valid frames.",
        )
        p.add_argument(
            "--grad-accum", dest="grad_accum", type=int, default=1,
            help="Micro-batches accumulated per optimizer update.",
        )
        p.add_argument(
            "--profile-steps", dest="profile_steps", type=str, default=None,
            help="torch.profiler trace of steps START:STOP of this launch "
            "(STOP defaults to START+5), written under <log-dir>/profile.",
        )
        p.add_argument(
            "--verbose-summaries", dest="verbose_summaries",
            action="store_true",
            help="Also write filter/bias/logits images and activation "
            "histograms at every checkpoint.",
        )
        p.add_argument(
            "--seq-parallel", dest="seq_parallel", type=int, default=0,
            help="Ranks sharding the conv stack over time (halo exchanges).",
        )

    def _add_evaluation_parser(self):
        p = self.subparsers.add_parser(
            "evaluate", help="Evaluate the development or test set.",
            parents=[self.base_parser],
        )
        p.add_argument("--dev", dest="dataset", action="store_const", const="dev")
        p.add_argument("--test", dest="dataset", action="store_const", const="test")
        p.add_argument(
            "--no-save", dest="should_save", action="store_false",
            help="Do not save evaluation summaries.",
        )
        p.add_argument("--step-count", dest="step_count", type=int, default=0)
        p.add_argument(
            "--from-audio", dest="from_audio", action="store_true",
            help="Skip the feature cache: decode the flacs and run the "
            "whole front end (resample, framing, FFT, mel, normalize) on "
            "the device.",
        )
        self._add_reference_weights_argument(p)
        p.add_argument(
            "--seq-parallel", dest="seq_parallel", type=int, default=0,
            help="Ranks sharding the conv stack over time (halo exchanges).",
        )
        self._add_language_model_arguments(p)
        p.set_defaults(dataset="test", should_save=True)

    @staticmethod
    def _add_reference_weights_argument(parser):
        parser.add_argument(
            "--reference-weights", dest="reference_weights", type=str,
            default=None,
            help="Directory of .npy weights, in the reference's export "
            "layout or the JAX package's `export --weights` layout.",
        )

    def _add_recording_parser(self):
        p = self.subparsers.add_parser(
            "record",
            help="Record using your microphone and inspect the transcription.",
            parents=[self.base_parser],
        )
        p.add_argument("--input-size", dest="input_size", type=int, default=128)
        p.add_argument(
            "--streaming", dest="streaming", action="store_true",
            help="Low-latency incremental transcription while recording.",
        )
        p.add_argument(
            "--feature-rate", dest="feature_rate", type=int, default=22050,
            help="Resample captured audio to this rate before the features "
            "(22050 = the rate of the preprocess cache the weights were "
            "trained on; 16000 feeds the 16 kHz capture straight in).",
        )
        p.add_argument(
            "--audio-source", dest="audio_source", type=str, nargs="+",
            default=None, metavar="FILE",
            help="Transcribe these audio files (flac, or float32 .npy at "
            "16 kHz) through the record pipeline instead of a microphone; "
            "one-shot mode takes each file as one gated utterance and "
            "exits after the last, --streaming feeds them as one chunk "
            "stream.",
        )
        self._add_reference_weights_argument(p)
        self._add_language_model_arguments(p)

    def _add_parameter_search_parser(self):
        p = self.subparsers.add_parser(
            "search",
            help="Search for language model hyperparameters using local search.",
            parents=[self.base_parser],
        )
        p.add_argument(
            "--population-size", dest="population_size", type=int, default=10
        )
        p.add_argument("--noise-std", dest="noise_std", type=float, default=0.5)
        p.add_argument(
            "--generations", dest="generations", type=int, default=0,
            help="Stop after this many mutation/score iterations "
            "(0 = run until interrupted, the reference behavior).",
        )
        p.add_argument("--ui", dest="use_ui", action="store_true")
        p.add_argument("--step-count", dest="step_count", type=int, default=1)
        self._add_language_model_arguments(p)

    def _add_export_parser(self):
        p = self.subparsers.add_parser(
            "export", help="Export network details", parents=[self.base_parser]
        )
        p.add_argument("--weights", dest="export_weights_dir", type=str)
        p.add_argument("--input-size", dest="input_size", type=int, default=128)
        p.add_argument(
            "--stablehlo", dest="export_stablehlo_dir", type=str,
            help="Also export the inference program (conv stack + greedy "
            "CTC decode, the weights inside) as a torch.export program a "
            "platform that torch alone loads (see speecht_tpu_torch/serving.py).",
        )
        p.add_argument(
            "--export-batch-size", dest="export_batch_size", type=int,
            default=0,
            help="Fix the artifact's batch dim (0 = shape-polymorphic).",
        )
        p.add_argument(
            "--export-frames", dest="export_frames", type=int, default=0,
            help="Fix the artifact's frame dim, must be even "
            "(0 = shape-polymorphic over even frame counts).",
        )
        p.add_argument(
            "--export-platforms", dest="export_platforms", type=str,
            default="cuda,cpu",
            help="Comma-separated torch devices to export a program for "
            "(cuda, cpu); cuda needs a card.",
        )
        p.add_argument(
            "--from-audio", dest="from_audio", action="store_true",
            help="With --stablehlo: export the end-to-end program, int16 "
            "raw audio in, the device front end (resample + feature DSP) "
            "ahead of the conv stack and the greedy decode.",
        )
        p.add_argument(
            "--wire-sr", dest="export_wire_sr", type=int, default=0,
            help="With --stablehlo --from-audio: the rate the audio input "
            "arrives at; the program resamples it to 22050 (0 = audio "
            "already at 22050).",
        )

    @property
    def parsed(self):
        if self._parsed is None:
            parsed = self.parser.parse_args(self.argv)
            if parsed.command:
                if parsed.command == "train":
                    parsed.run_type = "train"
                elif parsed.command == "evaluate":
                    parsed.run_type = parsed.dataset
                elif parsed.command == "record":
                    parsed.run_type = "record"
                else:
                    parsed.run_type = "other"
                parsed.run_train_dir = parsed.train_dir + "/" + parsed.run_name
                if hasattr(parsed, "language_model"):
                    from speecht_tpu_torch.ops.beam import LanguageModelConfig

                    parsed.lm = LanguageModelConfig(
                        language_model=parsed.language_model,
                        lm_weight=parsed.lm_weight,
                        word_count_weight=parsed.word_count_weight,
                        valid_word_count_weight=parsed.valid_word_count_weight,
                        beam_width=parsed.beam_width,
                        blank_threshold=parsed.blank_threshold,
                        device_beam=parsed.device_beam,
                        device_lm_hbm_gb=parsed.device_lm_hbm_gb,
                        rescore_n=parsed.rescore_n,
                    )
            self._parsed = parsed
        return self._parsed

    def _ensure_directories(self):
        for d in (
            self.parsed.train_dir,
            self.parsed.data_dir,
            self.parsed.log_dir,
            self.parsed.run_train_dir,
        ):
            os.makedirs(d, exist_ok=True)

    def run(self):
        if not self.parsed.command:
            self.parser.print_help()
            return None
        if self.parsed.command != "preprocess":
            # several processes: join the group torchrun's environment
            # names (one process: nothing happens)
            from speecht_tpu_torch.parallel import mesh as pmesh

            pmesh.init_distributed(self.parsed.device)
        self._ensure_directories()
        if self.parsed.command == "preprocess":
            from speecht_tpu_torch.preprocessing import Preprocessing

            return Preprocessing(self.parsed).run()
        if self.parsed.command == "train":
            from speecht_tpu_torch.training import Training

            return Training(self.parsed).run()
        if self.parsed.command == "search":
            from speecht_tpu_torch.parameter_search import (
                LanguageModelParameterSearch,
            )

            return LanguageModelParameterSearch(self.parsed).run()
        if self.parsed.command == "record":
            from speecht_tpu_torch.recording import Recording

            return Recording(self.parsed).run()
        if self.parsed.command == "export":
            from speecht_tpu_torch.exporting import Exporting

            return Exporting(self.parsed).run()
        from speecht_tpu_torch.evaluation import Evaluation

        return Evaluation(self.parsed).run()


def main(argv=None):
    try:
        CLI(argv).run()
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        # user-actionable failures (no card, missing weights, a flag's
        # value refused) print one line; library callers use
        # CLI(argv).run()
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
