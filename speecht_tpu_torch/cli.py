"""Command line of the port: ``python -m speecht_tpu_torch {train,evaluate} ...``.

Counterpart of ``speecht_tpu/cli.py``. The ``train`` and ``evaluate``
subcommands have the JAX package's base and per-command flags, with the
same names and defaults, plus ``--device {cuda,cpu}`` (default ``cuda``;
without a card it raises). Paths of the JAX package that the port does
not have yet raise an error that names the flag; none is ignored:
``train --spec-augment``, ``--profile-steps``, ``--verbose-summaries``,
``evaluate --language-model``, ``--from-audio``, and on both
``--seq-parallel`` or ``--data-parallel``/``--model-parallel`` above 1.
The other subcommands come with later parts of the port.
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
        self._add_training_parser()
        self._add_evaluation_parser()
        self._parsed = None

    def _create_base_parser(self) -> argparse.ArgumentParser:
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
            help="Devices on the data axis (not ported: at most 1).",
        )
        p.add_argument(
            "--model-parallel", dest="model_parallel", type=int, default=1,
            help="Devices on the model axis (not ported: at most 1).",
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
        p.add_argument(
            "--device", dest="device", type=str, default="cuda",
            choices=["cuda", "cpu"],
            help="Device to run on; cuda raises when no card is present.",
        )
        p.set_defaults(feature_type="power")
        return p

    def _add_language_model_arguments(self, parser):
        parser.add_argument(
            "--language-model", dest="language_model", type=str,
            help="Beam search with a language model (not ported yet).",
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
        )
        parser.add_argument(
            "--device-lm-hbm-gb", dest="device_lm_hbm_gb", type=float,
            default=8.0,
        )
        parser.add_argument(
            "--rescore", dest="rescore_n", type=int, default=0,
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
            help="On-device SpecAugment (not ported yet).",
        )
        p.add_argument(
            "--spec-augment-freq-width", dest="spec_augment_freq_width",
            type=int, default=None,
        )
        p.add_argument(
            "--spec-augment-time-frac", dest="spec_augment_time_frac",
            type=float, default=0.05,
        )
        p.add_argument(
            "--grad-accum", dest="grad_accum", type=int, default=1,
            help="Micro-batches accumulated per optimizer update.",
        )
        p.add_argument(
            "--profile-steps", dest="profile_steps", type=str, default=None,
            help="Profiler trace over steps START:STOP (not ported yet).",
        )
        p.add_argument(
            "--verbose-summaries", dest="verbose_summaries",
            action="store_true",
            help="Images and activation histograms (not ported yet).",
        )
        p.add_argument(
            "--seq-parallel", dest="seq_parallel", type=int, default=0,
            help="Time-sharded conv stack (not ported yet).",
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
            help="On-device front end from flacs (not ported yet).",
        )
        p.add_argument(
            "--reference-weights", dest="reference_weights", type=str,
            default=None,
            help="Directory of .npy weights, in the reference's export "
            "layout or the JAX package's `export --weights` layout.",
        )
        p.add_argument(
            "--seq-parallel", dest="seq_parallel", type=int, default=0,
            help="Time-sharded conv stack (not ported yet).",
        )
        self._add_language_model_arguments(p)
        p.set_defaults(dataset="test", should_save=True)

    @property
    def parsed(self):
        if self._parsed is None:
            parsed = self.parser.parse_args(self.argv)
            if parsed.command:
                parsed.run_type = (
                    "train" if parsed.command == "train" else parsed.dataset
                )
                parsed.run_train_dir = parsed.train_dir + "/" + parsed.run_name
            self._parsed = parsed
        return self._parsed

    def _check_ported(self):
        flags = self.parsed
        unported = []
        if flags.command == "train":
            if flags.spec_augment:
                unported.append("--spec-augment")
            if flags.profile_steps:
                unported.append("--profile-steps")
            if flags.verbose_summaries:
                unported.append("--verbose-summaries")
        else:
            if flags.language_model:
                unported.append("--language-model")
            if flags.from_audio:
                unported.append("--from-audio")
        if flags.seq_parallel > 1:
            unported.append("--seq-parallel")
        if flags.data_parallel > 1 or flags.model_parallel > 1:
            unported.append("--data-parallel/--model-parallel above 1")
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)}: this path is not ported to "
                "speecht_tpu_torch yet (use `speecht-cli` for it)"
            )

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
        self._check_ported()
        self._ensure_directories()
        if self.parsed.command == "train":
            from speecht_tpu_torch.training import Training

            return Training(self.parsed).run()
        from speecht_tpu_torch.evaluation import Evaluation

        return Evaluation(self.parsed).run()


def main(argv=None):
    try:
        CLI(argv).run()
    except (RuntimeError, FileNotFoundError) as e:
        # user-actionable failures (no card, missing weights, a path not
        # ported yet) print one line; library callers use CLI(argv).run()
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
