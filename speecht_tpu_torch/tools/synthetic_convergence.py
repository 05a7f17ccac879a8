"""Training-convergence drill on the synthetic tone-speech corpus.

The port of ``tools/synthetic_convergence.py``: writes 400 + 40 utterances
(``synthetic_corpus.py``), trains the full-width Wav2Letter for 600 steps
through the port's CLI (B=16, the 128-frame buckets, lr 3e-4), then
evaluates the HELD-OUT split four ways and gates each, as the JAX tool:

- greedy: LER < 0.05 (the model generalizes);
- the host beam with the corpus's unigram LM: WER <= greedy WER;
- ``--device-beam``: LER and WER equal to the host beam's;
- ``--device-beam --rescore 8``: WER <= greedy WER.

    python -m speecht_tpu_torch.tools.synthetic_convergence [n_train] [steps]

runs on the card (defaults 400 and 600); ``--device cpu`` runs it on the
CPU, and ``--base-channels``/``--wide-channels``/``--num-body-layers``
narrow the model. It exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import os
import re
import shutil
import sys
import tempfile
import time

N_TEST = 40
LM_FLAGS = ["--lm-weight", "0.4", "--valid-word-count-weight", "2.3"]
MODEL_FLAGS = ("base_channels", "wide_channels", "num_body_layers")
STEP_LINE = re.compile(r"^global step (\d+) .* average loss ([\d.]+|nan|inf) ")
ROW_LINES = re.compile(r"^expected: (.*)\ndecoded: (.*)$", re.M)


class _Tee(io.TextIOBase):
    """Writes to every stream it holds (the console and a buffer)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def run_cli(argv: list[str]):
    """``CLI(argv).run()`` in this process, its output printed and kept:
    returns (its result, its output)."""
    from speecht_tpu_torch.cli import CLI

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        result = CLI(argv).run()
    return result, buf.getvalue()


def interval_lines(output: str) -> list[tuple[int, float]]:
    """(global step, average loss) of each interval line of ``train``."""
    found = []
    for line in output.splitlines():
        m = STEP_LINE.match(line)
        if m:
            found.append((int(m.group(1)), float(m.group(2))))
    return found


def model_flags(**widths) -> list[str]:
    """``--base-channels 16``... for the widths given (None: the default)."""
    flags = []
    for name in MODEL_FLAGS:
        if widths.get(name) is not None:
            flags += ["--" + name.replace("_", "-"), str(widths[name])]
    return flags


def gates(greedy, host_lm, device_lm, rescore) -> dict[str, bool]:
    """The JAX tool's four gates on (LER, WER) pairs of the held-out split."""
    return {
        "SYNTHETIC CONVERGENCE": greedy[0] < 0.05,
        "LM FUSION IMPROVES/HOLDS WER": host_lm[1] <= greedy[1],
        "DEVICE BEAM == HOST BEAM": (
            device_lm[1] == host_lm[1] and device_lm[0] == host_lm[0]
        ),
        "RESCORE IMPROVES/HOLDS WER": rescore[1] <= greedy[1],
    }


def print_gates(passed: dict[str, bool]) -> None:
    for name, ok in passed.items():
        print(f"{name}:", "PASS" if ok else "FAIL")


def held_out_rates(output: str) -> tuple[float, float]:
    """(LER, WER) from an ``evaluate``'s per-row lines: the mean of the
    rows' rates as ``EvalStatistics`` defines them, summed exactly
    (``math.fsum``). The CLI's global rates add the rows up in the order
    read, which the reader shuffles afresh each run, so two runs that
    decode every row alike can differ in the last bit; these cannot."""
    from speecht_tpu_torch.metrics import levenshtein

    rows = ROW_LINES.findall(output)
    letters = [levenshtein(e, d) / len(e) for e, d in rows]
    words = [levenshtein(e.split(), d.split()) / len(e.split()) for e, d in rows]
    n = max(len(rows), 1)
    return math.fsum(letters) / n, math.fsum(words) / n


def timed_eval(argv: list[str]) -> dict:
    """One ``evaluate`` run: its held-out LER and WER (``held_out_rates``;
    the CLI's own as ``cli_ler``, ``cli_wer``), wall seconds and output."""
    t0 = time.perf_counter()
    stats, out = run_cli(argv)
    seconds = time.perf_counter() - t0
    ler, wer = held_out_rates(out)
    rows = len(ROW_LINES.findall(out))
    if rows != stats.decodings_counter:
        raise RuntimeError(
            f"evaluate printed {rows} rows of {stats.decodings_counter} decoded")
    return {
        "ler": ler,
        "wer": wer,
        "cli_ler": stats.global_letter_error_rate,
        "cli_wer": stats.global_word_error_rate,
        "rows": stats.decodings_counter,
        "seconds": seconds,
        "output": out,
    }


def main(n_train: int = 400, steps: int = 600, *, n_test: int = N_TEST,
         device: str = "cuda", root: str | None = None, **widths) -> dict:
    """Runs the drill; returns every path's LER, WER and wall seconds, the
    train run's interval losses and seconds, the gates and ``ok``. The
    corpus, checkpoints and LM go under ``root`` and stay there; without
    one, under a temporary directory removed at the end."""
    from speecht_tpu_torch.execution import resolve_device
    from speecht_tpu_torch.tools.synthetic_corpus import make_corpus, write_lm

    resolve_device(device)  # no card: fail before the corpus is written
    keep = root is not None
    root = root or tempfile.mkdtemp(prefix="synth_")
    try:
        print(f"Generating {n_train}+{n_test} synthetic utterances...")
        make_corpus(root, n_train, n_test)
        common = [
            "--data-dir", os.path.join(root, "data"),
            "--train-dir", os.path.join(root, "train"),
            "--log-dir", os.path.join(root, "log"),
            "--run-name", "synth",
            "--batch-size", "16",
            "--bucket-step", "128",
            "--device", device,
            *model_flags(**widths),
        ]
        t0 = time.perf_counter()
        _state, out = run_cli([
            "train", "--max-steps", str(steps), "--steps-per-checkpoint", "200",
            "--learning-rate", "3e-4", *common,
        ])
        train_seconds = time.perf_counter() - t0
        evaluate = ["evaluate", "--test", "--no-save", *common]
        lm = [*evaluate, "--language-model", write_lm(root), *LM_FLAGS]
        result = {
            "greedy": timed_eval(evaluate),
            # LM shallow fusion should repair residual spelling errors;
            # the device beam must reproduce the host beam's metrics
            "host_lm": timed_eval(lm),
            "device_lm": timed_eval([*lm, "--device-beam"]),
            "rescore": timed_eval([*lm, "--device-beam", "--rescore", "8"]),
        }
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)

    g, h, d, r = (result[k] for k in ("greedy", "host_lm", "device_lm", "rescore"))
    print(f"\nheld-out greedy  LER: {g['ler']:.3f} WER: {g['wer']:.3f} "
          f"({g['seconds']:.1f}s)")
    print(f"held-out beam+LM LER: {h['ler']:.3f} WER: {h['wer']:.3f} "
          f"(host beam, {h['seconds']:.1f}s)")
    print(f"held-out beam+LM LER: {d['ler']:.3f} WER: {d['wer']:.3f} "
          f"(device beam, {d['seconds']:.1f}s)")
    print(f"held-out rescore8 LER: {r['ler']:.3f} WER: {r['wer']:.3f} "
          f"(device n-best + host rescore, {r['seconds']:.1f}s)")
    passed = gates(*((x["ler"], x["wer"]) for x in (g, h, d, r)))
    print_gates(passed)
    result.update(
        train_seconds=train_seconds,
        interval_losses=interval_lines(out),
        gates=passed,
        ok=all(passed.values()),
    )
    return result


def parse_args(argv=None, default_steps: int = 600) -> argparse.Namespace:
    """``[n_train] [steps] [--n-test N] [--device {cuda,cpu}]`` and the
    model widths, shared by the drills' command lines."""
    p = argparse.ArgumentParser()
    p.add_argument("n_train", type=int, nargs="?", default=400)
    p.add_argument("steps", type=int, nargs="?", default=default_steps)
    p.add_argument("--n-test", dest="n_test", type=int, default=N_TEST)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    for name in MODEL_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), dest=name, type=int)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = vars(parse_args())
    sys.exit(0 if main(args.pop("n_train"), args.pop("steps"), **args)["ok"] else 1)
