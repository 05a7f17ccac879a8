"""The training features on the synthetic corpus, across a crash-save.

``tools/train_features_check.py``'s drill moved onto the tone-speech
corpus (``synthetic_corpus.py``; the JAX drill trains on a LibriSpeech
utterance the repository does not hold): ``train --spec-augment`` with
narrow masks (freq width 8, time frac 0.02) and ``--grad-accum 2`` for
1200 global steps (the global step counts micro-batches, so 600 updates
at an effective batch of 32), then ``evaluate --test`` greedy, gated at
LER < 0.05 as the JAX drill.

The training is cut in two. The first launch runs in a process of its
own (``python -m speecht_tpu_torch train ...``) and gets SIGTERM once its
first interval line (``global step 200 ...``) has printed: it must exit 0
after the deferred stop and the crash-save, leaving ``ckpt-<S>.pt`` with
200 < S < 1200. The relaunch, in this process, runs ``--max-steps
1200 - S`` (counted from the launch): it must restore step S, print its
first interval line at the next multiple of 200, end with a checkpoint
at 1200 and carry the optimizer's step across.

    python -m speecht_tpu_torch.tools.train_features_check [n_train] [steps]

runs on the card (defaults 400 and 1200); ``--device cpu`` and the width
flags as ``synthetic_convergence``. It exits 1 when a gate fails.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from speecht_tpu_torch.tools import synthetic_convergence as sc

STEPS = 1200
INTERVAL = 200
GRAD_ACCUM = 2
FEATURE_FLAGS = [
    "--spec-augment",
    "--spec-augment-freq-width", "8",
    "--spec-augment-time-frac", "0.02",
    "--grad-accum", str(GRAD_ACCUM),
]


def signal_launch(argv: list[str], interval: int,
                  timeout: float | None = None) -> tuple[int, str]:
    """``python -m speecht_tpu_torch <argv>`` in a process of its own, its
    output relayed; SIGTERM once its first interval line has printed.
    Returns (its exit code, its output). The process is killed if it
    outlives ``timeout`` seconds or this function raises."""
    import speecht_tpu_torch

    env = dict(os.environ)
    package_root = os.path.dirname(os.path.dirname(speecht_tpu_torch.__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (package_root, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "speecht_tpu_torch", *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1,
    )
    timer = threading.Timer(timeout, proc.kill) if timeout else None
    if timer is not None:
        timer.start()
    lines, sent = [], False
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            lines.append(line)
            if not sent and sc.interval_lines(line):
                proc.send_signal(signal.SIGTERM)  # the deferred stop
                sent = True
        code = proc.wait()
    finally:
        if timer is not None:
            timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return code, "".join(lines)


def read_checkpoint(run_dir: str, step: int) -> dict:
    """The optimizer step and learning rate saved under ``step``."""
    import torch

    from speecht_tpu_torch.train.checkpoint import CheckpointManager

    payload = torch.load(CheckpointManager(run_dir).path(step),
                         map_location="cpu", weights_only=True)
    return {"step": payload["step"], "learning_rate": payload["learning_rate"]}


def relaunch_facts(first_code: int, first_out: str, second_out: str,
                   crash_step: int | None, last_step: int | None,
                   saved: dict, final: dict, steps: int, interval: int) -> dict:
    """What the crash-save and the relaunch must show, each a bool, and the
    numbers they rest on."""
    before = sc.interval_lines(first_out)
    after = sc.interval_lines(second_out)
    follows = (crash_step // interval + 1) * interval if crash_step else None
    checks = {
        "first launch exits 0": first_code == 0,
        "first launch stopped after the interval line": (
            "Interrupted -- saving checkpoint before exit" in first_out),
        f"{interval} < S < {steps}": (
            crash_step is not None and interval < crash_step < steps),
        "relaunch restores S": f"Restored model at step {crash_step}" in second_out,
        "relaunch's first interval line follows S": (
            bool(after) and after[0][0] == follows),
        f"last checkpoint at {steps}": last_step == steps,
        # every micro-batch of the relaunch counted from the restored step
        "optimizer step carried": final.get("step") == (
            saved.get("step", -1) + (steps - (crash_step or 0)) // GRAD_ACCUM),
    }
    return {
        "checks": checks,
        "crash_step": crash_step,
        "saved_optimizer_step": saved.get("step"),
        "restored_learning_rate": saved.get("learning_rate"),
        "final_optimizer_step": final.get("step"),
        "loss_before": before[-1][1] if before else None,
        "loss_after": after[0][1] if after else None,
        "interval_losses": before + after,
    }


def main(n_train: int = 400, steps: int = STEPS, *, n_test: int = sc.N_TEST,
         device: str = "cuda", root: str | None = None,
         interval: int = INTERVAL, launch=signal_launch, **widths) -> dict:
    """Runs the drill; returns the held-out LER, WER, the relaunch's facts
    (``relaunch``), the wall seconds of each part, the gates and ``ok``.
    ``launch(argv, interval) -> (exit code, output)`` runs the first
    launch (tests pass one that requests the stop in this process)."""
    from speecht_tpu_torch.execution import resolve_device
    from speecht_tpu_torch.tools.synthetic_corpus import make_corpus
    from speecht_tpu_torch.train.checkpoint import CheckpointManager

    resolve_device(device)  # no card: fail before the corpus is written
    keep = root is not None
    root = root or tempfile.mkdtemp(prefix="trainfeat_")
    try:
        print(f"Generating {n_train}+{n_test} synthetic utterances...")
        make_corpus(root, n_train, n_test)
        common = [
            "--data-dir", os.path.join(root, "data"),
            "--train-dir", os.path.join(root, "train"),
            "--log-dir", os.path.join(root, "log"),
            "--run-name", "trainfeat",
            "--batch-size", "16",
            "--bucket-step", "128",
            "--device", device,
            *sc.model_flags(**widths),
        ]
        train = ["train", "--steps-per-checkpoint", str(interval),
                 "--learning-rate", "3e-4", *FEATURE_FLAGS, *common]
        run_dir = os.path.join(root, "train", "trainfeat")
        manager = CheckpointManager(run_dir)

        t0 = time.perf_counter()
        first_code, first_out = launch([*train, "--max-steps", str(steps)], interval)
        first_seconds = time.perf_counter() - t0
        crash_step = manager.latest_step()
        saved = read_checkpoint(run_dir, crash_step) if crash_step else {}
        print(f"\ncrash-save: exit code {first_code}, ckpt-{crash_step}.pt "
              f"(optimizer step {saved.get('step')}, learning rate "
              f"{saved.get('learning_rate')!r}); relaunch --max-steps "
              f"{steps - (crash_step or 0)}")

        t0 = time.perf_counter()
        _state, second_out = sc.run_cli(
            [*train, "--max-steps", str(steps - (crash_step or 0))])
        second_seconds = time.perf_counter() - t0
        last_step = manager.latest_step()
        final = read_checkpoint(run_dir, last_step) if last_step else {}

        held_out = sc.timed_eval(["evaluate", "--test", "--no-save", *common])
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)

    facts = relaunch_facts(first_code, first_out, second_out, crash_step,
                           last_step, saved, final, steps, interval)
    ler, wer = held_out["ler"], held_out["wer"]
    print(f"relaunch: S={crash_step}, restored learning rate "
          f"{facts['restored_learning_rate']!r}, interval loss "
          f"{facts['loss_before']} before and {facts['loss_after']} after, "
          f"last checkpoint {last_step} (optimizer step "
          f"{facts['final_optimizer_step']}); "
          + ", ".join(f"{k}: {'yes' if v else 'NO'}"
                      for k, v in facts["checks"].items()))
    print(f"\nfinal LER: {ler:.3f}")
    print(f"final WER: {wer:.3f}")
    passed = {
        "CRASH-SAVE AND RELAUNCH": all(facts["checks"].values()),
        "TRAIN FEATURES CHECK": ler < 0.05,
    }
    sc.print_gates(passed)
    return {
        **held_out,
        "relaunch": facts,
        "seconds": {"first launch": first_seconds, "relaunch": second_seconds,
                    "evaluate": held_out["seconds"]},
        "gates": passed,
        "ok": all(passed.values()),
    }


if __name__ == "__main__":
    args = vars(sc.parse_args(default_steps=STEPS))
    sys.exit(0 if main(args.pop("n_train"), args.pop("steps"), **args)["ok"] else 1)
