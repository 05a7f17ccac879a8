"""Training and evaluation on several processes, through the port's CLI.

The port of ``tools/multiprocess_drill.py``. Each rank is a process of its
own, started with torch.distributed's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and no launcher agent, so the drill can signal and kill
one rank as a scheduler would. A rank runs the port's ``cli.main`` on its
arguments (``python -m speecht_tpu_torch.tools.multiprocess_drill rank
REPORT <CLI arguments>``) and writes REPORT as it exits: its kernels'
launch counts and the peak memory of its card.

On a synthetic npz cache of 16 equal-length utterances (the global batch,
so every step's batch is the whole corpus and the mean loss is
independent of the row order), the drill checks, on the printed losses
(0.05 + 1e-3·|loss|, the JAX drill's ``check_close``):

1. **dp**: 3 steps on 2 ranks (``--data-parallel``, each rank reading its
   shard) equal the one-process run's (the two launches side by side, as
   are the one-process and 2-rank launches of phases 2, 4 and 7);
2. **resume**: a second 2-rank launch restores the 2-rank checkpoint at
   step 3, and steps 4-6 equal the one-process run's resume;
3. **dp x tp**: 4 ranks on a 2x2 grid (``--data-parallel 2
   --model-parallel 2``; JAX's ``(data=4, model=2)`` over 2 processes of
   4 devices: here a grid holds every launched rank, one a process);
4. **mixed buckets**: on a corpus where one 208-frame file lies in one
   rank's shard, each batch's bucket is synced across ranks
   (``parallel/mesh.py::sync_bucket_dims``), so 2 ranks equal one process;
5. **grad-accum**: half the batch and ``--grad-accum 2`` on 2 ranks equal
   the full-batch run, interval by interval;
6. **worker SIGTERM and relaunch**: rank 1 of an 8-step run gets SIGTERM
   once rank 0 has written its first checkpoint; it finishes its step,
   skips the solo crash-save and ends its run, the survivor is given a
   grace period and killed, and the relaunched pair restores the last
   checkpoint both ranks wrote (step k, 1 <= k < 6) and lands on the
   uninterrupted curve (steps k+1..6). Up to 3 attempts, each printed;
7. **evaluate**: 2 ranks restoring the mixed run's checkpoint give the
   one-process loss and global statistics.

    python -m speecht_tpu_torch.tools.multiprocess_drill [--device cpu]

runs on the card at full width (250/2000 channels, 11 layers; float32 with
TF32 off, ``NVIDIA_TF32_OVERRIDE=0``, so float32 means IEEE float32 as on
JAX's CPU) with JAX's other flags; ``--device cpu`` runs JAX's narrow
model. Ranks take NCCL with a card each; when they outnumber the cards
the drill sets ``SPEECHT_SHARE_CARD=1`` and they share them through gloo
(``parallel/mesh.py::placement``). Each launch prints its backend, wall
time, exit codes, its ranks' ``ctc_alpha``/``ctc_beta`` launches and peak
memory; the last lines are a JSON line of every launch and ``PASS
multiprocess drill``. It exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FILES = 16  # == global batch size: every global batch is the full corpus
N_FRAMES = 80
INPUT_SIZE = 128
LABEL_LEN = 10

# JAX's MODEL_FLAGS (the narrow model, for the CPU); the card runs the
# default widths with the rest of them
CPU_WIDTH_FLAGS = ["--base-channels", "32", "--wide-channels", "64",
                   "--num-body-layers", "2"]
MODEL_FLAGS = ["--bucket-step", "96", "--compute-dtype", "float32"]

KILL_STEPS = 8
KILL_ATTEMPTS = 3
LAUNCH_TIMEOUT_S = 600
# after the SIGTERM: the signalled rank's time to finish its step and end
# its run, then the survivor's to fail on its own, before each is killed
SIGNALLED_GRACE_S = 60
SURVIVOR_GRACE_S = 20
DIST_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")
SOLO_SAVE_SKIPPED = "distributed interrupt/crash: skipping solo crash-save"
# the checks' lines, in order (the JAX drill's, but for the grid's)
PASS_LINES = (
    "PASS dp 2-process steps 1-3",
    "PASS dp 2-process steps 4-6",
    "PASS dpxtp 4-rank 2x2 grid steps 1-3",
    "PASS mixed-bucket dp 2-process steps 1-3",
    "PASS grad-accum dp 2-process applies 1-3",
    "PASS kill/resume steps",
    "PASS eval 2-process loss",
    "PASS eval 2-process global stats",
    "PASS multiprocess drill",
)


def make_corpus(root: str) -> str:
    """Synthetic npz feature cache: N_FILES distinct equal-length samples."""
    data = os.path.join(root, "data")
    cache = os.path.join(data, "preprocessed-power", "train")
    os.makedirs(cache)
    rng = np.random.RandomState(0)
    for i in range(N_FILES):
        np.savez(
            os.path.join(cache, f"synth-{i:03d}"),
            audio_fragments=rng.randn(N_FRAMES, INPUT_SIZE).astype(
                np.float32
            ),
            transcript=rng.randint(0, 28, size=LABEL_LEN).astype(np.int64),
        )
    return data


def make_mixed_corpus(root: str) -> None:
    """Corpus whose shards disagree on batch shape: one file is 208
    frames (time bucket 288), the rest 80 (bucket 96). The long file
    lands in exactly one rank's shard, so without the per-batch bucket
    sync the ranks would pad their batches to different shapes. The test
    split equals the train split (the evaluate phase)."""
    rng = np.random.RandomState(1)
    samples = []
    for i in range(N_FILES):
        frames = 208 if i == 0 else N_FRAMES
        samples.append(
            (
                f"synth-{i:03d}",
                rng.randn(frames, INPUT_SIZE).astype(np.float32),
                rng.randint(0, 28, size=LABEL_LEN).astype(np.int64),
            )
        )
    for split in ("train", "test"):
        cache = os.path.join(root, "data", "preprocessed-power", split)
        os.makedirs(cache)
        for name, frags, transcript in samples:
            np.savez(
                os.path.join(cache, name),
                audio_fragments=frags,
                transcript=transcript,
            )


@dataclasses.dataclass
class Launch:
    """One launch of the CLI on ``len(logs)`` ranks: each rank's output,
    exit code (None: killed) and report (None: it wrote none)."""

    name: str
    argv: list
    seconds: float
    codes: list
    logs: list
    reports: list

    @property
    def out(self) -> str:
        return self.logs[0]

    def summary(self) -> dict:
        return {
            "name": self.name, "argv": self.argv, "ranks": len(self.logs),
            "seconds": self.seconds, "codes": self.codes,
            "backend": backend_of(self.logs),
            "launches": [r and r["launches"] for r in self.reports],
            "peak_mb": [r and r["peak_mb"] for r in self.reports],
        }


class Drill:
    """The launches of one drill: the device, the widths, the root."""

    def __init__(self, root: str, device: str):
        self.root = root
        self.device = device
        self.model_flags = MODEL_FLAGS + (CPU_WIDTH_FLAGS if device == "cpu" else [])
        self.launches: list[Launch] = []

    def common_flags(self, root: str, run_name: str) -> list[str]:
        return [
            "--data-dir", os.path.join(root, "data"),
            "--train-dir", os.path.join(root, "train"),
            "--log-dir", os.path.join(root, "log"),
            "--run-name", run_name,
            "--batch-size", str(N_FILES),
            "--device", self.device,
        ] + self.model_flags

    def train_args(self, root: str, run_name: str, extra=(), steps: int = 3) -> list[str]:
        return (
            ["train", "--max-steps", str(steps), "--steps-per-checkpoint", "1",
             "--learning-rate", "3e-4"]
            + self.common_flags(root, run_name)
            + list(extra)
        )

    def eval_args(self, root: str, run_name: str) -> list[str]:
        return ["evaluate", "--test", "--no-save", "--step-count", "1"] + \
            self.common_flags(root, run_name)

    def env(self, rank: int | None = None, world: int = 1, port: int = 0) -> dict:
        import speecht_tpu_torch

        env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
        package_root = os.path.dirname(os.path.dirname(speecht_tpu_torch.__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (package_root, env.get("PYTHONPATH")) if p)
        env["PYTHONUNBUFFERED"] = "1"
        if self.device != "cpu":
            env["NVIDIA_TF32_OVERRIDE"] = "0"
        if rank is not None:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            if self.device != "cpu" and world > cards():
                env["SPEECHT_SHARE_CARD"] = "1"
        return env

    def start(self, name: str, argv: list[str], ranks: int):
        """Starts the ranks of a launch; returns (processes, log paths,
        report paths, open files)."""
        port = free_port() if ranks > 1 else 0
        procs, logs, reports, files = [], [], [], []
        for r in range(ranks):
            log = os.path.join(self.root, f"{name}.r{r}.log")
            report = os.path.join(self.root, f"{name}.r{r}.json")
            if os.path.exists(report):
                os.remove(report)
            f = open(log, "w")
            files.append(f)
            logs.append(log)
            reports.append(report)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "speecht_tpu_torch.tools.multiprocess_drill",
                 "rank", report, *argv],
                env=self.env(r if ranks > 1 else None, ranks, port),
                stdout=f, stderr=subprocess.STDOUT, cwd=self.root,
            ))
        return procs, logs, reports, files

    def finish(self, name, argv, procs, logs, reports, files, t0, end=None) -> Launch:
        """Kills what is left of a launch and reads its logs and reports;
        its seconds run from ``t0`` to ``end`` (default: now)."""
        end = end or time.perf_counter()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        launch = Launch(
            name=name, argv=argv, seconds=end - t0,
            codes=[p.returncode if p.returncode >= 0 else None for p in procs],
            logs=[read(log) for log in logs],
            reports=[json.loads(read(r)) if os.path.exists(r) else None
                     for r in reports],
        )
        self.launches.append(launch)
        print_launch(launch)
        return launch

    def run(self, *launches) -> list[str]:
        """Launches, each (name, argv, ranks), side by side to their ends;
        returns each one's rank-0 output. What outlives the time limit is
        killed; any exit code but 0 raises. A comparison's one-process run
        goes beside its multi-rank run: only one launch at a time takes a
        rendezvous port."""
        t0 = time.perf_counter()
        started = [self.start(name, argv, ranks) for name, argv, ranks in launches]
        ended = [None] * len(started)
        try:
            deadline = time.time() + LAUNCH_TIMEOUT_S
            while None in ended and time.time() < deadline:
                for i, (procs, *_rest) in enumerate(started):
                    if ended[i] is None and all(p.poll() is not None for p in procs):
                        ended[i] = time.perf_counter()
                time.sleep(0.05)
        finally:
            done = [self.finish(name, argv, *s, t0, end)
                    for (name, argv, _ranks), s, end in zip(launches, started, ended)]
        failed = [launch for launch in done if any(code != 0 for code in launch.codes)]
        for launch in failed:
            for r, log in enumerate(launch.logs):
                sys.stderr.write(f"--- {launch.name}, rank {r} ---\n{log[-4000:]}\n")
        if failed:
            raise RuntimeError(", ".join(f"{launch.name}: exit codes {launch.codes}"
                                         for launch in failed))
        return [launch.out for launch in done]

    def kill_resume(self, root: str, curve: list[float], attempt: int) -> bool:
        """SIGTERM rank 1 of a 2-rank run once rank 0 has written its first
        checkpoint, tear the job down, relaunch it, and check that it
        resumes from the last checkpoint both ranks wrote onto ``curve``
        (the uninterrupted run's losses). False when the signal landed
        after rank 1's run ended (the caller retries)."""
        shutil.rmtree(os.path.join(root, "train", "killmp"), ignore_errors=True)
        args = self.train_args(root, "killmp", steps=KILL_STEPS)
        name = f"killmp{attempt}"
        t0 = time.perf_counter()
        started = self.start(name, args, 2)
        procs, logs = started[0], started[1]
        notes = []
        try:
            deadline = time.time() + LAUNCH_TIMEOUT_S
            while time.time() < deadline and procs[1].poll() is None:
                if "Model saved" in read(logs[0]):
                    break
                time.sleep(0.005)
            if procs[1].poll() is None:
                procs[1].send_signal(signal.SIGTERM)  # the eviction signal
                notes.append(f"SIGTERM to rank 1 {time.perf_counter() - t0:.1f} s "
                             "after the start, once rank 0 printed its first 'Model saved'")
            try:
                procs[1].wait(timeout=SIGNALLED_GRACE_S)
            except subprocess.TimeoutExpired:
                procs[1].kill()
                notes.append(f"rank 1 killed after its {SIGNALLED_GRACE_S} s grace")
            # the survivor waits on collectives with a dead peer: a
            # scheduler tears the rest of the job down after a grace period
            try:
                procs[0].wait(timeout=SURVIVOR_GRACE_S)
                notes.append(f"rank 0 ended on its own, exit code {procs[0].returncode}")
            except subprocess.TimeoutExpired:
                procs[0].kill()
                notes.append(f"rank 0 killed after its {SURVIVOR_GRACE_S} s grace")
        finally:
            launch = self.finish(name, args, *started, t0)
        log1 = launch.logs[1]
        landed = SOLO_SAVE_SKIPPED in log1
        print(f"kill/resume attempt {attempt}: " + "; ".join(notes)
              + ("" if landed else "; rank 1's run ended before the signal landed"),
              flush=True)
        if not landed:
            return False
        # the deferred stop ran to the end of the executor
        expect("Done training -- step limit reached" in log1, log1[-2000:])
        expect(launch.codes[1] == 0, (launch.codes, log1[-2000:]))

        (out,) = self.run((f"killmp{attempt}_resume", args, 2))
        m = re.search(r"Restored model at step (\d+)", out)
        expect(m, out[-2000:])
        k = int(m.group(1))
        expect(1 <= k < len(curve), (k, log1[-1000:]))
        # run-relative --max-steps: the relaunch runs k+1 .. k+KILL_STEPS;
        # the uninterrupted curve covers steps up to len(curve)
        check_close(
            f"kill/resume steps {k + 1}-{len(curve)} (killed at cooperative step {k})",
            parse_losses(out)[: len(curve) - k], curve[k:], 0.05,
        )
        return True


class DrillFailure(RuntimeError):
    """A check of the drill failed."""


def expect(cond, detail) -> None:
    """Raises DrillFailure with ``detail`` unless ``cond`` holds."""
    if not cond:
        raise DrillFailure(detail)


def cards() -> int:
    import torch

    return torch.cuda.device_count()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def backend_of(logs: list[str]) -> str:
    """The ranks' backend and devices from their ``distributed:`` lines."""
    found = sorted({m.group(1) for log in logs
                    for m in re.finditer(r"^distributed: rank \d+ of \d+, backend (.*)$",
                                         log, re.M)})
    return "; ".join(found) if found else "one process"


def print_launch(launch: Launch) -> None:
    s = launch.summary()
    counts = [None if n is None else {k: n[k] for k in ("ctc_alpha", "ctc_beta")}
              for n in s["launches"]]
    print(f"launch {s['name']}: {s['ranks']} rank(s), backend {s['backend']}; "
          f"{s['seconds']:.1f} s; exit codes {s['codes']}; kernel launches a rank "
          f"{counts}; peak memory a rank (MB allocated / reserved) {s['peak_mb']}",
          flush=True)


def parse_losses(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"average loss (\S+)", text)]


def parse_global_stats(text: str) -> list[float]:
    m = re.search(
        r"Global statistics\s*\nLED: (\S+) LER: (\S+) WED: (\S+) WER: (\S+)",
        text,
    )
    expect(m, text[-2000:])
    return [float(g) for g in m.groups()]


def check_close(name: str, got: list[float], want: list[float], tol: float):
    expect(len(got) == len(want), (name, got, want))
    for g, w in zip(got, want):
        # losses print with 2 decimals; tol covers print quantization +
        # f32 reduction-order differences across grids
        expect(abs(g - w) <= tol + 1e-3 * abs(w), (name, got, want))
    print(f"PASS {name}: losses {got} == {want} (tol {tol})", flush=True)


def run(drill: Drill) -> list[dict]:
    """The seven phases in JAX's order; returns every launch's summary."""
    root = os.path.join(drill.root, "uniform")
    make_corpus(root)

    print("== single-process baseline, beside the 2-rank dp run ==", flush=True)
    out, out_mp = drill.run(("base1", drill.train_args(root, "base"), 1),
                            ("mp1", drill.train_args(root, "mp"), 2))
    base_a = parse_losses(out)
    expect(len(base_a) == 3, base_a)
    expect("distributed: rank 0 of 2, backend" in out_mp, out_mp[-2000:])
    check_close("dp 2-process steps 1-3", parse_losses(out_mp), base_a, 0.05)

    print("== 2-rank resume from the 2-rank checkpoint, beside the baseline's ==",
          flush=True)
    out, out_mp = drill.run(("base2", drill.train_args(root, "base"), 1),
                            ("mp2", drill.train_args(root, "mp"), 2))
    expect("Restored model at step 3" in out, out[-2000:])
    base_b = parse_losses(out)
    expect(len(base_b) == 3, base_b)
    print(f"baseline losses: {base_a} then {base_b}", flush=True)
    expect("Restored model at step 3" in out_mp, out_mp[-2000:])
    check_close("dp 2-process steps 4-6", parse_losses(out_mp), base_b, 0.05)

    print("== 4-rank dp x tp run (grid 2x2) ==", flush=True)
    (out,) = drill.run(("mptp", drill.train_args(
        root, "mptp", extra=["--data-parallel", "2", "--model-parallel", "2"]), 4))
    expect("distributed: rank 0 of 4, backend" in out, out[-2000:])
    check_close("dpxtp 4-rank 2x2 grid steps 1-3", parse_losses(out), base_a, 0.05)

    print("== mixed-length corpus: per-batch bucket sync (dp) ==", flush=True)
    root2 = os.path.join(drill.root, "mixed")
    make_mixed_corpus(root2)
    out, out_mp = drill.run(("mixbase", drill.train_args(root2, "mixbase"), 1),
                            ("mixmp", drill.train_args(root2, "mixmp"), 2))
    mix_base = parse_losses(out)
    expect(len(mix_base) == 3, mix_base)
    check_close("mixed-bucket dp 2-process steps 1-3", parse_losses(out_mp), mix_base, 0.05)

    print("== 2-rank dp + grad-accum run ==", flush=True)
    # half the batch x 2 accumulated micro-batches == the full-batch
    # baseline: each pair of micro-batches partitions the corpus, so the
    # averaged gradient is the big batch's and the interval-averaged loss
    # (spc=2) equals the baseline's per-step loss
    (out,) = drill.run(("mpga", [
        "train", "--max-steps", "6", "--steps-per-checkpoint", "2",
        "--learning-rate", "3e-4", "--grad-accum", "2",
    ] + drill.common_flags(root, "mpga") + ["--batch-size", "8"], 2))
    expect("gradient accumulation: 2 micro-batches" in out, out[-2000:])
    check_close("grad-accum dp 2-process applies 1-3", parse_losses(out), base_a, 0.05)

    print("== 2-rank worker SIGTERM + job relaunch ==", flush=True)
    # base_a + base_b is the uninterrupted curve (dp and resume parity
    # held above)
    for attempt in range(1, KILL_ATTEMPTS + 1):
        if drill.kill_resume(root, base_a + base_b, attempt):
            break
    else:
        raise RuntimeError("kill/resume: SIGTERM never landed mid-train")

    print("== 2-rank evaluate (greedy, mixed corpus), beside one process ==", flush=True)
    # both restore the 2-rank run's checkpoint: per-row logits agree, so
    # the loss and the global statistics must too
    out, out_mp = drill.run(("evalbase", drill.eval_args(root2, "mixmp"), 1),
                            ("evalmp", drill.eval_args(root2, "mixmp"), 2))
    eval_base_loss = parse_losses(out)
    expect(len(eval_base_loss) == 1, eval_base_loss)
    check_close("eval 2-process loss", parse_losses(out_mp), eval_base_loss, 0.05)
    check_close("eval 2-process global stats", parse_global_stats(out_mp),
                parse_global_stats(out), 0.05)
    return [launch.summary() for launch in drill.launches]


def rank_main(report: str, argv: list[str]) -> None:
    """One rank (or the one process) of a launch: the port's CLI on
    ``argv``; at exit, REPORT holds the kernels' launch counts and the
    peak memory of this rank's card (None on the CPU)."""
    import torch

    from speecht_tpu_torch import cli
    from speecht_tpu_torch.ops import beam_device_cuda, conv0_cuda, ctc_cuda

    kernels = (list(ctc_cuda.KERNELS) + list(conv0_cuda.KERNELS)
               + list(beam_device_cuda.KERNELS))
    try:
        cli.main(argv)
    finally:
        peak = None
        if torch.cuda.is_initialized():
            peak = [torch.cuda.max_memory_allocated() / 1e6,
                    torch.cuda.max_memory_reserved() / 1e6]
        with open(report, "w") as f:
            json.dump({"launches": {k.name: k.launches for k in kernels},
                       "peak_mb": peak}, f)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m speecht_tpu_torch.tools.multiprocess_drill")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=None,
                    help="directory to run in and keep (default: a temporary one)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and cards() == 0:
        print("error: --device cuda: no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    keep = args.root is not None
    root = args.root or tempfile.mkdtemp(prefix="mp_drill_")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    try:
        summaries = run(Drill(root, args.device))
    except RuntimeError as e:
        print(f"FAIL multiprocess drill: {e!r}", flush=True)
        return 1
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"multiprocess_drill": summaries,
                      "seconds": time.perf_counter() - t0}))
    print(
        "PASS multiprocess drill: dp, checkpoint/resume, dp x tp, "
        "mixed-bucket sync, grad-accum, worker kill/resume, evaluate"
    )
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank_main(sys.argv[2], sys.argv[3:])
    else:
        sys.exit(main())
