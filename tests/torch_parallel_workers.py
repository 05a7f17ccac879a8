"""Multi-process harness and rank workers for the port's parallel tests.

:func:`run_ranks` starts ``world`` spawned processes on the CPU, each with
one torch thread, joined in a gloo group through a ``file://`` rendezvous
under the test's own directory (no TCP port, so pytest-xdist workers
never race for one). Each worker writes what it computed into ``.npz``
files beside the rendezvous, and the test compares them with the JAX
package in its own process. Only torch, numpy and the port are imported
here, so a rank starts in a second or two.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120


def _entry(target, rank, world, work, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{work}/rendezvous", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
        from speecht_tpu_torch.parallel import mesh as pmesh

        pmesh.init_distributed("cpu")
        target(rank, world, work, *args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(target, work, *args, world: int = 2) -> None:
    """Runs ``target(rank, world, work, *args)`` on ``world`` ranks; raises
    with the failing ranks' tracebacks, and kills every rank still alive
    after the timeout."""
    work = str(work)
    os.makedirs(work, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_entry, args=(target, r, world, work, args))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(work, f"error-{r}.txt")
        if os.path.exists(path):
            errors.append(f"rank {r}:\n{open(path).read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if alive or errors:
        raise AssertionError(
            f"{len(alive)} rank(s) timed out after {TIMEOUT_S} s\n" + "\n".join(errors)
        )


# -- shared pieces ------------------------------------------------------------


def tiny_config():
    from speecht_tpu_torch.models.wav2letter import Wav2LetterConfig

    return Wav2LetterConfig(
        input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
        compute_dtype="float32",
    )


def load_batch(path):
    from speecht_tpu_torch.data.pipeline import Batch, to_device

    with np.load(path) as z:
        b = Batch(z["features"], z["seq_lengths"], z["labels"], z["label_lengths"])
    return to_device(b, torch.device("cpu"), "float32")


def rows(batch, lo, hi):
    from speecht_tpu_torch.data.pipeline import Batch

    return Batch(*(getattr(batch, f)[lo:hi] for f in
                   ("features", "seq_lengths", "labels", "label_lengths")))


def fresh_state(model, state_path, lr):
    """The port's train state over ``model`` from a JAX state saved as npz
    (``params/<layer>/<leaf>``, ``mu/...``, ``nu/...``, ``count``, ``step``)."""
    from speecht_tpu_torch.train import state as tstate
    from speecht_tpu_torch.weights import train_state_from_jax

    trees = {"params": {}, "mu": {}, "nu": {}}
    with np.load(state_path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] in trees:
                trees[parts[0]].setdefault(parts[1], {})[parts[2]] = z[key]
        count, step = z["count"], z["step"]
    tx = tstate.make_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    state = tstate.create_train_state(dict(model.named_parameters()), tx, lr)
    state = train_state_from_jax(
        state, trees["params"], trees["mu"], trees["nu"], count, step, lr,
        split=model.split,
    )
    return state, tx


def stats_row(stats):
    """Evaluate's global statistics, in an order-free form: the utterance
    count and the edit-distance sums (integers), then the global LER and
    WER (float sums, so equal only to rounding)."""
    return [stats.decodings_counter, stats.sum_letter_edit_distance,
            stats.sum_word_edit_distance, stats.global_letter_error_rate,
            stats.global_word_error_rate]


# -- workers -------------------------------------------------------------------


def train_steps(rank, world, work, state_path, batch_paths, lr):
    """Per grid (DP 2x1, TP 1x2) and per --grad-accum: the train steps on
    the saved batches from the saved JAX state; rank 0 saves the full
    parameters and the losses and grad norms."""
    from speecht_tpu_torch.models.wav2letter import Wav2Letter
    from speecht_tpu_torch.ops import conv_grad
    from speecht_tpu_torch.parallel import mesh as pmesh
    from speecht_tpu_torch.train import step as tstep

    cfg = tiny_config()
    batches = [load_batch(p) for p in batch_paths]
    for name, (dp, mp), accum in (
        ("dp", (2, 1), 1), ("tp", (1, 2), 1), ("dp_accum", (2, 1), 2),
    ):
        mesh = pmesh.make_mesh(dp, mp)
        model = Wav2Letter(cfg, mesh=mesh)
        state, tx = fresh_state(model, state_path, lr)
        step = tstep.make_train_step_acc(model, tx, accum_steps=accum, mesh=mesh)
        gacc = tstep.init_grad_accum(state.params) if accum > 1 else None
        losses, norms, updates = [], [], 0.0
        input_grads = conv_grad.input_grads
        for batch in batches:
            per = batch.features.shape[0] // dp
            local = rows(batch, mesh.data_index * per, (mesh.data_index + 1) * per)
            acc = tstep.init_metrics_acc()
            if gacc is None:
                state, acc = step(state, acc, local)
            else:
                state, gacc, acc = step(state, gacc, acc, local)
            losses.append(acc["loss_sum"].item())
            norms.append(acc["grad_norm_sum"].item())
            updates += acc["updates"].item()
        metrics = {"loss": np.array(losses), "grad_norm": np.array(norms),
                   "updates": np.array(updates),
                   "input_grads": np.array(conv_grad.input_grads - input_grads)}
        full = model.split.unshard(state.params)
        if rank == 0:
            np.savez(os.path.join(work, f"{name}.npz"),
                     **{k: v.detach().numpy() for k, v in full.items()},
                     **{f"metric/{k}": v for k, v in metrics.items()})


def seq_parallel(rank, world, work, state_path, batch_path, lr):
    """On a 1 x 2 sequence-parallel grid: the forward's logits, the loss
    and its gradients (summed over the sequence group) and one train step;
    rank 0 saves them."""
    from speecht_tpu_torch.models.wav2letter import Wav2Letter
    from speecht_tpu_torch.ops import conv_grad
    from speecht_tpu_torch.parallel import mesh as pmesh
    from speecht_tpu_torch.parallel import seq_parallel as sp
    from speecht_tpu_torch.train import step as tstep

    mesh = pmesh.make_mesh(1, 2)
    mesh.seq_parallel = True
    model = Wav2Letter(tiny_config(), mesh=mesh)
    state, tx = fresh_state(model, state_path, lr)
    batch = load_batch(batch_path)
    out = {}
    with torch.no_grad():
        out["logits"] = sp.make_sp_forward(model, mesh)(batch.features).numpy()
    loss, _logits = sp.make_sp_loss_fn(model, mesh)(batch)
    names = list(state.params)
    input_grads = conv_grad.input_grads
    grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
    out["input_grads"] = np.array(conv_grad.input_grads - input_grads)
    grads = tstep._reduce_grads(grads, mesh)
    out["loss"] = loss.detach().numpy()
    out.update({f"grad/{k}": v.numpy() for k, v in grads.items()})
    state, m = sp.make_sp_train_step(model, tx, mesh)(state, batch)
    out["step_loss"] = m["loss"].numpy()
    out["step_grad_norm"] = m["grad_norm"].numpy()
    out.update({f"param/{k}": v.detach().numpy() for k, v in state.params.items()})
    if rank == 0:
        np.savez(os.path.join(work, "sp.npz"), **out)


def cli_runs(rank, world, work, argv_base):
    """``train --data-parallel 2`` and ``--model-parallel 2`` (2 steps, a
    checkpoint at step 2), then ``evaluate`` of the DP checkpoint on the
    2 x 1 and 1 x 2 grids and with ``--seq-parallel 2``, through the CLI; rank 0
    saves each evaluate's statistics and checks the ``distributed:`` line."""
    import contextlib
    import io
    import json

    from speecht_tpu_torch.cli import CLI

    out = {}
    for run, grid in (("dp", ["--data-parallel", "2"]), ("tp", ["--model-parallel", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            CLI(["train", *argv_base, "--run-name", run, *grid, "--max-steps", "2",
                 "--steps-per-checkpoint", "2", "--learning-rate", "1e-3"]).run()
        out[f"train_{run}"] = buf.getvalue()
    for name, grid in (("dp", ["--data-parallel", "2"]), ("tp", ["--model-parallel", "2"]),
                       ("sp", ["--seq-parallel", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = CLI(["evaluate", *argv_base, "--run-name", "dp", "--test",
                         "--no-save", *grid]).run()
        out[f"evaluate_{name}"] = {
            "stdout": buf.getvalue(),
            "stats": stats_row(stats),
        }
    with open(os.path.join(work, f"cli-{rank}.json"), "w") as f:
        json.dump(out, f)


def sync_dims(rank, world, work):
    """A batch built on a thread of its own (as the loader builds it) from
    a short utterance on rank 0 and a long one on rank 1, a direct
    ``sync_bucket_dims`` and the host row gather; each rank saves them."""
    import threading

    from speecht_tpu_torch.data.pipeline import build_batch
    from speecht_tpu_torch.parallel import mesh as pmesh

    frames, letters = (100, 3) if rank == 0 else (600, 40)
    samples = [(np.ones((frames, 8), np.float32), np.arange(letters, dtype=np.int32))]
    built = {}
    thread = threading.Thread(
        target=lambda: built.setdefault("batch", build_batch(samples, time_bucket=256))
    )
    thread.start()
    thread.join(TIMEOUT_S)
    batch = built["batch"]
    mesh = pmesh.Mesh(dp=world, mp=1, rank=rank)
    gathered = pmesh.allgather_host_rows(np.full((2, 3), rank, np.int32), mesh)
    np.savez(
        os.path.join(work, f"sync-{rank}.npz"),
        features_shape=np.array(batch.features.shape),
        labels_shape=np.array(batch.labels.shape),
        dims=np.array(pmesh.sync_bucket_dims(10 * (rank + 1), 7 - rank)),
        gathered=gathered,
        local=pmesh.local_rows(gathered, mesh),
    )


# -- evaluate with the LM and from audio (test_torch_parallel_decode.py) --------


def evaluate_recorded(argv):
    """``evaluate`` through ``CLI(argv).run()``: its stdout, the global
    statistics (:func:`stats_row`), every row it tracked as sorted
    ``[expected, decoded]`` strings, each batch's loss unrounded, and how
    many rows this process's beam searched."""
    import io

    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.cli import CLI
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder

    rows, losses, searched = [], [], []
    track, results = Evaluation._track_batch, Evaluation._result_iterator
    decode = BeamSearchDecoder.decode_emissions

    def tracked(stats, batch, decoded, dec_lengths, verbose=False):
        lengths = getattr(batch, "seq_lengths", None)
        lengths = batch.num_samples if lengths is None else lengths
        for i in range(decoded.shape[0]):
            if lengths[i]:
                rows.append([
                    vocabulary.ids_to_sentence(batch.labels[i, : batch.label_lengths[i]]),
                    vocabulary.ids_to_sentence(decoded[i, : dec_lengths[i]]),
                ])
        return track(stats, batch, decoded, dec_lengths, verbose)

    def recorded(self, eval_step, loader):
        for item in results(self, eval_step, loader):
            losses.append(float(item[1]))
            yield item

    def counted(self, logp, lengths, *args, **kwargs):
        searched.append(int(logp.shape[0]))
        return decode(self, logp, lengths, *args, **kwargs)

    Evaluation._track_batch = staticmethod(tracked)
    Evaluation._result_iterator = recorded
    BeamSearchDecoder.decode_emissions = counted
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            stats = CLI(["evaluate", *argv]).run()
    finally:
        Evaluation._track_batch = staticmethod(track)
        Evaluation._result_iterator = results
        BeamSearchDecoder.decode_emissions = decode
    return {"stdout": buf.getvalue(), "stats": stats_row(stats),
            "rows": sorted(rows), "losses": losses, "searched": sum(searched)}


def decode_runs(rank, world, work, argv_base, cases):
    """``evaluate`` through the CLI for each ``(name, flags)`` of
    ``cases`` (the LM paths and from audio, on a 2 x 1 or 1 x 2 grid);
    each rank saves what :func:`evaluate_recorded` returns."""
    import json

    os.environ["SPEECHT_DEVICE_LM_CACHE"] = os.path.join(work, "device_lm")
    out = {name: evaluate_recorded([*argv_base, *flags]) for name, flags in cases}
    with open(os.path.join(work, f"decode-{rank}.json"), "w") as f:
        json.dump(out, f)


def conformer_train(rank, world, work, argv):
    """``train --model conformer`` on ``world`` data-parallel ranks through
    the CLI (``argv`` holds the rest); each rank saves its parameters."""
    from speecht_tpu_torch.cli import CLI

    state = CLI([*argv, "--data-parallel", str(world)]).run()
    np.savez(os.path.join(work, f"conformer-{rank}.npz"),
             **{k: v.detach().numpy() for k, v in state.params.items()})
