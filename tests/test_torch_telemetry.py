"""The port's program spans (``speecht_tpu_torch/telemetry.py``) on the CPU.

Nothing is logged without a profiler; with one, a train step logs its
forward, backward and optimizer stages in order (the optimizer once an
update under gradient accumulation), and a ``PrefetchLoader`` pass logs
its stages on both threads with the batches' sequence numbers. A span
and a ``record_function`` around the same sleep agree on the profiler's
clock; the log is bounded and counts what it drops; the loader's stall
counters read the wait span's clock.
"""

import threading
import time

import numpy as np
import pytest
import torch

from speecht_tpu_torch import telemetry
from speecht_tpu_torch.data import pipeline
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops.augment import make_augment_fn
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep

TINY = Wav2LetterConfig(input_size=8, base_channels=8, wide_channels=16,
                        num_body_layers=1, compute_dtype="float32")
STAGES = ("step.forward", "step.backward", "step.optimizer")


@pytest.fixture
def log(monkeypatch):
    log = telemetry.SpanLog()
    monkeypatch.setattr(telemetry, "LOG", log)
    return log


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _batch(seed, B=2, T=32, L=3):
    rng = np.random.RandomState(seed)
    return pipeline.to_device(pipeline.Batch(
        features=rng.randn(B, T, 8).astype(np.float32),
        seq_lengths=np.full(B, T, np.int32),
        labels=rng.randint(0, 5, size=(B, L)).astype(np.int32),
        label_lengths=np.full(B, L, np.int32),
    ), torch.device("cpu"), "float32")


def _step(accum_steps=1, augment=False):
    torch.manual_seed(0)
    model = Wav2Letter(TINY)
    tx = tstate.make_optimizer()
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-3)
    step = tstep.make_train_step_acc(
        model, tx, accum_steps=accum_steps,
        augment_fn=make_augment_fn(freq_width=2) if augment else None)
    return state, step


def _samples(n, frames=(20, 60)):
    rng = np.random.RandomState(1)
    return [(rng.randn(rng.randint(*frames), 8).astype(np.float32),
             rng.randint(0, 28, size=4)) for _ in range(n)]


def _names(spans):
    return [s.name for s in spans]


def test_nothing_is_logged_without_a_profiler(log):
    state, step = _step(augment=True)
    step(state, tstep.init_metrics_acc(), _batch(0))
    loader = pipeline.PrefetchLoader(lambda: iter(_samples(6)), 2, torch.device("cpu"))
    assert len(list(loader)) == 3
    with telemetry.span("train.interval") as sp:
        pass
    assert not hasattr(sp, "start_ns")
    assert log.spans() == [] and log.dropped == 0


def test_train_step_logs_its_stages_in_order(log):
    state, step = _step(augment=True)
    with _profiler():
        step(state, tstep.init_metrics_acc(), _batch(0))
    spans = log.spans()
    # SpecAugment runs before the loss, in a forward span of its own
    assert _names(spans) == ["step.forward", "step.forward", "step.backward",
                             "step.optimizer"]
    assert all(s.parent is None and s.thread == threading.get_native_id() for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    assert all(s.start_ns < s.end_ns for s in spans)


def test_optimizer_span_opens_once_an_update_under_accumulation(log):
    state, step = _step(accum_steps=2)
    gacc, acc = tstep.init_grad_accum(state.params), tstep.init_metrics_acc()
    with _profiler():
        for k in range(4):
            state, gacc, acc = step(state, gacc, acc, _batch(k))
    names = _names(log.spans())
    assert names.count("step.forward") == names.count("step.backward") == 4
    assert names.count("step.optimizer") == 2
    assert names[:3] == ["step.forward", "step.backward", "step.forward"]


def test_spans_nest_on_their_thread(log):
    with _profiler():
        with telemetry.span("train.interval"):
            with telemetry.span("checkpoint.save"):
                pass
    inner, outer = log.spans()  # logged as they close
    assert (inner.name, outer.name) == ("checkpoint.save", "train.interval")
    assert inner.parent == outer.id and outer.parent is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_loader_pass_logs_its_stages_with_batch_numbers(log):
    loader = pipeline.PrefetchLoader(lambda: iter(_samples(8)), 2, torch.device("cpu"))
    with _profiler():
        taken = 0
        for _pair in loader:
            taken += 1
            time.sleep(0.01)  # the producer gets ahead and waits on its puts
    assert taken == 4
    spans = log.spans()
    by_name = {n: [s for s in spans if s.name == n] for n in
               ("loader.wait", "loader.produce", "loader.build", "loader.h2d", "loader.put")}
    me = threading.get_native_id()
    # the last wait is for the end of the pass
    assert [s.batch for s in by_name["loader.wait"]] == [0, 1, 2, 3, None]
    assert all(s.thread == me for s in by_name["loader.wait"])
    produce = {s.batch: s for s in by_name["loader.produce"]}
    assert sorted(produce) == [0, 1, 2, 3]
    for name in ("loader.build", "loader.h2d"):
        assert sorted(s.batch for s in by_name[name]) == [0, 1, 2, 3]
        for s in by_name[name]:
            outer = produce[s.batch]
            assert s.parent == outer.id and s.thread == outer.thread != me
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    # each put follows its batch's produce, and the next batch's produce
    # starts where it ends; a put is logged with the next batch, so the
    # last one is not
    assert [s.batch for s in by_name["loader.put"]] == [0, 1, 2]
    for s in by_name["loader.put"]:
        assert s.parent is None and s.start_ns == produce[s.batch].end_ns
        assert s.end_ns == produce[s.batch + 1].start_ns
    # a batch is taken after it was produced
    for w in by_name["loader.wait"][:-1]:
        assert w.end_ns >= produce[w.batch].end_ns


def test_span_and_record_function_agree_on_the_clock(log):
    with _profiler() as prof:
        with telemetry.span("probe"):
            time.sleep(0.02)
    (ours,) = log.spans()
    (theirs,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == telemetry.PREFIX + "probe"]
    assert abs(ours.start_ns - theirs.start_ns()) < 2e6
    assert abs(ours.end_ns - (theirs.start_ns() + theirs.duration_ns())) < 2e6


def test_bounded_log_drops_the_oldest_and_counts_them():
    log = telemetry.SpanLog(capacity=3)
    for k in range(5):
        log.add(f"s{k}", 1, 10 * k, 10 * k + 5)
    assert _names(log.spans()) == ["s2", "s3", "s4"]
    assert log.dropped == 2 and log.dropped_until_ns == 15


def test_stalls_are_the_wait_span_over_2_ms(log):
    taken = threading.Semaphore(0)

    def gated():
        for i, s in enumerate(_samples(8)):
            if i and i % 2 == 0:
                # the next batch is read only once the last one was taken
                assert taken.acquire(timeout=30)
                time.sleep(0.05)
            yield s

    loader = pipeline.PrefetchLoader(gated, 2, torch.device("cpu"))
    for _pair in loader:
        taken.release()
    # batches 1-3 each wait for a 50-ms read; the first batch is no stall
    assert loader.stall_count == 3
    assert loader.stall_seconds > 3 * 0.002
