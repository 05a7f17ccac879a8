"""The control and the faults against each cell's limits.

On the card (marked ``cuda``): each cell at its own size, on three seeds;
the program passes the cell's limits, and the float8 control and half a
batch left out each fail one of them. On the CPU: the same readings at the tiny
width, where half a batch fails the tiny limits.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import pytest
import torch

from gpubench import calibrate, check, manifest
from gpubench.kinds import train

from conftest import TINY_CONFIG, TINY_LIMITS, TINY_TRAFFIC


def spec_for(config, traffic, seed, device, work_dir):
    return train.Spec(workload="test", seed=seed, seconds=0.0, trace=False, config=config,
                      traffic=traffic, limits={}, device=device, work_dir=work_dir,
                      t_start=time.perf_counter())


def readings(config, traffic, seed, device):
    work_dir = tempfile.mkdtemp(prefix="gpubench-test-")
    try:
        return calibrate.readings(spec_for(config, traffic, seed, device, work_dir))
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def fails(values, limits):
    return not check.verdict(values, limits)[0]


def test_checked_rows_all_differ():
    """A corpus with fewer utterances a bucket than a batch repeats rows in
    the checked steps, which the run refuses."""
    traffic = dict(TINY_TRAFFIC, utterances=6)
    with pytest.raises(ValueError, match="repeat an utterance"):
        readings(TINY_CONFIG, traffic, 41, torch.device("cpu"))


def test_half_batch_fails_the_tiny_limits():
    row = readings(TINY_CONFIG, TINY_TRAFFIC, 41, torch.device("cpu"))
    assert not fails(row["program"], TINY_LIMITS), row
    assert fails(row["half_batch"], TINY_LIMITS), row
    assert set(row["control"]) == set(check.NUMBERS)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train_mfcc39_libri"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_and_half_batch_fail_on_the_card(card, workload, seed):
    bench = manifest.Manifest.load()
    cell = bench.workload(workload)
    limits = check.load_limits(workload)
    row = readings(bench.config(cell), bench.traffic(cell), seed, card)
    assert not fails(row["program"], limits), row
    assert fails(row["control"], limits), row
    assert fails(row["half_batch"], limits), row
