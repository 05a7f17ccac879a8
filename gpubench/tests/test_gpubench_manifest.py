"""BENCHMARK.json against the contract's shape, and every file it names."""

from __future__ import annotations

import json
import os

import pytest

from gpubench import check, manifest

ROOT = manifest.root_dir()
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "-m", "gpubench.run"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _entries():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            yield kind, entry


@pytest.mark.parametrize("kind,entry", list(_entries()), ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_and_units(kind, entry):
    assert manifest.NAME.match(entry["name"])
    if "unit" in entry:
        assert manifest.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_cell_has_its_files_and_metrics():
    bench = manifest.Manifest.load()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    used = set()
    for cell in BENCH["workloads"]:
        used.add(cell["config"])
        assert cell["chips"] in (1, 4)
        manifest.architecture(bench.config(cell), cell["config"])
        traffic = bench.traffic(cell)
        manifest.kind(traffic["kind"])
        assert check.load_limits(cell["name"])
        reported = [m["name"] for m in bench.metrics(cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        layered = bench.metrics(cell, "per_layer")
        assert layered
        for m in bench.metrics(cell, "end_to_end") + layered:
            assert callable(bench.reader(m["name"]))
        for m in layered:
            assert m["moves"] in reported
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("gpubench/configs/") and c["reduced"] == []


def test_per_layer_layers_and_sources():
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        layers.setdefault(m["layer"], []).append(m["name"])
    assert any("roofline" in n for names in layers.values() for n in names)
    assert any("mfu" in n for names in layers.values() for n in names)
