"""The corpus-scale soak and its report, on the CPU.

``speecht_tpu_torch/tools/librispeech_scale_soak.py`` against
``tools/librispeech_scale_soak.py``: the corpus (plain and ``--hard``, the
port's spectrogram pool among them) is the same file for file and bit for
bit, with the same statistics; the bucket histogram and the stats parser
agree; the JAX tool's regexes read the port's own ``train`` and
``evaluate`` output as the port's parsers do. Then the whole soak at
narrow width on ``--device cpu`` (3 segments of 2 steps, a checkpoint a
step, each CLI process run through ``multiprocess_drill``'s ``rank``
entry, which writes its kernel launches at exit), and a second run with
``--skip-gen`` that resumes at the checkpoint's step. The dev and test
splits are cut from 256 to 2 rows each (the tool's ``N_DEV``/``N_TEST``).
``speecht_tpu_torch/tools/soak_report.py`` prints what
``tools/soak_report.py`` prints on the committed record and on a copy cut
in the middle of a line.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from speecht_tpu_torch.tools import hard_corpus
from speecht_tpu_torch.tools import librispeech_scale_soak as soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "docs", "records", "soak_log.jsonl")
WIDTHS = ["--base-channels", "16", "--wide-channels", "32", "--num-body-layers", "2"]
SEGMENTS, SEGMENT_STEPS = 3, 2


@pytest.fixture(scope="module")
def jax_soak(tmp_path_factory):
    """``tools/librispeech_scale_soak.py``, loaded by path. It enables JAX's
    compilation cache when imported: pointed at a temporary directory, the
    settings put back afterwards."""
    import jax

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    env = os.environ.get("SPEECHT_COMPILATION_CACHE")
    os.environ["SPEECHT_COMPILATION_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_librispeech_scale_soak", os.path.join(ROOT, "tools", "librispeech_scale_soak.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        yield module
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        if env is None:
            os.environ.pop("SPEECHT_COMPILATION_CACHE", None)
        else:
            os.environ["SPEECHT_COMPILATION_CACHE"] = env


def _files(root):
    out = {}
    base = os.path.join(root, "data", "preprocessed-power")
    for split in sorted(os.listdir(base)):
        for name in sorted(os.listdir(os.path.join(base, split))):
            with np.load(os.path.join(base, split, name)) as z:
                out[f"{split}/{name}"] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("hard, workers", [(False, 0), (True, 0), (True, 2)],
                         ids=["plain", "hard", "hard-pool"])
def test_corpus_matches_jax(tmp_path, jax_soak, hard, workers):
    hp = hard_corpus.HardParams() if hard else None
    jax_hp = importlib.import_module("hard_corpus").HardParams() if hard else None
    with contextlib.redirect_stdout(io.StringIO()):
        theirs = jax_soak.make_corpus(str(tmp_path / "jax"), 6, 2, 2, hard_params=jax_hp)
    threads = os.environ.get("OPENBLAS_NUM_THREADS")
    ours = soak.make_corpus(str(tmp_path / "port"), 6, 2, 2, hard_params=hp, workers=workers)
    assert os.environ.get("OPENBLAS_NUM_THREADS") == threads  # the pool's setting put back
    assert ours == theirs
    assert ("hard" in ours) == hard
    files, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(files) == list(want)
    assert list(files)[0] == "dev/synth-1000000.npz" and "test/synth-2000001.npz" in files
    assert "train/synth-000005.npz" in files and len(files) == 10
    for name, arrays in files.items():
        assert sorted(arrays) == ["audio_fragments", "transcript"]
        for key, value in arrays.items():
            other = want[name][key]
            assert value.dtype == other.dtype and value.shape == other.shape, name
            assert value.tobytes() == other.tobytes(), f"{name}: {key} differs"

    for step in (256, 96):
        assert soak.bucket_occupancy(str(tmp_path / "port"), step) == \
            jax_soak.bucket_occupancy(str(tmp_path / "jax"), step)
    assert soak.dir_size_mb(str(tmp_path / "port")) == jax_soak.dir_size_mb(str(tmp_path / "jax"))


def test_corpus_workers():
    assert soak.corpus_workers(10) == 0
    assert 0 <= soak.corpus_workers(20512) <= soak.MAX_WORKERS


@pytest.mark.parametrize("out", [
    "LED: 3 LER: 0.25 WED: 1 WER: 0.50\nGlobal statistics\nLED: 12 LER: 0.12 WED: 4 WER: 0.40\n",
    "Global statistics\nLED: 12 LER: 0.12 WED: 4 WER: 0.40\nprecise: LER 0.1234 WER 0.4000\n",
    "no statistics here\n",
], ids=["summary", "precise", "none"])
def test_parse_global_stats_matches_jax(jax_soak, out):
    try:
        want = jax_soak.parse_global_stats(out)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match=str(e)):
            soak.parse_global_stats(out)
    else:
        assert soak.parse_global_stats(out) == want


@pytest.fixture(scope="module")
def soak_run(tmp_path_factory):
    """The soak at narrow width on the CPU, then a second run with
    ``--skip-gen`` and one segment; returns (root, the reports' directory,
    the two finals, the two outputs). On two torch threads a process: the
    suite's workers share the machine's cores."""
    root = str(tmp_path_factory.mktemp("soak"))
    reports = os.path.join(root, "reports")
    os.makedirs(reports)
    common = ["--hard", "--n-train", "6", "--segment-steps", str(SEGMENT_STEPS),
              "--steps-per-checkpoint", "1", "--device", "cpu", "--out", root, *WIDTHS]
    launcher = f"speecht_tpu_torch.tools.multiprocess_drill rank {reports}/{{name}}.json"
    outs, finals = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(soak, "N_DEV", 2)
        mp.setattr(soak, "N_TEST", 2)
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.setenv("SPEECHT_DEVICE_LM_CACHE", os.path.join(root, "device_lm"))
        for extra in (["--max-segments", str(SEGMENTS), "--launcher", launcher],
                      ["--max-segments", "1", "--skip-gen"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                finals.append(soak.main(common + extra))
            outs.append(buf.getvalue())
    return root, reports, finals, outs


def _records(root):
    with open(os.path.join(root, "soak_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_soak_end_to_end_on_cpu(soak_run):
    root, reports, finals, outs = soak_run
    first = finals[0]
    assert sorted(first) == ["steps", "test_beam_lm_ler", "test_beam_lm_wer", "test_ler",
                             "test_wer"]
    assert first["steps"] == SEGMENTS * SEGMENT_STEPS
    assert f"\nSOAK DONE: {json.dumps(first)}" in outs[0]
    with open(os.path.join(root, "soak_summary.json")) as f:
        assert json.load(f) == finals[1]

    records = _records(root)
    kinds = [r["kind"] for r in records]
    assert kinds[:2] == ["corpus", "buckets"]
    assert kinds.count("train_segment") == SEGMENTS + 1
    beams = [r for r in records if r["kind"] == "dev_beam_lm"]
    assert [(b["segment"], b["step"]) for b in beams] == [(3, 6)]
    segments = [r for r in records if r["kind"] == "train_segment"][:SEGMENTS]
    for k, seg in enumerate(segments, start=1):
        assert seg["target_step"] == k * SEGMENT_STEPS
        # each segment a process that resumed where the one before stopped
        assert [i["step"] for i in seg["intervals"]] == [
            (k - 1) * SEGMENT_STEPS + s for s in range(1, SEGMENT_STEPS + 1)]
        assert all(np.isfinite(i["loss"]) for i in seg["intervals"])
        assert all(i["lr"] == pytest.approx(3e-4) for i in seg["intervals"])
    # one checkpoint a step, the newest 5 kept
    names = sorted(os.listdir(os.path.join(root, "train", "soak")))
    assert names == [f"ckpt-{s}.pt" for s in (4, 5, 6, 7, 8)]

    # each CLI process ran through the launcher and reported at exit (on
    # the CPU no kernel launches, and no card memory); the segment-3
    # --device-beam evaluate ran the plain search
    with open(os.path.join(reports, "seg3-dev-beam.json")) as f:
        assert json.load(f) == {"launches": {"ctc_alpha": 0, "ctc_beta": 0, "conv0": 0,
                                             "beam_device": 0}, "peak_mb": None}
    assert sorted(os.listdir(reports)) == sorted(
        [f"seg{k}-{what}.json" for k in range(1, SEGMENTS + 1) for what in ("train", "dev")]
        + ["seg3-dev-beam.json", "final-test.json", "final-test-beam.json"])


def test_soak_log_has_the_records_kinds_and_keys(soak_run):
    def shape(records):
        found = {}
        for r in records:
            found.setdefault(r["kind"], set()).update(r)
        return found

    with open(RECORD) as f:
        want = shape(json.loads(line) for line in f)
    assert shape(_records(soak_run[0])) == want


def test_skip_gen_resumes_at_the_checkpoint(soak_run):
    root, _reports, finals, outs = soak_run
    assert "Generating" not in outs[1]
    assert "resuming at step 6" in outs[1]
    resumed = [r for r in _records(root) if r["kind"] == "train_segment"][-1]
    assert resumed["segment"] == 1 and resumed["target_step"] == 8
    assert [i["step"] for i in resumed["intervals"]] == [7, 8]
    assert finals[1]["steps"] == 8


def test_jax_regexes_read_the_port_output(soak_run, jax_soak):
    root, _reports, _finals, outs = soak_run
    out = outs[0]
    ours = [m.groups() for m in soak._STEP_RE.finditer(out)]
    assert len(ours) == SEGMENTS * SEGMENT_STEPS
    assert [m.groups() for m in jax_soak._STEP_RE.finditer(out)] == ours
    assert [m.groups() for m in jax_soak._STALL_RE.finditer(out)] == \
        [m.groups() for m in soak._STALL_RE.finditer(out)]
    logged = [r for r in _records(root) if r["kind"] == "train_segment"][:SEGMENTS]
    assert [(str(i["step"]), i["loss"]) for s in logged for i in s["intervals"]] == \
        [(g[0], float(g[3])) for g in ours]

    # each evaluate's output: the text before the line that reports it
    chunks = re.split(r"^(dev greedy|dev device-beam\+LM): (.*)$", out, flags=re.M)
    evaluates = list(zip(chunks[:-1:3], chunks[2::3]))
    assert len(evaluates) == SEGMENTS + 1
    for text, line in evaluates:
        text = text.split("===")[-1]
        assert jax_soak._GLOBAL_STATS_RE.findall(text) == soak._GLOBAL_STATS_RE.findall(text)
        assert jax_soak._PRECISE_STATS_RE.findall(text)
        ler, wer = jax_soak.parse_global_stats(text)
        assert (ler, wer) == soak.parse_global_stats(text)
        reported = json.loads(line)
        assert (round(ler, 4), round(wer, 4)) == (reported["ler"], reported["wer"])


def _report(module_args, path):
    return subprocess.run([sys.executable, *module_args, "--out", path], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, check=True).stdout


@pytest.mark.parametrize("cut", [False, True], ids=["record", "cut-mid-line"])
def test_soak_report_matches_jax(tmp_path, cut):
    path = RECORD
    if cut:
        with open(RECORD) as f:
            text = f.read()
        path = str(tmp_path / "soak_log.jsonl")
        with open(path, "w") as f:
            f.write(text[: text.index('"kind": "dev_beam_lm"', len(text) // 2) + 5])
    ours = _report(["-m", "speecht_tpu_torch.tools.soak_report"], path)
    assert ours == _report([os.path.join("tools", "soak_report.py")], path)
    assert ("skipping unparseable line" in ours) == cut
    assert "| 10 | 10000 |" in ours or cut


def test_soak_report_renders_the_port_log(soak_run):
    out = _report(["-m", "speecht_tpu_torch.tools.soak_report"], soak_run[0])
    assert "corpus: 6 train utts" in out and "| 4 | 8 |" in out
    assert "dev device-beam+LM LER/WER by step:\n  6: " in out
    assert out.count("final held-out test @ step") == 2
