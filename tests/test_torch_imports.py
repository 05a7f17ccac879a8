"""The port imports nothing of JAX and nothing of the JAX package, nor
the repo's ``tools/`` drills (the port keeps its own in
``speecht_tpu_torch/tools``).

Checked twice: an AST scan of every source of ``speecht_tpu_torch`` and of
``chip_smoke.py``, and a fresh interpreter that imports every module of
the package and then looks at ``sys.modules``. The port's host C++
(``speecht_tpu_torch/native``) includes only its own files and the
standard library's headers.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "speecht_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "speecht_tpu", "tools")


def _sources():
    found = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PACKAGE):
        found += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(found)


def _modules():
    mods = []
    for path in _sources():
        if path.startswith(PACKAGE) and not path.endswith("__main__.py"):
            rel = os.path.relpath(path, ROOT)[: -len(".py")]
            mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_source_imports_no_jax(path):
    bad = set(_imported_roots(path)) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_package_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_of_the_train_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.training",
        "speecht_tpu_torch.train.state",
        "speecht_tpu_torch.train.step",
        "speecht_tpu_torch.train.checkpoint",
        "speecht_tpu_torch.train.summaries",
        "speecht_tpu_torch.ops.ctc_cuda",
    ):
        assert m in mods


def test_every_module_of_the_conv0_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.ops.conv0",
        "speecht_tpu_torch.ops.conv0_cuda",
        "speecht_tpu_torch.ops.augment",
        "speecht_tpu_torch.ops.cuda_build",
        "speecht_tpu_torch.models.wav2letter",
    ):
        assert m in mods


def test_every_module_of_the_beam_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.native",
        "speecht_tpu_torch.ops.beam",
        "speecht_tpu_torch.ops.decode",
        "speecht_tpu_torch.parameter_search",
        "speecht_tpu_torch.evaluation",
    ):
        assert m in mods


def test_every_module_of_the_device_beam_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.ops.beam_device",
        "speecht_tpu_torch.ops.beam_device_cuda",
        "speecht_tpu_torch.ops.beam",
        "speecht_tpu_torch.native",
        "speecht_tpu_torch.parameter_search",
        "speecht_tpu_torch.cli",
    ):
        assert m in mods


def test_every_module_of_the_audio_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.native",
        "speecht_tpu_torch.data.features",
        "speecht_tpu_torch.data.features_device",
        "speecht_tpu_torch.data.pipeline",
        "speecht_tpu_torch.data.reader",
        "speecht_tpu_torch.ops.resample",
        "speecht_tpu_torch.ops.beam",
        "speecht_tpu_torch.corpus",
        "speecht_tpu_torch.preprocessing",
        "speecht_tpu_torch.evaluation",
        "speecht_tpu_torch.train.step",
        "speecht_tpu_torch.cli",
    ):
        assert m in mods


def test_every_module_of_the_serving_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.serving",
        "speecht_tpu_torch.exporting",
        "speecht_tpu_torch.recording",
        "speecht_tpu_torch.record_utils",
        "speecht_tpu_torch.ops.streaming",
        "speecht_tpu_torch.ops.resample",
        "speecht_tpu_torch.ops.beam_device_cuda",
        "speecht_tpu_torch.data.pipeline",
        "speecht_tpu_torch.train.step",
        "speecht_tpu_torch.native",
        "speecht_tpu_torch.cli",
    ):
        assert m in mods


def test_every_module_of_the_parallel_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.compat",
        "speecht_tpu_torch.parallel",
        "speecht_tpu_torch.parallel.comm",
        "speecht_tpu_torch.parallel.mesh",
        "speecht_tpu_torch.parallel.seq_parallel",
        "speecht_tpu_torch.weights",
        "speecht_tpu_torch.models.wav2letter",
        "speecht_tpu_torch.data.reader",
        "speecht_tpu_torch.data.pipeline",
        "speecht_tpu_torch.execution",
        "speecht_tpu_torch.training",
        "speecht_tpu_torch.evaluation",
        "speecht_tpu_torch.train.step",
        "speecht_tpu_torch.train.checkpoint",
        "speecht_tpu_torch.train.metrics_writer",
        "speecht_tpu_torch.parameter_search",
        "speecht_tpu_torch.ops.cuda_build",
        "speecht_tpu_torch.cli",
    ):
        assert m in mods


def test_the_port_does_not_import_tensorflow():
    """The card's machine has no tensorflow: the TF checkpoint reader is
    the port's own (``compat.py``)."""
    for path in _sources():
        assert "tensorflow" not in set(_imported_roots(path)), path


def _native_sources():
    native = os.path.join(PACKAGE, "native")
    return sorted(
        os.path.join(native, f)
        for f in os.listdir(native)
        if f.endswith((".cpp", ".h"))
    )


def test_native_sources_are_the_ones_built():
    """Every C++ file of ``native/`` is compiled into the library, the
    audio and cache readers among them."""
    from speecht_tpu_torch import native

    built = {os.path.join(native.NATIVE_DIR, s) for s in native.SOURCES}
    cpp = {p for p in _native_sources() if p.endswith(".cpp")}
    assert built == cpp
    for name in ("speecht_native.cpp", "npz_reader.cpp"):
        assert os.path.join(native.NATIVE_DIR, name) in built


@pytest.mark.parametrize(
    "path", _native_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_native_source_includes_nothing_outside_its_directory(path):
    """A quoted include names a file of the same directory; an angle
    include names a standard header (no path): no ``<zlib.h>``, so the
    library builds with the compiler alone."""
    here = os.listdir(os.path.dirname(path))
    with open(path) as f:
        includes = re.findall(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', f.read(), re.M)
    assert includes
    for kind, name in includes:
        if kind == '"':
            assert name in here, f"{path} includes {name}"
        else:
            assert "/" not in name and "." not in name, f"{path} includes <{name}>"


def test_every_module_of_the_drills_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.tools",
        "speecht_tpu_torch.tools.synthetic_corpus",
        "speecht_tpu_torch.tools.synthetic_convergence",
        "speecht_tpu_torch.tools.train_features_check",
    ):
        assert m in mods


def test_every_module_of_the_sanitizer_and_hard_corpus_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.tools.native_sanitize_check",
        "speecht_tpu_torch.tools.hard_corpus",
        "speecht_tpu_torch.tools.hard_search_drill",
        "speecht_tpu_torch.native",
        "speecht_tpu_torch.compat",
    ):
        assert m in mods


def test_every_module_of_the_multiprocess_and_large_lm_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.tools.multiprocess_drill",
        "speecht_tpu_torch.tools.large_lm_probe",
        "speecht_tpu_torch.data.pipeline",
        "speecht_tpu_torch.ops.beam_device",
    ):
        assert m in mods


def test_every_module_of_the_scale_soak_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.tools.librispeech_scale_soak",
        "speecht_tpu_torch.tools.soak_report",
        "speecht_tpu_torch.tools.hard_corpus",
        "speecht_tpu_torch.train.checkpoint",
    ):
        assert m in mods


def test_every_module_of_the_measurement_tools_slice_is_checked():
    mods = set(_modules())
    for m in (
        "speecht_tpu_torch.tools.arpa_to_kenlm_binary",
        "speecht_tpu_torch.tools.layer_breakdown",
        "speecht_tpu_torch.tools.perf_probe",
        "speecht_tpu_torch.tools.device_beam_probe",
        "speecht_tpu_torch.tools.pipeline_soak",
        "speecht_tpu_torch.execution",
    ):
        assert m in mods


def test_the_package_does_not_import_chip_smoke():
    """``chip_smoke.py`` drives the package; the package (its drills
    among it) never imports the script."""
    for path in _sources():
        if path.startswith(PACKAGE):
            assert "chip_smoke" not in set(_imported_roots(path)), path
