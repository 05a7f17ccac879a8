"""The port imports nothing of JAX and nothing of the JAX package.

Checked twice: an AST scan of every source of ``speecht_tpu_torch`` and of
``chip_smoke.py``, and a fresh interpreter that imports every module of
the package and then looks at ``sys.modules``.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "speecht_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "speecht_tpu")


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
