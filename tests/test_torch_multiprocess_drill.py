"""The port's multi-process drill (``speecht_tpu_torch/tools/multiprocess_drill.py``)
on the CPU, against the JAX tool (``tools/multiprocess_drill.py``, loaded
by path: it imports only numpy and the standard library at the top):

- the port's two corpora are the JAX tool's, array for array;
- the drill with ``--device cpu`` (JAX's narrow model, gloo ranks of two
  torch threads each) exits 0 and prints every ``PASS`` line that
  ``tests/test_multiprocess.py`` asserts for JAX's drill. JAX's 2x2 mesh
  over 2 processes is here 4 ranks on a 2x2 grid, and its line says so.
"""

import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np

from speecht_tpu_torch.tools import multiprocess_drill as drill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_multiprocess.py's lines, the grid's in the port's words
PASS_LINES = (
    "PASS dp 2-process steps 1-3",
    "PASS dp 2-process steps 4-6",
    "PASS dpxtp 4-rank 2x2 grid steps 1-3",
    "PASS mixed-bucket dp 2-process steps 1-3",
    "PASS grad-accum dp 2-process applies 1-3",
    "PASS kill/resume steps",
    "PASS eval 2-process global stats",
    "PASS multiprocess drill",
)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_multiprocess_drill", os.path.join(REPO, "tools", "multiprocess_drill.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    found = {}
    for path in sorted(glob.glob(os.path.join(root, "data", "**", "*.npz"), recursive=True)):
        with np.load(path) as z:
            found[os.path.relpath(path, root)] = {k: z[k] for k in z.files}
    return found


def test_corpora_equal_the_jax_tool(tmp_path):
    jax_tool = _jax_tool()
    for make in ("make_corpus", "make_mixed_corpus"):
        getattr(jax_tool, make)(str(tmp_path / "jax" / make))
        getattr(drill, make)(str(tmp_path / "port" / make))
        want = _files(str(tmp_path / "jax" / make))
        got = _files(str(tmp_path / "port" / make))
        assert len(want) == (2 if make == "make_mixed_corpus" else 1) * drill.N_FILES
        assert sorted(got) == sorted(want)
        for name, arrays in want.items():
            assert sorted(got[name]) == sorted(arrays)
            for key, value in arrays.items():
                assert got[name][key].dtype == value.dtype
                np.testing.assert_array_equal(got[name][key], value)


def test_drill_passes_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "speecht_tpu_torch.tools.multiprocess_drill",
         "--device", "cpu", "--root", str(tmp_path / "drill")],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    out = proc.stdout
    assert proc.returncode == 0, out[-4000:] + proc.stderr[-4000:]
    for line in PASS_LINES:
        assert line in out, (line, out[-4000:])
    # the relaunch restored a checkpoint the ranks wrote before the SIGTERM
    killed = [log for log in glob.glob(str(tmp_path / "drill" / "killmp*.r1.log"))
              if "resume" not in log]
    assert killed
    with open(sorted(killed)[-1]) as f:
        log = f.read()
    assert drill.SOLO_SAVE_SKIPPED in log and "Done training" in log
