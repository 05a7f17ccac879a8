"""The port's host C++ under ASan and UBSan, and its CRC32C.

``native.crc32c`` (the TF checkpoint reader's check of each tensor) against
the pure-Python CRC32C of the event writer on the standard check value and
on random lengths, then ``speecht_tpu_torch.tools.native_sanitize_check``
end to end in a process of its own: the sanitizer build of
``native.SOURCES``, every ``stt_`` entry point and the three fuzz passes,
on FLACs written by ``chip_smoke.write_flac`` in every layout the decoder
reads (``chip_smoke.sanitizer_flacs``: FIXED orders 0-4, verbatim, each
stereo mode, a block size that does not divide the length), as phase 6b
of ``chip_smoke.py`` runs it on the card's machine. It skips only where g++ has no ASan runtime.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from speecht_tpu_torch import native
from speecht_tpu_torch.tools import native_sanitize_check
from speecht_tpu_torch.train.metrics_writer import crc32c as python_crc32c

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_crc32c_check_value_and_random_lengths():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0
    rng = np.random.RandomState(0)
    for n in list(range(20)) + list(rng.randint(20, 5000, size=20)):
        buf = rng.randint(0, 256, size=n).astype(np.uint8).tobytes()
        assert native.crc32c(buf) == python_crc32c(buf), n
        assert native.crc32c(bytearray(buf)) == native.crc32c(memoryview(buf)), n


def test_sanitizer_drill_passes(tmp_path):
    try:
        native_sanitize_check.asan_runtime()
    except (RuntimeError, OSError) as e:
        pytest.skip(f"g++ has no ASan runtime here: {e}")
    flacs = chip_smoke.sanitizer_flacs(str(tmp_path))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "speecht_tpu_torch.tools.native_sanitize_check",
         "--flac", *flacs],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-3000:]
    assert out.splitlines()[-1] == native_sanitize_check.PASSED
    for name in ("kenlm.binary", "flac", "npz"):
        assert f"fuzz {name}: 40 mutated or truncated files" in out, name
    for mode in ("independent", "left_side", "right_side", "mid_side"):
        assert f"flac stereo_{mode}.flac: 5000 samples at 22050 Hz" in out, mode
    assert "crc32c ok: lengths 0-17 and 1 MB" in out
    # the temporary build directory is gone; the cached -O3 library is not touched
    assert not [n for n in os.listdir(tmp_path) if n.startswith("stt_asan_")]
    build_dir = os.path.dirname(native.library_path())
    assert not [n for n in (os.listdir(build_dir) if os.path.isdir(build_dir) else [])
                if "asan" in n]
