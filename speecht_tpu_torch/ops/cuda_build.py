"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers) into ``_build/lib<name>-<digest>.so`` inside
the package, where ``<digest>`` hashes the source, the shared headers
``csrc/*.cuh``, the flags and any ``-D`` defines, so an edited source
rebuilds and a built one is reused; a library built with defines (a
variant of the same source, such as the beam kernel's split build) sits
beside the plain one under its own digest. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them. Processes
that share the build directory (the ranks of a multi-process run) may
build the same library at once: each writes its own ``.so`` and compiler
log under a name with its pid and publishes both with ``os.replace``.
Nothing is built when a module is imported: the wrappers call
:func:`load` at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then the usual toolkit, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "speecht_tpu_torch are built from source at first use"
        )
    return found


def library_path(name: str, defines: tuple = ()) -> str:
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def log_path(name: str, defines: tuple = ()) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory, spills)."""
    return library_path(name, defines)[: -len(".so")] + ".log"


def build(names: list) -> dict:
    """Compile every library in ``names`` that is not built yet, in parallel.

    An entry is a source's name, or (name, defines) for a variant built
    with ``-D`` of each define. Returns {entry: path of the .so}. Raises
    RuntimeError with the compiler output when a build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    specs = {entry: (entry, ()) if isinstance(entry, str) else entry for entry in names}
    paths = {entry: library_path(*spec) for entry, spec in specs.items()}
    running = {}
    for entry, path in paths.items():
        if os.path.exists(path):
            continue
        name, defines = specs[entry]
        tmp = f"{path}.{os.getpid()}.tmp"
        tmp_log = f"{log_path(name, defines)}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        log = open(tmp_log, "w")
        running[entry] = (
            subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
            log,
            tmp,
            tmp_log,
        )
    failed = []
    for entry, (proc, log, tmp, tmp_log) in running.items():
        proc.wait()
        log.close()
        if proc.returncode == 0:
            os.replace(tmp_log, log_path(*specs[entry]))
            os.replace(tmp, paths[entry])
        else:
            with open(tmp_log) as f:
                failed.append(f"{' -D'.join([specs[entry][0] + '.cu', *specs[entry][1]])}:"
                              f"\n{f.read()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (with ``defines``) if needed and load it."""
    entry = (name, tuple(defines)) if defines else name
    return ctypes.CDLL(build([entry])[entry])


def device_index(device) -> int:
    """The CUDA ordinal of ``device`` (the current one for plain ``cuda``)."""
    import torch

    return device.index if device.index is not None else torch.cuda.current_device()


class KernelLibrary:
    """A kernel library, built at first use, and its launch count.

    ``launches`` goes up by one where the wrapper launches its kernel and
    nowhere else, so a run can show that its path went through the kernel.
    Each library exports ``<name>_error_string`` for its launch codes.
    """

    name = ""
    # -D defines of a variant build of the same source
    defines: tuple = ()
    # (function, argtypes, restype) of the library's C interface
    signatures: tuple = ()

    def __init__(self):
        self.launches = 0
        self._lib: ctypes.CDLL | None = None

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name, self.defines)
            for fn, argtypes, restype in self.signatures:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib

    def _raise_on(self, code: int) -> None:
        if code != 0:
            error_string = getattr(self.lib, f"{self.name}_error_string")
            raise RuntimeError(
                f"{self.name} launch failed: {error_string(code).decode()}"
            )
