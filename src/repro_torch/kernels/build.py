"""Build the CUDA sources of :mod:`repro_torch.kernels` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, loaded with :mod:`ctypes`. Libraries go to ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A failed build raises with nvcc's output in the message.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# sm_90a: Hopper. No --use_fast_math: log2f and IEEE division keep the
# kernels within the reference's tolerances. -fmad=false keeps each multiply
# and add rounded on its own, as the plain PyTorch version rounds them.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "cached"}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): the "
        "CUDA kernels of repro_torch are built from source at first use")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; ``None`` when its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, cmd, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "", "cached": True})
        return
    proc, tmp, out, cmd, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                       "cached": False}


def build_all() -> dict[str, dict]:
    """Build every CUDA source, one nvcc each, all started together."""
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        _finish(name, job)
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
