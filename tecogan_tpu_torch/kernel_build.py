"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/kernels/`` beside the package, named by a hash
of the sources and flags, so a checkout builds it at first use and reuses
it until a source changes. A missing ``nvcc`` or a failed build raises:
nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BuildError", "build", "load_library", "library_path"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtecogan_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise BuildError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                     "CUDA kernels cannot be built")


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the current library exists.

    Returns (library path, seconds spent compiling — 0.0 when it was
    already built, nvcc's diagnostics including ``-Xptxas -v``'s register
    report).
    """
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    nvcc = _nvcc()
    path.parent.mkdir(parents=True, exist_ok=True)
    # compile to a unique name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                             f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library (once per process)."""
    path, _, _ = build()
    return ctypes.CDLL(str(path))
