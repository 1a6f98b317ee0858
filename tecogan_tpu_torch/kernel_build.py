"""Build and load the port's native code: the CUDA kernels and the host
loader's C++ clip assembler.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/`` beside the package, named by a hash of
the sources, the headers and the flags, so a checkout builds it at first
use and reuses it until a source changes. A missing ``nvcc`` or a failed
build raises: nothing falls back to the plain PyTorch versions.

The clip assembler (``native/tecoloader.cpp``, the JAX package's source,
read and never written) is compiled by ``g++`` into ``build/native/``,
named by the same kind of hash. Without a C++ compiler the loader takes its
numpy path; a compiler that refuses the source raises.
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

__all__ = ["BuildError", "build", "load_library", "library_path",
           "native_loader_path", "build_native_loader"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "tecoloader.cpp"
NATIVE_BUILD_DIR = BUILD_DIR.parent / "native"
NATIVE_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """A compiler is missing or refused the sources."""


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest(flags, files) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs = sorted([*_sources(), *CSRC_DIR.glob("*.cuh")])
    return BUILD_DIR / f"libtecogan_kernels_{_digest(NVCC_FLAGS, srcs)}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise BuildError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                     "CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]], logdir: str) -> str:
    """Run the commands concurrently; raise BuildError if any fails.
    Returns their output, in command order."""
    procs = []
    for k, cmd in enumerate(cmds):
        log = open(os.path.join(logdir, f"cmd{k}.log"), "w+")
        procs.append((cmd, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
    out, failed = [], []
    for cmd, log, proc in procs:
        with log:
            rc = proc.wait()
            log.seek(0)
            text = log.read()
        out.append(text)
        if rc != 0:
            failed.append(f"{os.path.basename(cmd[0])} failed ({rc}):\n"
                          f"{' '.join(cmd)}\n{text}")
    if failed:
        raise BuildError("\n".join(failed))
    return "".join(out)


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
    t0 = time.perf_counter()
    # compile into a private directory, then rename the library into
    # place: concurrent builders never load a half-written library
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(_sources(), objs)], tmp)
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc, "-shared", "-o", lib, *objs]], tmp)
        os.replace(lib, path)
    return path, time.perf_counter() - t0, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library (once per process)."""
    path, _, _ = build()
    return ctypes.CDLL(str(path))


def native_loader_path(build_dir=None) -> Path:
    """Where the clip assembler built from the current source lives."""
    return (Path(build_dir or NATIVE_BUILD_DIR)
            / f"libtecoloader_{_digest(NATIVE_FLAGS, [NATIVE_SRC])}.so")


def build_native_loader(build_dir=None) -> Path | None:
    """Compile ``native/tecoloader.cpp`` with g++ unless its library for
    the current source exists. Returns its path, or None when there is no
    g++; raises BuildError when g++ refuses the source."""
    path = native_loader_path(build_dir)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        lib = os.path.join(tmp, path.name)
        _run_all([[cxx, *NATIVE_FLAGS, "-o", lib, str(NATIVE_SRC)]], tmp)
        os.replace(lib, path)
    return path
