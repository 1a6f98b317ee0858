"""ctypes binding to the native clip assembler (``native/tecoloader.cpp``;
the binding is copied from ``tecogan_tpu/data/native.py`` lines 1-224, the
build is the port's own).

``load_library()`` compiles the source with g++ into ``build/native/``
(``kernel_build.build_native_loader``, keyed on the source's hash) at first
use and never writes into ``native/``. Where there is no C++ compiler it
returns None and the stores take their numpy path; a compiler that refuses
the source, or a library that lacks an entry point, raises. ctypes releases
the GIL during calls, so the loader's worker threads scale.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

__all__ = ["load_library", "NativeBlob", "aug_coeffs"]

_SYMBOLS = ("teco_mmap_open", "teco_mmap_close",
            "teco_assemble_clip_f32", "teco_assemble_clip_u8",
            "teco_assemble_clip_aug_f32", "teco_assemble_clip_aug_u8",
            "teco_set_max_threads", "teco_get_max_threads")


_LOAD_LOCK = threading.Lock()


def load_library(build_dir=None):
    """The assembler's library (built if needed; once per process and build
    directory, whichever thread asks first), or None where no g++ can build
    it. The number of threads the library assembles one sample with
    (default 4) is read from ``TECOGAN_LOADER_THREADS`` at the first load."""
    with _LOAD_LOCK:
        return _load_library(build_dir)


@functools.cache
def _load_library(build_dir):
    from ..kernel_build import build_native_loader

    path = build_native_loader(build_dir)
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    missing = [sym for sym in _SYMBOLS if not hasattr(lib, sym)]
    if missing:
        raise RuntimeError(f"{path} lacks the entry points {missing}")
    lib.teco_set_max_threads.argtypes = [ctypes.c_int32]
    lib.teco_set_max_threads.restype = None
    lib.teco_get_max_threads.restype = ctypes.c_int32
    lib.teco_get_max_threads.argtypes = []
    lib.teco_mmap_open.restype = ctypes.c_void_p
    lib.teco_mmap_open.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.teco_mmap_close.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.teco_mmap_close.restype = None
    clip_sig = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    aug_sig = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,  # csz
        ctypes.c_int32, ctypes.c_int32,  # r0, c0
        ctypes.c_int32, ctypes.c_int32,  # drr, drc
        ctypes.c_int32, ctypes.c_int32,  # dcr, dcc
        ctypes.c_void_p,
    ]
    for name, sig in (("teco_assemble_clip_f32", clip_sig),
                      ("teco_assemble_clip_u8", clip_sig),
                      ("teco_assemble_clip_aug_f32", aug_sig),
                      ("teco_assemble_clip_aug_u8", aug_sig)):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = None
    env_threads = os.environ.get("TECOGAN_LOADER_THREADS")
    if env_threads:
        try:
            lib.teco_set_max_threads(int(env_threads))
        except ValueError:
            raise ValueError(
                f"TECOGAN_LOADER_THREADS={env_threads!r} is not an int")
    return lib


@functools.cache
def aug_coeffs(csz: int) -> np.ndarray:
    """(12, 6) int32 affine coefficients (r0, c0, drr, drc, dcr, dcc) of
    the 12 dihedral augmentations over a csz x csz crop: output pixel
    (ro, co) of aug a reads crop pixel
    (r0 + ro*drr + co*dcr, c0 + ro*drc + co*dcc).

    Derived from the same index maps the device-resident gather uses
    (``data/device_data.py::dihedral_maps``: an identity grid pushed
    through the numpy flip/rot90 the host's numpy path applies), so all
    three input paths share one source of truth."""
    if csz < 2:
        raise ValueError(f"aug_coeffs needs csz >= 2, got {csz}")
    from .device_data import dihedral_maps

    maps = dihedral_maps(csz)  # (12, csz, csz, 2)
    coeffs = np.empty((12, 6), np.int32)
    for a in range(12):
        m = maps[a]
        r0, c0 = m[0, 0]
        coeffs[a] = (r0, c0,
                     m[1, 0, 0] - r0, m[1, 0, 1] - c0,   # drr, drc
                     m[0, 1, 0] - r0, m[0, 1, 1] - c0)   # dcr, dcc
    # the extracted affine form must reproduce the maps exactly
    ro, co = np.meshgrid(np.arange(csz), np.arange(csz), indexing="ij")
    for a in range(12):
        r0, c0, drr, drc, dcr, dcc = (int(v) for v in coeffs[a])
        if not ((maps[a][..., 0] == r0 + ro * drr + co * dcr).all()
                and (maps[a][..., 1] == c0 + ro * drc + co * dcc).all()):
            raise AssertionError(f"aug {a} is not affine at csz {csz}")
    coeffs.flags.writeable = False
    return coeffs


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBlob:
    """mmap handle to a records data.bin served by the native library."""

    def __init__(self, path: str, lib=None):
        self.lib = load_library() if lib is None else lib
        if self.lib is None:
            raise RuntimeError("the native assembler is not built: no g++")
        size = ctypes.c_int64()
        self.base = self.lib.teco_mmap_open(path.encode(),
                                            ctypes.byref(size))
        if not self.base:
            raise OSError(f"mmap failed: {path}")
        self.size = size.value

    def assemble_clip(self, frame_offsets, h, w, c, tops, lefts, ch, cw,
                      dtype=np.float32):
        """-> (t, ch, cw, c) clip: float32 in [0, 1] or raw uint8."""
        t = len(frame_offsets)
        offs = np.ascontiguousarray(frame_offsets, np.int64)
        tops = np.ascontiguousarray(tops, np.int32)
        lefts = np.ascontiguousarray(lefts, np.int32)
        out = np.empty((t, ch, cw, c), dtype)
        fn = (self.lib.teco_assemble_clip_f32 if dtype == np.float32
              else self.lib.teco_assemble_clip_u8)
        fn(self.base, _ptr(offs, ctypes.c_int64), t, h, w, c,
           _ptr(tops, ctypes.c_int32), _ptr(lefts, ctypes.c_int32), ch, cw,
           out.ctypes.data_as(ctypes.c_void_p))
        return out

    def assemble_clip_aug(self, frame_offsets, h, w, c, tops, lefts, csz,
                          aug: int, dtype=np.float32, out=None):
        """Fused gather + crop + dihedral aug -> (t, csz, csz, c) clip.

        ``out`` may be a preallocated C-contiguous destination (e.g. a
        batch slot) so the sample is materialised exactly once."""
        t = len(frame_offsets)
        dtype = np.dtype(dtype)
        if dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(f"unsupported clip dtype {dtype}")
        offs = np.ascontiguousarray(frame_offsets, np.int64)
        tops = np.ascontiguousarray(tops, np.int32)
        lefts = np.ascontiguousarray(lefts, np.int32)
        if out is None:
            out = np.empty((t, csz, csz, c), dtype)
        elif not (out.flags.c_contiguous and out.dtype == dtype
                  and out.shape == (t, csz, csz, c)):
            raise ValueError(f"bad destination {out.shape} {out.dtype}; "
                             f"expected C-contiguous {(t, csz, csz, c)} "
                             f"{dtype}")
        r0, c0, drr, drc, dcr, dcc = (int(v) for v in aug_coeffs(csz)[aug])
        fn = (self.lib.teco_assemble_clip_aug_f32 if dtype == np.float32
              else self.lib.teco_assemble_clip_aug_u8)
        fn(self.base, _ptr(offs, ctypes.c_int64), t, h, w, c,
           _ptr(tops, ctypes.c_int32), _ptr(lefts, ctypes.c_int32),
           csz, r0, c0, drr, drc, dcr, dcc,
           out.ctypes.data_as(ctypes.c_void_p))
        return out

    def close(self):
        if self.base:
            self.lib.teco_mmap_close(self.base, self.size)
            self.base = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
