"""TecoRecords: mmap-friendly frame storage for training clips (copied from
``tecogan_tpu/data/records.py`` lines 1-266).

A records store is a directory with one flat binary blob of raw uint8 RGB
frames (``data.bin``) and a JSON index (``index.json``); it replaces the
reference's LMDB databases (`codes/data/base_dataset.py:48-66`). Frames are
read zero-copy through one ``np.memmap``, and the native C++ assembler
(``data/native.py``) reads the same blob. The format is byte for byte the
JAX package's, so a store written by either package is read by the other.

Key format matches the reference ("<vid>_<T>x<H>x<W>_<idx>"). A store in
the reference's LMDB format (``meta_info.pkl`` + frames) is read by
``LMDBStore`` where the ``lmdb`` package imports; a records store needs
nothing beyond numpy.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import threading

import numpy as np

__all__ = ["RecordWriter", "RecordStore", "LMDBStore", "open_store",
           "parse_key", "make_key"]

_log = logging.getLogger("base")


def make_key(vid: str, tot_frm: int, h: int, w: int, idx: int) -> str:
    return f"{vid}_{tot_frm}x{h}x{w}_{idx:04d}"


def parse_key(key: str):
    parts = key.split("_")
    vid = "_".join(parts[:-2])
    tot, h, w = map(int, parts[-2].split("x"))
    return vid, (tot, h, w), int(parts[-1])


class RecordWriter:
    """Append frames sequence-by-sequence into a records directory."""

    def __init__(self, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.blob = open(osp.join(out_dir, "data.bin"), "wb")
        self.seqs = []  # (vid, tot, h, w, c, start_offset)
        self.offset = 0

    def add_sequence(self, vid: str, frames: np.ndarray):
        """frames: (t, h, w, c) uint8 RGB."""
        t, h, w, c = frames.shape
        if frames.dtype != np.uint8:
            raise ValueError(f"frames must be uint8, got {frames.dtype}")
        if any(v == vid for (v, *_rest) in self.seqs):
            # seq_info on the read side is keyed by vid, so a duplicate
            # would silently shadow the earlier sequence's bytes: every
            # read of the first 'vid' would return the second one's pixels
            raise ValueError(
                f"duplicate sequence name {vid!r}: records keys are "
                f"vid-unique (reference LMDB keys are too); rename the "
                f"source directory")
        start = self.offset
        data = np.ascontiguousarray(frames)
        self.blob.write(data.tobytes())
        self.offset += data.nbytes
        self.seqs.append((vid, t, h, w, c, start))

    def close(self):
        self.blob.close()
        meta = {
            "seqs": [
                {"vid": v, "t": t, "h": h, "w": w, "c": c, "offset": o}
                for (v, t, h, w, c, o) in self.seqs
            ]
        }
        with open(osp.join(self.out_dir, "index.json"), "w") as f:
            json.dump(meta, f)


def _check_clip_dtype(dtype):
    """Only float32 (normalised) and uint8 (raw) are supported: anything
    else (e.g. float16) would silently return 0-255-scaled values under a
    'normalised' dtype (the native assembler supports exactly these two)."""
    if dtype not in (np.float32, np.uint8):
        raise ValueError(
            f"clip dtype must be float32 (normalised) or uint8 (raw), "
            f"got {np.dtype(dtype)}")


class _StoreBase:
    """Shared clip-assembly helper (numpy path)."""

    def clip(self, keys, tops, lefts, ch, cw, dtype=np.float32) -> np.ndarray:
        """Crop one frame per key at (tops[i], lefts[i], ch, cw) and return
        a (t, ch, cw, c) clip: float32 in [0, 1], or raw uint8 (normalised
        on the device: a quarter of the host-to-device bytes)."""
        _check_clip_dtype(dtype)
        frames = []
        for key, top, left in zip(keys, tops, lefts):
            frm = self.get(key)
            frames.append(frm[top:top + ch, left:left + cw])
        out = np.stack(frames)
        if dtype == np.float32:
            return out.astype(np.float32) / 255.0
        return out

    def clip_aug(self, keys, tops, lefts, csz, aug: int,
                 dtype=np.float32, out=None) -> np.ndarray:
        """Crop + dihedral augmentation in one call: the csz x csz crops of
        ``clip`` with flip/rot90 variant ``aug`` in [0, 12) applied (same
        encoding as the sample plans: aug = (flip_axis - 1) * 4 + rot_k).
        ``out``, if given, is a preallocated (t, csz, csz, c) destination,
        e.g. one sample's slot of the batch buffer."""
        pats = self.clip(keys, tops, lefts, csz, csz, dtype)
        axis, k = aug // 4 + 1, aug % 4
        if axis > 1:
            pats = np.flip(pats, axis - 1)
        pats = np.rot90(pats, k, (1, 2))
        if out is not None:
            out[...] = pats
            return out
        return np.ascontiguousarray(pats)


class RecordStore(_StoreBase):
    """Read side: key -> (h, w, c) uint8 frame view (no copy).

    Clips are assembled by the native C++ library where it builds
    (``data/native.py``: mmap gather + crop + aug + dtype in one
    multithreaded pass), else by numpy; the store logs which, once.
    """

    def __init__(self, rec_dir):
        with open(osp.join(rec_dir, "index.json")) as f:
            meta = json.load(f)
        self.rec_dir = rec_dir
        self._blob_path = osp.join(rec_dir, "data.bin")
        self.blob = np.memmap(self._blob_path, dtype=np.uint8, mode="r")
        self.seq_info = {}
        self.keys = []
        for s in meta["seqs"]:
            if s["vid"] in self.seq_info:
                # last-wins would alias every earlier same-named
                # sequence's reads onto the later one's bytes
                raise ValueError(
                    f"records index {rec_dir} holds duplicate sequence "
                    f"name {s['vid']!r}; rebuild it with "
                    f"tecogan_tpu_torch.tools.create_records from "
                    f"uniquely-named clips")
            self.seq_info[s["vid"]] = s
            for i in range(s["t"]):
                self.keys.append(make_key(s["vid"], s["t"], s["h"], s["w"], i))
        self.keys.sort()
        self._native = None
        self._native_tried = False
        self._native_lock = threading.Lock()

    @property
    def assembler(self) -> str:
        """'native' or 'numpy': which path assembles this store's clips
        (decided at the first call)."""
        self._native_blob()
        return "numpy" if self._native is None else "native"

    def _frame_offset(self, key):
        vid, (tot, h, w), idx = parse_key(key)
        s = self.seq_info[vid]
        if not (0 <= idx < s["t"]) or (h, w) != (s["h"], s["w"]):
            # trusting the key blindly would read well-shaped garbage from
            # the NEXT sequence's bytes (silent data corruption)
            raise KeyError(
                f"key {key!r} inconsistent with stored sequence "
                f"{vid!r} (t={s['t']}, {s['h']}x{s['w']})")
        return s["offset"] + idx * (h * w * s["c"]), h, w, s["c"]

    def get(self, key: str) -> np.ndarray:
        off, h, w, c = self._frame_offset(key)
        return self.blob[off:off + h * w * c].reshape(h, w, c)

    def _native_blob(self):
        """The native assembler's handle on data.bin, or None where no C++
        compiler can build it. Decided once per store, and logged: the
        loader's workers that ask while the library builds wait for it."""
        if not self._native_tried:
            with self._native_lock:
                if not self._native_tried:
                    self._native = self._open_native()
                    self._native_tried = True
        return self._native

    def _open_native(self):
        from . import native

        lib = native.load_library()
        if lib is None:
            _log.info("RecordStore %s: clips assembled by numpy (no C++ "
                      "compiler to build native/tecoloader.cpp)",
                      self.rec_dir)
            return None
        _log.info("RecordStore %s: clips assembled by the native assembler "
                  "(%s)", self.rec_dir, lib._name)
        return native.NativeBlob(self._blob_path, lib)

    def _native_offsets(self, keys):
        """(offsets, h, w, c) for the native assembler, or None when it is
        unavailable or the keys mix frame geometries (the C assembler
        strides all frames with one geometry; a wrong stride would
        silently gather garbage pixels)."""
        if self._native_blob() is None:
            return None
        offs, h, w, c = [], None, None, None
        for key in keys:
            off, kh, kw, kc = self._frame_offset(key)
            if h is not None and (kh, kw, kc) != (h, w, c):
                return None
            h, w, c = kh, kw, kc
            offs.append(off)
        return offs, h, w, c

    def clip(self, keys, tops, lefts, ch, cw, dtype=np.float32) -> np.ndarray:
        _check_clip_dtype(dtype)
        nat = self._native_offsets(keys)
        if nat is None:
            return super().clip(keys, tops, lefts, ch, cw, dtype)
        offs, h, w, c = nat
        return self._native.assemble_clip(offs, h, w, c, tops, lefts, ch, cw,
                                          dtype)

    def clip_aug(self, keys, tops, lefts, csz, aug: int,
                 dtype=np.float32, out=None) -> np.ndarray:
        nat = self._native_offsets(keys) if csz >= 2 else None
        if nat is None:
            return super().clip_aug(keys, tops, lefts, csz, aug, dtype, out)
        offs, h, w, c = nat
        return self._native.assemble_clip_aug(offs, h, w, c, tops, lefts,
                                              csz, aug, dtype, out)


class LMDBStore(_StoreBase):
    """Same interface over a reference-format LMDB (meta_info.pkl + frames).

    Opens the environment lazily, per process (fork-safe), mirroring
    `base_dataset.py:48-51`. Needs the ``lmdb`` package, imported at the
    first read.
    """

    def __init__(self, lmdb_dir):
        import pickle

        with open(osp.join(lmdb_dir, "meta_info.pkl"), "rb") as f:
            meta = pickle.load(f)
        self.keys = sorted(meta["keys"])
        self.dir = lmdb_dir
        self._env = None

    def _env_handle(self):
        if self._env is None:
            try:
                import lmdb
            except ImportError as e:
                raise ImportError(
                    f"reading the LMDB store {self.dir} needs the 'lmdb' "
                    f"package, which is not installed. A records store "
                    f"(index.json + data.bin, written by python -m "
                    f"tecogan_tpu_torch.tools.create_records) needs "
                    f"nothing beyond numpy.") from e

            self._env = lmdb.open(self.dir, readonly=True, lock=False,
                                  readahead=False, meminit=False)
        return self._env

    def get(self, key: str) -> np.ndarray:
        _, (tot, h, w), _ = parse_key(key)
        with self._env_handle().begin(write=False) as txn:
            buf = txn.get(key.encode("ascii"))
        if buf is None:
            raise KeyError(f"key {key!r} not found in LMDB {self.dir}")
        # The reference format stores RGB uint8 (`base_dataset.py:61-66`,
        # writer `create_lmdb.py:43-66`) and the key carries no channel
        # count: validate the payload instead of silently reshaping a
        # non-RGB buffer into garbage pixels.
        if len(buf) != h * w * 3:
            c = len(buf) / (h * w) if h * w else float("nan")
            raise ValueError(
                f"LMDB value for {key!r} has {len(buf)} bytes, expected "
                f"{h * w * 3} (h={h}, w={w}, 3 channels); inferred "
                f"channels={c:g}. Only RGB uint8 LMDBs are supported.")
        return np.frombuffer(buf, dtype=np.uint8).reshape(h, w, 3)


def open_store(path: str):
    """Auto-detect the store type at ``path``."""
    if osp.exists(osp.join(path, "index.json")):
        return RecordStore(path)
    if osp.exists(osp.join(path, "meta_info.pkl")):
        return LMDBStore(path)
    raise FileNotFoundError(
        f"no TecoRecords index.json or LMDB meta_info.pkl under {path}")
