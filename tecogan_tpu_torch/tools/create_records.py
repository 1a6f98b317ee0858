"""Build a records store (or check one) from a PNG sequence tree (port of
``scripts/create_records.py`` lines 27-55 and its ``--check``, lines
85-101, with frames read by ``utils/png.py`` instead of cv2)::

    python -m tecogan_tpu_torch.tools.create_records --raw_dir RAW \\
        --out_dir data/REDS/GT.lmdb [--filter_file F]
    python -m tecogan_tpu_torch.tools.create_records --check \\
        --out_dir data/REDS/GT.lmdb

RAW holds one directory of PNG frames per sequence; the store
(``index.json`` + ``data.bin``, ``data/records.py``) is read by the
training loaders of both packages. ``.jpg`` frames raise, as the port's
PNG reader does. ``--format lmdb`` writes the reference's LMDB format
instead, and needs the ``lmdb`` package.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import random

import numpy as np

from ..data.records import RecordWriter, make_key, open_store
from ..utils.png import read_image, write_png

__all__ = ["build", "build_lmdb", "check"]


def _iter_sequences(raw_dir, filter_file=None):
    seqs = sorted(os.listdir(raw_dir))
    if filter_file:
        with open(filter_file) as f:
            sel = {line.strip() for line in f if line.strip()}
        seqs = [s for s in seqs if s in sel]
    for si, seq in enumerate(seqs):
        seq_dir = osp.join(raw_dir, seq)
        frames = [read_image(osp.join(seq_dir, fname))
                  for fname in sorted(os.listdir(seq_dir))
                  if fname.lower().endswith((".png", ".jpg"))]
        if frames:
            yield si, len(seqs), seq, np.ascontiguousarray(np.stack(frames))


def build(raw_dir, out_dir, filter_file=None):
    writer = RecordWriter(out_dir)
    for si, n, seq, frames in _iter_sequences(raw_dir, filter_file):
        writer.add_sequence(seq, frames)
        print(f"[{si + 1}/{n}] {seq}: {len(frames)} frames")
    writer.close()
    print(f"wrote {out_dir}")


def build_lmdb(raw_dir, out_dir, filter_file=None, map_gb=200):
    """Write a reference-format LMDB (`scripts/create_lmdb.py:13-139`):
    RGB uint8 frames under keys ``{seq}_{T}x{H}x{W}_{i:04d}`` plus a
    ``meta_info.pkl`` with name + keys. Needs the ``lmdb`` package."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "--format lmdb needs the 'lmdb' package, which is not "
            "installed; the default records format needs nothing") from e

    os.makedirs(out_dir, exist_ok=True)
    env = lmdb.open(out_dir, map_size=int(map_gb * 2 ** 30))
    all_keys = []
    for si, n, seq, frames in _iter_sequences(raw_dir, filter_file):
        t, h, w, _ = frames.shape
        with env.begin(write=True) as txn:
            for i in range(t):
                key = make_key(seq, t, h, w, i)
                txn.put(key.encode("ascii"),
                        np.ascontiguousarray(frames[i]).tobytes())
                all_keys.append(key)
        print(f"[{si + 1}/{n}] {seq}: {t} frames")
    env.close()
    meta = {"name": osp.basename(out_dir.rstrip("/")), "keys": all_keys}
    with open(osp.join(out_dir, "meta_info.pkl"), "wb") as f:
        pickle.dump(meta, f)
    print(f"wrote LMDB {out_dir} ({len(all_keys)} keys)")


def check(out_dir, n_samples=3):
    """Spot check: read the store and write a few random frames next to
    it as PNGs. Returns the frame keys written."""
    store = open_store(out_dir)
    n_seq = len({k.rsplit("_", 2)[0] for k in store.keys})
    print(f"{len(store.keys)} frame keys, ~{n_seq} sequences")
    keys = []
    for _ in range(n_samples):
        key = random.choice(store.keys)
        frm = store.get(key)
        out = osp.join(out_dir, f"check_{key}.png")
        write_png(out, frm)
        print(f"  {key}: {frm.shape} -> {out}")
        keys.append(key)
    return keys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--raw_dir", default="")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--filter_file", default=None)
    p.add_argument("--check", action="store_true")
    p.add_argument("--format", choices=["records", "lmdb"],
                   default="records")
    args = p.parse_args(argv)
    if args.check:
        check(args.out_dir)
    elif args.format == "lmdb":
        build_lmdb(args.raw_dir, args.out_dir, args.filter_file)
    else:
        build(args.raw_dir, args.out_dir, args.filter_file)


if __name__ == "__main__":
    main()
