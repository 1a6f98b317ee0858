"""The port's one frame reader (``utils/png.py::read_image``) against the JAX
package's readers, and the official harness's frame pairing.

The JAX package reads every frame with ``cv2.imread`` (its datasets, its
``scripts/create_records.py``, its official harness and its serving
host). The port decodes the 8-bit PNGs it writes itself and hands every
other file to cv2: here a JPEG, a palette, a 16-bit and an interlaced
(Adam7) PNG go through each JAX reader and its port counterpart, bit for
bit. The harness pairs frames by basename where equal counts hold
different names (each dir missing another frame), and by position where
the names agree or do not overlap at all (the reference's rule).
"""

import importlib.util
import os
import os.path as osp
import struct
import subprocess
import sys
import textwrap
import zlib

import cv2
import numpy as np
import pytest

from tecogan_tpu import serve as jserve
from tecogan_tpu.data import datasets as jdatasets
from tecogan_tpu.official_metrics import metrics as jmetrics
from tecogan_tpu_torch import serve
from tecogan_tpu_torch.data import datasets
from tecogan_tpu_torch.official_metrics import metrics
from tecogan_tpu_torch.tools import create_records
from tecogan_tpu_torch.utils.png import read_image, read_png, write_png

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
_H, _W = 13, 17  # odd sizes: every Adam7 pass is ragged


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png(path, w, h, depth, ctype, rows, interlace=0, extra=b""):
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + extra
                + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


def _filtered(img):
    """Rows of ``img`` (h, w, bytes a pixel) each behind filter byte 0."""
    h = img.shape[0]
    return b"".join(b"\x00" + img[r].tobytes() for r in range(h))


# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _write_frames(d, rng):
    """One frame of each kind the port hands to cv2, plus an 8-bit PNG it
    decodes itself; returns {name: path}."""
    os.makedirs(d, exist_ok=True)
    rgb = rng.integers(0, 256, (_H, _W, 3), dtype=np.uint8)
    paths = {k: osp.join(d, f"{i:04d}_{k}.{'jpg' if k == 'jpeg' else 'png'}")
             for i, k in enumerate(("png8", "jpeg", "palette", "png16",
                                    "interlaced"))}
    write_png(paths["png8"], rgb)
    cv2.imwrite(paths["jpeg"], rgb[..., ::-1].copy())
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (_H, _W, 1), dtype=np.uint8)
    _png(paths["palette"], _W, _H, 8, 3, _filtered(idx),
         extra=_chunk(b"PLTE", palette.tobytes()))
    rgb16 = rng.integers(0, 65536, (_H, _W, 3), dtype=np.uint16)
    _png(paths["png16"], _W, _H, 16, 2, _filtered(rgb16.astype(">u2").view(
        np.uint8).reshape(_H, _W, 6)))
    rows = b"".join(_filtered(rgb[r0::dr, c0::dc])
                    for r0, c0, dr, dc in _ADAM7
                    if r0 < _H and c0 < _W)
    _png(paths["interlaced"], _W, _H, 8, 2, rows, interlace=1)
    return paths


def _cv2_rgb(path):
    return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]


def _jax_create_records():
    spec = importlib.util.spec_from_file_location(
        "jax_create_records", osp.join(_REPO, "scripts", "create_records.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["png8", "jpeg", "palette", "png16",
                                  "interlaced"])
def test_read_image_matches_the_jax_readers(tmp_path, rng, kind):
    """Every reader of the port against its JAX counterpart on one frame of
    ``kind``, bit for bit; the port's own PNG decoder takes the 8-bit PNG
    and refuses the rest, which go to cv2."""
    paths = _write_frames(str(tmp_path / "all"), rng)
    path = paths[kind]
    seq = str(tmp_path / "seq")
    os.makedirs(seq)
    os.replace(path, osp.join(seq, osp.basename(path)))
    path = osp.join(seq, osp.basename(path))
    want = _cv2_rgb(path)
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == (_H, _W, 3)
    np.testing.assert_array_equal(got, want)
    if kind == "png8":
        np.testing.assert_array_equal(read_png(path), want)
    else:
        with pytest.raises(IOError, match=osp.basename(path)):
            read_png(path)
    # test sets and training sequences
    np.testing.assert_array_equal(datasets._read_seq(seq, False),
                                  jdatasets._read_seq(seq, False))
    # the official harness
    np.testing.assert_array_equal(metrics.read_image(path),
                                  jmetrics._read_rgb(path))
    # the serving host
    args = (seq, [osp.basename(path)], _H, _W, "seq")
    np.testing.assert_array_equal(serve._read_sequence(*args),
                                  jserve._read_sequence(*args))
    # the records tool (it lists .png and .jpg frames)
    raw = str(tmp_path / "raw")
    os.makedirs(raw)
    os.replace(seq, osp.join(raw, "seq"))
    (_, _, _, mine), = create_records._iter_sequences(raw)
    (_, _, _, theirs), = _jax_create_records()._iter_sequences(raw)
    np.testing.assert_array_equal(mine, theirs)


def test_read_image_refusals(tmp_path, rng):
    """A file cv2 cannot read raises IOError naming it; with cv2 blocked an
    8-bit PNG still reads and every other frame raises ImportError naming
    the package."""
    bad = tmp_path / "0000.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0not a jpeg")
    with pytest.raises(IOError, match="0000.jpg"):
        read_image(str(bad))
    paths = _write_frames(str(tmp_path / "f"), rng)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        import numpy as np
        from tecogan_tpu_torch.utils.png import read_image, read_png
        paths = {paths!r}
        np.testing.assert_array_equal(read_image(paths["png8"]),
                                      read_png(paths["png8"]))
        for k in ("jpeg", "palette", "png16", "interlaced"):
            try:
                read_image(paths[k])
            except ImportError as e:
                assert "tecogan_tpu_torch" in str(e) and paths[k] in str(e)
            else:
                raise AssertionError(k)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok"]


def _frames(d, names, rng, base):
    os.makedirs(d, exist_ok=True)
    for n in names:
        img = base[n].astype(np.int16) + rng.integers(-1, 2, base[n].shape)
        write_png(osp.join(d, f"{n:04d}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))


def test_harness_pairs_equal_counts_by_basename(tmp_path, rng, capsys):
    """A result dir missing frame 3 and a target dir missing frame 5, each
    of 8 frames: scored on the 7 frames both hold, name by name, with a
    WARNING; by position, every pair from frame 3 to 5 would be a frame
    off. The JAX harness pairs these by position."""
    base = {i: rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
            for i in range(9)}
    res, tar = str(tmp_path / "sr"), str(tmp_path / "gt")
    _frames(res, [i for i in range(9) if i != 3], rng, base)
    _frames(tar, [i for i in range(9) if i != 5], rng, base)
    outs, tars = metrics._pair_frames(metrics.list_png(res),
                                      metrics.list_png(tar), res, tar)
    assert [osp.basename(p) for p in outs] == [
        osp.basename(p) for p in tars] == [
        f"{i:04d}.png" for i in (0, 1, 2, 4, 6, 7, 8)]
    assert "WARNING" in capsys.readouterr().out
    j_outs, j_tars = jmetrics._pair_frames(jmetrics.list_png(res),
                                           jmetrics.list_png(tar), res, tar)
    assert [osp.basename(p) for p in j_outs] != [
        osp.basename(p) for p in j_tars]
    got = metrics.evaluate_folders([res], [tar], str(tmp_path / "log"),
                                   device="cpu")
    # frames within one gray level of each other: PSNR far above a pair a
    # frame apart (random images, about 8 dB)
    assert got["PSNR"][0] == 7 - 2 * metrics._CUTFR
    assert got["PSNR"][1] > 40, got["PSNR"]


@pytest.mark.parametrize("case", ["same names", "disjoint names"])
def test_harness_pairs_by_position_where_the_reference_does(tmp_path, rng,
                                                            capsys, case):
    """Equal name sets, and equal counts of names that do not overlap at
    all, pair by sorted position as the JAX harness pairs them, without a
    WARNING."""
    base = {i: rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
            for i in range(12)}
    res, tar = str(tmp_path / "sr"), str(tmp_path / "gt")
    _frames(res, range(6), rng, base)
    _frames(tar, range(6) if case == "same names" else range(6, 12), rng,
            base)
    args = (metrics.list_png(res), metrics.list_png(tar), res, tar)
    assert metrics._pair_frames(*args) == jmetrics._pair_frames(*args) == (
        args[0], args[1])
    assert "WARNING" not in capsys.readouterr().out
