"""The port's PNG reader and writer (numpy + zlib) against OpenCV, and on
files encoded by hand with each of the five row filters."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from tecogan_tpu_torch.utils.png import read_png, write_png


def _image(rng, h=23, w=31, c=3):
    """A smooth-ish image, so the filters' predictions matter."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(3 * xx + yy) % 256, (2 * yy + xx * xx) % 256,
                     (xx * yy // 5) % 256, (xx + 7 * yy) % 256], -1)[..., :c]
    noise = rng.integers(0, 9, (h, w, c))
    return ((base + noise) % 256).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype, row, prior, bpp):
    """The PNG filter ``ftype`` applied to one row of bytes (the encoder's
    side, written out byte by byte)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) % 256
    return bytes([ftype]) + bytes(out)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _encode(img, ftypes, ctype, depth=8, interlace=0, height=None):
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    rows = img.reshape(h, w * bpp)
    prior = bytes(w * bpp)
    raw = b""
    for r in range(h):
        raw += _filter_row(ftypes[r % len(ftypes)], bytes(rows[r]), prior,
                           bpp)
        prior = bytes(rows[r])
    ihdr = struct.pack(">IIBBBBB", w, height or h, depth, ctype, 0, 0,
                       interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype,name", [
    (0, "none"), (1, "sub"), (2, "up"), (3, "average"), (4, "paeth")])
def test_each_row_filter(tmp_path, rng, ftype, name):
    img = _image(rng)
    p = tmp_path / f"{name}.png"
    p.write_bytes(_encode(img, [ftype], ctype=2))
    np.testing.assert_array_equal(read_png(p), img)
    # OpenCV agrees with the hand encoding
    np.testing.assert_array_equal(cv2.imread(str(p))[..., ::-1], img)


@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_colour_types_with_mixed_filters(tmp_path, rng, ctype, channels):
    img = _image(rng, c=channels)
    p = tmp_path / "mixed.png"
    p.write_bytes(_encode(img if channels > 1 else img[..., 0],
                          [4, 3, 0, 1, 2, 4, 3], ctype=ctype))
    want = np.repeat(img[..., :1], 3, -1) if channels <= 2 else img[..., :3]
    got = read_png(p)
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("kind", ["grey", "bgr", "bgra"])
@pytest.mark.parametrize("level", [0, 1, 9])
def test_read_matches_cv2_imread(tmp_path, rng, kind, level):
    """Files OpenCV wrote (libpng chooses the filters) read as
    ``cv2.imread(..., IMREAD_COLOR)[..., ::-1]``."""
    img = _image(rng, 40, 52, 4)
    arr = {"grey": img[..., 0], "bgr": img[..., :3], "bgra": img}[kind]
    p = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(p, arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(
        read_png(p), cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1])


def test_writer_against_cv2(tmp_path, rng):
    img = _image(rng, 17, 29)
    p = str(tmp_path / "out.png")
    write_png(p, img)
    np.testing.assert_array_equal(cv2.imread(p)[..., ::-1], img)
    np.testing.assert_array_equal(read_png(p), img)
    with pytest.raises(ValueError):
        write_png(p, img.astype(np.float32))
    with pytest.raises(ValueError):
        write_png(p, img[..., 0])


def test_truncated_file_raises_naming_it(tmp_path, rng):
    p = tmp_path / "cut.png"
    data = _encode(_image(rng), [4], ctype=2)
    for n in (len(data) - 5, len(data) // 2, 12):
        p.write_bytes(data[:n])
        with pytest.raises(IOError, match="cut.png"):
            read_png(p)


@pytest.mark.parametrize("case", ["crc", "palette", "16bit", "interlaced",
                                  "jpeg", "short_data"])
def test_unsupported_or_corrupt_raises_naming_it(tmp_path, rng, case):
    img = _image(rng)
    p = tmp_path / f"{case}.png"
    if case == "crc":
        data = bytearray(_encode(img, [1], ctype=2))
        data[45] ^= 0xFF  # inside the IDAT payload
        p.write_bytes(bytes(data))
    elif case == "palette":
        p.write_bytes(_encode(img[..., 0], [0], ctype=3))
    elif case == "16bit":
        p.write_bytes(_encode(img, [0], ctype=2, depth=16))
    elif case == "interlaced":
        p.write_bytes(_encode(img, [0], ctype=2, interlace=1))
    elif case == "jpeg":
        p = tmp_path / "frame.jpg"
        assert cv2.imwrite(str(p), img)
    else:
        p.write_bytes(_encode(img[:-1], [0], ctype=2, height=23))
    with pytest.raises(IOError, match=p.name):
        read_png(p)
