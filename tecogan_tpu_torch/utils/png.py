"""PNG frames with numpy and zlib: the port's counterpart of ``cv2.imread``
(``tecogan_tpu/data/datasets.py:311-324``) and ``cv2.imwrite``
(``tecogan_tpu/ops/color.py:41-50``), since OpenCV is not a dependency of
the port.

``read_png`` decodes 8-bit grey, grey+alpha, RGB and RGBA images with any
of the five row filters and returns RGB as ``cv2.IMREAD_COLOR`` would
(after its BGR -> RGB flip): grey is copied to three channels and alpha is
dropped. Palette images, 16-bit samples, interlacing, other formats (JPEG
frames included) and corrupt files raise ``IOError`` naming the file.
``write_png`` writes 8-bit RGB with no row filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel by colour type: grey, RGB, grey+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# zlib's fastest level, the level cv2.imwrite uses by default
_LEVEL = 1


def _chunks(buf, path):
    """(type, data) of every chunk, CRCs checked, up to IEND."""
    pos = len(_SIGNATURE)
    while True:
        if pos + 8 > len(buf):
            raise IOError(f"truncated PNG (no IEND chunk): {path}")
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        end = pos + 12 + length
        if end > len(buf):
            raise IOError(f"truncated PNG ({kind!r} chunk cut short): "
                          f"{path}")
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[end - 4:end])
        if zlib.crc32(kind + data) != crc:
            raise IOError(f"corrupt PNG (CRC mismatch in {kind!r}): {path}")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end


def _unfilter(data, h, w, bpp):
    """Undo the per-row filters of (h, 1 + w*bpp) bytes -> (h, w, bpp).

    Average and Paeth predict each byte from its left, upper and upper-left
    neighbours, so the rows are decoded together along anti-diagonals of
    pixels: every pixel of one diagonal depends only on earlier ones.
    """
    ftype = data[:, 0]
    raw = data[:, 1:].reshape(h, w, bpp)
    if not ftype.any():
        return raw.copy()
    if (ftype > 4).any():
        raise ValueError(f"unknown row filter {int(ftype.max())}")
    x = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column
    raw = raw.astype(np.int32)
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1):min(h, d + 1)]
        c = d - r
        a, b, ul = x[r + 1, c], x[r, c + 1], x[r, c]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        f = ftype[r][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) >> 1], paeth)
        x[r + 1, c + 1] = (raw[r, c] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit PNG file -> (h, w, 3) uint8 RGB."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_SIGNATURE):
        raise IOError(f"not a PNG file (only PNG frames are read): {path}")
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = data
        elif kind == b"IDAT":
            idat.append(data)
    if header is None or len(header) != 13:
        raise IOError(f"corrupt PNG (bad IHDR): {path}")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", header)
    if ctype == 3:
        raise IOError(f"palette PNG not supported: {path}")
    if ctype not in _CHANNELS or depth != 8:
        raise IOError(f"unsupported PNG (colour type {ctype}, bit depth "
                      f"{depth}; 8-bit grey/RGB with or without alpha are "
                      f"read): {path}")
    if interlace:
        raise IOError(f"interlaced PNG not supported: {path}")
    bpp = _CHANNELS[ctype]
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"corrupt PNG ({e}): {path}") from e
    if len(data) != h * (1 + w * bpp):
        raise IOError(f"corrupt PNG ({len(data)} bytes of image data, "
                      f"{h * (1 + w * bpp)} expected): {path}")
    try:
        img = _unfilter(np.frombuffer(data, np.uint8).reshape(h, -1), h, w,
                        bpp)
    except ValueError as e:
        raise IOError(f"corrupt PNG ({e}): {path}") from e
    if bpp <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, rgb) -> None:
    """(h, w, 3) uint8 RGB -> an 8-bit RGB PNG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"write_png takes (h, w, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0: None
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _LEVEL))
                + _chunk(b"IEND", b""))
