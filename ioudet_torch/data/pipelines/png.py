"""A PNG reader for label maps in numpy and the standard library's ``zlib``
(no image library): what ``np.asarray(PIL.Image.open(path))`` gives for

  * 8-bit grayscale (colour type 0): (H, W) uint8;
  * 8-bit palette (colour type 3): (H, W) uint8, the palette indices;
  * 8-bit RGB (colour type 2): (H, W, 3) uint8;

non-interlaced, with any of the five row filters (None, Sub, Up, Average,
Paeth) on any row.  Every chunk's CRC is checked.  Anything else (another
bit depth or colour type, Adam7 interlacing, a broken stream) raises a
``ValueError`` naming the file.

The filters are undone row against row and byte against byte, so Average
and Paeth cannot be one vector operation along a row; the decoder walks the
image by anti-diagonals of pixels instead (pixel (y, x) needs its left,
upper and upper-left neighbours, all on the two diagonals before its own),
each diagonal one vector step: H + W steps an image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1}   # colour type -> samples a pixel (8-bit only)


def _chunks(buf: bytes, name: str):
    pos = len(SIGNATURE)
    while pos + 12 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        crc = buf[pos + 8 + length:pos + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: bad CRC in PNG chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters, by anti-diagonals of pixels: pixel (y, x) on diagonal
    y + x, its bytes together."""
    h, nbytes = rows.shape
    w = nbytes // bpp
    # recon with one zero row above and one zero pixel to the left, flat
    stride = nbytes + bpp
    rec = np.zeros((h + 1) * stride, np.int32)
    filt = rows.astype(np.int32).reshape(-1)
    kinds = types.astype(np.int32)
    lane = np.arange(bpp)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        col = ((d - y) * bpp)[:, None] + lane            # byte columns of pixel (y, d - y)
        at = (y[:, None] + 1) * stride + col + bpp       # its place in rec
        a, b, c = rec[at - bpp], rec[at - stride], rec[at - stride - bpp]
        t = kinds[y][:, None]
        pred = np.where(t == 4, _paeth(a, b, c), np.where(
            t == 3, (a + b) >> 1, np.where(t == 2, b, np.where(t == 1, a, 0))))
        rec[at] = (filt[y[:, None] * nbytes + col] + pred) & 255
    return rec.reshape(h + 1, stride)[1:, bpp:].astype(np.uint8)


def decode_png(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, 3) uint8 (see the module's docstring)."""
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(buf, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, ctype, compression, method, interlace = header
    if depth != 8 or ctype not in CHANNELS or compression or method or interlace:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace} is not read here; only 8-bit grey, palette or RGB, "
                         "not interlaced")
    bpp = CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: broken PNG image data ({e})") from e
    stride = width * bpp + 1
    if len(raw) < stride * height:
        raise ValueError(f"{name}: PNG image data too short")
    data = np.frombuffer(raw, np.uint8, stride * height).reshape(height, stride)
    types, rows = data[:, 0], data[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"{name}: unknown PNG row filter {int(types.max())}")
    img = _unfilter(rows, types, bpp)
    return img.reshape(height, width, bpp)[..., 0] if bpp == 1 else \
        img.reshape(height, width, bpp)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)
