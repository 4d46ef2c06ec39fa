"""Blizzard Mipmap (BLP1, BLP2) reader, as ``np.asarray(PIL.Image.open(
path))`` and ``im.mode`` give it (Pillow 12's BlpImagePlugin): the first
mipmap, in mode RGBA where the header's alpha flag is set, else RGB.

BLP1  compression 0: the shared JPEG header, the bytes up to the first
      mipmap's offset skipped, then the mipmap's bytes, decoded as one JPEG
      stream (utils/jpeg.py); a CMYK stream is decoded as CMYK whatever its
      Adobe transform (PIL sets the jpeg decoder's colour space to "CMYK"),
      and the RGB bytes are stored as "BGR", so red and blue trade places. Compression 1 with
      encoding 4 or 5: 8-bit indices into the 256-entry BGRA palette that
      follows the header (the index data read from there, whatever the
      offset table says).
BLP2  compression 1: encoding 1, the palette's indices at the first
      mipmap's offset; encoding 2, DXT1 (3 bytes a pixel without the alpha
      flag), DXT3 or DXT5 by the alpha encoding, decoded as
      BlpImagePlugin's own Python decoders do (utils/bcn.decode_blp_dxt:
      5:6:5 shifted, not widened), block row by block row.
Each decoder's bytes are then read as PIL's raw decoder reads them into
the image: rows of the header's width, so a width that is not a multiple
of 4 shears DXT rows, and a JPEG of another size than the header's gives
its bytes in the header's rows; too few bytes raise ("not enough image
data").

A header cut before its size, and a size of zero, hand the file to the
next plugin; everything else PIL refuses at load raises BlpError
(BLPFormatError, "Truncated File Read", the JPEG stream's own errors).
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn, jpeg
from .image import NotThisFormat, check_size, to_rgb_like_pil

# BLP2 alpha encoding -> the DXT decoder
_DXT = {0: 1, 1: 2, 7: 3}


class BlpError(ValueError):
    pass


class _File:
    """The decoder's view of the file: ImageFile._safe_read at a
    position."""

    def __init__(self, buf: bytes, pos: int, name: str):
        self.buf, self.pos, self.name = buf, pos, name

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        data = self.buf[self.pos:self.pos + n]
        if len(data) < n:
            raise BlpError(f"{self.name}: Truncated File Read")
        self.pos += n
        return data


def _raw(data, mode: str, rawmode: str, w: int, h: int, name: str):
    """PIL's raw decoder from `rawmode` into a w x h image of `mode`."""
    bands = len(rawmode)
    data = np.asarray(data, np.uint8).reshape(-1)
    if len(data) < w * h * bands:
        raise BlpError(f"{name}: not enough image data")
    px = data[:w * h * bands].reshape(h, w, bands)
    if rawmode == "BGR":
        px = px[..., ::-1]
    if mode == "RGBA" and bands == 3:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(px)


def _palette(f: _File):
    """256 BGRA entries -> [256, 4] as RGBA."""
    return np.frombuffer(f.read(1024), np.uint8).reshape(256, 4)[:, [2, 1, 0,
                                                                      3]]


def _indexed(f: _File, length: int, pal: np.ndarray, alpha: bool):
    idx = np.frombuffer(f.read(length), np.uint8)
    return pal[idx][:, :4 if alpha else 3]


def _jpeg(f: _File, offsets, lengths, name: str):
    """_decode_jpeg_stream: the JPEG's RGB bytes."""
    (header_size,) = struct.unpack("<I", f.read(4))
    header = f.read(header_size)
    f.read(offsets[0] - f.pos)
    stream = header + f.read(lengths[0])
    try:
        mode = jpeg._pil_open(stream)
        arr, mode, _ = jpeg.decode_jpeg_like_pil(
            stream, "CMYK" if mode == "CMYK" else "")
    except (NotThisFormat, jpeg.JpegError) as e:
        raise BlpError(f"{name}: {e}") from None
    return to_rgb_like_pil(arr, mode)


def decode_blp(buf: bytes, name: str = "BLP"):
    """(array, mode, info) of a BLP file's bytes."""
    magic = buf[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise NotThisFormat(f"{name}: Bad BLP magic {magic!r}")
    v1 = magic == b"BLP1"
    if len(buf) < (24 if v1 else 20):
        raise NotThisFormat(f"{name}: short BLP header")
    (compression,) = struct.unpack_from("<i", buf, 4)
    if v1:
        alpha = struct.unpack_from("<I", buf, 8)[0] != 0
        w, h, encoding = struct.unpack_from("<IIi", buf, 12)
        offset = 28
    else:
        encoding, alpha_flag, alpha_encoding = struct.unpack_from("<3b", buf,
                                                                  8)
        alpha = alpha_flag != 0
        w, h = struct.unpack_from("<II", buf, 12)
        offset = 20
    mode = "RGBA" if alpha else "RGB"
    check_size(w, h, name)
    f = _File(buf, offset, name)
    offsets = struct.unpack("<16I", f.read(64))
    lengths = struct.unpack("<16I", f.read(64))
    if v1:
        if compression == 0:
            return _raw(_jpeg(f, offsets, lengths, name), mode, "BGR", w, h,
                        name), mode, {}
        if compression != 1:
            raise BlpError(f"{name}: Unsupported BLP compression {encoding}")
        if encoding not in (4, 5):
            raise BlpError(f"{name}: Unsupported BLP encoding {encoding}")
        data = _indexed(f, lengths[0], _palette(f), alpha)
        return _raw(data, mode, mode, w, h, name), mode, {}
    pal = _palette(f)
    f.pos = offsets[0]
    if compression != 1:
        raise BlpError(f"{name}: Unknown BLP compression {compression}")
    if encoding == 1:
        data = _indexed(f, lengths[0], pal, alpha)
    elif encoding == 2:
        if alpha_encoding not in _DXT:
            raise BlpError(f"{name}: Unsupported alpha encoding "
                           f"{alpha_encoding}")
        n = _DXT[alpha_encoding]
        bw, bh = (w + 3) // 4, (h + 3) // 4
        rows = b"".join(f.read(bw * bcn.block_bytes(n)) for _ in range(bh))
        px = bcn.decode_blp_dxt(rows, n, bw, bh)
        data = px[..., :3] if n == 1 and not alpha else px
    else:
        raise BlpError(f"{name}: Unknown BLP encoding {encoding}")
    return _raw(data, mode, mode, w, h, name), mode, {}


def read_blp_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a BLP
    file."""
    with open(path, "rb") as f:
        return decode_blp(f.read(), path)
