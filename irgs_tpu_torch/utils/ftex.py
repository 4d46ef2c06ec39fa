"""FTEX (Texture File Format, IW2:EOC) reader, as
``np.asarray(PIL.Image.open(path))`` and ``im.mode`` give it (Pillow 12's
FtexImagePlugin): the first mipmap of a single-format file, at the offset
the format table gives, as DXT1 through the "bcn" decoder (RGBA,
utils/bcn.py) or as raw RGB.

A header cut before its mipmap size, and a size of zero or less, hand the
file to the next plugin; a format count other than 1 (PIL's assert), a
negative offset or mipmap size other than -1, and an unknown format raise
FtexError, as does pixel data that ends early.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn
from .image import NotThisFormat, check_size


class FtexError(ValueError):
    pass


def decode_ftex(buf: bytes, name: str = "FTEX"):
    """(array, mode, info) of an FTEX file's bytes."""
    if not buf.startswith(b"FTEX") or len(buf) < 24:
        raise NotThisFormat(f"{name}: not an FTEX file")
    w, h, _, format_count = struct.unpack_from("<4i", buf, 8)
    if format_count != 1:
        raise FtexError(f"{name}: {format_count} formats (PIL asserts 1)")
    if len(buf) < 32:
        raise NotThisFormat(f"{name}: short FTEX format table")
    fmt, where = struct.unpack_from("<2i", buf, 24)
    if where < 0:
        raise FtexError(f"{name}: negative seek to the mipmap")
    if len(buf) < where + 4:
        raise NotThisFormat(f"{name}: no mipmap size")
    (size,) = struct.unpack_from("<i", buf, where)
    if size < -1:
        raise FtexError(f"{name}: read length must be non-negative or -1")
    data = buf[where + 4:] if size == -1 else buf[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise FtexError(f"{name}: Invalid texture compression format: {fmt}")
    check_size(w, h, name)
    if fmt == 0:
        try:
            return bcn.decode(data, "DXT1", w, h), "RGBA", {}
        except bcn.BcnError as e:
            raise FtexError(f"{name}: {e}") from None
    if len(data) < w * h * 3:
        raise FtexError(f"{name}: image file is truncated")
    return np.frombuffer(data, np.uint8, w * h * 3).reshape(h, w, 3).copy(), \
        "RGB", {}


def read_ftex_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an FTEX
    file."""
    with open(path, "rb") as f:
        return decode_ftex(f.read(), path)
