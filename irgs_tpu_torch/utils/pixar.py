"""PIXAR raster reader, as ``np.asarray(PIL.Image.open(path))`` and
``im.mode`` give it (Pillow 12's PixarImagePlugin): the magic
``\\x80\\xe8\\0\\0``, a 512-byte header whose little-endian words at 418
and 416 are the width and height and whose channel/depth pair at 424 and
426 must be (14, 2): RGB, read raw from byte 1,024. Any other pair leaves
PIL without a mode, so the file goes on to the next plugin, as does a
header too short for those words.
"""

from __future__ import annotations

import struct

from . import pil_raw
from .image import NotThisFormat, check_size


class PixarError(ValueError):
    pass


def decode_pixar(buf: bytes, name: str = "PIXAR"):
    """(array, mode, info) of a PIXAR file's bytes."""
    s = buf[:512]
    if not s.startswith(b"\x80\xe8\0\0"):
        raise NotThisFormat(f"{name}: not a PIXAR file")
    if len(s) < 428:
        raise NotThisFormat(f"{name}: short PIXAR header")
    h, w = struct.unpack_from("<HH", s, 416)
    if struct.unpack_from("<HH", s, 424) != (14, 2) or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(w, h, name)
    try:
        return pil_raw.load(buf, 1024, "RGB", "RGB", (w, h),
                            name=name), "RGB", {}
    except pil_raw.RawError as e:
        raise PixarError(str(e)) from None


def read_pixar_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a PIXAR
    file."""
    with open(path, "rb") as f:
        return decode_pixar(f.read(), path)
