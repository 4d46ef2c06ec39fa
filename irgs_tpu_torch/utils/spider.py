"""SPIDER reader, as ``np.asarray(PIL.Image.open(path))`` and ``im.mode``
give it (Pillow 12's SpiderImagePlugin): mode F from 32-bit floats,
big-endian ("F;32BF") where the first 27 header floats read big-endian
pass ``isSpiderHeader`` (header words 1, 2, 5, 12, 13, 22 and 23 whole
numbers, an iform of 1, 3, -11, -12, -21 or -22, and the header's byte
count equal to its records times their length), else little-endian
("F;32F") where they pass read so. Only 2-D images (iform 1) are read; a
stack's first image lies one header past the stack's header, and a
single image inside a stack fails as in PIL (the plugin reads an offset
it has not set). ``convert("RGB")`` clips and truncates the floats
(utils/image.to_rgb_like_pil).

A file whose header fails those checks hands it to the next plugin;
header words PIL cannot make integers of, and load errors, raise
SpiderError.
"""

from __future__ import annotations

import struct

from . import pil_raw
from .image import NotThisFormat, check_size, pil_open

IFORMS = (1, 3, -11, -12, -21, -22)


class SpiderError(ValueError):
    pass


def _is_int(f) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def header_length(t) -> int:
    """SpiderImagePlugin.isSpiderHeader: the header's bytes, 0 if the
    floats `t` are not a SPIDER header."""
    h = (99,) + tuple(t)
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labbyt = int(h[22])
    if labbyt != int(h[13]) * int(h[23]):
        return 0
    return labbyt


def _open(buf):
    f = buf[:108]
    order = ">"
    t = struct.unpack(">27f", f)
    hdrlen = header_length(t)
    if hdrlen == 0:
        order = "<"
        t = struct.unpack("<27f", f)
        hdrlen = header_length(t)
    if hdrlen == 0:
        raise SyntaxError("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise AttributeError("'SpiderImageFile' object has no attribute "
                             "'stkoffset'")
    else:
        raise SyntaxError("inconsistent stack header values")
    return size, offset, "F;32BF" if order == ">" else "F;32F"


def decode_spider(buf: bytes, name: str = "SPIDER"):
    """(array, mode, info) of a SPIDER file's bytes."""
    (w, h), offset, rawmode = pil_open(_open, buf, name, SpiderError)
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(w, h, name)
    try:
        return pil_raw.load(buf, offset, "F", rawmode, (w, h),
                            name=name), "F", {}
    except pil_raw.RawError as e:
        raise SpiderError(str(e)) from None


def read_spider_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a SPIDER
    file."""
    with open(path, "rb") as f:
        return decode_spider(f.read(), path)
