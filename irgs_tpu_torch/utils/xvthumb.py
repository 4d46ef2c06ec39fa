"""XV thumbnail reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.getpalette()`` give it (Pillow 12's
XVThumbImagePlugin): ``P7 332``, comment lines, a ``w h ...`` line, then
P pixels raw (mapped as PIL maps them) over the 3-3-2 palette PIL builds
(red r * 255 // 7, green g * 255 // 7, blue b * 255 // 3). The file ends
in the comments: handed on; a size line PIL cannot split or make numbers
of raises XvThumbError.
"""

from __future__ import annotations

import io

import numpy as np

from . import pil_raw
from .image import NotThisFormat, check_size, pil_open

_R, _G, _B = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                         indexing="ij")
PALETTE = np.stack([_R * 255 // 7, _G * 255 // 7, _B * 255 // 3],
                   -1).reshape(256, 3).astype(np.uint8)


class XvThumbError(ValueError):
    pass


def _open(fp):
    if not fp.read(6).startswith(b"P7 332"):
        raise SyntaxError("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    return (int(w), int(h)), fp.tell()


def decode_xvthumb(buf: bytes, name: str = "XVThumb"):
    """(array, mode, info) of an XV thumbnail's bytes (info: the 3-3-2
    palette)."""
    (w, h), offset = pil_open(_open, io.BytesIO(buf), name, XvThumbError)
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(w, h, name)
    try:
        arr = pil_raw.load(buf, offset, "P", "P", (w, h), name=name)
    except pil_raw.RawError as e:
        raise XvThumbError(str(e)) from None
    return arr, "P", {"palette": PALETTE.copy()}


def read_xvthumb_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an XV
    thumbnail."""
    with open(path, "rb") as f:
        return decode_xvthumb(f.read(), path)
