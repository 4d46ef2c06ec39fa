"""X11 bitmap (XBM) reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info`` give it (Pillow 12's XbmImagePlugin): mode
"1" from the ``#define ..._width`` and ``_height`` lines (and an
``_x_hot``/``_y_hot`` pair, kept as ``info["hotspot"]``) that PIL's regular
expression finds in the first 512 bytes, up to the last ``_bits[]``
there. The pixels are the bytes written as the two characters after each
``x`` (XbmDecode in csrc/small_decode.cpp: a character that is not a hex
digit counts 0), least significant bit first, a set bit 1 (True).

A header the expression does not match hands the file to the next
plugin; data that ends first raises XbmError.
"""

from __future__ import annotations

import re

import numpy as np

from . import small_codecs
from .image import NotThisFormat, check_size

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")


class XbmError(ValueError):
    pass


def decode_xbm(buf: bytes, name: str = "XBM"):
    """(array, mode, info) of an XBM file's bytes."""
    m = HEAD.match(buf[:512])
    if not m:
        raise NotThisFormat(f"{name}: not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    info = {}
    if m.group("hotspot"):
        info["hotspot"] = (int(m.group("xhot")), int(m.group("yhot")))
    check_size(w, h, name)
    try:
        rows = small_codecs.xbm(buf[m.end():], (w + 7) // 8, h)
    except small_codecs.SmallCodecError as e:
        raise XbmError(f"{name}: {e}") from None
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return bits.astype(bool), "1", info


def read_xbm_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an XBM
    file."""
    with open(path, "rb") as f:
        return decode_xbm(f.read(), path)
