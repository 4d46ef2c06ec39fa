"""Intel DCX reader, as ``np.asarray(PIL.Image.open(path))``, ``im.mode``
and ``im.getpalette()`` give it (Pillow 12's DcxImagePlugin): the magic
0x3ADE68B1, a table of up to 1,024 little-endian frame offsets ended by a
zero, and the first frame read as PCX (utils/pcx.py) at its offset, its
256-colour palette still the file's last 769 bytes. A cut table or no
frame hands the file on, as PIL does.
"""

from __future__ import annotations

import struct

from . import pcx
from .image import NotThisFormat

MAGIC = 0x3ADE68B1


def decode_dcx(buf: bytes, name: str = "DCX"):
    """(array, mode, info) of a DCX file's bytes."""
    if len(buf) < 4 or struct.unpack_from("<I", buf)[0] != MAGIC:
        raise NotThisFormat(f"{name}: not a DCX file")
    offsets = []
    for i in range(1024):
        at = 4 + 4 * i
        if len(buf) < at + 4:
            raise NotThisFormat(f"{name}: cut offset table")
        offset = struct.unpack_from("<I", buf, at)[0]
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise NotThisFormat(f"{name}: attempt to seek outside sequence")
    return pcx.decode_pcx(buf, name, base=offsets[0])


def read_dcx_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a DCX
    file."""
    with open(path, "rb") as f:
        return decode_dcx(f.read(), path)
