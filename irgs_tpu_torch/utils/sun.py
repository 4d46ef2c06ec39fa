"""Sun raster reader, as ``np.asarray(PIL.Image.open(path))``, ``im.mode``
and ``im.getpalette()`` give it (Pillow 12's SunImagePlugin).

Depths 1 ("1", inverted bits), 4 (L, each nibble times 17), 8 (L), 24 and 32
(RGB; type 3 stores RGB(X), the others BGR(X)). A colour map of type 1 (at
most 1,024 bytes: the red, green and blue planes) makes an L image P; on a
1-, 24- or 32-bit image PIL's load refuses it. Rows are padded to 16 bits in
the raw layouts (types 0, 1, 3, 4, 5); type 2 is Sun's RLE (SunRleDecode in
csrc/small_decode.cpp: 0x80 0 is a literal 0x80, 0x80 n v a run of n + 1
that carries on into the next lines), whose lines are the unpacker's bytes,
unpadded. The header's data length is ignored.

An unknown depth, a colour map type other than 1, a colour map over
1,024 bytes or an unknown type hand the file to the next plugin, as
PIL's SyntaxError does; load errors raise SunError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import pil_raw, small_codecs
from .image import NotThisFormat, check_size

MAGIC = 0x59A66A95


class SunError(ValueError):
    pass


def decode_sun(buf: bytes, name: str = "SUN"):
    """(array, mode, info) of a Sun raster file's bytes (info: the palette
    of mode P, uint8 [n, 3])."""
    s = buf[:32]
    if len(s) < 4 or struct.unpack_from(">I", s)[0] != MAGIC:
        raise NotThisFormat(f"{name}: not an SUN raster file")
    if len(s) < 32:
        raise NotThisFormat(f"{name}: short Sun raster header")
    (w, h, depth, _, file_type, palette_type,
     palette_length) = struct.unpack_from(">7I", s, 4)
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth in (24, 32):
        mode = "RGB"
        rawmode = ("RGB" if file_type == 3 else "BGR") + (
            "X" if depth == 32 else "")
    else:
        raise NotThisFormat(f"{name}: Unsupported Mode/Bit Depth")
    offset, info = 32, {}
    if palette_length:
        if palette_length > 1024:
            raise NotThisFormat(f"{name}: Unsupported Color Palette Length")
        if palette_type != 1:
            raise NotThisFormat(f"{name}: Unsupported Palette Type")
        offset += palette_length
        raw = np.frombuffer(buf[32:32 + palette_length], np.uint8)
        n = len(raw) // 3               # "RGB;L": three planes
        info["palette"] = np.ascontiguousarray(
            raw[:3 * n].reshape(3, n).T)
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"{name}: Unsupported Sun Raster file type")
    check_size(w, h, name)
    if "palette" in info and mode != "P":
        raise SunError(f"{name}: a colour map on a {mode} image (PIL's "
                       f"putpalette refuses the mode)")
    try:
        if file_type == 2:
            bits = pil_raw.BITS[mode, rawmode]
            rows = small_codecs.sun_rle(buf[offset:], (w * bits + 7) // 8, h)
            return pil_raw.unpack(rows, mode, rawmode, w), mode, info
        stride = ((w * depth + 15) // 16) * 2
        return pil_raw.load(buf, offset, mode, rawmode, (w, h), stride,
                            maps=False, name=name), mode, info
    except (pil_raw.RawError, small_codecs.SmallCodecError) as e:
        raise SunError(f"{name}: {e}") from None


def read_sun_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a Sun
    raster file."""
    with open(path, "rb") as f:
        return decode_sun(f.read(), path)
