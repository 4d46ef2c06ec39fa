"""SGI (Iris) reader, as ``np.asarray(PIL.Image.open(path))`` and
``im.mode`` give it (Pillow 12's SgiImagePlugin): the 512-byte header's
bytes per channel (1 or 2), dimension and channel count pick L, RGB or
RGBA (every entry of PIL's MODES; 16-bit channels keep their high byte, as
PIL's "L;16B" unpacker does); rows run bottom-up. Verbatim data is one
plane per channel; run-length data goes through SgiRleDecode
(csrc/small_decode.cpp) with its offset and length tables and its checks:
a row stops at its first zero count, a packet counter that reaches its
last byte on a nonzero one stops the decoder with no error (the rows not
reached stay 0), and the line buffer carries what a short row does not
write over from the row before.

A header shorter than its size fields, or a size of zero, hands the file
to the next plugin; streams PIL refuses raise SgiError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import small_codecs
from .image import NotThisFormat, check_size

# (bytes per channel, dimension, channels) -> PIL's raw mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
         (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


class SgiError(ValueError):
    pass


def decode_sgi(buf: bytes, name: str = "SGI"):
    """(array, mode, info) of an SGI file's bytes."""
    if len(buf) < 12 or buf[:2] != b"\x01\xda":
        raise NotThisFormat(f"{name}: not an SGI image file")
    compression, bpc = buf[2], buf[3]
    dimension, w, h, z = struct.unpack_from(">HHHH", buf, 4)
    rawmode = MODES.get((bpc, dimension, z))
    if rawmode is None:
        raise SgiError(f"{name}: Unsupported SGI image mode ({bpc} bytes, "
                       f"dimension {dimension}, {z} channels)")
    mode = rawmode.split(";")[0]
    check_size(w, h, name)
    bands = len(mode)
    if compression == 0:
        page = w * h * bpc
        planes = []
        for b in range(bands):
            data = buf[512 + b * page:512 + (b + 1) * page]
            if len(data) < page:
                raise SgiError(f"{name}: image file is truncated")
            v = np.frombuffer(data, np.uint8).reshape(h, w, bpc)[..., 0]
            planes.append(v[::-1])
        arr = planes[0] if bands == 1 else np.stack(planes, -1)
        return np.ascontiguousarray(arr), mode, {}
    if compression != 1:
        raise SgiError(f"{name}: cannot load this image (compression "
                       f"{compression})")
    if len(buf) - 512 < 8 * bands * h:
        raise SgiError(f"{name}: buffer overrun when reading image file")
    try:
        lines = small_codecs.sgi_rle(buf[512:], w, h, bands, bpc)
    except small_codecs.SmallCodecError as e:
        raise SgiError(f"{name}: {e}") from None
    v = lines.reshape(h, w, bands, bpc)[..., 0][::-1]
    arr = v[..., 0] if bands == 1 else v
    return np.ascontiguousarray(arr), mode, {}


def read_sgi_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an SGI
    file."""
    with open(path, "rb") as f:
        return decode_sgi(f.read(), path)
