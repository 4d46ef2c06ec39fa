"""McIdas area reader, as ``np.asarray(PIL.Image.open(path))`` and
``im.mode`` give it (Pillow 12's McIdasImagePlugin): a 256-byte directory
of 64 big-endian signed words after the magic ``\\0\\0\\0\\0\\0\\0\\0\\4``;
word 11 is the bytes a pixel (1: L, 2: I;16B, 4: I from big-endian
words), words 10 and 9 the size, and the raw rows start at words 34 + 15
with a stride of word 15 + width * word 11 * word 14. L and I;16B are
mapped as PIL maps them (a stride below a row's bytes overlaps rows;
a file shorter than height strides is decoded instead).
"""

from __future__ import annotations

import struct

from . import pil_raw
from .image import NotThisFormat, check_size

MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


class McIdasError(ValueError):
    pass


def decode_mcidas(buf: bytes, name: str = "MCIDAS"):
    """(array, mode, info) of a McIdas area file's bytes."""
    s = buf[:256]
    if not s.startswith(b"\0\0\0\0\0\0\0\4") or len(s) != 256:
        raise NotThisFormat(f"{name}: not an McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    if w[11] not in MODES:
        raise NotThisFormat(f"{name}: unsupported McIdas format")
    mode, rawmode = MODES[w[11]]
    size = w[10], w[9]
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(*size, name)
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    try:
        return pil_raw.load(buf, offset, mode, rawmode, size, stride,
                            name=name), mode, {}
    except pil_raw.RawError as e:
        raise McIdasError(str(e)) from None


def read_mcidas_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a McIdas
    area file."""
    with open(path, "rb") as f:
        return decode_mcidas(f.read(), path)
