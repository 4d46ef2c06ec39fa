"""Windows Paint (MSP) reader, as ``np.asarray(PIL.Image.open(path))`` and
``im.mode`` give it (Pillow 12's MspImagePlugin): mode "1" from a 32-byte
header whose sixteen little-endian words XOR to 0. Version 1 (``DanM``)
holds the rows raw; version 2 (``LinS``) a row map of one 16-bit length
a row and then each row's runs, decoded as PIL's Python MspDecoder does
(csrc/small_decode.cpp: a 0 byte, a count and a value repeat the value;
any other byte is a count of literal bytes; an empty row is white) with
the rows' bytes concatenated unaligned and read as the raw "1" image.

A bad signature or checksum hands the file to the next plugin; a short
row map, a cut or corrupt row and too little data raise MspError.
"""

from __future__ import annotations

import struct

from . import pil_raw, small_codecs
from .image import NotThisFormat, check_size


class MspError(ValueError):
    pass


def decode_msp(buf: bytes, name: str = "MSP"):
    """(array, mode, info) of an MSP file's bytes."""
    s = buf[:32]
    if not s.startswith((b"DanM", b"LinS")):
        raise NotThisFormat(f"{name}: not an MSP file")
    if len(s) < 32:
        raise NotThisFormat(f"{name}: short MSP header")
    checksum = 0
    for v in struct.unpack("<16H", s):
        checksum ^= v
    if checksum:
        raise NotThisFormat(f"{name}: bad MSP checksum")
    w, h = struct.unpack_from("<HH", s, 4)
    check_size(w, h, name)
    try:
        if s.startswith(b"DanM"):
            return pil_raw.load(buf, 32, "1", "1", (w, h), name=name), "1", {}
        rowmap = buf[32:32 + 2 * h]
        if len(rowmap) < 2 * h:
            raise MspError(f"{name}: Truncated MSP file in row map")
        stride = (w + 7) // 8
        data = small_codecs.msp_rle(buf[32 + 2 * h:], struct.unpack(
            f"<{h}H", rowmap), stride, stride * h)
        if len(data) < stride * h:
            raise MspError(f"{name}: not enough image data")
        return pil_raw.load(data, 0, "1", "1", (w, h), name=name), "1", {}
    except (pil_raw.RawError, small_codecs.SmallCodecError) as e:
        raise MspError(f"{name}: {e}") from None


def read_msp_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an MSP
    file."""
    with open(path, "rb") as f:
        return decode_msp(f.read(), path)
