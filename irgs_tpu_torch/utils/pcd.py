"""Kodak PhotoCD reader, as ``np.asarray(PIL.Image.open(path))`` and
``im.mode`` give it (Pillow 12's PcdImagePlugin): the 768x512 base image
at byte 196,608 (sector 96), RGB, decoded as PcdDecode.c with the YCC;P
unpacker (csrc/small_decode.cpp: each pair of rows is two luma rows and
the two chroma rows they share, PhotoYCC to RGB through UnpackYCC.c's
tables), then turned a quarter to the left at orientation 1 and to the
right at orientation 3 (byte 3,586 & 3). A file without ``PCD_`` at byte
2,048 or shorter than 3,587 bytes hands the file on; one that ends before
the 589,824 bytes of the image raises PcdError ("image file is
truncated").
"""

from __future__ import annotations

import numpy as np

from . import small_codecs
from .image import NotThisFormat

OFFSET = 96 * 2048


class PcdError(ValueError):
    pass


def decode_pcd(buf: bytes, name: str = "PCD"):
    """(array, mode, info) of a PhotoCD file's bytes."""
    s = buf[2048:2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:
        raise NotThisFormat(f"{name}: not a PCD file")
    orientation = s[1538] & 3
    try:
        rgb = small_codecs.pcd(buf[OFFSET:], 768, 512)
    except small_codecs.SmallCodecError as e:
        raise PcdError(f"{name}: {e}") from None
    if orientation in (1, 3):
        rgb = np.ascontiguousarray(np.rot90(rgb, 1 if orientation == 1
                                            else 3))
    return rgb, "RGB", {}


def read_pcd_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a PhotoCD
    file."""
    with open(path, "rb") as f:
        return decode_pcd(f.read(), path)
