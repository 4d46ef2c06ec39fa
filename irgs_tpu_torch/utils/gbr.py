"""GIMP brush (GBR) reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info`` give it (Pillow 12's GbrImagePlugin and its
own load): a big-endian header of at least 20 bytes, version 1 or 2
(version 2: the magic ``GIMP`` and ``info["spacing"]``), a size and 1
(L) or 4 (RGBA) bytes a pixel; ``info["comment"]`` is the rest of the
header without its last byte (a header size below the fields reads the
whole file as the comment, as PIL's read of a negative count does). The
pixels follow the header; fewer than the image needs raise GbrError
("not enough image data"). A header PIL's _open refuses hands the file
on.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from .image import NotThisFormat, check_size, pil_open


class GbrError(ValueError):
    pass


def _i32(fp):
    return struct.unpack(">I", fp.read(4))[0]


def _open(fp):
    header_size = _i32(fp)
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = _i32(fp)
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    width, height, depth = _i32(fp), _i32(fp), _i32(fp)
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    info = {}
    if version == 1:
        comment_length = header_size - 20
    else:
        comment_length = header_size - 28
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        info["spacing"] = _i32(fp)
    info["comment"] = fp.read(comment_length)[:-1]
    return (width, height), depth, info, fp.tell()


def decode_gbr(buf: bytes, name: str = "GBR"):
    """(array, mode, info) of a GIMP brush file's bytes."""
    (w, h), depth, info, at = pil_open(_open, io.BytesIO(buf), name,
                                       GbrError)
    check_size(w, h, name)
    data = buf[at:at + w * h * depth]
    if len(data) < w * h * depth:
        raise GbrError(f"{name}: not enough image data")
    arr = np.frombuffer(data, np.uint8)
    mode = "L" if depth == 1 else "RGBA"
    return (arr.reshape(h, w) if depth == 1 else arr.reshape(h, w, 4)
            ).copy(), mode, info


def read_gbr_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a GIMP
    brush."""
    with open(path, "rb") as f:
        return decode_gbr(f.read(), path)
