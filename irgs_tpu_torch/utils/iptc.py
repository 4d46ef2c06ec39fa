"""IPTC/NAA reader, as ``np.asarray(PIL.Image.open(path))`` and ``im.mode``
give it (Pillow 12's IptcImagePlugin).

The file is fields of ``0x1C, record, tag, size`` (a size of 128 and
above counts the bytes of a longer size; above 132 raises): _open reads
them up to the first (8, 10) field or a zeroed one. (3, 60) gives the
layers and whether they are components: L for one layer without,
RGB for 3 with, CMYK for 4 with; (3, 65) the band that the image fills
(1-based); (3, 20) and (3, 30) the size; (3, 120) the compression (1
raw, 5 JPEG; another raises). Load joins the (8, 10) fields into one
stream, with a P5 header of the size in front of raw data, and opens it
again as Image.open does (`image._open`, every plugin); an RGB or CMYK
image takes it as its one band, the others zero.

Fields PIL's _open fails on in a way it hands on (a bad marker, a
missing field, no mode, no size) hand the file on; a missing image
stream and load errors raise IptcError.
"""

from __future__ import annotations

import io
import os
import struct
import tempfile

import numpy as np

from .image import (NotThisFormat, UnreadableImageError, check_size,
                    open_like_pil, pil_open)

COMPRESSION = {1: "raw", 5: "jpeg"}


class IptcError(ValueError):
    pass


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp):
    s = fp.read(5)
    if not s.strip(b"\0"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(fp.read(size - 128))
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _open(fp):
    info = {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        data = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(data)
            else:
                info[tag] = [info[tag], data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    key = _i(info[(3, 120)])
    if key not in COMPRESSION:
        raise OSError("Unknown IPTC image compression")
    return mode, size, COMPRESSION[key], band, (
        offset if tag == (8, 10) else None)


def decode_iptc(buf: bytes, name: str = "IPTC"):
    """(array, mode, info) of an IPTC/NAA file's bytes."""
    fp = io.BytesIO(buf)
    mode, (w, h), compression, band, offset = pil_open(_open, fp, name,
                                                       IptcError)
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(w, h, name)
    if offset is None:
        raise IptcError(f"{name}: cannot load this image")
    fp.seek(offset)
    out = io.BytesIO()
    if compression == "raw":
        out.write(b"P5\n%d %d\n255\n" % (w, h))
    try:
        while True:
            tag, size = _field(fp)
            if tag != (8, 10):
                break
            out.write(fp.read(size))
    except Exception as e:              # PIL's load raises them all
        raise IptcError(f"{name}: {e!r}") from None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "iptc")
        with open(path, "wb") as f:
            f.write(out.getvalue())
        try:
            arr, inner, _ = open_like_pil(path)
        except Exception as e:           # Image.open(o) of the stream fails
            raise IptcError(f"{name}: {e!r}") from None
    if arr.shape[:2] != (h, w):
        raise UnreadableImageError(
            f"{name}: IPTC is not ported where the stream's size "
            f"{arr.shape[1]}x{arr.shape[0]} is not the fields' {w}x{h} (PIL "
            f"then reads past its pixels)")
    if band is None:
        if inner != mode:
            raise UnreadableImageError(f"{name}: IPTC is not ported for a "
                                       f"{inner} stream in an {mode} image")
        return arr, mode, {}
    if inner != "L":
        raise IptcError(f"{name}: mode mismatch ({inner} into band {band} "
                        f"of {mode})")
    bands = np.zeros((h, w, len(mode)), np.uint8)
    try:
        bands[..., band] = arr
    except IndexError:
        raise IptcError(f"{name}: band {band} of {mode}") from None
    return bands, mode, {}


def read_iptc_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an
    IPTC/NAA file."""
    with open(path, "rb") as f:
        return decode_iptc(f.read(), path)
