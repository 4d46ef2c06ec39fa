"""PCX reader, as ``np.asarray(PIL.Image.open(path))``, ``im.mode`` and
``im.getpalette()`` give it (Pillow 12's PcxImagePlugin).

Layouts: 1 bit in one plane (mode "1"); 1 bit in 2 or 4 planes (mode P,
PIL's "P;2L"/"P;4L", the 16-colour header palette); version 5 at 8 bits in
one plane (L, or P where the file ends in a 769-byte palette that is not
the grey ramp; PIL seeks 769 bytes back from the end, so a shorter file is
refused) and in three planes (RGB, "RGB;L"). The size is the header's
bounding box; each plane's stride is the least that holds a row, made even
where the header gives another. The run-length data goes through
PcxDecode (csrc/small_decode.cpp), which compacts a line whose planes are
padded as PIL does.

A header PIL's _open refuses (short, an empty bounding box) hands the file
to the next plugin; streams PIL refuses raise PcxError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import small_codecs
from .image import NotThisFormat, bits_of, check_size

# raw mode -> bits a pixel as PIL's unpacker counts them
BITS = {"1": 1, "L": 8, "P": 8, "P;2L": 2, "P;4L": 4, "RGB;L": 24}


class PcxError(ValueError):
    pass


def _unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    if rawmode == "1":
        return bits_of(rows, 1, w).astype(bool)
    if rawmode in ("L", "P"):
        return np.ascontiguousarray(rows[:, :w])
    if rawmode == "RGB;L":
        return np.stack([rows[:, i * w:(i + 1) * w] for i in range(3)], -1)
    # each bit plane at its padded stride (what PIL's P;2L and P;4L read)
    planes = int(rawmode[2])
    stride = rows.shape[1] // planes
    out = np.zeros((rows.shape[0], w), np.uint8)
    for i in range(planes):
        out |= bits_of(rows[:, i * stride:(i + 1) * stride], 1, w).astype(
            np.uint8) << i
    return out


def decode_pcx(buf: bytes, name: str = "PCX", base: int = 0):
    """(array, mode, info) of a PCX file's bytes, its header at `base` (a
    DCX file's first frame; the 769-byte palette is still the file's last
    bytes) (info: the palette of mode P, uint8 [n, 3])."""
    s = buf[base:base + 68]
    if len(s) < 2 or s[0] != 10 or s[1] not in (0, 2, 3, 5) or len(s) < 12:
        raise NotThisFormat(f"{name}: not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat(f"{name}: bad PCX image size")
    if len(s) < 68:
        raise NotThisFormat(f"{name}: short PCX header")
    version, bits, planes = s[1], s[3], s[65]
    given_stride = struct.unpack_from("<H", s, 66)[0]
    info = {}
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        info["palette"] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        if len(buf) < 769:
            raise PcxError(f"{name}: the 769-byte palette would start before "
                           f"the file")
        tail = buf[-769:]
        if tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode = rawmode = "P"
                info["palette"] = pal.copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise PcxError(f"{name}: unknown PCX mode (version {version}, bits "
                       f"{bits}, planes {planes})")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    check_size(w, h, name)
    # a run packet yields at most 63 bytes: too short a stream fails before
    # the lines are allocated
    if planes * stride * h > 63 * (len(buf) - base - 128):
        raise PcxError(f"{name}: image file is truncated")
    try:
        rows = small_codecs.pcx(buf[base + 128:], w, BITS[rawmode],
                                planes * stride, h)
    except small_codecs.SmallCodecError as e:
        raise PcxError(f"{name}: {e}") from None
    return _unpack(rows, rawmode, w), mode, info


def read_pcx_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a PCX
    file."""
    with open(path, "rb") as f:
        return decode_pcx(f.read(), path)
