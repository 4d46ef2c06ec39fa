"""Autodesk FLI/FLC reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.getpalette()`` give it (Pillow 12's FliImagePlugin):
the first frame, mode P.

The 128-byte header (magic 0xAF11 or 0xAF12, flags 0 or 3, the zeroed
reserved fields PIL checks) gives the size and the frame count (0 frames
hand the file on). The palette starts as the grey ramp; the first frame
chunk's first COLOR_256 (type 4) or COLOR_64 (type 11, each value
shifted left 2 and kept modulo 256) sub-chunk overwrites the entries its
packets reach (a skip count, then up to 256 colours), after a prefix
chunk (0xF100) that _open skips. The pixels are decoded as PIL's load
drives FliDecode.c (csrc/small_decode.cpp: BRUN, COPY, BLACK, LC, SS2
and PSTAMP chunks over a zeroed image, reads of the frame's size) from
byte 128, where PIL looks for the frame even past a prefix chunk (whose
type then fails the decoder).

Header errors PIL's _open hands on (a short chunk, a palette packet
past the 256th entry) hand the file on; decoder errors raise FliError.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from . import small_codecs
from .image import NotThisFormat, check_size, pil_open


class FliError(ValueError):
    pass


def _i16(b, at=0):
    return struct.unpack_from("<H", b, at)[0]


def _i32(b, at=0):
    return struct.unpack_from("<I", b, at)[0]


def _palette(fp, palette, shift):
    i = 0
    for _ in range(_i16(fp.read(2))):
        s = fp.read(2)
        i = i + s[0]
        n = s[1] or 256
        s = fp.read(n * 3)
        for k in range(0, len(s), 3):
            palette[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1


def _open(fp):
    s = fp.read(128)
    if not (len(s) >= 16 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3) and s[20:22] == b"\0\0"
            and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    n_frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _i16(s, 4) == 0xF100:
        fp.seek(128 + _i32(s))
        s = fp.read(16)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                fp.seek(chunk_size - 6, os.SEEK_CUR)
            s = fp.read(6)
            chunk_type = _i16(s, 4)
            if chunk_type in (4, 11):
                _palette(fp, palette, 2 if chunk_type == 11 else 0)
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    if n_frames == 0:
        raise EOFError("attempt to seek outside sequence")
    fp.seek(128)
    s = fp.read(4)
    if not s:
        raise EOFError("missing frame size")
    return size, palette, _i32(s)


def decode_fli(buf: bytes, name: str = "FLI"):
    """(array, mode, info) of an FLI/FLC file's bytes (info: the palette,
    uint8 [256, 3])."""
    (w, h), palette, framesize = pil_open(_open, io.BytesIO(buf), name,
                                          FliError)
    check_size(w, h, name)
    info = {"palette": np.array(palette, np.int64).astype(np.uint8)}
    try:
        img = small_codecs.fli(buf[128:], framesize, w, h,
                               np.zeros((h, w), np.uint8))
    except small_codecs.SmallCodecError as e:
        raise FliError(f"{name}: {e}") from None
    return img, "P", info


def read_fli_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an FLI or
    FLC file."""
    with open(path, "rb") as f:
        return decode_fli(f.read(), path)
