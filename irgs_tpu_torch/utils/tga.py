"""Targa reader, as ``np.asarray(PIL.Image.open(path))``, ``im.mode`` and
``im.getpalette()`` give it (Pillow 12's TgaImagePlugin).

Image types 1 and 9 (colour-mapped: mode P, or L without a map), 2 and 10
(true colour: RGB at 24 bits, else RGBA), 3 and 11 (grey: "1" at 1 bit,
LA at 16, else L); depths 1, 8, 16, 24 and 32. A 16-bit pixel reads as
PIL's "BGRA;15Z": each 5-bit channel widened as v * 255 // 31, alpha 255
where the top bit is clear and 0 where it is set. Colour maps of 16, 24
(and, refused at load as by PIL, 32) bits start at their first index (the
entries before it are black); the ID field is skipped; the descriptor's
bit 5 puts the first row on top and bit 4 mirrors the rows. Run-length
data goes through TgaRleDecode (csrc/small_decode.cpp): a literal packet
may run on into the next row, a run packet may not.

A header PIL's _open refuses (short, a colour-map type other than 0 and
1, no size, another depth, type or map depth) hands the file to the next
plugin; streams PIL refuses at load raise TgaError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import small_codecs
from .image import NotThisFormat, bits_of, check_size

# (image type & 7, depth) -> PIL's raw mode
RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
            (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24,
        "BGRA": 32}


class TgaError(ValueError):
    pass


def _bgra15z(v: np.ndarray) -> np.ndarray:
    """Little-endian 16-bit words -> [..., 4] RGBA as PIL's BGRA;15Z."""
    v = v.astype(np.int32)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                     (v & 31) * 255 // 31,
                     np.where(v & 0x8000, 0, 255)], -1).astype(np.uint8)


def _unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    if rawmode == "1":
        return bits_of(rows, 1, w).astype(bool)
    if rawmode in ("P", "L"):
        return np.ascontiguousarray(rows[:, :w])
    if rawmode == "LA":
        return np.ascontiguousarray(rows[:, :2 * w].reshape(-1, w, 2))
    if rawmode == "BGRA;15Z":
        return _bgra15z(rows[:, :2 * w].copy().view("<u2"))
    n = len(rawmode)
    px = rows[:, :n * w].reshape(rows.shape[0], w, n)
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][:n]])


def decode_tga(buf: bytes, name: str = "TGA"):
    """(array, mode, info) of a Targa file's bytes (info: the palette of
    mode P, uint8 [n, 3])."""
    if len(buf) < 18:
        raise NotThisFormat(f"{name}: short Targa header")
    id_len, cmap_type, itype = buf[0], buf[1], buf[2]
    depth, flags = buf[16], buf[17]
    w, h = struct.unpack_from("<HH", buf, 12)
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 \
            or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat(f"{name}: not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat(f"{name}: unknown TGA mode")
    top = bool(flags & 0x20)
    mirror = bool(flags & 0x10)
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, map_depth = struct.unpack_from("<HHB", buf, 3)
        if map_depth not in (16, 24, 32):
            raise NotThisFormat(f"{name}: unknown TGA map depth")
        nb = map_depth // 8
        entries = buf[pos:pos + nb * size]
        pos += len(entries)
        palette = (map_depth, bytes(nb * start) + entries)
    check_size(w, h, name)
    rawmode = RAWMODES.get((itype & 7, depth))
    if rawmode is None:
        raise TgaError(f"{name}: cannot load this image (type {itype}, "
                       f"depth {depth})")
    if palette is not None:
        if mode not in ("P", "L", "LA"):
            raise TgaError(f"{name}: unrecognized image mode (a colour map "
                           f"on a {mode} image)")
        map_depth, pal = palette
        if map_depth == 32:
            raise TgaError(f"{name}: unrecognized raw mode (32-bit colour "
                           f"map)")
        n = len(pal) * 8 // map_depth
        if n > 256:
            raise TgaError(f"{name}: invalid palette size ({n})")
        if map_depth == 16:
            rgb = _bgra15z(np.frombuffer(pal[:2 * n], "<u2"))[:, :3]
        else:
            rgb = np.frombuffer(pal[:3 * n], np.uint8).reshape(n, 3)[:, ::-1]
        palette = np.ascontiguousarray(rgb)
    if mode == "L" and rawmode == "P":
        raise TgaError(f"{name}: unknown raw mode for given image mode "
                       f"(colour-mapped data without a colour map)")
    linebytes = (BITS[rawmode] * w + 7) // 8
    if itype & 8:
        # a packet yields at most 128 pixels: a stream too short for the
        # image fails before the lines are allocated
        if w * h > 128 * (len(buf) - pos):
            raise TgaError(f"{name}: image file is truncated")
        try:
            rows = small_codecs.tga_rle(buf[pos:], depth // 8, linebytes, h)
        except small_codecs.SmallCodecError as e:
            raise TgaError(f"{name}: {e}") from None
    else:
        data = buf[pos:pos + linebytes * h]
        if len(data) < linebytes * h:
            raise TgaError(f"{name}: image file is truncated")
        rows = np.frombuffer(data, np.uint8).reshape(h, linebytes)
    arr = _unpack(rows if top else rows[::-1], rawmode, w)
    if mirror:
        arr = arr[:, ::-1]
    info = {} if palette is None else {"palette": palette}
    return np.ascontiguousarray(arr), mode, info


def read_tga_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a Targa
    file."""
    with open(path, "rb") as f:
        return decode_tga(f.read(), path)
