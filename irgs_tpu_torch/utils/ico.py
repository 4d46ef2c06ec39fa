"""Windows icon and cursor readers, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.getpalette()`` give them (Pillow 12's
IcoImagePlugin and CurImagePlugin).

ICO: PIL sorts the directory by colour depth and then, stably, by area,
largest first, and reads the first entry: the largest frame, of the lowest
depth among frames of that size. A frame is a PNG stream (utils/png.py,
read to its end whatever the entry's size says) or a DIB (utils/bmp.py)
whose height counts the AND mask too: the first half of its rows is the
image, converted to RGBA; the alpha is the fourth byte of each pixel where
the entry says 32 bits, else the AND mask, read from the end of the
entry's data (1 is transparent). A frame's size, not the entry's, is the
image's.

CUR: the first entry, or a later one wider and taller in its first two
bytes; its bitmap (no AND mask) is half the height its header says, 32-bit
pixels with their alpha where the bitmap sits at offset 22.

A directory PIL's _open refuses (short, empty, a frame without a size)
hands the file to the next plugin; streams PIL refuses at load raise
IcoError, BmpError or PngError.
"""

from __future__ import annotations

import struct
from math import ceil, log

import numpy as np

from . import bmp, png
from .image import NotThisFormat, bits_of, check_size, to_rgb_like_pil


class IcoError(ValueError):
    pass


def _entries(buf: bytes, name: str):
    """IcoFile's directory, sorted as PIL sorts it: dicts of width, height,
    bpp, size, offset and colour depth."""
    if len(buf) < 6:
        raise NotThisFormat(f"{name}: short ICO header")
    count = struct.unpack_from("<H", buf, 4)[0]
    out = []
    for i in range(count):
        s = buf[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat(f"{name}: short ICO directory")
        w, h, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (nb_color != 0 and ceil(log(nb_color, 2))) or 256
        out.append(dict(w=w, h=h, bpp=bpp, size=size, offset=offset,
                        depth=depth, square=w * h))
    out = sorted(out, key=lambda e: e["depth"])
    return sorted(out, key=lambda e: e["square"], reverse=True)


def _png_frame(buf: bytes, at: int, name: str):
    arr, mode, info = png.decode_png_like_pil(buf[at:], name)
    return arr, mode, {"palette": info["palette"]} if mode == "P" else {}


def _mask(buf: bytes, at: int, n: int, need: int, name: str) -> bytes:
    """n bytes from `at`, of which the first `need` must be there (a raw
    decode stops before the last row's padding); the rest reads as 0."""
    if at < 0:
        raise IcoError(f"{name}: negative seek to the AND mask")
    data = buf[at:at + n]
    if len(data) < need:
        raise IcoError(f"{name}: not enough image data (mask)")
    return data.ljust(n, b"\0")


def _bmp_frame(buf: bytes, e: dict, name: str):
    bm = bmp._bitmap(buf, e["offset"], 0, name)
    check_size(bm["w"], bm["h"], name)
    w, h = bm["w"], int(bm["h"] / 2)
    if e["bpp"] == 32:
        alpha = _mask(buf, bm["data"], w * h * 4, w * h * 4, name)[3::4]
        a = np.frombuffer(alpha, np.uint8).reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32) % 32
        total = int(wp * h / 8)
        data = _mask(buf, e["offset"] + e["size"] - total, total,
                     total - wp // 8 + (w + 7) // 8, name)
        rows = np.frombuffer(data, np.uint8).reshape(h, wp // 8)[::-1]
        a = np.where(bits_of(rows, 1, w), 0, 255).astype(np.uint8)
    if h <= 0:
        raise IcoError(f"{name}: tile cannot extend outside image")
    arr = bmp._load(buf, bm, h, name)
    rgb = to_rgb_like_pil(arr, bm["mode"], bm["info"].get("palette"))
    return np.concatenate([rgb, a[..., None]], -1), "RGBA", {}


def decode_ico(buf: bytes, name: str = "ICO"):
    """(array, mode, info) of an icon file's bytes (info: the palette of a
    PNG frame of mode P)."""
    entries = _entries(buf, name)
    if not entries:
        raise NotThisFormat(f"{name}: no icons in the directory")
    e = entries[0]
    if buf[e["offset"]:e["offset"] + 8] == b"\x89PNG\r\n\x1a\n":
        arr, mode, info = _png_frame(buf, e["offset"], name)
    else:
        arr, mode, info = _bmp_frame(buf, e, name)
    check_size(arr.shape[1], arr.shape[0], name)
    return arr, mode, info


def decode_cur(buf: bytes, name: str = "CUR"):
    """(array, mode, info) of a cursor file's bytes (info: the palette of
    mode P)."""
    if len(buf) < 6:
        raise NotThisFormat(f"{name}: short CUR header")
    count = struct.unpack_from("<H", buf, 4)[0]
    m, pos = b"", 6
    for _ in range(count):
        s = buf[pos:pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif not s or (s[0] > m[0] and min(len(s), len(m)) < 2):
            raise NotThisFormat(f"{name}: short CUR directory")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise NotThisFormat(f"{name}: No cursors were found")
    if len(m) < 16:
        raise NotThisFormat(f"{name}: short CUR entry")
    header = struct.unpack_from("<I", m, 12)[0]
    bm = bmp._bitmap(buf, header or pos, 0, name, header=header)
    h = bm["h"] // 2
    check_size(bm["w"], h, name)
    return bmp._load(buf, bm, h, name), bm["mode"], bm["info"]


def read_ico_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an icon."""
    with open(path, "rb") as f:
        return decode_ico(f.read(), path)


def read_cur_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a cursor."""
    with open(path, "rb") as f:
        return decode_cur(f.read(), path)
