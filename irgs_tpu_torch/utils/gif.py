"""GIF reader: the first frame, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info``'s palette and transparency give it (Pillow
12's GifImagePlugin with its default loading strategy).

The frame's palette is its local one, else the global one; a palette
whose entries are all the grey ramp 0, 1, 2, ... counts as none. With a
palette the image is "P", without one "L"; either way ``np.asarray``
gives the indices (a frame whose local palette is the ramp keeps the
global palette, which ``convert("RGB")`` then uses). The canvas is the
logical screen, grown to the frame
where the frame reaches past it, filled with the frame's transparency
index where its graphic control extension gives one (``info
["transparency"]``), else 0. The LZW data (csrc/lzw_decode.cpp,
gif_lzw_decode: Pillow's GifDecode.c) fills the frame's rectangle, its
rows in the four interlace passes where the frame is interlaced. A frame
whose data ends, or whose END code comes, before its last pixel is
refused, as PIL refuses it (image file is truncated); so is a broken code.

Streams PIL refuses raise GifError; GifHeaderError (a NotThisFormat) where
PIL's _open fails and Image.open tries the next plugin: everything before
the first frame's LZW data.
"""

from __future__ import annotations

import struct

import numpy as np

from . import lzw
from .image import NotThisFormat, check_size


class GifError(ValueError):
    pass


class GifHeaderError(GifError, NotThisFormat):
    """PIL's GifImageFile._open, which reads up to the first frame's LZW
    code size, fails with SyntaxError, EOFError, IndexError or
    struct.error: Image.open tries the next plugin."""


def _palette(p: bytes):
    """PIL's _is_palette_needed: the palette [n, 3], or None where every
    entry i is (i, i, i)."""
    if len(p) % 3:
        raise GifHeaderError("truncated palette")
    a = np.frombuffer(p, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(a)).astype(np.uint8)[:, None]
    if len(a) <= 256 and np.array_equal(a, np.broadcast_to(ramp, a.shape)):
        return None
    return a.copy()


def _blocks(buf: bytes, pos: int):
    """Data sub-blocks from `pos` -> (their bytes, position after the
    terminator); only whole blocks count, as in Pillow's decoder."""
    out = bytearray()
    n = len(buf)
    while pos < n:
        size = buf[pos]
        if size == 0:
            return bytes(out), pos + 1
        if pos + 1 + size > n:
            break
        out += buf[pos + 1:pos + 1 + size]
        pos += 1 + size
    return bytes(out), n


def decode_gif(buf: bytes, name: str = "GIF"):
    """(array, mode, info) of a GIF file's bytes: its first frame."""
    if not buf.startswith((b"GIF87a", b"GIF89a")) or len(buf) < 13:
        raise GifHeaderError(f"{name}: not a GIF file")
    sw, sh = struct.unpack_from("<HH", buf, 6)
    flags = buf[10]
    pos = 13
    info = {}
    global_pal = None
    if flags & 128:
        info["background"] = buf[11]
        p = buf[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        global_pal = _palette(p)
    frame_pal, transparency, frame = None, None, None
    while pos < len(buf):
        s = buf[pos]
        pos += 1
        if s == 0x3B:                                   # trailer
            break
        if s == 0x21:                                   # extension
            if pos >= len(buf):
                break
            label = buf[pos]
            size = buf[pos + 1] if pos + 1 < len(buf) else 0
            first = buf[pos + 2:pos + 2 + size] if size else None
            pos += 2 + size
            if label == 0xF9 and first is not None and first[0] & 1:
                if len(first) < 4:
                    raise GifHeaderError(f"{name}: short graphic "
                                         f"control extension")
                transparency = first[3]
            if label != 0xFE or first is not None:
                # PIL reads on to an empty block, even after an empty
                # first block (but not after an empty comment)
                _, pos = _blocks(buf, pos)
        elif s == 0x2C:                                 # image descriptor
            if pos + 9 > len(buf):
                raise GifHeaderError(f"{name}: truncated image "
                                     f"descriptor")
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", buf, pos)
            pos += 9
            interlace = bool(fflags & 64)
            if fflags & 128:
                p = buf[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += len(p)
                frame_pal = _palette(p)
                if frame_pal is None:
                    frame_pal = False
            if pos >= len(buf):
                raise GifHeaderError(f"{name}: no LZW code size")
            bits = buf[pos]
            pos += 1
            frame = (x0, y0, fw, fh, interlace, bits, pos)
            break
    if frame is None:
        raise GifHeaderError(f"{name}: image not found in GIF frame")
    x0, y0, fw, fh, interlace, bits, pos = frame
    pal = frame_pal if frame_pal is not None else global_pal
    mode = "P" if pal is not None and pal is not False else "L"
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    try:
        check_size(w, h, name)
    except NotThisFormat as err:
        raise GifHeaderError(str(err)) from None
    if bits > 12:
        raise GifError(f"{name}: decoder configuration error (LZW code "
                       f"size {bits})")
    canvas = np.full((h, w), transparency or 0, np.uint8)
    if fw and fh:
        data, _ = _blocks(buf, pos)
        out, got, status = lzw.gif_lzw(data, bits, fw * fh)
        if status == -1:
            raise GifError(f"{name}: broken LZW data")
        if got < fw * fh:
            raise GifError(f"{name}: image file is truncated")
        rows = out.reshape(fh, fw)
        if interlace:
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                    np.arange(2, fh, 4), np.arange(1, fh, 2)])
            placed = np.empty_like(rows)
            placed[order] = rows
            rows = placed
        canvas[y0:y0 + fh, x0:x0 + fw] = rows
    if transparency is not None:
        info["transparency"] = transparency
    if mode == "P":
        info["palette"] = pal
    elif frame_pal is False and global_pal is not None:
        # PIL keeps the global palette on the "L" image, and its
        # convert("RGB") looks the indices up in it
        info["palette"] = global_pal
    return canvas, mode, info


def read_gif_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a GIF."""
    with open(path, "rb") as f:
        return decode_gif(f.read(), path)
