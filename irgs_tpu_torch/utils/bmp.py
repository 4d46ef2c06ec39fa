"""BMP reader, as ``np.asarray(PIL.Image.open(path))``, ``im.mode`` and
``im.info``'s palette give it (Pillow 12's BmpImagePlugin).

Headers: BITMAPCOREHEADER (12 bytes), BITMAPINFOHEADER (40) and its
V2-V5 extensions (52, 56, 64, 108, 124). Depths 1, 4 and 8 (palette), 16
(5-5-5, or 5-6-5 by bitfields), 24 and 32; BI_RGB, BI_RLE8, BI_RLE4 and
BI_BITFIELDS with the masks PIL takes. Rows bottom-up, or top-down where
the height is negative. As PIL reads them:

  - a palette whose entries are all grey ramps (0, 255 for two colours,
    else 0, 1, 2, ...) makes the image "1" or "L", whose rows PIL then
    unpacks at 1 or 8 bits whatever the file's depth;
  - a 32-bit BI_RGB file reads as RGB: its fourth byte is dropped;
  - 16-bit samples widen as v * 255 // 31 (or // 63);
  - run-length data goes through PIL's own decoder, kept here with its
    quirks (a delta reads two bytes it then ignores, an odd RLE4 absolute
    run loses its last pixel, the word alignment follows the file
    position, pixels no run reaches stay 0, too little data is refused).

`_bitmap` and `_load` are PIL's BmpImageFile._bitmap and its tile: the
BMP reader, the bare DIB (a BMP without its file header,
BmpImagePlugin's DibImageFile) and the icon and cursor frames of
utils/ico.py share them. A file cut in the last row's padding reads, as
PIL's raw decoder reads it.

Streams PIL refuses raise BmpError (BmpHeaderError, a NotThisFormat, where
PIL's _open meets the end of the header and PIL tries the next plugin).
"""

from __future__ import annotations

import struct

import numpy as np

from .image import NotThisFormat, bits_of, check_size


class BmpError(ValueError):
    pass


class BmpHeaderError(BmpError, NotThisFormat):
    """The header ends where PIL's _open meets the end of the data (a
    struct.error there): PIL tries the next plugin."""


_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """PIL's unpacker `rawmode` on [H, stride] row bytes."""
    if rawmode == "1":
        return bits_of(rows, 1, width).astype(bool)
    if rawmode in ("P;1", "P;4"):
        return bits_of(rows, int(rawmode[2]), width).astype(np.uint8)
    if rawmode in ("P", "L"):
        return np.ascontiguousarray(rows[:, :width])
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].view("<u2").astype(np.int32)
        g6 = rawmode == "BGR;16"
        r = (v >> (11 if g6 else 10)) & 31
        g = (v >> 5) & (63 if g6 else 31)
        b = v & 31
        return np.stack([r * 255 // 31, g * 255 // (63 if g6 else 31),
                         b * 255 // 31], -1).astype(np.uint8)
    n = len(rawmode)
    px = rows[:, :n * width].reshape(rows.shape[0], width, n)
    order = [rawmode.index(c) for c in "RGBA" if c in rawmode]
    return np.ascontiguousarray(px[..., order])


def _rle(buf: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """PIL's BmpRleDecoder: the indices in file row order, [h, w]."""
    need = w * h
    data = bytearray()
    x = 0
    n = len(buf)
    while len(data) < need:
        if pos + 2 > n:
            break
        count, byte = buf[pos], buf[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 0x0F])
                data += (pair * ((count + 1) // 2))[:count]
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:                        # end of line
            if len(data) % w:
                data += bytes(w - len(data) % w)
            x = 0
        elif byte == 1:                        # end of bitmap
            break
        elif byte == 2:                        # delta: two bytes read, unused
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise BmpError("not enough values to unpack (RLE delta)")
            right, up = buf[pos], buf[pos + 1]
            pos += 2
            data += bytes(right + up * w)
            x = len(data) % w
        else:                                  # absolute run
            take = byte // 2 if rle4 else byte
            got = buf[pos:pos + take]
            pos += len(got)
            if rle4:
                for b in got:
                    data += bytes([b >> 4, b & 0x0F])
            else:
                data += got
            if len(got) < take:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(data) < need:
        raise BmpError("not enough image data")
    return np.frombuffer(bytes(data[:need]), np.uint8).reshape(h, w)


def _bitmap(buf: bytes, start: int, offset: int, name: str,
            header: int = 0) -> dict:
    """BmpImageFile._bitmap on the bitmap header at `start` (a BMP's past its
    file header, a DIB's at 0, an icon frame's at its offset): the plan of
    PIL's tile (size, mode, raw mode, run-length flag, where the pixels
    start, row stride and direction, info). `offset` is a BMP's pixel
    offset (0: the pixels follow the header and palette); `header` is the
    offset PIL was asked to seek to (22: a cursor's one 32-bit frame,
    which PIL reads with its alpha)."""
    if start + 4 > len(buf):
        raise BmpHeaderError(f"{name}: short bitmap header")
    header_size = struct.unpack_from("<I", buf, start)[0]
    hd = buf[start + 4:start + header_size] if header_size > 4 else b""
    if len(hd) < header_size - 4:
        raise BmpError(f"{name}: truncated BMP header")
    pos = start + 4 + len(hd)
    direction = -1
    masks = None
    if header_size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", hd, 0)
        compression, padding, colors = RAW, 3, 0
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        direction = 1 if y_flip else -1
        w, hraw = struct.unpack_from("<II", hd, 0)
        h = 2 ** 32 - hraw if y_flip else hraw
        bits, compression = struct.unpack_from("<HI", hd, 10)
        colors = struct.unpack_from("<I", hd, 28)[0]
        padding = 4
        if compression == BITFIELDS:
            if len(hd) >= 48:
                m = list(struct.unpack_from("<III", hd, 36))
                m.append(struct.unpack_from("<I", hd, 48)[0]
                         if len(hd) >= 52 else 0)
            else:
                if pos + 12 > len(buf):
                    raise BmpHeaderError(f"{name}: truncated bitfield masks")
                m = list(struct.unpack_from("<III", buf, pos)) + [0]
                pos += 12
            masks = tuple(m)
    else:
        raise BmpError(f"{name}: unsupported BMP header type "
                       f"({header_size})")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise BmpError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, rawmode = _BIT2MODE[bits]
    if compression == BITFIELDS:
        if bits == 32 and (32, masks) in _MASK_MODES:
            rawmode = _MASK_MODES[(32, masks)]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits in (24, 16) and (bits, masks[:3]) in _MASK_MODES:
            rawmode = _MASK_MODES[(bits, masks[:3])]
        else:
            raise BmpError(f"{name}: unsupported BMP bitfields layout")
    elif compression == RAW:
        if bits == 32 and header == 22:
            rawmode, mode = "BGRA", "RGBA"
    elif compression not in (RLE8, RLE4):
        raise BmpError(f"{name}: unsupported BMP compression "
                       f"({compression})")
    info = {"compression": compression}
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise BmpError(f"{name}: unsupported BMP palette size ({colors})")
        pal = buf[pos:pos + padding * colors]
        pos += len(pal)
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            n = len(pal) // padding
            p = np.frombuffer(pal[:n * padding], np.uint8).reshape(n, padding)
            palette = np.ascontiguousarray(p[:, 2::-1])
    return dict(w=w, h=h, mode=mode, rawmode=rawmode, bits=bits,
                rle=None if compression not in (RLE8, RLE4)
                else compression == RLE4, data=offset or pos,
                stride=((w * bits + 31) >> 3) & ~3, direction=direction,
                info=info, palette=palette)


def _load(buf: bytes, bm: dict, h: int, name: str) -> np.ndarray:
    """The pixels of plan `bm` (from `_bitmap`), `h` rows, as PIL's tile
    decodes them; the palette, as PIL realizes it, into bm["info"]."""
    w, mode, rawmode = bm["w"], bm["mode"], bm["rawmode"]
    if bm["rle"] is not None:
        # PIL's BmpRleDecoder hands its bytes on as "L" or "P" pixels
        if mode not in ("L", "P"):
            raise BmpError(f"{name}: unknown raw mode for a {mode} RLE "
                           f"image")
        rows = _rle(buf, bm["data"], w, h, bm["rle"])
        arr = rows[::-1] if bm["direction"] == -1 else rows
    else:
        stride = bm["stride"]
        unpack_bits = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8,
                       "BGR;15": 16, "BGR;16": 16, "BGR": 24}.get(
                           rawmode, 8 * len(rawmode))
        if (w * unpack_bits + 7) // 8 > stride:
            raise BmpError(f"{name}: decoder configuration error (rows of "
                           f"{stride} bytes for {rawmode})")
        # PIL's raw decoder skips a row's padding only before the next row:
        # the last row's padding may be missing
        data = buf[bm["data"]:bm["data"] + stride * h]
        if len(data) < stride * (h - 1) + (w * unpack_bits + 7) // 8:
            raise BmpError(f"{name}: image file is truncated")
        rows = np.frombuffer(data.ljust(stride * h, b"\0"),
                             np.uint8).reshape(h, stride)
        arr = _unpack(rows[::-1] if bm["direction"] == -1 else rows, rawmode,
                      w)
    if bm["palette"] is not None:
        if len(bm["palette"]) > 256:
            raise BmpError(f"{name}: invalid palette size "
                           f"({len(bm['palette'])})")
        bm["info"]["palette"] = bm["palette"]
    return np.ascontiguousarray(arr)


def decode_bmp(buf: bytes, name: str = "BMP"):
    """(array, mode, info) of a BMP file's bytes."""
    if not buf.startswith(b"BM") or len(buf) < 14:
        raise BmpHeaderError(f"{name}: not a BMP file")
    bm = _bitmap(buf, 14, struct.unpack_from("<I", buf, 10)[0], name)
    check_size(bm["w"], bm["h"], name)
    return _load(buf, bm, bm["h"], name), bm["mode"], bm["info"]


def decode_dib(buf: bytes, name: str = "DIB"):
    """(array, mode, info) of a DIB's bytes: a BMP without its file header,
    the pixels right after the header and palette (BmpImagePlugin's
    DibImageFile)."""
    bm = _bitmap(buf, 0, 0, name)
    check_size(bm["w"], bm["h"], name)
    return _load(buf, bm, bm["h"], name), bm["mode"], bm["info"]


def read_dib_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a DIB."""
    with open(path, "rb") as f:
        return decode_dib(f.read(), path)


def read_bmp_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a BMP."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)
