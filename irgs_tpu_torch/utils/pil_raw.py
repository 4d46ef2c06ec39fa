"""PIL's "raw" tile as ``ImageFile.load`` reads it, for the readers of
Pillow's small rasters (utils/sun.py, im.py, fits.py, spider.py, msp.py,
mcidas.py, imt.py, xvthumb.py, pixar.py, gbr.py).

`unpack` turns the decoder's line buffers into ``np.asarray``'s array for
each (mode, raw mode) pair those plugins use: the bilevel, grey, palette,
RGB(X)/BGR(X), planar ``;L`` line layouts, 16- and 32-bit integers and the
float family. `load` reads one raw tile from a file's bytes: where the
tile's arguments allow it (a mode in ``Image._MAPMODES`` equal to its raw
mode), PIL maps the file instead of decoding it, which refuses a file
shorter than ``ysize`` strides ("buffer is not large enough"); otherwise
the raw decoder reads ``ysize`` lines of ``ceil(xsize * bits / 8)`` bytes
with ``stride - that`` bytes skipped between them, and a stride below a
line's bytes or a file that ends first fails.
"""

from __future__ import annotations

import numpy as np

from . import pcx, tga
from .image import bits_of

MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")

# (mode, raw mode) -> bits a pixel, as libImaging's unpackers count them
BITS = {("1", "1"): 1, ("1", "1;I"): 1, ("L", "L"): 8, ("P", "P"): 8,
        ("L", "L;4"): 4, ("P", "P;4"): 4, ("P", "P;2"): 2,
        ("RGB", "RGB"): 24, ("RGB", "BGR"): 24, ("RGB", "RGBX"): 32,
        ("RGB", "BGRX"): 32, ("RGB", "RGB;L"): 24, ("LA", "LA;L"): 16,
        ("PA", "PA;L"): 16, ("RGBA", "RGBA;L"): 32, ("RGB", "RGBX;L"): 32,
        ("CMYK", "CMYK;L"): 32, ("YCbCr", "YCbCr;L"): 24,
        ("I;16", "I;16"): 16, ("I;16L", "I;16L"): 16, ("I;16B", "I;16B"): 16,
        ("I", "I"): 32, ("I", "I;32"): 32, ("I", "I;32S"): 32,
        ("I", "I;32B"): 32, ("F", "F"): 32, ("F", "F;8"): 8,
        ("F", "F;8S"): 8, ("F", "F;16"): 16, ("F", "F;16S"): 16,
        ("F", "F;32"): 32, ("F", "F;32F"): 32, ("F", "F;32BF"): 32}
# numpy's view of the samples of the integer and float raw modes
_SAMPLES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I": "<i4",
            "I;32": "<u4", "I;32S": "<i4", "I;32B": ">u4", "F": "<f4",
            "F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2",
            "F;32": "<u4", "F;32F": "<f4", "F;32BF": ">f4"}
# the array dtype of each such mode
_DTYPE = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I": "<i4",
          "F": "<f4"}


class RawError(ValueError):
    pass


def unpack(rows: np.ndarray, mode: str, rawmode: str, w: int) -> np.ndarray:
    """[H, linebytes] uint8 lines -> ``np.asarray`` of the image of mode
    `mode` these lines fill through the unpacker `rawmode`."""
    if rawmode in ("1", "L", "P"):
        return tga._unpack(rows, rawmode, w)
    if rawmode == "1;I":
        return ~bits_of(rows, 1, w).astype(bool)
    if rawmode in ("L;4", "P;4", "P;2"):
        v = bits_of(rows, int(rawmode[2]), w)
        return v * 17 if mode == "L" else v
    if rawmode == "RGB;L":
        return pcx._unpack(rows, rawmode, w)
    if rawmode.endswith(";L"):        # one plane after another in a line
        n = len(rawmode) - 2 if rawmode != "YCbCr;L" else 3
        keep = len(mode) if mode != "YCbCr" else 3
        return np.ascontiguousarray(np.stack(
            [rows[:, i * w:(i + 1) * w] for i in range(n)], -1)[..., :keep])
    if rawmode in ("RGB", "BGR", "RGBX", "BGRX"):
        n = len(rawmode)
        px = rows[:, :n * w].reshape(rows.shape[0], w, n)
        order = [2, 1, 0] if rawmode.startswith("B") else [0, 1, 2]
        return np.ascontiguousarray(px[..., order])
    if rawmode in _SAMPLES:
        v = np.frombuffer(np.ascontiguousarray(rows).tobytes(), _SAMPLES[
            rawmode]).reshape(rows.shape[0], -1)[:, :w]
        if mode == "F":
            return v.astype("<f4")
        if mode == "I":                    # unsigned words wrap
            return v.astype(np.uint32 if v.dtype.kind == "u"
                            else np.int32).view(np.int32)
        return v.astype(_DTYPE[mode])
    raise RawError(f"unknown raw mode {rawmode} for mode {mode}")


def _rows(buf, offset: int, h: int, step: int, linebytes: int):
    """h lines of `linebytes` bytes `step` apart from `offset` (a copy)."""
    flat = np.frombuffer(buf, np.uint8)
    return np.lib.stride_tricks.as_strided(
        flat[offset:], (h, linebytes), (step, 1), writeable=False).copy()


def load(buf: bytes, offset: int, mode: str, rawmode: str, size, stride=0,
         ystep=1, maps=True, name="raw") -> np.ndarray:
    """``np.asarray`` of an image of mode `mode` and `size` (w, h) whose
    one tile is ("raw", offset, (rawmode, stride, ystep)) in the file of
    bytes `buf`; `maps` False where the tile's arguments are a pair, which
    PIL never maps. Raises RawError where PIL's load fails."""
    w, h = size
    if not -2 ** 31 <= stride < 2 ** 31:
        raise RawError(f"{name}: signed integer is out of range (stride "
                       f"{stride})")
    if maps and rawmode == mode and mode in MAPMODES:
        if offset < 0:
            raise RawError(f"{name}: Tile offset cannot be negative")
        if offset + h * stride <= len(buf):
            step = stride if stride > 0 else w * (
                1 if mode in ("L", "P") else 2 if mode.startswith("I;16")
                else 4)
            if offset + h * step > len(buf):
                raise RawError(f"{name}: buffer is not large enough")
            linebytes = (w * BITS[mode, mode] + 7) // 8
            if offset + (h - 1) * step + linebytes > len(buf):
                raise RawError(f"{name}: rows overlap past the end of the "
                               f"file (PIL reads beyond its map)")
            rows = _rows(buf, offset, h, step, linebytes)
            return unpack(rows if ystep > 0 else rows[::-1], mode, rawmode, w)
    bits = BITS.get((mode, rawmode))
    if bits is None:
        raise RawError(f"{name}: unknown raw mode for given image mode "
                       f"({mode}, {rawmode})")
    if offset < 0:
        raise RawError(f"{name}: negative seek value {offset}")
    linebytes = (w * bits + 7) // 8
    if offset >= len(buf):
        raise RawError(f"{name}: image file is truncated")
    if stride and stride < linebytes:
        raise RawError(f"{name}: decoder error -8")
    step = stride if stride else linebytes
    if len(buf) - offset < (h - 1) * step + linebytes:
        raise RawError(f"{name}: image file is truncated")
    rows = _rows(buf, offset, h, step, linebytes)
    return unpack(rows if ystep > 0 else rows[::-1], mode, rawmode, w)
