"""PNG decode (8 and 16 bits) and 8-bit encode in numpy + zlib.

The JAX package reads dataset frames with ``PIL.Image.open``
(irgs_tpu/scene/datasets.py:59-60) and writes its visualisations with
``imageio.imwrite`` (irgs_tpu/utils/vis.py:32,54); the port reads and writes
the same files without either library.

  read : colour types 0 (grey), 2 (RGB), 4 (grey + alpha), 6 (RGBA) at 8 or
         16 bits, all five row filters; palette (3), other bit depths and
         interlaced files raise.
  write: 8-bit grey, grey + alpha, RGB or RGBA, one chosen row filter.

Format per the PNG specification (ISO/IEC 15948, W3C REC-PNG).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}            # colour type -> samples/pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}          # channels -> colour type


class PngError(ValueError):
    pass


def _chunks(buf: bytes):
    """(type, payload) of every chunk, CRCs checked, up to IEND."""
    if buf[:8] != _SIGNATURE:
        raise PngError("not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", buf, pos + 8 + n)
        if len(data) != n or zlib.crc32(kind + data) != crc:
            raise PngError(f"corrupt {kind!r} chunk")
        pos += 12 + n
        yield kind, data
        if kind == b"IEND":
            return
    raise PngError("missing IEND")


def _unfilter_average(x: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    x, up = x.tolist(), up.tolist()
    out = [0] * len(x)
    for i in range(len(x)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (x[i] + ((left + up[i]) >> 1)) & 0xFF
    return np.array(out, np.uint8)


def _unfilter_paeth(x: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    x, up = x.tolist(), up.tolist()
    out = [0] * len(x)
    for i in range(len(x)):
        if i >= bpp:
            a, c = out[i - bpp], up[i - bpp]
        else:
            a = c = 0
        b = up[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (x[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines -> [H, stride] bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        f, x = int(rows[r, 0]), rows[r, 1:]
        if f == 0:
            cur = x
        elif f == 1:   # Sub: running sum of each byte lane, mod 256
            cur = (np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:   # Up
            cur = x + prev
        elif f == 3:
            cur = _unfilter_average(x, prev, bpp)
        elif f == 4:
            cur = _unfilter_paeth(x, prev, bpp)
        else:
            raise PngError(f"unknown row filter {f}")
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """The samples as stored: uint8 or uint16, [H, W] for grey, [H, W, C]
    (C = 2, 3 or 4) otherwise."""
    with open(path, "rb") as f:
        buf = f.read()
    header, idat = None, []
    for kind, data in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise PngError(f"{path}: no IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype == 3:
        raise NotImplementedError(f"{path}: palette PNGs are not read")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNGs are not read")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise NotImplementedError(f"{path}: colour type {ctype} at {depth} "
                                  "bits is not read")
    nch = _CHANNELS[ctype]
    bpp = nch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise PngError(f"{path}: {raw.size} bytes of image data, expected "
                       f"{h * (1 + w * bpp)}")
    data = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        data = data.view(">u2").astype(np.uint16)
    img = data.reshape(h, w, nch)
    return img[..., 0] if nch == 1 else img


def read_png_as_pil(path: str) -> np.ndarray:
    """What ``np.asarray(PIL.Image.open(path))`` gives for the files
    read_png takes: 8-bit samples and 16-bit grey as stored; the other
    16-bit types keep only the high byte of each sample, and 16-bit grey +
    alpha comes as RGBA."""
    img = read_png(path)
    if img.dtype == np.uint16 and img.ndim == 3:
        img = (img >> 8).astype(np.uint8)
        if img.shape[-1] == 2:
            img = img[..., [0, 0, 0, 1]]
    return img


def _filter(img: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """[H, stride] uint8 -> the same rows filtered by `filter_type`."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    elif filter_type == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"filter_type must be 0..4, got {filter_type}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 1) -> None:
    """Write a uint8 image, [H, W] or [H, W, C] with C in 1..4, every row
    filtered with `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1..4], got "
                         f"{img.shape}")
    h, w, nch = img.shape
    rows = _filter(np.ascontiguousarray(img).reshape(h, w * nch), nch,
                   filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[nch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + chunk(b"IEND", b""))
