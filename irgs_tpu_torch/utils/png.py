"""PNG decode and encode in numpy + zlib.

The JAX package reads dataset frames with ``PIL.Image.open``
(irgs_tpu/scene/datasets.py:59-60) and writes its visualisations with
``imageio.imwrite`` (irgs_tpu/utils/vis.py:32,54); the port reads and writes
the same files without either library.

  read : every PNG image type (grey at 1, 2, 4, 8 and 16 bits, palette at
         1, 2, 4 and 8, RGB, grey + alpha and RGBA at 8 and 16), all five
         row filters, Adam7 interlacing; `read_png_like_pil` gives PIL's
         array, mode and palette.
  write: 8-bit grey, grey + alpha, RGB or RGBA, one chosen row filter; and
         (`write_png_like_pil`) the file PIL's save writes for the modes
         "1", "P" (palette), "L", "LA", "RGB", "RGBA" and "I;16", with the
         source's transparency (tRNS) and ICC profile (iCCP): PIL's row
         filters and deflate settings, so equal byte for byte where
         Python's zlib deflates as PIL's does.

Format per the PNG specification (ISO/IEC 15948, W3C REC-PNG).
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from .image import NotThisFormat, check_size

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}            # colour type -> samples/pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}          # channels -> colour type


class PngError(ValueError):
    pass


class PngHeaderError(PngError, NotThisFormat):
    """PIL's PngImageFile._open fails with SyntaxError or struct.error:
    Image.open tries the next plugin."""

_IS_CID = re.compile(rb"\w\w\w\w")
# chunk -> bytes its PngStream handler unpacks before any other check
# (short ones raise struct.error or IndexError in PIL's _open)
_NEEDS = {b"gAMA": 4, b"pHYs": 8, b"sRGB": 1}


def _chunks(buf: bytes):
    """(type, payload) of every chunk up to IEND, as PIL reads them: the
    chunks before the first IDAT as PIL's _open reads them (a chunk type
    that is not four word characters, a CRC that is wrong or cut, a header
    cut before a chunk's length, a short tRNS, gAMA, pHYs or sRGB payload,
    an IHDR with a filter method: PngHeaderError, the next plugin's turn;
    a payload cut short: PngError, as PIL's OSError); from the first IDAT
    on, as PIL's load reads them, no CRC, and a chunk cut short or a
    missing IEND ends the stream."""
    if buf[:8] != _SIGNATURE:
        raise PngHeaderError("not a PNG file")
    pos, ctype = 8, None
    while True:                                        # PIL's _open
        head = buf[pos:pos + 8]
        if len(head) < 4:
            raise PngHeaderError("broken PNG file (no chunk header)")
        (n,) = struct.unpack_from(">I", head)
        kind = head[4:]
        if not _IS_CID.match(kind):
            raise PngHeaderError(f"broken PNG file (corrupt chunk type "
                                 f"{kind!r})")
        if kind in (b"IDAT", b"IEND"):
            break
        data = buf[pos + 8:pos + 8 + n]
        if len(data) < n:
            raise PngError(f"corrupt {kind!r} chunk (truncated file read)")
        if kind == b"IHDR":
            if n < 13:
                raise PngError("truncated IHDR chunk")
            ctype = data[9]
            if data[11]:
                raise PngHeaderError("unknown filter category")
        short = len(data) < _NEEDS.get(kind, 0)
        if kind == b"tRNS" and ctype in (0, 2):
            short = len(data) < (2 if ctype == 0 else 6)
        if kind == b"iCCP":
            short = data.find(b"\0") + 1 >= len(data)
        if short:
            raise PngHeaderError(f"broken PNG file (short {kind!r} chunk)")
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + data) != struct.unpack(">I",
                                                                    crc)[0]:
            raise PngHeaderError(f"broken PNG file (corrupt {kind!r} chunk: "
                                 f"bad header checksum)")
        pos += 12 + n
        yield kind, data
    while pos + 12 <= len(buf):                        # PIL's load
        (n,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        if len(data) != n:
            if kind == b"IDAT":
                yield kind, data
            return
        pos += 12 + n
        yield kind, data
        if kind == b"IEND":
            return


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


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _unpack(data: np.ndarray, w: int, depth: int, nch: int) -> np.ndarray:
    """[h, stride] unfiltered bytes -> [h, w, nch] samples (uint8 or uint16
    as stored; bit depths below 8 unpacked, not scaled)."""
    h = data.shape[0]
    if depth == 16:
        return data.view(">u2").astype(np.uint16).reshape(h, w, nch)
    if depth == 8:
        return data.reshape(h, w, nch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (data[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None].astype(np.uint8)


def _decode_image(raw: np.ndarray, w: int, h: int, depth: int, nch: int,
                  interlace: int, path: str) -> np.ndarray:
    bpp = max(1, nch * depth // 8)

    def stride(width):
        return 1 + (width * nch * depth + 7) // 8

    if not interlace:
        # PIL's decoder stops at the last row: more data is not read
        if raw.size < h * stride(w):
            raise PngError(f"{path}: {raw.size} bytes of image data, "
                           f"expected {h * stride(w)}")
        rows = _unfilter(raw[:h * stride(w)].reshape(h, stride(w)), bpp)
        return _unpack(rows, w, depth, nch)
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((h, w, nch), dtype)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:           # Adam7: seven sub-images
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        n = ph * stride(pw)
        if pos + n > raw.size:
            raise PngError(f"{path}: interlaced image data too short")
        rows = _unfilter(raw[pos:pos + n].reshape(ph, stride(pw)), bpp)
        img[y0::dy, x0::dx] = _unpack(rows, pw, depth, nch)
        pos += n
    return img


def _icc_profile(data: bytes, path: str):
    """An iCCP payload's profile as PngImagePlugin's chunk_iCCP reads it:
    None where zlib fails, an error past PIL's 1 MiB limit."""
    i = data.find(b"\0")
    if data[i + 1] != 0:
        raise PngError(f"{path}: unknown iCCP compression {data[i + 1]}")
    d = zlib.decompressobj()
    try:
        profile = d.decompress(data[i + 2:], 1 << 20)
    except zlib.error:
        return None
    if d.unconsumed_tail:
        raise PngError(f"{path}: iCCP profile past PIL's 1 MiB limit")
    return profile


def _read(path: str):
    """(samples [H, W, C] as stored, bit depth, colour type, palette uint8
    [n, 3] or None, tRNS payload or None, info: ``icc_profile`` from the
    last iCCP chunk, as PIL's info holds it once the image is loaded)."""
    with open(path, "rb") as f:
        return _decode(f.read(), path)


def _decode(buf: bytes, path: str):
    header, idat, palette, trns, info = None, [], None, None, {}
    for kind, data in _chunks(buf):
        if kind == b"iCCP":
            info["icc_profile"] = _icc_profile(data, path)
        elif kind == b"IHDR":
            header = struct.unpack_from(">IIBBBBB", data)
        elif kind == b"PLTE":
            if len(data) % 3 or not 3 <= len(data) <= 768:
                raise PngError(f"{path}: bad PLTE chunk")
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3).copy()
        elif kind == b"tRNS":
            trns = bytes(data)
        elif kind == b"IDAT":
            idat.append(data)
    # no IHDR, or one PIL has no mode for, leaves PIL's image without a
    # mode or a size: the next plugin's turn
    if header is None:
        raise PngHeaderError(f"{path}: no IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise PngHeaderError(f"{path}: colour type {ctype} at {depth} bits "
                             f"is not a PNG image type")
    try:
        check_size(w, h, path)
    except NotThisFormat as err:
        raise PngHeaderError(str(err)) from None
    if ctype == 3 and palette is None:
        raise PngError(f"{path}: palette image without PLTE")
    if interlace not in (0, 1):
        raise PngError(f"{path}: unknown interlace method {interlace}")
    nch = 1 if ctype == 3 else _CHANNELS[ctype]
    # as PIL's ZIP decoder: a stream cut after the last row still reads
    try:
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)),
                            np.uint8)
    except zlib.error as e:
        raise PngError(f"{path}: broken data stream ({e})") from None
    img = _decode_image(raw, w, h, depth, nch, interlace, path)
    return img, depth, ctype, palette, trns, info


def read_png(path: str) -> np.ndarray:
    """The samples as stored: uint8 or uint16, [H, W] for grey and palette
    indices, [H, W, C] (C = 2, 3 or 4) otherwise; bit depths below 8 as
    their values (0-1, 0-3, 0-15)."""
    img = _read(path)[0]
    return img[..., 0] if img.shape[-1] == 1 else img


def _transparency(trns: bytes, ctype: int, depth: int):
    """A tRNS payload as PngImagePlugin's chunk_tRNS keeps it in info, or
    None where PIL keeps none (colour types with alpha)."""
    if ctype == 3:
        # PIL's _simple_palette: one fully transparent entry and the rest
        # opaque is kept as that entry's index
        simple = re.fullmatch(rb"\xff*\x00\xff*", trns)
        return trns.index(b"\0") if simple else trns
    if ctype == 0:
        (grey,) = struct.unpack_from(">H", trns)
        return (255 if grey else 0) if depth == 1 else grey
    if ctype == 2:
        return struct.unpack_from(">HHH", trns)
    return None


def read_png_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)``: ``np.asarray(
    im)``, ``im.mode`` and the info the port carries: ``palette`` (uint8
    [n, 3], mode P), ``transparency`` (the palette's tRNS alphas as
    bytes, or the index of its one transparent entry; the grey sample of
    modes "1" (0 or 255), "L" and "I;16"; the (r, g, b) samples of RGB) and
    ``icc_profile`` (the iCCP chunk's profile).

    Modes as PngImagePlugin maps them: grey at 1 bit is "1" (bool), at 2
    and 4 bits "L" scaled to 0-255, at 16 bits "I;16"; palette at any depth
    "P" (the indices); 16-bit colour keeps each sample's high byte, and
    16-bit grey + alpha becomes RGBA."""
    with open(path, "rb") as f:
        return decode_png_like_pil(f.read(), path)


def decode_png_like_pil(buf: bytes, path: str = "PNG"):
    """`read_png_like_pil` of a PNG stream's bytes (an icon's frame)."""
    img, depth, ctype, palette, trns, info = _decode(buf, path)
    t = None if trns is None else _transparency(trns, ctype, depth)
    if t is not None:
        info["transparency"] = t
    if ctype == 3:
        info["palette"] = palette
        return img[..., 0], "P", info
    if ctype == 0:
        g = img[..., 0]
        if depth == 1:
            return g.astype(bool), "1", info
        if depth in (2, 4):
            return (g * (255 // ((1 << depth) - 1))).astype(np.uint8), "L", info
        return g, ("I;16" if depth == 16 else "L"), info
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            return img[..., [0, 0, 0, 1]], "RGBA", info
    return img, {2: "RGB", 4: "LA", 6: "RGBA"}[ctype], info


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


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


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
    _write(path, w, h, 8, _COLOR_TYPE[nch], rows, filter_type)


def _write(path, w, h, depth, ctype, rows, filter_type, extra=b"",
           deflate=None, idat_size=None):
    """`rows` [h, stride] already filtered with `filter_type` (one type, or
    one per row); `deflate` zlib.compressobj's arguments (default
    zlib.compress's); `idat_size` the bytes per IDAT chunk (default one
    chunk)."""
    raw = np.concatenate([np.broadcast_to(np.asarray(
        filter_type, np.uint8).reshape(-1, 1), (h, 1)), rows], 1)
    z = zlib.compressobj(*(deflate or ()))
    data = z.compress(raw.tobytes()) + z.flush()
    step = idat_size or max(len(data), 1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + extra
                + b"".join(_chunk(b"IDAT", data[i:i + step])
                           for i in range(0, len(data), step))
                + _chunk(b"IEND", b""))


def _filter_like_pil(rows: np.ndarray, bpp: int):
    """PIL's ZIP encoder's row filters (ZipEncode.c): per row, the first
    of None, Up, Sub, Paeth whose bytes, read as signed, have the least
    absolute sum (Average only with ``optimize``). -> (filtered rows, the
    filter type of each row)."""
    order = (0, 2, 1, 4)
    cand = np.stack([_filter(rows, bpp, f) for f in order])
    cost = np.minimum(cand, 256 - cand.astype(np.int32)).sum(-1)
    pick = np.argmin(cost, axis=0)          # the first of equal sums
    return (np.take_along_axis(cand, pick[None, :, None], 0)[0],
            np.asarray(order, np.uint8)[pick])


def _pack(values: np.ndarray, depth: int) -> np.ndarray:
    """[h, w] values below 2^depth -> [h, ceil(w * depth / 8)] bytes."""
    h, w = values.shape
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = values
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(
        padded.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def write_png_like_pil(path: str, img: np.ndarray, mode: str,
                       info: dict | None = None) -> None:
    """Write an image of PIL mode `mode` as ``PIL.Image.save(path)`` stores
    it: "1" at 1 bit, "L", "LA", "RGB", "RGBA" at 8, "I;16" and "I;16B"
    at 16 bits, "I" at 16 bits clipped to 0..65535 (PIL's I;16B packer), and
    "P" with its palette (``info["palette"]``, [n, 3]) at the depth PIL picks
    from the palette's length (1 bit up to 2 entries, 2 up to 4, 4 up to 16,
    else 8); the ``transparency`` of ``info`` as a tRNS chunk and its
    ``icc_profile`` as an iCCP chunk, as PIL carries them from the source
    (the profile compressed by zlib.compress, as PIL does). The rows are
    filtered as PIL's encoder filters them (8-bit palette rows not at all)
    and deflated with its settings (level 6, memLevel 9, Z_FILTERED; 8-bit
    palette Z_DEFAULT_STRATEGY) into IDAT chunks of ImageFile's buffer
    size."""
    info = info or {}
    img = np.asarray(img)
    h, w = img.shape[:2]
    extra = b""
    if mode == "1":
        rows, depth, ctype = _pack(img.astype(np.uint8), 1), 1, 0
    elif mode == "P":
        pal = np.asarray(info["palette"], np.uint8).reshape(-1, 3)
        colors = max(min(len(pal), 256), 1)
        depth = 1 if colors <= 2 else 2 if colors <= 4 else 4 if colors <= 16 \
            else 8
        rows = _pack(img & ((1 << depth) - 1), depth) if depth < 8 else img
        ctype = 3
        extra = _chunk(b"PLTE", pal[:colors].tobytes())
    elif mode in ("I;16", "I;16B", "I"):
        if mode == "I":
            img = np.clip(img, 0, 65535)
        rows = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
        depth, ctype = 16, 0
    elif mode in ("L", "LA", "RGB", "RGBA"):
        nch = len(mode)
        rows = np.ascontiguousarray(img, np.uint8).reshape(h, w * nch)
        depth, ctype = 8, _COLOR_TYPE[nch]
    else:
        raise OSError(f"cannot write mode {mode} as PNG")
    t = info.get("transparency")
    if t or t == 0:                         # PngImagePlugin._save's test
        if mode == "P":
            if not isinstance(t, bytes):
                t = b"\xff" * max(0, min(255, int(t))) + b"\0"
            extra += _chunk(b"tRNS", t[:colors])
        elif mode in ("1", "L", "I", "I;16"):
            extra += _chunk(b"tRNS", struct.pack(">H", max(0, min(65535,
                                                                 int(t)))))
        elif mode == "RGB":
            extra += _chunk(b"tRNS", struct.pack(">HHH", *t))
    if info.get("icc_profile"):
        extra = _chunk(b"iCCP", b"ICC Profile\0\0"
                       + zlib.compress(info["icc_profile"])) + extra
    rows = np.ascontiguousarray(rows, np.uint8)
    if mode == "P" and depth == 8:          # PIL's raw mode "P"
        filters, strategy = 0, zlib.Z_DEFAULT_STRATEGY
    else:
        bpp = (depth * _CHANNELS.get(ctype, 1) + 7) // 8
        rows, filters = _filter_like_pil(rows, bpp)
        strategy = zlib.Z_FILTERED
    _write(path, w, h, depth, ctype, rows, filters, extra,
           deflate=(6, zlib.DEFLATED, 15, 9, strategy),
           idat_size=max(65536, 4 * w))
