"""TIFF reader: the first page, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info``'s palette give it (Pillow 12).

PIL picks the mode from (byte order, photometric, sample format, fill
order, bits per sample, extra samples) in its OPEN_INFO table, copied here
for the layouts read: bilevel and grey at 1, 2, 4, 8 and 16 bits, signed
16- and 32-bit and unsigned 32-bit grey (mode I), 32-bit float (F), grey +
alpha, RGB(A) at 8 and 16 bits with unassociated or associated (divided
out, as PIL's RGBa unpacker does) alpha or padding samples, palette at 1,
2, 4 and 8 bits (with alpha: PA), CMYK at 8 and 16 bits and CIELab. 16-bit
colour keeps the high byte of each sample.

Uncompressed files go through PIL's own raw decoder (the strips' byte
counts and the predictor tag are ignored; a file that ends early is
refused); PackBits, LZW and Deflate (8 and 32946) through libtiff
(csrc/lzw_decode.cpp for PackBits and LZW, zlib for Deflate; each strip or
tile must decode to its full size; predictor 2 undone on 8-, 16- and
32-bit samples). Strips and tiles, planar configurations 1 and 2, byte
orders II and MM, classic and (little-endian) BigTIFF headers, fill
order 2, and the EXIF
orientation PIL applies on load (ImageOps.exif_transpose). PIL's quirks
are kept: a big-endian compressed file of signed or float samples reads
byte-swapped (libtiff hands PIL native order, PIL unpacks it as big
endian again); with planar configuration 2 a CIELab file reads a and b
offset by 128 and, through libtiff, grey + alpha and palette + alpha read
alpha 0.

Streams PIL refuses raise TiffError, and so do the ones not ported yet,
named as such: JPEG (6, 7) and the other compressions (CCITT, LZMA, zstd,
WebP, ...), YCbCr, 12-bit samples, the float predictor 3, old-style LZW,
and planar configuration 2 where PIL's raw decoder reads something other
than the planes (16-bit samples).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import lzw

II, MM = b"II", b"MM"


def _both(photo, fmt, fill, bps, extra, mode, raw):
    return {(II, photo, fmt, fill, bps, extra): (mode, raw),
            (MM, photo, fmt, fill, bps, extra): (mode, raw)}


# (byte order, photometric, sample format, fill order, bits, extra samples)
# -> (mode, raw mode): PIL's TiffImagePlugin.OPEN_INFO, without 12 bits
# and YCbCr.
OPEN_INFO: dict = {}
for _photo, _inv in ((0, "I"), (1, "")):
    for _fill, _r in ((1, ""), (2, "R")):
        OPEN_INFO.update(_both(_photo, (1,), _fill, (1,), (), "1",
                               "1" + (";" + _inv + _r if _inv + _r else "")))
        for _b in (2, 4):
            OPEN_INFO.update(_both(_photo, (1,), _fill, (_b,), (), "L",
                                   f"L;{_b}{_inv}{_r}"))
        OPEN_INFO.update(_both(_photo, (1,), _fill, (8,), (), "L",
                               "L" + (";" + _inv + _r if _inv + _r else "")))
OPEN_INFO.update(_both(1, (2,), 1, (8,), (), "L", "L"))
OPEN_INFO.update({
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (MM, 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (II, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (II, 1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
})
OPEN_INFO.update(_both(1, (1,), 1, (8, 8), (2,), "LA", "LA"))
OPEN_INFO.update(_both(2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"))
OPEN_INFO.update(_both(2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"))
for _extra, _mode, _raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
                            ((0, 0), "RGB", "RGBXX"),
                            ((0, 0, 0), "RGB", "RGBXXX"),
                            ((1,), "RGBA", "RGBa"), ((1, 0), "RGBA", "RGBaX"),
                            ((1, 0, 0), "RGBA", "RGBaXX"),
                            ((2,), "RGBA", "RGBA"), ((2, 0), "RGBA", "RGBAX"),
                            ((2, 0, 0), "RGBA", "RGBAXX"),
                            ((999,), "RGBA", "RGBA")):
    OPEN_INFO.update(_both(2, (1,), 1, (8,) * (3 + len(_extra) + (not _extra)),
                           _extra, _mode, _raw))
for _extra, _mode, _raw in (((), "RGB", "RGB"), ((), "RGBA", "RGBA"),
                            ((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"),
                            ((2,), "RGBA", "RGBA")):
    _n = 3 + len(_extra) + (_mode == "RGBA" and not _extra)
    OPEN_INFO[(II, 2, (1,), 1, (16,) * _n, _extra)] = (_mode, _raw + ";16L")
    OPEN_INFO[(MM, 2, (1,), 1, (16,) * _n, _extra)] = (_mode, _raw + ";16B")
for _b in (1, 2, 4):
    OPEN_INFO.update(_both(3, (1,), 1, (_b,), (), "P", f"P;{_b}"))
    OPEN_INFO.update(_both(3, (1,), 2, (_b,), (), "P", f"P;{_b}R"))
OPEN_INFO.update(_both(3, (1,), 1, (8,), (), "P", "P"))
OPEN_INFO.update(_both(3, (1,), 1, (8, 8), (0,), "P", "PX"))
OPEN_INFO.update(_both(3, (1,), 1, (8, 8), (2,), "PA", "PA"))
OPEN_INFO.update(_both(3, (1,), 2, (8,), (), "P", "P;R"))
OPEN_INFO.update(_both(5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK"))
OPEN_INFO.update(_both(5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"))
OPEN_INFO.update(_both(5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"))
OPEN_INFO[(II, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16L")
OPEN_INFO[(MM, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16B")
OPEN_INFO.update(_both(8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"))

# PIL's COMPRESSION_INFO; the ones read here map to a decoder
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
_READ = {"raw", "tiff_lzw", "packbits", "tiff_adobe_deflate", "tiff_deflate"}

# IFD entry type -> struct code
_TYPES = {1: "B", 2: "B", 3: "H", 4: "L", 5: "LL", 6: "b", 7: "B", 8: "h",
          9: "l", 10: "ll", 11: "f", 12: "d", 13: "L", 16: "Q", 17: "q",
          18: "Q"}
_MAX_SAMPLES = 6
# raw modes of OPEN_INFO that PIL's raw decoder has no unpacker for
_NO_UNPACKER = {"P;1R", "P;2R", "P;4R", "L;IR"}
_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))

class TiffError(ValueError):
    pass


def _ifd(buf: bytes, order: bytes, big: bool, pos: int):
    """The first IFD at `pos` -> {tag: tuple of values}."""
    e = "<" if order == II else ">"
    cnt_fmt, off_fmt, entry = ("Q", "Q", 20) if big else ("H", "L", 12)
    inline = 8 if big else 4
    try:
        (n,) = struct.unpack_from(e + cnt_fmt, buf, pos)
    except struct.error as err:
        raise TiffError("truncated IFD") from err
    pos += struct.calcsize(cnt_fmt)
    tags = {}
    for i in range(n):
        at = pos + i * entry
        if at + entry > len(buf):
            raise TiffError("truncated IFD")
        tag, typ = struct.unpack_from(e + "HH", buf, at)
        (count,) = struct.unpack_from(e + ("Q" if big else "L"), buf,
                                      at + 4)
        code = _TYPES.get(typ)
        if code is None:
            continue
        size = struct.calcsize(e + code) * count
        if size <= inline:
            data_at = at + (12 if big else 8)
        else:
            (data_at,) = struct.unpack_from(e + off_fmt, buf,
                                            at + (12 if big else 8))
        if data_at + size > len(buf):
            continue
        vals = struct.unpack_from(e + code * count, buf, data_at)
        if typ in (5, 10):
            vals = tuple(vals[k] / vals[k + 1] if vals[k + 1] else 0.0
                         for k in range(0, len(vals), 2))
        tags[tag] = vals
    return tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if not v else v[0]


def _samples_of(raw: bytes, rows: int, cols: int, spp: int, bits: int,
                e: str, kind: str) -> np.ndarray:
    """Decoded bytes -> [rows, cols, spp] sample values (rows padded to
    whole bytes at 1, 2 and 4 bits)."""
    if bits < 8:
        rowbytes = (cols * spp * bits + 7) // 8
        b = np.frombuffer(raw, np.uint8, rows * rowbytes).reshape(rows, rowbytes)
        per = 8 // bits
        shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
        v = (b[..., None] >> shifts) & ((1 << bits) - 1)
        return v.reshape(rows, rowbytes * per)[:, :cols * spp].reshape(
            rows, cols, spp)
    dt = np.dtype(f"{e}{kind}{bits // 8}")
    return np.frombuffer(raw, dt, rows * cols * spp).reshape(rows, cols, spp)


def _undo_predictor(s: np.ndarray) -> np.ndarray:
    """Horizontal differencing undone along each row (libtiff's horAcc8,
    16, 32: sums that wrap at the sample's width)."""
    u = s.view(s.dtype.str.replace("i", "u").replace("f", "u"))
    u = u.astype(u.dtype.newbyteorder("="))
    acc = np.cumsum(u, axis=1, dtype=u.dtype)
    return acc.view(s.dtype.newbyteorder("="))


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBa unpacker: c * 255 // a clipped at 255, 0 where a = 0."""
    a = rgba[..., 3:4].astype(np.int32)
    c = rgba[..., :3].astype(np.int32)
    out = np.where(a > 0, np.minimum(c * 255 // np.maximum(a, 1), 255), 0)
    return np.concatenate([out, a], -1).astype(np.uint8)


def _to_mode(s: np.ndarray, mode: str, rawmode: str) -> np.ndarray:
    """Sample values [H, W, spp] -> np.asarray of PIL's image."""
    base = rawmode.split(";")[0]
    if mode == "1":
        return (s[..., 0] == 0) if "I" in rawmode[1:] else (s[..., 0] != 0)
    if mode == "L":
        scale = {2: 85, 4: 17}.get(int(rawmode[2]) if rawmode[2:3].isdigit()
                                   else 8, 1)
        v = s[..., 0].astype(np.int32) * scale
        inverted = rawmode in ("L;I", "L;IR") or rawmode.startswith(
            ("L;2I", "L;4I"))
        return (255 - v if inverted else v).astype(np.uint8)
    if mode in ("I;16", "I;16B"):
        return s[..., 0].astype("<u2" if mode == "I;16" else ">u2")
    if mode == "I":
        return s[..., 0].astype(s.dtype.newbyteorder("=")).view(
            np.int32) if s.dtype.itemsize == 4 else s[..., 0].astype(np.int32)
    if mode == "F":
        return s[..., 0].astype(np.float32)
    if mode == "P":
        return s[..., 0].astype(np.uint8)
    if s.dtype.itemsize == 2:                      # 16-bit colour
        s = (s.astype(np.uint16) >> 8).astype(np.uint8)
    s = s.astype(np.uint8)
    n = {"LA": 2, "PA": 2, "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}[mode]
    if mode == "LA" or mode == "PA":
        return np.ascontiguousarray(s[..., [0, -1]] if s.shape[-1] > 2 else s)
    out = np.ascontiguousarray(s[..., :n])
    if base.startswith("RGBa"):
        out = _unpremultiply(out)
    return out


def _transpose(a: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose for EXIF orientation 2..8."""
    if orientation == 2:
        return a[:, ::-1]
    if orientation == 3:
        return a[::-1, ::-1]
    if orientation == 4:
        return a[::-1]
    if orientation == 5:
        return a.swapaxes(0, 1)
    if orientation == 6:
        return np.rot90(a, -1)
    if orientation == 7:
        return a[::-1, ::-1].swapaxes(0, 1)
    if orientation == 8:
        return np.rot90(a, 1)
    return a


def decode_tiff(buf: bytes, name: str = "TIFF"):
    """(array, mode, info) of the first page of a TIFF file's bytes."""
    head = buf[:4]
    big = head in (b"MM\x00\x2b", b"II\x2b\x00")
    if head not in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                    b"II\x00\x2a") and not big:
        raise TiffError(f"{name}: not a TIFF file")
    order = head[:2]
    if big and order == MM:
        raise TiffError(f"{name}: cannot identify image file (PIL reads "
                        f"no big-endian BigTIFF)")
    e = "<" if order == II else ">"
    try:
        (first,) = struct.unpack_from(e + ("Q" if big else "L"), buf,
                                      8 if big else 4)
    except struct.error as err:
        raise TiffError(f"{name}: truncated header") from err
    tags = _ifd(buf, order, big, first)

    comp_id = _one(tags, 259, 1)
    compression = COMPRESSIONS.get(comp_id)
    if compression is None:
        raise TiffError(f"{name}: unknown compression {comp_id}")
    if compression not in _READ:
        raise TiffError(f"{name}: TIFF compression {compression} "
                        f"({comp_id}) is not ported yet")
    if 0xBC01 in tags:
        raise TiffError(f"{name}: Windows Media Photo files not supported")
    planar = _one(tags, 284, 1)
    photo = _one(tags, 262, 0)
    fill = _one(tags, 266, 1)
    if 256 not in tags or 257 not in tags:
        raise TiffError(f"{name}: missing dimensions")
    w, h = int(tags[256][0]), int(tags[257][0])
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tuple(tags.get(258, (1,)))
    extra = tuple(tags.get(338, ()))
    spp = _one(tags, 277, 1)
    if spp > _MAX_SAMPLES:
        raise TiffError(f"{name}: invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise TiffError(f"{name}: unknown data organization")
    if photo == 6:
        raise TiffError(f"{name}: YCbCr TIFF is not ported yet")
    if bps == (12,):
        raise TiffError(f"{name}: 12-bit samples are not ported yet")
    key = (order, photo, fmt, fill, bps, extra)
    if key not in OPEN_INFO:
        raise TiffError(f"{name}: unknown pixel mode {key[1:]}")
    mode, rawmode = OPEN_INFO[key]
    bits = bps[0]
    libtiff = compression != "raw"
    if not libtiff and rawmode in _NO_UNPACKER:
        raise TiffError(f"{name}: unknown raw mode {rawmode} for mode {mode}")
    predictor = _one(tags, 317, 1) if compression in (
        "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate") else 1
    if predictor == 2 and bits not in (8, 16, 32):
        raise TiffError(f"{name}: horizontal differencing not supported "
                        f"with {bits}-bit samples")
    if predictor not in (1, 2):
        raise TiffError(f"{name}: TIFF predictor {predictor} is not ported "
                        f"yet")
    if planar == 2 and spp > 1:
        if not libtiff and rawmode not in ("RGB", "RGBA", "CMYK", "LAB"):
            if bits != 8:
                raise TiffError(f"{name}: planar configuration 2 with "
                                f"{bits}-bit samples uncompressed is not "
                                f"ported")
            raise TiffError(f"{name}: unknown raw mode for given image mode "
                            f"(planar configuration 2, {rawmode})")
        if libtiff and 324 not in tags and rawmode.startswith(
                ("RGBX", "RGBaX", "RGBAX", "CMYKX", "PX")):
            raise TiffError(f"{name}: decoder error (planar configuration 2 "
                            f"strips with padding samples)")
        if len(bps) != len(extra) + {2: 3, 5: 4, 8: 3}.get(photo, 1):
            raise TiffError(f"{name}: planar configuration 2 without its "
                            f"ExtraSamples tag is not ported")

    kind = {1: "u", 2: "i", 3: "f"}[fmt[0]] if bits >= 8 else "u"
    planes = spp if planar == 2 else 1
    spp_plane = 1 if planar == 2 else spp
    if 324 in tags:
        tw, th = _one(tags, 322), _one(tags, 323)
        if not isinstance(tw, int) or not isinstance(th, int) or tw <= 0 \
                or th <= 0:
            raise TiffError(f"{name}: invalid tile dimensions")
        offsets, counts = tags[324], tags.get(325)
        boxes = [(x, y, tw, th) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    elif 273 in tags:
        rps = min(_one(tags, 278, h) or h, h)
        offsets, counts = tags[273], tags.get(279)
        boxes = [(0, y, w, rps) for y in range(0, h, rps)]
    else:
        raise TiffError(f"{name}: unknown data organization")
    if not libtiff and 324 not in tags and rps == h and planar != 2:
        offsets = offsets[-1:]
    if len(offsets) < len(boxes) * planes:
        raise TiffError(f"{name}: fewer strips or tiles than the image needs")
    if libtiff and (counts is None or len(counts) < len(offsets)):
        raise TiffError(f"{name}: missing strip or tile byte counts")

    samples = np.zeros((h, w, spp), np.dtype(f"={kind}{max(bits, 8) // 8}"))
    k = 0
    for p in range(planes):
        for (x, y, bw, bh) in boxes:
            tile = 324 in tags
            rows = bh if tile else min(bh, h - y)
            rowbytes = (bw * spp_plane * bits + 7) // 8
            need = rows * rowbytes
            off = int(offsets[k])
            if not libtiff:
                rows_read = min(bh, h - y)
                raw = buf[off:off + rows_read * rowbytes]
                if len(raw) < rows_read * rowbytes:
                    raise TiffError(f"{name}: image file is truncated")
                rows = rows_read
                if fill == 2:
                    raw = raw.translate(_REVERSE)
            else:
                data = buf[off:off + int(counts[k])]
                if len(data) < int(counts[k]):
                    raise TiffError(f"{name}: read error on strip or tile "
                                    f"{k}")
                if fill == 2:
                    data = data.translate(_REVERSE)
                if compression == "tiff_lzw":
                    raw = lzw.tiff_lzw(data, need)
                    if raw == -3:
                        raise TiffError(f"{name}: old-style LZW is not "
                                        f"ported yet")
                elif compression == "packbits":
                    raw = lzw.packbits(data, need)
                else:
                    try:
                        raw = zlib.decompressobj().decompress(data, need)
                    except zlib.error as err:
                        raise TiffError(f"{name}: Deflate error in strip or "
                                        f"tile {k}: {err}") from err
                    if len(raw) < need:
                        raw = -2
                if isinstance(raw, int):
                    raise TiffError(f"{name}: {compression} data of strip or "
                                    f"tile {k} is corrupt or short")
            s = _samples_of(raw, rows, bw, spp_plane, bits, e, kind)
            if predictor == 2:
                s = _undo_predictor(s)
            cw, ch = min(bw, w - x), min(rows, h - y)
            samples[y:y + ch, x:x + cw, p:p + spp_plane] = s[:ch, :cw]
            k += 1

    if libtiff and order == MM and rawmode in ("I;16BS", "I;32BS", "F;32BF"):
        samples = samples.byteswap()        # swapped twice, as PIL reads it
    if planar == 2 and spp > 1:
        if mode == "LAB":
            samples[..., 1:] ^= 0x80
        elif libtiff and mode in ("LA", "PA"):
            samples[..., 1:] = 0
    arr = _to_mode(samples, mode, rawmode)
    info = {"compression": compression}
    if mode in ("P", "PA"):
        cmap = tags.get(320)
        if cmap is None:
            raise TiffError(f"{name}: palette image without a colour map")
        n = len(cmap) // 3
        pal = (np.asarray(cmap, np.int64) // 256).astype(np.uint8)
        info["palette"] = np.ascontiguousarray(pal[:3 * n].reshape(3, n).T)
    orientation = _one(tags, 274)
    if orientation in range(2, 9):
        arr = np.ascontiguousarray(_transpose(arr, orientation))
    return arr, mode, info


def read_tiff_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a TIFF."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)
