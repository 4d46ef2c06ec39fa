"""TIFF reader: the first page, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info``'s palette give it (Pillow 12, libtiff 4.7).

PIL picks the mode from (byte order, photometric, sample format, fill
order, bits per sample, extra samples) in its OPEN_INFO table, copied here:
bilevel and grey at 1, 2, 4, 8 and 16 bits, 12-bit little-endian grey (PIL's
I;12 unpacker, mode I;16), signed 16- and 32-bit and unsigned 32-bit grey
(mode I), 32-bit float (F), grey + alpha, RGB(A) at 8 and 16 bits with
unassociated or associated (divided out, as PIL's RGBa unpacker does)
alpha or padding samples, palette at 1, 2, 4 and 8 bits (with alpha: PA),
CMYK at 8 and 16 bits, CIELab and YCbCr. 16-bit colour keeps the high byte
of each sample.

Uncompressed files go through PIL's own raw decoder (the strips' byte
counts and the predictor tag are ignored; a file that ends early is
refused; YCbCr reads as "RGBX", 4 bytes a pixel; a plane of a planar file
is read with a one-band 8-bit unpacker, so of 16-bit planes PIL reads
their first bytes, rows of its own stride). The other codecs go through
libtiff, as here: PackBits and LZW, old-style (LSB-first) LZW included
(csrc/lzw_decode.cpp), Deflate (8 and 32946, zlib), Zstandard (50000,
csrc/zstd_decode.cpp) and LZMA (34925, csrc/xz_decode.cpp), each strip or
tile decoded to its full size with predictor 2 undone on 8-, 16- and 32-bit
samples and the floating-point predictor 3 (libtiff's fpAcc) on 32-bit
float grey; ThunderScan (32809, csrc/small_decode.cpp); JPEG (7) through
utils/jpeg.py with the JPEGTables tag and the colour space the container
gives (YCbCr converted to RGB after upsampling within each strip, every
other photometric passed through); old-style JPEG (6) as libtiff's OJPEG
codec assembles it (the JPEGInterchangeFormat stream or the
JPEGQ/DC/ACTables tags, a restart marker between strips) and hands
libjpeg's raw YCbCr data units on; YCbCr under the other codecs, and
old-style JPEG, through libtiff's RGBA interface (data units at
subsampling 1x1 to 4x4, separate planes at 1x1, its TIFFYCbCrToRGB tables
from YCbCrCoefficients and ReferenceBlackWhite; the unit bytes a 4x4
strip leaves unread are reported); CCITT modified Huffman (2), RLEW
(32771, rows word-aligned), T.4 (3, 1D or 2D) and T.6 (4) through
csrc/ccitt_decode.cpp. Damaged strips read as PIL reads them: libtiff's
fax recovery (bad rows whitened, T.4's "no EOL" retry, T.6 strips that
stop early), libjpeg-turbo's (corrupt codes, data that runs out, its SIMD
IDCT's 16-bit lanes), libzstd's and liblzma's checks where they fail a
strip, ThunderScan rows that give too few or too many pixels; pixels
libtiff never writes (a T.6 strip that stops early in the first strip, a
ThunderScan run that reaches its row's end) are what PIL's buffer held and
are reported (`report`). Strips and tiles, planar configurations 1 and 2
(without an ExtraSamples tag, 4-sample RGB through libtiff reads as RGBa),
byte orders II and MM, classic and (little-endian) BigTIFF headers, fill
order 2, and the EXIF orientation PIL applies on load
(ImageOps.exif_transpose). PIL's quirks are kept: a big-endian compressed
file of signed or float samples reads byte-swapped (libtiff hands PIL
native order, PIL unpacks it as big endian again); with planar
configuration 2 a CIELab file reads a and b offset by 128 and, through
libtiff, grey + alpha and palette + alpha read alpha 0.

Streams PIL refuses raise TiffError, at the point where PIL raises:
TiffHeaderError (a NotThisFormat, the next plugin's turn) where PIL's
_open fails (unknown compression or pixel mode, SGILog's LogL/LogLuv
photometrics, 12-bit big-endian or min-is-white grey, missing dimensions
or colour map), TiffError where its load fails (SGILog under other
photometrics, WebP-in-TIFF, which this libtiff has no codec for, a float
predictor on integer samples, YCbCr in planar configuration 2 at other
than 1x1). Still "not ported": old-style JPEG other than YCbCr strips
(tiles, RGB or planar files), old-style JPEG at 4 vertical subsampling
with partly read rows of units, predictor 2 with subsampled or planar
YCbCr, and 16-bit planes uncompressed whose raw mode has other bands.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import jpeg, lzw, small_codecs, tiff_codecs
from .image import NotThisFormat

II, MM = b"II", b"MM"


def _both(photo, fmt, fill, bps, extra, mode, raw):
    return {(II, photo, fmt, fill, bps, extra): (mode, raw),
            (MM, photo, fmt, fill, bps, extra): (mode, raw)}


# (byte order, photometric, sample format, fill order, bits, extra samples)
# -> (mode, raw mode): PIL's TiffImagePlugin.OPEN_INFO.
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
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
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
OPEN_INFO.update(_both(6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"))

# PIL's COMPRESSION_INFO; the ones read here map to a decoder
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
_FAX = {"tiff_ccitt", "group3", "group4", "tiff_raw_16"}
# libtiff's horizontal predictor codecs
_PREDICTED = {"tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "lzma", "zstd"}
# the YCbCr subsamplings libtiff's RGBA interface has a put routine for
_SUBSAMPLINGS = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}

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


class TiffHeaderError(TiffError, NotThisFormat):
    """PIL's TiffImageFile._open fails with SyntaxError, KeyError,
    TypeError, EOFError or struct.error: Image.open tries the next
    plugin."""


def _ifd(buf: bytes, order: bytes, big: bool, pos: int):
    """The first IFD at `pos` -> {tag: tuple of values}, as PIL's
    ImageFileDirectory_v2.load reads it: entries of unknown type skipped,
    and the reading stopped (the tags so far kept) where an entry or its
    value runs past the file."""
    e = "<" if order == II else ">"
    cnt_fmt, off_fmt, entry = ("Q", "Q", 20) if big else ("H", "L", 12)
    inline = 8 if big else 4
    tags = {}
    try:
        (n,) = struct.unpack_from(e + cnt_fmt, buf, pos)
    except struct.error:
        return tags
    pos += struct.calcsize(cnt_fmt)
    for i in range(n):
        at = pos + i * entry
        if at + entry > len(buf):
            break
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
            break
        if typ in (1, 7):           # PIL keeps BYTE and UNDEFINED as bytes
            tags[tag] = buf[data_at:data_at + size]
            continue
        vals = struct.unpack_from(e + code * count, buf, data_at)
        if typ in (5, 10):
            vals = tuple(vals[k] / vals[k + 1] if vals[k + 1] else 0.0
                         for k in range(0, len(vals), 2))
        tags[tag] = vals
    return tags


def _one(tags, tag, default=None):
    """A tag's one value as PIL's tag_v2.get gives it (BYTE and UNDEFINED
    tags as their bytes)."""
    v = tags.get(tag)
    return default if not v else v if isinstance(v, bytes) else v[0]


def _samples_of(raw: bytes, rows: int, cols: int, spp: int, bits: int,
                e: str, kind: str) -> np.ndarray:
    """Decoded bytes -> [rows, cols, spp] sample values (rows padded to
    whole bytes at 1, 2 and 4 bits)."""
    if bits == 12:                  # PIL's I;12: two samples in 3 bytes
        rowbytes = (cols * spp * 12 + 7) // 8
        b = np.frombuffer(raw, np.uint8, rows * rowbytes).reshape(
            rows, rowbytes).astype(np.uint16)
        b = np.pad(b, ((0, 0), (0, -rowbytes % 3))).reshape(rows, -1, 3)
        v = np.stack([b[..., 0] << 4 | b[..., 1] >> 4,
                      (b[..., 1] & 15) << 8 | b[..., 2]], -1)
        return v.reshape(rows, -1)[:, :cols * spp].reshape(rows, cols, spp)
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


def _undo_fp_predictor(raw: bytes, rows: int, cols: int, spp: int,
                       size: int) -> np.ndarray:
    """libtiff's fpAcc, row by row: the bytes summed at a stride of spp
    (wrapping at 8 bits), then each sample's bytes gathered from the row's
    byte planes, most significant first -> native samples [rows, cols,
    spp] (libtiff skips its byte swap after this predictor)."""
    wc = cols * spp
    b = np.frombuffer(raw, np.uint8, rows * wc * size).reshape(rows, -1)
    b = b.reshape(rows, -1, spp).cumsum(1, dtype=np.uint8).reshape(rows, -1)
    be = b.reshape(rows, size, wc).transpose(0, 2, 1)       # MSB first
    dt = np.dtype(f">f{size}")
    v = np.ascontiguousarray(be).view(dt).reshape(rows, cols, spp)
    return v.astype(dt.newbyteorder("="))


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


def _ycbcr_to_rgb(y, cb, cr, luma, ref) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit tables (float32 arithmetic, 16 fraction
    bits) and TIFFYCbCrtoRGB: uint8 planes -> uint8 [..., 3]."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    ref = [f32(v) for v in ref]

    def fix(x):                       # FIX: float product, double + 0.5
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    def clamp(f, lo, hi):
        return lo if not f >= lo else hi if f > hi else f

    two, zero = f32(2), f32(0)
    f1 = two - two * lr
    f3 = two - two * lb
    d1 = fix(clamp(f1, zero, two))
    d2 = -fix(clamp(f32(lr * f1) / lg, zero, two))
    d3 = fix(clamp(f3, zero, two))
    d4 = -fix(clamp(f32(lb * f3) / lg, zero, two))

    def code2v(c, rb, rw, cr):        # Code2V, then CLAMPw and (int32_t)
        d = rw - rb
        v = f32(f32(c - int(rb)) * f32(cr)) / (d if d != 0 else f32(1))
        return int(clamp(f32(v), f32(-4096), f32(4096)))

    cr_r, cb_b, cr_g, cb_g, y_tab = (np.zeros(256, np.int64)
                                     for _ in range(5))
    for i in range(256):
        x = i - 128
        c_r = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
        c_b = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
        cr_r[i] = (d1 * c_r + 32768) >> 16
        cb_b[i] = (d3 * c_b + 32768) >> 16
        cr_g[i] = d2 * c_r
        cb_g[i] = d4 * c_b + 32768
        y_tab[i] = code2v(i, ref[0], ref[1], 255)
    yy = y_tab[y]
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16),
                    yy + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _data_units(raw: bytes, rows: int, cols: int, sh: int, sv: int):
    """Packed YCbCr data units (sh x sv luma samples, then Cb, Cr; bytes,
    or an array of the same layout) covering rows x cols -> luma and
    replicated chroma planes [rows, cols]."""
    ur, uc = -(-rows // sv), -(-cols // sh)
    n = sh * sv + 2
    u = (np.frombuffer(raw, np.uint8, ur * uc * n) if isinstance(raw, bytes)
         else raw[:ur * uc * n]).reshape(ur, uc, n)
    y = u[..., :sh * sv].reshape(ur, uc, sv, sh).transpose(0, 2, 1, 3)
    y = y.reshape(ur * sv, uc * sh)
    cb = np.repeat(np.repeat(u[..., n - 2], sv, 0), sh, 1)
    cr = np.repeat(np.repeat(u[..., n - 1], sv, 0), sh, 1)
    return y[:rows, :cols], cb[:rows, :cols], cr[:rows, :cols]


def decode_tiff(buf: bytes, name: str = "TIFF", report: dict | None = None,
                samples_only: bool = False):
    """(array, mode, info) of the first page of a TIFF file's bytes. Where
    `report` is a dict, ``report["undefined"]`` is set to a bool mask of
    the array's pixels that PIL reads from memory libtiff never wrote (rows
    after a CCITT strip that ends early: whatever PIL's strip buffer held,
    which varies from run to run); the port gives them the buffer's
    previous strip, or 0. With `samples_only`, (samples, tags): the
    decoded samples [H, W, spp] in native byte order, as libtiff hands
    them on (before PIL's unpacking and its quirks, and unrotated), and
    the first IFD's tags."""
    head = buf[:4]
    big = head in (b"MM\x00\x2b", b"II\x2b\x00")
    if head not in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                    b"II\x00\x2a") and not big:
        raise TiffHeaderError(f"{name}: not a TIFF file")
    order = head[:2]
    if big and order == MM:
        raise TiffHeaderError(f"{name}: PIL reads no big-endian BigTIFF")
    e = "<" if order == II else ">"
    try:
        (first,) = struct.unpack_from(e + ("Q" if big else "L"), buf,
                                      8 if big else 4)
    except struct.error as err:
        raise TiffHeaderError(f"{name}: truncated header") from err
    if first == 0:
        raise TiffHeaderError(f"{name}: no more images in TIFF file")
    tags = _ifd(buf, order, big, first)

    comp_id = _one(tags, 259, 1)
    compression = COMPRESSIONS.get(comp_id)
    if compression is None:
        raise TiffHeaderError(f"{name}: unknown compression {comp_id}")
    if 0xBC01 in tags:
        raise TiffError(f"{name}: Windows Media Photo files not supported")
    planar = _one(tags, 284, 1)
    photo = file_photo = _one(tags, 262, 0)
    if compression == "tiff_jpeg":
        photo = 6               # PIL: old-style JPEG "most certainly" YCbCr
    fill = _one(tags, 266, 1)
    if 256 not in tags or 257 not in tags:
        raise TiffHeaderError(f"{name}: missing dimensions")
    w, h = _one(tags, 256), _one(tags, 257)
    if not isinstance(w, int) or not isinstance(h, int) or len(
            tags[256]) != 1 or len(tags[257]) != 1:
        raise TiffError(f"{name}: invalid dimensions")
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    spp = _one(tags, 277, 1)
    if spp > _MAX_SAMPLES:
        raise TiffHeaderError(f"{name}: invalid value for samples per "
                              f"pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise TiffHeaderError(f"{name}: unknown data organization")
    key = (order, photo, fmt, fill, bps, extra)
    if key not in OPEN_INFO:
        raise TiffHeaderError(f"{name}: unknown pixel mode {key[1:]}")
    mode, rawmode = OPEN_INFO[key]
    bits = bps[0]
    libtiff = compression != "raw"
    if not libtiff and rawmode in _NO_UNPACKER:
        raise TiffError(f"{name}: unknown raw mode {rawmode} for mode {mode}")
    # how a strip's bytes become samples: libtiff's codec output ("plain"),
    # its JPEG codec ("jpeg", YCbCr converted where `to_rgb`), its RGBA
    # interface for YCbCr under other codecs ("rgba"), or its fax decoder
    ycbcr = photo == 6
    route = "jpeg" if compression == "jpeg" else "fax" if (
        compression in _FAX) else "plain"
    if compression == "tiff_thunderscan":
        route = "thunder"
    if compression == "tiff_jpeg":
        if file_photo != 6 or planar != 1 or 324 in tags or spp != 3:
            raise TiffError(f"{name}: old-style JPEG other than YCbCr "
                            f"strips in planar configuration 1 is not "
                            f"ported")
        route = "rgba"
    to_rgb = False
    # codecs this libtiff fails on in PIL's load
    if compression in ("tiff_sgilog", "tiff_sgilog24"):
        raise TiffError(f"{name}: decoder error (LogLuvSetupDecode: "
                        f"inappropriate photometric interpretation {photo} "
                        f"for SGILog compression)")
    if compression == "webp":
        raise TiffError(f"{name}: decoder error (WEBP compression support "
                        f"is not configured in this libtiff)")
    if route == "thunder" and bits != 4:
        raise TiffError(f"{name}: decoder error (ThunderSetupDecode: wrong "
                        f"bitspersample value {bits})")
    if ycbcr and compression == "jpeg":
        to_rgb, rawmode = True, "RGB"
    elif ycbcr and libtiff and route != "thunder":
        route = "rgba"
    # the JPEG codec takes a missing YCbCrSubsampling from the first strip
    sub = tuple(tags.get(530, (2, 2) if route != "jpeg" else ()))[:2]
    if route == "rgba" and sub not in _SUBSAMPLINGS:
        raise TiffError(f"{name}: YCbCr subsampling {sub} (PIL cannot read "
                        f"it either)")
    if route == "rgba" and planar == 2 and sub != (1, 1):
        # libtiff's RGBA interface has a separate-plane YCbCr put routine
        # at 1x1 only
        raise TiffError(f"{name}: decoder error (YCbCr {sub[0]}x{sub[1]} in "
                        f"planar configuration 2)")
    if route == "jpeg" and bits != 8:
        raise TiffError(f"{name}: {bits}-bit JPEG-in-TIFF is not ported")
    if route == "fax" and (bits != 1 or spp != 1):
        raise TiffError(f"{name}: bits/sample must be 1 for Group 3/4")
    predictor = _one(tags, 317, 1) if compression in _PREDICTED else 1
    if predictor == 2 and bits not in (8, 16, 32):
        raise TiffError(f"{name}: horizontal differencing not supported "
                        f"with {bits}-bit samples")
    if predictor == 3 and fmt[0] != 3:
        raise TiffError(f"{name}: floating point predictor not supported "
                        f"with {fmt[0]} data format")
    if predictor not in (1, 2, 3):
        raise TiffError(f"{name}: decoder error (unknown predictor "
                        f"{predictor})")
    if route == "rgba" and predictor == 2 and (sub != (1, 1) or planar == 2):
        raise TiffError(f"{name}: predictor 2 with subsampled or planar "
                        f"YCbCr is not ported")
    # PIL's raw decoder reads plane k of a planar file with the one-band
    # unpacker rawmode[k] (8 bits: of a 16-bit plane, its first bytes)
    bands = rawmode.split(";")[0]
    raw16_planes = not libtiff and planar == 2 and spp > 1 and bits == 16
    if planar == 2 and spp > 1:
        if raw16_planes and any(c not in "RGBACMYK" for c in bands[:spp]):
            raise TiffError(f"{name}: planar configuration 2 with 16-bit "
                            f"{rawmode} samples uncompressed is not ported")
        if not libtiff and not raw16_planes and rawmode not in (
                "RGB", "RGBA", "CMYK", "LAB") and not (ycbcr and
                                                        rawmode == "RGBX"):
            raise TiffError(f"{name}: unknown raw mode for given image mode "
                            f"(planar configuration 2, {rawmode})")
        if libtiff and not ycbcr and 324 not in tags and rawmode.startswith(
                ("RGBX", "RGBaX", "RGBAX", "CMYKX", "PX")):
            raise TiffError(f"{name}: decoder error (planar configuration 2 "
                            f"strips with padding samples)")
        if libtiff and mode == "RGBA" and not extra:
            # without ExtraSamples PIL reads libtiff's planes as RGBa
            rawmode = "RGBa" + rawmode[4:]
    if route == "rgba":
        luma = tuple(tags.get(529, (0.299, 0.587, 0.114)))
        ref = tuple(tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)))
        if len(luma) != 3 or luma[1] == 0 or len(ref) != 6:
            raise TiffError(f"{name}: invalid YCbCrCoefficients or "
                            f"ReferenceBlackWhite")
    tables = bytes(tags[347]) if route == "jpeg" and 347 in tags else None

    kind = {1: "u", 2: "i", 3: "f"}[fmt[0]] if bits >= 8 else "u"
    planes = spp if planar == 2 else 1
    spp_plane = 1 if planar == 2 else spp
    # PIL's raw decoder reads uncompressed YCbCr as "RGBX": 4 bytes a pixel
    spp_read = 4 if ycbcr and not libtiff and planar == 1 else spp_plane
    # the samples PIL's raw decoder counts in a planar file's row stride
    plane_count = {2: 3, 5: 4, 6: 3, 8: 3}.get(photo, 1) + len(extra)
    tile = 324 in tags
    if tile:
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
    elif libtiff:       # libtiff's TIFFReadDirectory fails in PIL's load
        raise TiffError(f"{name}: decoder error (no strip or tile offsets)")
    else:
        raise TiffHeaderError(f"{name}: unknown data organization")
    if mode in ("P", "PA") and 320 not in tags:
        # PIL's _setup reads the colour map last (a KeyError)
        raise TiffHeaderError(f"{name}: palette image without a colour map")
    if not libtiff and not tile and rps == h and planar != 2:
        offsets = offsets[-1:]
    if compression == "tiff_jpeg":
        ojpeg, sub = _ojpeg_units(buf, tags, w, h, rps, len(boxes), sub,
                                  name)
        if sub[1] == 4 and (-(-w // sub[0]) * (4 * sub[0] + 2)) % 4:
            # libtiff asks OJPEGDecodeRaw for part of a row of units,
            # which it refuses, and the RGBA interface reads on
            raise TiffError(f"{name}: old-style JPEG at {sub[0]}x4 with "
                            f"partly read rows of data units is not "
                            f"ported")
        counts = counts or (0,) * len(offsets)
    if len(offsets) < len(boxes) * planes:
        raise TiffError(f"{name}: fewer strips or tiles than the image needs")
    if libtiff and (counts is None or len(counts) < len(offsets)):
        raise TiffError(f"{name}: missing strip or tile byte counts")

    samples = np.zeros((h, w, max(spp, spp_read)),
                       np.dtype(f"={kind}{-(-max(bits, 8) // 8)}"))
    undefined = np.zeros((h, w), bool)
    fax_mode = {"tiff_ccitt": tiff_codecs.CCITT_RLE,
                "tiff_raw_16": tiff_codecs.CCITT_RLEW,
                "group4": tiff_codecs.CCITT_G4}.get(compression)
    if compression == "group3":
        fax_mode = (tiff_codecs.CCITT_G3_2D if _one(tags, 292, 0) & 1
                    else tiff_codecs.CCITT_G3_1D)
    fax_state: dict = {}
    jpeg_keep: dict = {}
    strip_buf = strip_defined = None     # PIL's strip buffer, reused
    k = 0
    for p in range(planes):
        for (x, y, bw, bh) in boxes:
            rows = bh if tile else min(bh, h - y)
            rowbytes = (bw * spp_read * bits + 7) // 8
            need = rows * rowbytes
            cw, ch = min(bw, w - x), min(rows, h - y)
            off = int(offsets[k])
            if not libtiff:
                if planar == 2 and spp > 1:
                    # one byte a sample (the one-band unpacker), rows of
                    # PIL's stride: given where a tile passes the image's
                    # right edge, else the unpacker's own
                    rowbytes = (int(bw * sum(bps) / 8 / plane_count)
                                if x + bw > w else bw)
                raw = buf[off:off + rows * rowbytes]
                if len(raw) < rows * rowbytes:
                    raise TiffError(f"{name}: image file is truncated")
                if fill == 2:
                    raw = raw.translate(_REVERSE)
                if raw16_planes:
                    b = np.frombuffer(raw, np.uint8).reshape(rows, rowbytes)
                    # kept as a 16-bit sample's high byte (_to_mode)
                    samples[y:y + ch, x:x + cw, p] = b[:ch, :cw].astype(
                        np.uint16) << 8
                    k += 1
                    continue
                if planar == 2 and spp > 1 and rowbytes != bw:
                    raw = np.frombuffer(raw, np.uint8).reshape(
                        rows, rowbytes)[:, :bw].tobytes()
            else:
                # (old-style JPEG reads its strips through _OjpegSource;
                # libjpeg takes JPEG strips in their own bit order)
                data = b"" if compression == "tiff_jpeg" else _chunk_of(
                    buf, offsets, counts, k, 1 if route == "jpeg" else fill,
                    name)
                if route == "jpeg":
                    s, sub = _jpeg_strip(tables, data, to_rgb, bw, rows,
                                         spp_plane, sub if ycbcr else (1, 1),
                                         not tile and y + rows >= h, name, k,
                                         jpeg_keep)
                    # a frame narrower or shorter than the strip leaves the
                    # rest as PIL's strip buffer held it
                    if strip_buf is None:
                        strip_buf = np.zeros((rows, bw, s.shape[-1]),
                                             np.uint8)
                        strip_defined = np.zeros((rows, bw), bool)
                    strip_buf[:s.shape[0], :s.shape[1]] = s
                    strip_defined[:s.shape[0], :s.shape[1]] = True
                    samples[y:y + ch, x:x + cw, p:p + s.shape[-1]] = \
                        strip_buf[:ch, :cw]
                    undefined[y:y + ch, x:x + cw] = ~strip_defined[:ch, :cw]
                    k += 1
                    continue
                if route == "rgba" and planar == 2:
                    # the three planes' strips or tiles of this box, each
                    # a byte a sample (1x1 only)
                    ycc = [np.frombuffer(_decode_strip(
                        compression, _chunk_of(buf, offsets, counts,
                                               k + j * len(boxes), fill, name),
                        rows * bw, name, k + j * len(boxes)), np.uint8
                    ).reshape(rows, bw) for j in range(3)]
                    samples[y:y + ch, x:x + cw, :3] = _ycbcr_to_rgb(
                        *ycc, luma, ref)[:ch, :cw]
                    k += 1
                    continue
                if route == "rgba":
                    units, read = _rgba_bytes(rows, bw, sub, tile)
                    if compression == "tiff_jpeg":
                        start = (y // sub[1]) * (units // -(-rows // sub[1]))
                        raw = ojpeg[start:start + read]
                    else:
                        raw = _decode_strip(compression, data, read, name, k)
                    raw = raw + bytes(units - read)
                    if predictor == 2:
                        raw = _undo_predictor(_samples_of(
                            raw, rows, bw, 3, 8, e, "u")).tobytes()
                    planes_ycc = _data_units(raw, rows, bw, *sub)
                    samples[y:y + ch, x:x + cw, :3] = _ycbcr_to_rgb(
                        *planes_ycc, luma, ref)[:ch, :cw]
                    if read < units:
                        # the unit bytes libtiff leaves unread: whatever
                        # its strip buffer held
                        at = _data_units(np.arange(units), rows, bw, *sub)
                        unread = np.maximum.reduce(at) >= read
                        undefined[y:y + ch, x:x + cw] = unread[:ch, :cw]
                    k += 1
                    continue
                if route == "thunder":
                    got = small_codecs.thunder(data, rows, bw)
                    if got is None:
                        raise TiffError(f"{name}: ThunderScan data of strip "
                                        f"or tile {k} gives too few or too "
                                        f"many pixels")
                    raw, wrote = got
                    undefined[y:y + ch, x:x + cw] = ~wrote[:ch, :cw]
                elif route == "fax":
                    if strip_buf is None or len(strip_buf) < need:
                        strip_buf = np.zeros(need, np.uint8)
                        strip_defined = np.zeros(rows, bool)
                    ok, written = tiff_codecs.ccitt(data, fax_mode, bw, rows,
                                                    strip_buf, fax_state)
                    if not ok:
                        raise TiffError(f"{name}: {compression} data of "
                                        f"strip or tile {k} is corrupt")
                    strip_defined[:rows] |= written
                    undefined[y:y + ch, x:x + cw] = ~strip_defined[:ch, None]
                    raw = strip_buf[:need].tobytes()
                else:
                    raw = _decode_strip(compression, data, need, name, k)
            if predictor == 3:
                s = _undo_fp_predictor(raw, rows, bw, spp_read, bits // 8)
            else:
                s = _samples_of(raw, rows, bw, spp_read, bits, e, kind)
            if predictor == 2:
                s = _undo_predictor(s)
            samples[y:y + ch, x:x + cw, p:p + spp_read] = s[:ch, :cw]
            k += 1
        if route == "rgba" and planar == 2:
            break                       # the box read all three planes

    if samples_only:
        return samples, tags
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
        cmap = tags[320]
        n = len(cmap) // 3
        pal = (np.asarray(cmap, np.int64) // 256).astype(np.uint8)
        info["palette"] = np.ascontiguousarray(pal[:3 * n].reshape(3, n).T)
    orientation = _one(tags, 274)
    if orientation in range(2, 9):
        arr = np.ascontiguousarray(_transpose(arr, orientation))
        undefined = _transpose(undefined, orientation)
    if report is not None:
        report["undefined"] = np.ascontiguousarray(undefined)
    return arr, mode, info


class _OjpegSource:
    """libtiff's OJPEG byte source (tif_ojpeg.c, OJPEGReadBufferFill): the
    JPEGInterchangeFormat stream, then each strip in turn (an offset past
    the file reads nothing, a byte count of 0 or past the file reads to its
    end); `rst_at` holds the positions where a strip ends and another
    follows, where the compressed data gets a restart marker."""

    def __init__(self, buf: bytes, tags, nstrips: int):
        size = len(buf)
        parts = []
        jif, jif_len = _one(tags, 513, 0), _one(tags, 514, 0)
        if jif and jif < size:
            if not jif_len or jif + jif_len > size:
                jif_len = size - jif
            parts.append((buf[jif:jif + jif_len], False))
        offs, cnts = tags.get(273, ()), tags.get(279, ())
        for k in range(nstrips):
            off = int(offs[k]) if k < len(offs) else 0
            cnt = int(cnts[k]) if k < len(cnts) else 0
            data = b""
            if 0 < off < size:
                data = buf[off:size if not cnt else min(off + cnt, size)]
            parts.append((data, k < nstrips - 1))
        self.data = b"".join(p for p, _ in parts)
        self.rst_at, at = [], 0
        for p, rst in parts:
            at += len(p)
            if rst:
                self.rst_at.append(at)
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise TiffError("OJPEG: the JPEG data ends in its header")
        self.pos += 1
        return self.data[self.pos - 1]

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def block(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise TiffError("OJPEG: the JPEG data ends in its header")
        self.pos += n
        return out


def _ojpeg_stream(buf: bytes, tags, w: int, h: int, rps: int, nstrips: int,
                  sub, name: str):
    """The JPEG stream libtiff's OJPEG codec hands libjpeg for a YCbCr
    old-style JPEG file, and the subsampling it decodes at -> (stream,
    (sh, sv)). The header's markers are read from the byte source
    (_OjpegSource) as OJPEGReadHeaderInfoSec reads them (SOI, APPn and
    COM skipped, DRI, DQT, DHT, SOF0/1/3, SOS; anything else fails); a SOF
    there sets the subsampling (OJPEGSubsamplingCorrect) and must agree
    with the tags; without one the tables come from JPEGQTables,
    JPEGDCTables and JPEGACTables (one per component, a repeated offset
    shares the one before) and the frame from the tags. The stream is
    SOI, the tables, DRI (the stream's, or one restart interval per strip
    where there are several), SOF, SOS (baseline), the compressed bytes
    with RSTn between strips, EOI."""
    src = _OjpegSource(buf, tags, nstrips)
    qt, dc, ac = {}, {}, {}
    restart = 0
    sof = sos = None
    sh, sv = sub
    # OJPEGSubsamplingCorrect: the first SOF's luma sampling, if valid
    probe = _OjpegSource(buf, tags, nstrips)
    try:
        while probe.byte() == 0xFF:
            m = probe.byte()
            while m == 0xFF:
                m = probe.byte()
            if m in (0xC0, 0xC1, 0xC3):
                probe.block(8)              # Lf, P, Y, X, Nf
                hv = probe.block(2)[1]      # C1, H1 V1
                if hv >> 4 in (1, 2, 4) and hv & 15 in (1, 2, 4):
                    sh, sv = hv >> 4, hv & 15
                break
            if m == 0xD8:
                continue
            if m == 0xDA:
                break
            probe.block(probe.word() - 2)
    except TiffError:
        pass
    if rps < h:
        if rps % (8 * sv):
            raise TiffError(f"{name}: OJPEG: incompatible vertical "
                            f"subsampling and image strip length")
        restart = -(-w // (8 * sh)) * (rps // (8 * sv))
    while True:
        if src.pos >= len(src.data):
            raise TiffError(f"{name}: OJPEG: no JPEG data")
        if src.data[src.pos] != 0xFF:
            break
        src.pos += 1
        m = src.byte()
        while m == 0xFF:
            m = src.byte()
        if m == 0xD8:
            continue
        if 0xE0 <= m <= 0xEF or m == 0xFE:
            n = src.word()
            if n < 2:
                raise TiffError(f"{name}: OJPEG: corrupt JPEG data")
            src.block(n - 2)
        elif m == 0xDD:
            if src.word() != 4:
                raise TiffError(f"{name}: OJPEG: corrupt DRI marker")
            restart = src.word()
        elif m == 0xDB:
            n = src.word() - 2
            if n <= 0:
                raise TiffError(f"{name}: OJPEG: corrupt DQT marker")
            while n > 0:
                if n < 65:
                    raise TiffError(f"{name}: OJPEG: corrupt DQT marker")
                t = src.block(65)
                if t[0] & 0xF0 or t[0] & 15 > 3:
                    raise TiffError(f"{name}: OJPEG: corrupt DQT marker")
                qt[t[0] & 15] = b"\xff\xdb\x00\x43" + t
                n -= 65
        elif m == 0xC4:
            n = src.word()
            if n <= 2:
                raise TiffError(f"{name}: OJPEG: corrupt DHT marker")
            body = src.block(n - 2)
            o = body[0]
            if o & 0xF0 not in (0, 16) or o & 15 > 3:
                raise TiffError(f"{name}: OJPEG: corrupt DHT marker")
            (dc if o & 0xF0 == 0 else ac)[o & 15] = (
                b"\xff\xc4" + struct.pack(">H", n) + body)
        elif m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise TiffError(f"{name}: OJPEG: corrupt JPEG data")
            n = src.word()
            if n < 11 or (n - 8) % 3 or (n - 8) // 3 != 3:
                raise TiffError(f"{name}: OJPEG: corrupt SOF marker")
            if src.byte() != 8:
                raise TiffError(f"{name}: OJPEG: JPEG data of other than "
                                f"8 bits per sample")
            fy, fx = src.word(), src.word()
            if fy < h or fx < w or fx > w:
                raise TiffError(f"{name}: OJPEG: JPEG frame {fx}x{fy} for "
                                f"a {w}x{h} image")
            if src.byte() != 3:
                raise TiffError(f"{name}: OJPEG: corrupt SOF marker")
            comps = src.block(9)
            if comps[1] != (sh << 4 | sv) or comps[4] != 17 or \
                    comps[7] != 17:
                raise TiffError(f"{name}: OJPEG: unexpected subsampling "
                                f"values")
            sof = (m, fy, fx, comps)
        elif m == 0xDA:
            if src.word() != 12 or src.byte() != 3:
                raise TiffError(f"{name}: OJPEG: corrupt SOS marker")
            if sof is None:
                raise TiffError(f"{name}: OJPEG: SOS before SOF")
            sos = src.block(6)
            src.block(3)                     # Ss, Se, Ah/Al: not checked
            break
        else:
            raise TiffError(f"{name}: OJPEG: unknown marker type {m} in "
                            f"JPEG data")
    if sof is None:                          # tables from the tags
        cs = []
        for tag, kind, out in ((519, "Q", qt), (520, "DC", dc),
                               (521, "AC", ac)):
            offs = tags.get(tag, ())
            if not offs or not offs[0]:
                raise TiffError(f"{name}: OJPEG: missing JPEG tables")
            sel = []
            for m in range(3):
                off = int(offs[m]) if m < len(offs) else 0
                if off and (m == 0 or off != int(offs[m - 1])):
                    if any(off == int(offs[n]) for n in range(m - 1)):
                        raise TiffError(f"{name}: OJPEG: corrupt JPEG{kind}"
                                        f"Tables tag value")
                    if kind == "Q":
                        t = buf[off:off + 64]
                        if len(t) < 64:
                            raise TiffError(f"{name}: OJPEG: short table")
                        out[m] = b"\xff\xdb\x00\x43" + bytes([m]) + t
                    else:
                        counts = buf[off:off + 16]
                        q = sum(counts)
                        vals = buf[off + 16:off + 16 + q]
                        if len(counts) < 16 or len(vals) < q:
                            raise TiffError(f"{name}: OJPEG: short table")
                        cls = 0 if kind == "DC" else 16
                        out[m] = (b"\xff\xc4" + struct.pack(">H", 19 + q)
                                  + bytes([cls | m]) + counts + vals)
                    sel.append(m)
                else:
                    sel.append(sel[-1] if sel else 0)
            cs.append(sel)
        comps = bytes([0, sh << 4 | sv, cs[0][0], 1, 17, cs[0][1], 2, 17,
                       cs[0][2]])
        sof = (0xC0, h, w, comps)
        sos = bytes([0, cs[1][0] << 4 | cs[2][0], 1, cs[1][1] << 4 |
                     cs[2][1], 2, cs[1][2] << 4 | cs[2][2]])
    # the compressed bytes, with RSTn where a strip ends and another follows
    data, parts, at, n_rst = src.data, [], src.pos, 0
    for end in src.rst_at:
        if end >= at:
            parts.append(data[at:end] + bytes([0xFF, 0xD0 + n_rst % 8]))
            n_rst, at = n_rst + 1, end
    parts.append(data[at:])
    m, fy, fx, comps = sof
    stream = (b"\xff\xd8" + b"".join(qt[k] for k in sorted(qt))
              + b"".join(dc[k] for k in sorted(dc))
              + b"".join(ac[k] for k in sorted(ac))
              + (b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
                 if restart else b"")
              + bytes([0xFF, m]) + struct.pack(">HBHHB", 17, 8, fy, fx, 3)
              + comps + b"\xff\xda\x00\x0c\x03" + sos + b"\x00\x3f\x00"
              + b"".join(parts) + b"\xff\xd9")
    return stream, (sh, sv)


def _ojpeg_units(buf: bytes, tags, w: int, h: int, rps: int, nstrips: int,
                 sub, name: str):
    """Old-style JPEG as libtiff's OJPEGDecodeRaw hands it to the RGBA
    interface: libjpeg's raw (unconverted, not upsampled) YCbCr output
    packed into data units (sh x sv luma, then Cb, Cr), row of units
    after row -> (the image's units as bytes, (sh, sv))."""
    stream, (sh, sv) = _ojpeg_stream(buf, tags, w, h, rps, nstrips, sub,
                                     name)
    try:
        (y, cb, cr), frame = jpeg.decode_raw_components(stream)
    except (jpeg.JpegError, ValueError) as err:
        raise TiffError(f"{name}: OJPEG: {err}") from err
    ur, uc = -(-h // sv), -(-w // sh)
    ys = y[:ur * sv, :uc * sh].reshape(ur, sv, uc, sh).transpose(0, 2, 1, 3)
    units = np.concatenate([ys.reshape(ur, uc, sh * sv),
                            cb[:ur, :uc, None], cr[:ur, :uc, None]], -1)
    return units.astype(np.uint8).tobytes(), (sh, sv)


def _chunk_of(buf: bytes, offsets, counts, k: int, fill: int,
              name: str) -> bytes:
    """Strip or tile `k`'s bytes as libtiff reads them."""
    data = buf[int(offsets[k]):int(offsets[k]) + int(counts[k])]
    if len(data) < int(counts[k]):
        raise TiffError(f"{name}: read error on strip or tile {k}")
    return data.translate(_REVERSE) if fill == 2 else data


def _decode_strip(compression: str, data: bytes, need: int, name: str,
                  k: int) -> bytes:
    """libtiff's codec for one strip or tile: its first `need` bytes, or
    TiffError where libtiff fails (a short strip included)."""
    if compression == "tiff_lzw":
        raw = lzw.tiff_lzw(data, need)
        if raw == -3:                   # LZWDecodeCompat
            raw = lzw.tiff_lzw_compat(data, need)
    elif compression == "packbits":
        raw = lzw.packbits(data, need)
    elif compression in ("lzma", "zstd"):
        try:
            return getattr(tiff_codecs, compression)(data, need)
        except ValueError as err:
            raise TiffError(f"{name}: strip or tile {k}: {err}") from err
    else:
        try:
            raw = zlib.decompressobj().decompress(data, need)
        except zlib.error as err:
            raise TiffError(f"{name}: Deflate error in strip or tile {k}: "
                            f"{err}") from err
        if len(raw) < need:
            raw = -2
    if isinstance(raw, int):
        raise TiffError(f"{name}: {compression} data of strip or tile {k} "
                        f"is corrupt or short")
    return raw


def _rgba_bytes(rows: int, cols: int, sub, tile: bool):
    """(the bytes of a YCbCr strip's or tile's data units, the bytes
    libtiff's RGBA interface reads of them): whole units for a tile; for a
    strip TIFFScanlineSize, which divides a row of units by the vertical
    subsampling (rounding down), times the rows rounded up to whole
    units, so that where a row of units does not divide, the last units
    stay partly unread."""
    sh, sv = sub
    unit_row = -(-cols // sh) * (sh * sv + 2)
    units = -(-rows // sv) * unit_row
    if tile:
        return units, units
    return units, -(-rows // sv) * sv * (unit_row // sv)


def _jpeg_strip(tables, data, to_rgb, seg_w, seg_h, comps, sub, last_strip,
                name, k, keep):
    """One JPEG-in-TIFF strip or tile, held to libtiff's JPEGPreDecode
    checks: its frame's size (a last strip may be taller than the rows
    left, any may be narrower or shorter), component count and sampling
    factors (`sub`, or where empty
    those of this, the first, strip). -> (samples, sub)."""
    try:
        s, frame = jpeg.decode_tiff_jpeg(tables, data, to_rgb, keep)
    except jpeg.JpegError as err:
        raise TiffError(f"{name}: JPEG strip or tile {k}: {err}") from err
    fw, fh = frame["w"], frame["h"]
    if fw > seg_w or (fh > seg_h and not last_strip):
        raise TiffError(f"{name}: JPEG strip or tile {k} is {fw}x{fh}, "
                        f"expected {seg_w}x{seg_h}")
    cs = frame["comps"]
    if len(cs) != comps:
        raise TiffError(f"{name}: improper JPEG component count")
    sub = tuple(sub) or (cs[0]["h"], cs[0]["v"])
    if (cs[0]["h"], cs[0]["v"]) != sub or any(
            (c["h"], c["v"]) != (1, 1) for c in cs[1:]):
        raise TiffError(f"{name}: improper JPEG sampling factors")
    return s[:seg_h], sub


def read_tiff_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a TIFF."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        return decode_tiff(buf, path)
    except TypeError as err:        # a BYTE tag where PIL compares numbers
        raise TiffHeaderError(f"{path}: {err}") from err
