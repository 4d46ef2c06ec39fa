"""TIFF reader: the first page, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info``'s palette give it (Pillow 12, libtiff 4.7).

PIL picks the mode from (byte order, photometric, sample format, fill
order, bits per sample, extra samples) in its OPEN_INFO table, copied here
for the layouts read: bilevel and grey at 1, 2, 4, 8 and 16 bits, signed
16- and 32-bit and unsigned 32-bit grey (mode I), 32-bit float (F), grey +
alpha, RGB(A) at 8 and 16 bits with unassociated or associated (divided
out, as PIL's RGBa unpacker does) alpha or padding samples, palette at 1,
2, 4 and 8 bits (with alpha: PA), CMYK at 8 and 16 bits, CIELab and YCbCr.
16-bit colour keeps the high byte of each sample.

Uncompressed files go through PIL's own raw decoder (the strips' byte
counts and the predictor tag are ignored; a file that ends early is
refused; YCbCr reads as "RGBX", 4 bytes a pixel). The other codecs go
through libtiff, as here: PackBits and LZW (csrc/lzw_decode.cpp), Deflate
(8 and 32946, zlib), Zstandard (50000, csrc/zstd_decode.cpp) and LZMA
(34925, csrc/xz_decode.cpp), each strip or tile decoded to its full size
with predictor 2 undone on 8-, 16- and 32-bit samples; JPEG (7) through
utils/jpeg.py with the JPEGTables tag and the colour space the container
gives (YCbCr converted to RGB after upsampling within each strip, every
other photometric passed through); YCbCr under the other codecs through
libtiff's RGBA interface (data units at subsampling 1x1 to 4x4, its
TIFFYCbCrToRGB tables from YCbCrCoefficients and ReferenceBlackWhite);
CCITT modified Huffman (2), T.4 (3, 1D or 2D) and T.6 (4) through
csrc/ccitt_decode.cpp. Damaged strips read as PIL reads them: libtiff's
fax recovery (bad rows whitened, T.4's "no EOL" retry, T.6 strips that
stop early), libjpeg-turbo's (corrupt codes, data that runs out, its SIMD
IDCT's 16-bit lanes), libzstd's and liblzma's checks where they fail a
strip; pixels libtiff never writes (a T.6 strip that stops early in the
first strip) are what PIL's buffer held and are reported (`report`).
Strips and tiles, planar configurations 1 and 2, byte orders II and MM,
classic and (little-endian) BigTIFF headers, fill order 2, and the EXIF
orientation PIL applies on load (ImageOps.exif_transpose). PIL's quirks
are kept: a big-endian compressed file of signed or float samples reads
byte-swapped (libtiff hands PIL native order, PIL unpacks it as big
endian again); with planar configuration 2 a CIELab file reads a and b
offset by 128 and, through libtiff, grey + alpha and palette + alpha read
alpha 0.

Streams PIL refuses raise TiffError, and so do the ones not ported yet,
named "not ported": old-style JPEG (6), WebP-in-TIFF (50001), SGILog
(34676, 34677), ThunderScan (32809) and the other compressions PIL lists,
12-bit samples, the float predictor 3, old-style LZW, YCbCr in planar
configuration 2, YCbCr 4x4 strips whose unit rows libtiff reads in part,
and planar configuration 2 where PIL's raw decoder reads something other
than the planes (16-bit samples).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import jpeg, lzw, tiff_codecs

II, MM = b"II", b"MM"


def _both(photo, fmt, fill, bps, extra, mode, raw):
    return {(II, photo, fmt, fill, bps, extra): (mode, raw),
            (MM, photo, fmt, fill, bps, extra): (mode, raw)}


# (byte order, photometric, sample format, fill order, bits, extra samples)
# -> (mode, raw mode): PIL's TiffImagePlugin.OPEN_INFO, without 12 bits.
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
OPEN_INFO.update(_both(6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"))

# PIL's COMPRESSION_INFO; the ones read here map to a decoder
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
_READ = {"raw", "tiff_lzw", "packbits", "tiff_adobe_deflate", "tiff_deflate",
         "jpeg", "lzma", "zstd", "tiff_ccitt", "group3", "group4"}
_FAX = {"tiff_ccitt", "group3", "group4"}
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
    """Packed YCbCr data units (sh x sv luma samples, then Cb, Cr) covering
    rows x cols -> luma and replicated chroma planes [rows, cols]."""
    ur, uc = -(-rows // sv), -(-cols // sh)
    n = sh * sv + 2
    u = np.frombuffer(raw, np.uint8, ur * uc * n).reshape(ur, uc, n)
    y = u[..., :sh * sv].reshape(ur, uc, sv, sh).transpose(0, 2, 1, 3)
    y = y.reshape(ur * sv, uc * sh)
    cb = np.repeat(np.repeat(u[..., n - 2], sv, 0), sh, 1)
    cr = np.repeat(np.repeat(u[..., n - 1], sv, 0), sh, 1)
    return y[:rows, :cols], cb[:rows, :cols], cr[:rows, :cols]


def decode_tiff(buf: bytes, name: str = "TIFF", report: dict | None = None):
    """(array, mode, info) of the first page of a TIFF file's bytes. Where
    `report` is a dict, ``report["undefined"]`` is set to a bool mask of
    the array's pixels that PIL reads from memory libtiff never wrote (rows
    after a CCITT strip that ends early: whatever PIL's strip buffer held,
    which varies from run to run); the port gives them the buffer's
    previous strip, or 0."""
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
    if compression == "tiff_jpeg":
        raise TiffError(f"{name}: old-style JPEG (compression 6) is not "
                        f"ported yet")
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
    # how a strip's bytes become samples: libtiff's codec output ("plain"),
    # its JPEG codec ("jpeg", YCbCr converted where `to_rgb`), its RGBA
    # interface for YCbCr under other codecs ("rgba"), or its fax decoder
    ycbcr = photo == 6
    route = "jpeg" if compression == "jpeg" else "fax" if (
        compression in _FAX) else "plain"
    to_rgb = False
    if ycbcr and planar == 2 and libtiff:
        raise TiffError(f"{name}: YCbCr with planar configuration 2 is not "
                        f"ported")
    if ycbcr and compression == "jpeg":
        to_rgb, rawmode = True, "RGB"
    elif ycbcr and libtiff:
        route = "rgba"
    # the JPEG codec takes a missing YCbCrSubsampling from the first strip
    sub = tuple(tags.get(530, (2, 2) if route != "jpeg" else ()))[:2]
    if route == "rgba" and sub not in _SUBSAMPLINGS:
        raise TiffError(f"{name}: YCbCr subsampling {sub} (PIL cannot read "
                        f"it either)")
    if route == "jpeg" and bits != 8:
        raise TiffError(f"{name}: {bits}-bit JPEG-in-TIFF is not ported")
    if route == "fax" and (bits != 1 or spp != 1):
        raise TiffError(f"{name}: bits/sample must be 1 for Group 3/4")
    predictor = _one(tags, 317, 1) if compression in _PREDICTED else 1
    if predictor == 2 and bits not in (8, 16, 32):
        raise TiffError(f"{name}: horizontal differencing not supported "
                        f"with {bits}-bit samples")
    if predictor not in (1, 2):
        raise TiffError(f"{name}: TIFF predictor {predictor} is not ported "
                        f"yet")
    if route == "rgba" and predictor == 2 and sub != (1, 1):
        raise TiffError(f"{name}: predictor 2 with subsampled YCbCr is not "
                        f"ported")
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
    spp_read = 4 if ycbcr and not libtiff else spp_plane
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
    else:
        raise TiffError(f"{name}: unknown data organization")
    if not libtiff and not tile and rps == h and planar != 2:
        offsets = offsets[-1:]
    if len(offsets) < len(boxes) * planes:
        raise TiffError(f"{name}: fewer strips or tiles than the image needs")
    if libtiff and (counts is None or len(counts) < len(offsets)):
        raise TiffError(f"{name}: missing strip or tile byte counts")

    samples = np.zeros((h, w, max(spp, spp_read)),
                       np.dtype(f"={kind}{max(bits, 8) // 8}"))
    undefined = np.zeros((h, w), bool)
    fax_mode = {"tiff_ccitt": tiff_codecs.CCITT_RLE,
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
                raw = buf[off:off + rows * rowbytes]
                if len(raw) < rows * rowbytes:
                    raise TiffError(f"{name}: image file is truncated")
                if fill == 2:
                    raw = raw.translate(_REVERSE)
            else:
                data = buf[off:off + int(counts[k])]
                if len(data) < int(counts[k]):
                    raise TiffError(f"{name}: read error on strip or tile "
                                    f"{k}")
                if fill == 2 and route != "jpeg":
                    data = data.translate(_REVERSE)
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
                if route == "rgba":
                    raw = _decode_strip(compression, data, _rgba_bytes(
                        rows, bw, sub, tile, name), name, k)
                    if predictor == 2:
                        raw = _undo_predictor(_samples_of(
                            raw, rows, bw, 3, 8, e, "u")).tobytes()
                    planes_ycc = _data_units(raw, rows, bw, *sub)
                    samples[y:y + ch, x:x + cw, :3] = _ycbcr_to_rgb(
                        *planes_ycc, luma, ref)[:ch, :cw]
                    k += 1
                    continue
                if route == "fax":
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
            s = _samples_of(raw, rows, bw, spp_read, bits, e, kind)
            if predictor == 2:
                s = _undo_predictor(s)
            samples[y:y + ch, x:x + cw, p:p + spp_read] = s[:ch, :cw]
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
        undefined = _transpose(undefined, orientation)
    if report is not None:
        report["undefined"] = np.ascontiguousarray(undefined)
    return arr, mode, info


def _decode_strip(compression: str, data: bytes, need: int, name: str,
                  k: int) -> bytes:
    """libtiff's codec for one strip or tile: its first `need` bytes, or
    TiffError where libtiff fails (a short strip included)."""
    if compression == "tiff_lzw":
        raw = lzw.tiff_lzw(data, need)
        if raw == -3:
            raise TiffError(f"{name}: old-style LZW is not ported yet")
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


def _rgba_bytes(rows: int, cols: int, sub, tile: bool, name: str) -> int:
    """The bytes libtiff's RGBA interface reads of a YCbCr strip or tile:
    whole data units (TIFFScanlineSize, which divides a row of units by
    the vertical subsampling, times the rows rounded up to whole units)."""
    sh, sv = sub
    unit_row = -(-cols // sh) * (sh * sv + 2)
    units = -(-rows // sv) * unit_row
    if tile:
        return units
    read = -(-rows // sv) * sv * (unit_row // sv)
    if read != units:
        raise TiffError(f"{name}: YCbCr {sh}x{sv} strips whose data-unit "
                        f"rows do not divide by {sv} are not ported (libtiff "
                        f"leaves part of them unread)")
    return read


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
        return decode_tiff(f.read(), path)
