"""Image helpers: PIL's reading and mode conversions without PIL, and
resampling for the eval CLIs.

The JAX package reads LDR frames with ``np.asarray(Image.open(p))``
(irgs_tpu/scene/datasets.py:59-60) and COLMAP frames with
``Image.open(p).convert("RGB")`` (irgs_tpu/scene/colmap.py:122). PIL picks
the decoder from the file's first bytes, whatever its name, and so does
`read_image_like_pil`; the port's readers (utils/png.py, jpeg.py, tiff.py,
bmp.py, gif.py, webp.py) return PIL's array together with its mode (and
palette); `to_rgb_like_pil` then converts as Pillow's Convert.c does for
each mode.

A file that none of those readers takes is identified as PIL would
identify it: each of Pillow 12's other plugins in ``Image.OPEN``'s order,
by its ``_accept`` prefix check (and, for the plugins that have none, the
first checks of their ``_open``). A format PIL reads and the port does not
(PPM, TGA, ICO, QOI, PCX, SGI, PSD, JPEG 2000, AVIF, DDS, ...) raises
`UnreadableImageError` "<FORMAT> is not ported", naming PIL's format;
bytes that no plugin accepts raise "cannot identify image file", as PIL's
UnidentifiedImageError.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch.nn.functional as F

# first bytes -> reader, as PIL's plugins accept them
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                  b"MM\x00\x2b", b"II\x2b\x00")


def _i16(b, at=0):
    return struct.unpack_from("<H", b, at)[0] if len(b) >= at + 2 else -1


def _i32(b, at=0):
    return struct.unpack_from("<I", b, at)[0] if len(b) >= at + 4 else -1


def _i32be(b, at=0):
    return struct.unpack_from(">I", b, at)[0] if len(b) >= at + 4 else -1


def _is_int(v):
    try:
        return v == int(v)
    except (OverflowError, ValueError):
        return False


def _spider(head):
    """SpiderImagePlugin.isSpiderHeader, either byte order."""
    if len(head) < 92:
        return False
    for e in "><":
        h = (99,) + struct.unpack(e + "23f", head[:92])
        if all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)) \
                and int(h[5]) in (1, 3, -11, -12, -21, -22) \
                and int(h[22]) == int(h[13]) * int(h[23]):
            return True
    return False


_IM_KEY = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {b"Comment", b"Date", b"Digitalization equipment",
            b"File size (no of images)", b"Lut", b"Name", b"Scale (x,y)",
            b"Image size (x*y)", b"Image type"}


def _im(head):
    """ImImagePlugin's header: text lines of 'key: value' up to a NUL or
    ^Z, at least one of them a known key."""
    if b"\n" not in head[:100]:
        return False
    known = 0
    for line in re.split(rb"\r?\n", head.split(b"\0")[0].split(b"\x1a")[0]):
        line = line.lstrip(b"\r")
        if not line:
            continue
        m = _IM_KEY.match(line)
        if not m or len(line) > 100:
            return False
        known += m.group(1) in _IM_TAGS
    return known > 0


def _imt(head):
    """ImtImagePlugin: 'width N', 'height N' and 'pixel n8' lines before a
    form feed."""
    if b"\n" not in head[:100] or b"\x0c" not in head:
        return False
    keys = dict(re.findall(rb"^([a-z]*) ([^ \r\n]*)",
                           head.split(b"\x0c")[0], re.M))
    return (keys.get(b"pixel") == b"n8" and keys.get(b"width", b"0").isdigit()
            and keys.get(b"height", b"0").isdigit()
            and int(keys[b"width"]) > 0 and int(keys[b"height"]) > 0)


def _tga(h):
    """TgaImagePlugin's header checks."""
    return (len(h) >= 18 and h[1] in (0, 1) and _i16(h, 12) > 0
            and _i16(h, 14) > 0 and h[16] in (1, 8, 16, 24, 32)
            and h[2] in (1, 2, 3, 9, 10, 11))


# Pillow 12's plugins other than the ported ones, in Image.OPEN's order:
# (format, does PIL's plugin take these first bytes)
_PIL_FORMATS = (
    ("AVIF", lambda h: h[4:8] == b"ftyp" and h[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda h: h.startswith((b"BLP1", b"BLP2"))),
    ("DIB", lambda h: _i32(h) in (12, 40, 52, 56, 64, 108, 124)),
    ("BUFR", lambda h: h.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda h: h.startswith(b"\0\0\2\0") and _i16(h, 4) > 0),
    ("PCX", lambda h: len(h) >= 2 and h[0] == 10 and h[1] in (0, 2, 3, 5)),
    ("DCX", lambda h: _i32(h) == 0x3ADE68B1),
    ("DDS", lambda h: h.startswith(b"DDS ")),
    ("EPS", lambda h: h.startswith(b"%!PS") or _i32(h) == 0xC6D3D0C5),
    ("FITS", lambda h: h.startswith(b"SIMPLE")),
    ("FLI", lambda h: len(h) >= 16 and _i16(h, 4) in (0xAF11, 0xAF12)
     and _i16(h, 14) in (0, 3)),
    ("FTEX", lambda h: h.startswith(b"FTEX")),
    ("GBR", lambda h: len(h) >= 8 and _i32be(h) >= 20
     and _i32be(h, 4) in (1, 2)),
    ("GRIB", lambda h: len(h) >= 8 and h.startswith(b"GRIB") and h[7] == 1),
    ("HDF5", lambda h: h.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", lambda h: h.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", lambda h: h.startswith(b"icns")),
    ("ICO", lambda h: h.startswith(b"\0\0\1\0")),
    ("IM", _im),
    ("IMT", _imt),
    ("IPTC", lambda h: len(h) >= 5 and h[0] == 0x1C
     and h[1] in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)),
    ("MCIDAS", lambda h: h.startswith(b"\0\0\0\0\0\0\0\4")),
    ("MPEG", lambda h: h.startswith(b"\0\0\1\xb3")),
    ("MSP", lambda h: h.startswith((b"DanM", b"LinS"))),
    ("PCD", lambda h: h[2048:2052] == b"PCD_"),
    ("PIXAR", lambda h: h.startswith(b"\200\350\000\000")),
    ("PPM", lambda h: len(h) >= 2 and h[:1] == b"P" and h[1] in b"0123456fy"),
    ("PSD", lambda h: h.startswith(b"8BPS")),
    ("QOI", lambda h: h.startswith(b"qoif")),
    ("SGI", lambda h: h[:2] == b"\x01\xda"),
    ("SPIDER", _spider),
    ("SUN", lambda h: _i32be(h) == 0x59A66A95),
    ("TGA", _tga),
    ("WMF", lambda h: h.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                    b"\x01\x00\x00\x00"))),
    ("XBM", lambda h: h.lstrip().startswith(b"#define")),
    ("XPM", lambda h: h.startswith(b"/* XPM */")),
    ("XVThumb", lambda h: h.startswith(b"P7 332")),
)


def _pil_format(head: bytes):
    """The name of the first of PIL's other plugins that takes a file
    starting with `head` (its first 2,052 bytes or more), or None."""
    for name, accepts in _PIL_FORMATS:
        if accepts(head):
            return name
    return None


class UnreadableImageError(ValueError):
    """None of the port's readers (PNG, JPEG, TIFF, BMP, GIF, WebP) takes
    the file: PIL's UnidentifiedImageError where PIL has no reader for it
    either, else a container PIL reads that is not ported yet."""


def read_image_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)``, the decoder
    chosen by the file's content: ``np.asarray(im)``, ``im.mode`` and
    ``im.info``'s palette, transparency and comment where the file has
    them."""
    with open(path, "rb") as f:
        head = f.read(4096)
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        from . import png
        return png.read_png_like_pil(path)
    if head.startswith(b"\xff\xd8\xff"):
        from . import jpeg
        return jpeg.read_jpeg_like_pil(path)
    if head.startswith(_TIFF_PREFIXES):
        from . import tiff
        return tiff.read_tiff_like_pil(path)
    if head.startswith(b"BM"):
        from . import bmp
        return bmp.read_bmp_like_pil(path)
    if head.startswith((b"GIF87a", b"GIF89a")):
        from . import gif
        return gif.read_gif_like_pil(path)
    if (head.startswith(b"RIFF") and head[8:12] == b"WEBP"
            and head[12:16] in (b"VP8 ", b"VP8L", b"VP8X")):
        from . import webp
        return webp.read_webp_like_pil(path)
    name = _pil_format(head)
    if name is not None:
        raise UnreadableImageError(f"{path}: {name} is not ported (PIL "
                                   f"reads it as {name})")
    raise UnreadableImageError(f"cannot identify image file {path}")


def _muldiv255(a, b):
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def to_rgb_like_pil(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """``np.asarray(im.convert("RGB"))`` for an image of PIL mode `mode`
    whose ``np.asarray`` is `arr`: uint8 [H, W, 3].

      1      0 or 255;                L, LA   the grey replicated;
      I;16,  the grey clamped at 255;  I       the grey clipped to 0..255;
      I;16B
      F      the grey truncated, 0 at or below 0 (and NaN), 255 at or
             above 255;
      P, PA  the palette's colour, black past its last entry (so too an
             "L" image that carries a palette, as a GIF frame can);
      RGB    as is;                    RGBA    alpha dropped;
      CMYK   cmyk2rgb: each of R, G, B is 255 - K - C (M, Y) * (255 - K)
             / 255, rounded as MULDIV255.
    CIELab (LAB) raises: PIL converts it, the port does not yet.
    """
    arr = np.asarray(arr)
    if mode == "1":
        g = np.where(arr, 255, 0).astype(np.uint8)
    elif mode == "L" and palette is None:
        g = arr.astype(np.uint8)
    elif mode in ("I;16", "I;16B"):
        g = np.minimum(arr, 255).astype(np.uint8)
    elif mode == "I":
        g = np.clip(arr, 0, 255).astype(np.uint8)
    elif mode == "F":
        with np.errstate(invalid="ignore"):
            g = np.where(arr >= 255, 255, np.where(arr > 0, arr, 0))
        g = np.nan_to_num(g, nan=0.0).astype(np.uint8)
    elif mode == "LA":
        g = arr[..., 0].astype(np.uint8)
    elif mode in ("P", "PA", "L"):
        lut = np.zeros((256, 3), np.uint8)
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
        return lut[arr[..., 0] if mode == "PA" else arr]
    elif mode == "RGB":
        return arr.astype(np.uint8)
    elif mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3], np.uint8)
    elif mode == "CMYK":
        nk = 255 - arr[..., 3:4].astype(np.int32)
        return np.clip(nk - _muldiv255(arr[..., :3], nk), 0, 255).astype(
            np.uint8)
    else:
        raise UnreadableImageError(f"convert('RGB') from mode {mode} is not "
                                   f"ported")
    return np.repeat(g[..., None], 3, -1)


def read_rgb_like_pil(path: str) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path).convert("RGB"))``: uint8
    [H, W, 3]."""
    arr, mode, info = read_image_like_pil(path)
    return to_rgb_like_pil(arr, mode, info.get("palette"))


def resize_bilinear(img, h: int, w: int):
    """[H, W, C] -> [h, w, C], as ``jax.image.resize(img, (h, w, C),
    "bilinear")`` computes it: half-pixel centres, and a triangle filter
    widened by the scale when downscaling (JAX's default antialias)."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)
