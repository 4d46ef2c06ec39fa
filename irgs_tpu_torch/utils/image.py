"""Image helpers: PIL's reading and mode conversions without PIL, and
resampling for the eval CLIs.

The JAX package reads LDR frames with ``np.asarray(Image.open(p))``
(irgs_tpu/scene/datasets.py:59-60) and COLMAP frames with
``Image.open(p).convert("RGB")`` (irgs_tpu/scene/colmap.py:122). PIL picks
the decoder from the file's content, whatever its name, and so does
`read_image_like_pil`; the port's readers (utils/png.py, jpeg.py, tiff.py,
bmp.py with DIB, gif.py, webp.py, ppm.py, tga.py, ico.py with CUR,
qoi.py, pcx.py, sgi.py, jpeg2000.py for JP2 and J2K, psd.py, dds.py,
ftex.py, blp.py, icns.py, and for Pillow's last small rasters im.py,
xbm.py, xpm.py, sun.py, msp.py, spider.py, fits.py, dcx.py, fli.py,
pcd.py, pixar.py, gbr.py, mcidas.py, imt.py, xvthumb.py and iptc.py)
return PIL's array together with its mode (and palette);
`to_rgb_like_pil` then converts as Pillow's Convert.c does for each mode.

Plugins are tried as Image.open tries them in a fresh process (_PLUGINS):
first the six Image.preinit loads (BMP, DIB, GIF, JPEG, PPM, PNG), then,
once none of those took the file, Image.init's whole list in Image.OPEN's
order. (A process that has called Image.init() before its first open
tries every plugin in Image.OPEN's order from the start, BMP after AVIF
and BLP; the fresh order is the one a loader's first frame meets.) A
plugin whose prefix check passes is tried; where its header parse fails
as PIL's _open fails (SyntaxError, IndexError, TypeError, KeyError,
EOFError, struct.error, or no size: `NotThisFormat`), the next plugin is
tried, as PIL does; errors in the pixel data (PIL's load) raise. A format
PIL reads and the port does not (AVIF, BUFR, EPS, GRIB, HDF5, MPEG, WMF)
raises `UnreadableImageError` "<FORMAT> is not ported", naming PIL's
format: for those plugins only their prefix check is modelled, so a file
such a plugin would refuse in _open stops there. The plugins without a
prefix check (IM, IMT, IPTC, PCD, SPIDER, TGA) run their whole _open on
every file that reaches them, as PIL does, each a literal port of the
plugin's (`pil_open` maps its errors). Bytes that no plugin takes raise
"cannot identify image file", as PIL's UnidentifiedImageError. The PNG,
JPEG,
TIFF and GIF readers model their plugin's _open up to the pixel data (PNG:
the chunks before IDAT with their CRCs; JPEG: the markers up to the first
SOS; TIFF: the IFD as PIL loads it and _setup's checks; GIF: the blocks up
to the first frame's LZW code size) and hand the file on where it fails
so, as does the JPEG 2000 reader (Jpeg2KImagePlugin._open: the JP2 boxes
or SIZ, and the first COM). WebP's _open fails only with OSError (libwebp's demuxer), which PIL
does not hand on, so a bad WebP header raises.
"""

from __future__ import annotations

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


# Pillow 12's plugins in the order PIL tries them in a fresh process:
# (format, its _accept on the file's first 16 bytes -- None where the
# plugin has none and PIL tries its _open on every file --, the port's
# reader as "module.function", or None where the port does not read it:
# AVIF, BUFR, EPS, GRIB, HDF5, MPEG, WMF). The accept function of WMF,
# which the port does not read, takes the file's first 4,096 bytes
# (_WHOLE_HEAD).
_PLUGINS = (
    ("BMP", lambda h: h.startswith(b"BM"), "bmp.read_bmp_like_pil"),
    ("DIB", lambda h: _i32(h) in (12, 40, 52, 56, 64, 108, 124),
     "bmp.read_dib_like_pil"),
    ("GIF", lambda h: h.startswith((b"GIF87a", b"GIF89a")),
     "gif.read_gif_like_pil"),
    ("JPEG", lambda h: h.startswith(b"\xff\xd8\xff"),
     "jpeg.read_jpeg_like_pil"),
    ("PPM", lambda h: len(h) >= 2 and h[:1] == b"P" and h[1] in b"0123456fy",
     "ppm.read_ppm_like_pil"),
    ("PNG", lambda h: h.startswith(b"\x89PNG\r\n\x1a\n"),
     "png.read_png_like_pil"),
    ("AVIF", lambda h: h[4:8] == b"ftyp" and h[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1"), None),
    ("BLP", lambda h: h.startswith((b"BLP1", b"BLP2")),
     "blp.read_blp_like_pil"),
    ("BUFR", lambda h: h.startswith((b"BUFR", b"ZCZC")), None),
    ("CUR", lambda h: h.startswith(b"\0\0\2\0"), "ico.read_cur_like_pil"),
    ("PCX", lambda h: len(h) >= 2 and h[0] == 10 and h[1] in (0, 2, 3, 5),
     "pcx.read_pcx_like_pil"),
    ("DCX", lambda h: _i32(h) == 0x3ADE68B1, "dcx.read_dcx_like_pil"),
    ("DDS", lambda h: h.startswith(b"DDS "), "dds.read_dds_like_pil"),
    ("EPS", lambda h: h.startswith(b"%!PS") or _i32(h) == 0xC6D3D0C5, None),
    ("FITS", lambda h: h.startswith(b"SIMPLE"), "fits.read_fits_like_pil"),
    ("FLI", lambda h: len(h) >= 16 and _i16(h, 4) in (0xAF11, 0xAF12)
     and _i16(h, 14) in (0, 3), "fli.read_fli_like_pil"),
    ("FTEX", lambda h: h.startswith(b"FTEX"), "ftex.read_ftex_like_pil"),
    ("GBR", lambda h: len(h) >= 8 and _i32be(h) >= 20
     and _i32be(h, 4) in (1, 2), "gbr.read_gbr_like_pil"),
    ("GRIB", lambda h: len(h) >= 8 and h.startswith(b"GRIB") and h[7] == 1,
     None),
    ("HDF5", lambda h: h.startswith(b"\x89HDF\r\n\x1a\n"), None),
    ("JPEG2000", lambda h: h.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
     "jpeg2000.read_jpeg2000_like_pil"),
    ("ICNS", lambda h: h.startswith(b"icns"), "icns.read_icns_like_pil"),
    ("ICO", lambda h: h.startswith(b"\0\0\1\0"), "ico.read_ico_like_pil"),
    ("IM", None, "im.read_im_like_pil"),
    ("IMT", None, "imt.read_imt_like_pil"),
    ("IPTC", None, "iptc.read_iptc_like_pil"),
    ("MCIDAS", lambda h: h.startswith(b"\0\0\0\0\0\0\0\4"),
     "mcidas.read_mcidas_like_pil"),
    ("MPEG", lambda h: h.startswith(b"\0\0\1\xb3"), None),
    ("TIFF", lambda h: h.startswith(_TIFF_PREFIXES),
     "tiff.read_tiff_like_pil"),
    ("MSP", lambda h: h.startswith((b"DanM", b"LinS")),
     "msp.read_msp_like_pil"),
    ("PCD", None, "pcd.read_pcd_like_pil"),
    ("PIXAR", lambda h: h.startswith(b"\200\350\000\000"),
     "pixar.read_pixar_like_pil"),
    ("PSD", lambda h: h.startswith(b"8BPS"), "psd.read_psd_like_pil"),
    ("QOI", lambda h: h.startswith(b"qoif"), "qoi.read_qoi_like_pil"),
    ("SGI", lambda h: len(h) >= 2 and h[:2] == b"\x01\xda",
     "sgi.read_sgi_like_pil"),
    ("SPIDER", None, "spider.read_spider_like_pil"),
    ("SUN", lambda h: _i32be(h) == 0x59A66A95, "sun.read_sun_like_pil"),
    ("TGA", None, "tga.read_tga_like_pil"),
    ("WEBP", lambda h: h.startswith(b"RIFF") and h[8:12] == b"WEBP"
     and h[12:16] in (b"VP8 ", b"VP8L", b"VP8X"), "webp.read_webp_like_pil"),
    ("WMF", lambda h: h.startswith(b"\xd7\xcd\xc6\x9a\x00\x00") or (
        h.startswith(b"\x01\x00\x00\x00") and h[40:44] == b" EMF"), None),
    ("XBM", lambda h: h.lstrip().startswith(b"#define"),
     "xbm.read_xbm_like_pil"),
    ("XPM", lambda h: h.startswith(b"/* XPM */"), "xpm.read_xpm_like_pil"),
    ("XVThumb", lambda h: h.startswith(b"P7 332"),
     "xvthumb.read_xvthumb_like_pil"),
)
_WHOLE_HEAD = {"WMF"}
# Image.MAX_IMAGE_PIXELS: Image.open refuses more than twice as many pixels
# (DecompressionBombError)
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


class UnreadableImageError(ValueError):
    """No reader of the port takes the file: PIL's UnidentifiedImageError
    where PIL has no reader for it either, else a format PIL reads that is
    not ported yet, or an image PIL refuses as a decompression bomb."""


class NotThisFormat(ValueError):
    """A reader's header parse failed where PIL's plugin fails in _open
    with SyntaxError, IndexError, TypeError, KeyError, EOFError or
    struct.error, or leaves the image without a size: PIL goes on to the
    next plugin, and so does `read_image_like_pil`."""


# what Image.open hands on to the next plugin when a plugin's _open raises
# it (ImageFile wraps the last five in SyntaxError)
HANDED_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
             struct.error)


def pil_open(opener, fp, name: str, error):
    """``opener(fp)``, a plugin's _open written as PIL's: the errors PIL
    hands on raise NotThisFormat, any other raises `error` (a ValueError
    subclass), as PIL raises it."""
    try:
        return opener(fp)
    except HANDED_ON as e:
        raise NotThisFormat(f"{name}: {e!r}") from None
    except Exception as e:
        raise error(f"{name}: {e!r}") from None


def check_size(w: int, h: int, name: str) -> None:
    """What PIL checks once a plugin's _open is done: a positive size
    (else the next plugin is tried) and at most twice MAX_IMAGE_PIXELS."""
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin "
                            f"({w}x{h})")
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise UnreadableImageError(
            f"{name}: image size ({w * h} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb "
            f"DOS attack.")


def bits_of(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """[H, stride] row bytes -> [H, width] values of `bits` bits, MSB
    first."""
    per = 8 // bits
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
    v = (rows[..., None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(rows.shape[0], -1)[:, :width]


def _reader(spec: str):
    import importlib
    module, func = spec.split(".")
    return getattr(importlib.import_module(f"{__package__}.{module}"), func)


def open_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` once loaded, the
    decoder chosen by the file's content: the pixels, ``im.mode`` and
    ``im.info``'s palette, transparency and comment where the file has
    them; what PIL's methods (``convert``, ``resize``, ``crop``) see."""
    arr, mode, info = _open(path)[1]
    info.pop("asarray", None)
    return arr, mode, info


def format_like_pil(path: str) -> str:
    """``PIL.Image.open(path).format`` where the port reads the file: the
    plugin that took it (raises where `read_image_like_pil` raises)."""
    return _open(path)[0]


def _open(path: str):
    """-> (format, (array, mode, info)) of the first plugin that takes the
    file."""
    with open(path, "rb") as f:
        head = f.read(4096)
    for name, accepts, reader in _PLUGINS:
        if accepts is not None and not accepts(
                head if name in _WHOLE_HEAD else head[:16]):
            continue
        if reader is None:
            raise UnreadableImageError(f"{path}: {name} is not ported (PIL "
                                       f"reads it as {name})")
        try:
            return name, _reader(reader)(path)
        except NotThisFormat:
            continue
    raise UnreadableImageError(f"cannot identify image file {path}")


def read_image_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)``:
    ``np.asarray(im)``, ``im.mode`` and ``im.info`` as `open_like_pil`
    gives them. Where a reader says that ``np.asarray`` of the fresh image
    differs from its loaded pixels (``info["asarray"]``: ICNS), that answer
    is returned, or raised, and the loaded pixels go in
    ``info["loaded"]``."""
    arr, mode, info = _open(path)[1]
    fresh = info.pop("asarray", None)
    if fresh is None:
        return arr, mode, info
    if isinstance(fresh, Exception):
        raise fresh
    info["loaded"] = arr
    return fresh, mode, info


def _muldiv255(a, b):
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def to_rgb_like_pil(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """``np.asarray(im.convert("RGB"))`` for an image of PIL mode `mode`
    whose ``np.asarray`` is `arr`: uint8 [H, W, 3].

      1      0 or 255;                L, LA   the grey replicated;
      I;16,  the grey clamped at 255;  I       the grey clipped to 0..255;
      I;16L,
      I;16B
      F      the grey truncated, 0 at or below 0 (and NaN), 255 at or
             above 255;
      P, PA  the palette's colour, black past its last entry (so too an
             "L" image that carries a palette, as a GIF frame can; all
             black without a palette);
      RGB    as is;                    RGBA    alpha dropped;
      CMYK   cmyk2rgb: each of R, G, B is 255 - K - C (M, Y) * (255 - K)
             / 255, rounded as MULDIV255;
      YCbCr  ConvertYCbCr.c's fixed-point tables (utils/ycbcr.py).
    CIELab (LAB) raises: PIL converts it through LittleCMS (ImageCms's
    built-in LAB profile to sRGB, an optimized 8-bit transform), which the
    port does not emulate.
    """
    arr = np.asarray(arr)
    if mode == "1":
        g = np.where(arr, 255, 0).astype(np.uint8)
    elif mode == "L" and palette is None:
        g = arr.astype(np.uint8)
    elif mode in ("I;16", "I;16L", "I;16B"):
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
        pal = np.asarray(palette if palette is not None else (),
                         np.uint8).reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
        return lut[arr[..., 0] if mode == "PA" else arr]
    elif mode == "RGB":
        return arr.astype(np.uint8)
    elif mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3], np.uint8)
    elif mode == "YCbCr":
        from .ycbcr import ycbcr_to_rgb
        return ycbcr_to_rgb(arr)
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
    arr, mode, info = open_like_pil(path)
    return to_rgb_like_pil(arr, mode, info.get("palette"))


def resize_bilinear(img, h: int, w: int):
    """[H, W, C] -> [h, w, C], as ``jax.image.resize(img, (h, w, C),
    "bilinear")`` computes it: half-pixel centres, and a triangle filter
    widened by the scale when downscaling (JAX's default antialias)."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)
