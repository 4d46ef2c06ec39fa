"""``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` without cv2, for the JAX
loader's ``.hdr`` branch (irgs_tpu/scene/datasets.py:51-57), which hands
any file so named to cv2.

cv2 (OpenCV 5.0) picks its decoder by the file's first bytes, whatever its
name, and returns the decoder's own array: channels in BGR(A) order, grey
as [H, W], 8-bit, 16-bit (kept) or float samples. `imread_unchanged` does
the same with the port's readers, as OpenCV's decoders differ from PIL's:

  Radiance      utils/hdr.py (``#?RADIANCE``, ``#?RGBE``), float32 BGR;
  PNG           samples as stored: 16 bits kept, bit depths below 8
                scaled to 0..255, palette expanded, grey + alpha as BGRA,
                a palette or RGB tRNS chunk as an alpha channel (grey tRNS
                ignored);
  JPEG          grey or BGR as libjpeg-turbo gives them (no EXIF
                rotation); CMYK through OpenCV's icvCvt_CMYK2BGR on the
                stored samples;
  BMP           1-, 4-, 8-bit palettes (grey where every entry is grey),
                24-bit, 32-bit BI_RGB (the fourth byte dropped);
  WebP          BGR, BGRA where the stream has alpha (one frame);
  PNM           P1-P6 as OpenCV's PxM decoder: text samples scaled by
                255 / maxval (floor) at 8 bits, binary ones as stored, 16
                bits above maxval 255, P1/P4 as 0 and 255;
  PFM           PF (BGR) and Pf, times float(1 / |scale|), rows bottom-up;
  TIFF          8-bit grey, bilevel, RGB and palette (16-bit colour maps
                shifted, as libtiff's RGBA interface does), RGBA with
                unassociated alpha premultiplied as that interface does;
                16-bit and float grey, RGB and RGBA as stored;
  GIF           the first frame's palette expanded, BGRA where it has a
                transparent index (its pixels the background colour);
  JPEG 2000     JP2 or a raw codestream through utils/jpeg2000.py as
                OpenJPEG's opj_decode gives it to cv2 (palette, cdef):
                8-bit, 16-bit above 8 bits, sYCC through cvtColor's
                YUV2BGR; grey + alpha, signed, below 8 bits, subsampled or
                offset images refused as cv2 refuses them.

The cv2 the JAX package runs here reads no OpenEXR (with or without
OPENCV_IO_ENABLE_OPENEXR), so an EXR file is not read, as bytes no decoder
takes are not: both raise
OSError, as the JAX loader raises IOError where cv2.imread gives None, and
so does a file that a decoder takes and then fails on. Content cv2 decodes
and the port does not (PAM, Sun raster, HTJ2K code-blocks, the layouts
above do not list) raises UnreadableImageError "... not ported".
"""

from __future__ import annotations

import struct

import numpy as np

from . import hdr
from .image import UnreadableImageError


def _not_ported(path, what):
    return UnreadableImageError(f"{path}: {what} as cv2.imread reads it is "
                                f"not ported")


def _bgr(rgb: np.ndarray) -> np.ndarray:
    """RGB(A) [H, W, C] -> BGR(A); grey [H, W] as is."""
    if rgb.ndim == 3 and rgb.shape[-1] >= 3:
        rgb = np.concatenate([rgb[..., 2::-1], rgb[..., 3:]], -1)
    return np.ascontiguousarray(rgb)


def _expand(index: np.ndarray, palette: np.ndarray, alpha=None):
    """Palette indices -> RGB(A) (black past the palette's end)."""
    lut = np.zeros((256, 3), np.uint8)
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    lut[:len(pal)] = pal
    rgb = lut[index]
    if alpha is None:
        return rgb
    a = np.full(256, 255, np.uint8)
    a[:len(alpha)] = alpha[:256]
    return np.concatenate([rgb, a[index][..., None]], -1)


def _png(buf, path):
    from . import png
    img, depth, ctype, palette, trns, _ = png._decode(buf, path)
    if ctype == 3:
        alpha = None if trns is None else np.frombuffer(trns, np.uint8)
        return _bgr(_expand(img[..., 0], palette, alpha))
    if depth < 8:
        img = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype == 0:
        return img[..., 0]
    if ctype == 4:
        return _bgr(img[..., [0, 0, 0, 1]])
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), img.dtype)
        top = np.iinfo(img.dtype).max
        a = np.where((img == key).all(-1), 0, top).astype(img.dtype)
        img = np.concatenate([img, a[..., None]], -1)
    return _bgr(img)


def _jpeg(buf, path):
    from . import jpeg
    arr, mode, _ = jpeg.decode_jpeg_like_pil(buf)
    if mode == "L":
        return arr
    if mode == "RGB":
        return _bgr(arr)
    # icvCvt_CMYK2BGR_8u_C4C3R on libjpeg's output, which PIL inverts
    raw = 255 - arr.astype(np.int32)
    k = raw[..., 3:]
    return _bgr((k - ((255 - raw[..., :3]) * k >> 8)).astype(np.uint8))


def _bmp(buf, path):
    from . import bmp
    size = struct.unpack_from("<I", buf, 14)[0] if len(buf) >= 18 else 0
    if size < 40 or len(buf) < 34:
        raise _not_ported(path, "a BMP with a core header")
    bpp, comp = struct.unpack_from("<HI", buf, 28)
    if bpp not in (1, 4, 8, 24, 32) or comp != 0:
        raise _not_ported(path, f"a {bpp}-bit BMP of compression {comp}")
    arr, mode, info = bmp.decode_bmp(buf, path)
    if mode == "1":
        return np.where(arr, 255, 0).astype(np.uint8)
    if mode == "L":                     # PIL's grey ramp palette
        return arr
    if mode == "P":
        pal = np.asarray(info["palette"], np.uint8).reshape(-1, 3)
        if (pal == pal[:, :1]).all():             # IsColorPalette false
            return _expand(arr, pal)[..., 0]
        return _bgr(_expand(arr, pal))
    return _bgr(arr)


def _jpeg2000(buf, path):
    from . import jpeg2000
    return jpeg2000.imread_jpeg2000(buf, path)


def _webp(buf, path):
    from . import webp
    if buf[12:16] == b"VP8X" and len(buf) > 20 and buf[20] & 0x02:
        raise _not_ported(path, "an animated WebP")
    return _bgr(webp.decode_webp(buf, path)[0])


def _gif(buf, path):
    from . import gif
    arr, mode, info = gif.decode_gif(buf, path)
    if info.get("palette") is None:
        raise _not_ported(path, "a GIF without a colour table")
    t = info.get("transparency")
    if t is None:
        return _bgr(_expand(arr, info["palette"]))
    # transparent pixels keep the canvas's background colour, alpha 0
    out = _expand(arr, info["palette"], np.where(np.arange(256) == t, 0,
                                                 255).astype(np.uint8))
    bg = _expand(np.array([info.get("background", 0)]), info["palette"])[0]
    out[arr == t, :3] = bg
    return _bgr(out)


class _Stream:
    """OpenCV's RLByteStream with PxM's ReadNumber."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise EOFError
        self.pos += 1
        return self.buf[self.pos - 1]

    def number(self, maxdigits: int = 0) -> int:
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:                                  # '#' comment
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif chr(c).isspace():
                while chr(c).isspace():
                    c = self.byte()
            else:
                raise ValueError("PXM: unexpected code in ReadNumber()")
        val = digits = 0
        while True:
            val = val * 10 + c - 48
            if val > 2 ** 31 - 1:
                raise ValueError("PXM: number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val


def _pxm(buf, path):
    code = buf[1] - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[code]
    binary = code >= 4
    s = _Stream(buf, 2)
    w, h = s.number(), s.number()
    maxval = 1 if bpp == 1 else s.number()
    if not (w > 0 and h > 0 and 0 < maxval < 65536):
        raise ValueError("PXM: bad header")
    cn = 3 if bpp == 24 else 1
    n = w * h * cn
    if bpp == 1:
        if binary:
            rowbytes = (w + 7) // 8
            data = buf[s.pos:s.pos + rowbytes * h]
            if len(data) < rowbytes * h:
                raise EOFError
            rows = np.frombuffer(data, np.uint8).reshape(h, rowbytes)
            bits = np.unpackbits(rows, axis=1)[:, :w]
        else:
            bits = np.array([s.number(1) != 0 for _ in range(w * h)],
                            np.uint8).reshape(h, w)
        return np.where(bits, 0, 255).astype(np.uint8)
    sixteen = maxval > 255
    if binary:
        size = n * (2 if sixteen else 1)
        data = buf[s.pos:s.pos + size]
        if len(data) < size:
            raise EOFError
        v = np.frombuffer(data, ">u2" if sixteen else np.uint8).astype(
            np.uint16 if sixteen else np.uint8)
    else:
        v = np.minimum([s.number() for _ in range(n)], maxval)
        v = (v.astype(np.uint16) if sixteen
             else (v * 255 // maxval).astype(np.uint8))
    v = v.reshape(h, w, cn)
    return _bgr(v) if cn == 3 else v[..., 0]


def _pfm_token(s: _Stream) -> bytes:
    c = s.byte()
    while chr(c).isspace():
        c = s.byte()
    out = bytearray()
    while not chr(c).isspace():
        out.append(c)
        c = s.byte()
    return bytes(out)


def _pfm(buf, path):
    cn = 3 if buf[1:2] == b"F" else 1
    s = _Stream(buf, 2)
    w, h = int(_pfm_token(s)), int(_pfm_token(s))
    scale = float(_pfm_token(s))
    if w <= 0 or h <= 0:
        raise ValueError("PFM: bad header")
    size = 4 * w * h * cn
    data = buf[s.pos:s.pos + size]
    if len(data) < size:
        raise EOFError
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4").astype(np.float32)
    v = v.reshape(h, w, cn)[::-1]
    if abs(scale) != 1.0 and scale != 0:
        v = v * np.float32(1.0 / abs(scale))
    return _bgr(v) if cn == 3 else np.ascontiguousarray(v[..., 0])


def _tiff(buf, path):
    from . import tiff
    samples, tags = tiff.decode_tiff(buf, path, samples_only=True)
    one = lambda t, d=None: tiff._one(tags, t, d)   # noqa: E731
    photo, spp = one(262, 0), one(277, 1)
    bits = tags.get(258, (1,))[0]
    fmt = tags.get(339, (1,))[0]
    extra = tuple(tags.get(338, ()))
    if one(274, 1) != 1:
        raise _not_ported(path, "a TIFF with an orientation tag")
    if photo == 3 and bits == 8 and spp == 1:
        cmap = np.asarray(tags[320], np.int64).reshape(3, -1).T
        if (cmap >= 256).any():                  # libtiff's checkcmap
            cmap = cmap >> 8
        return _bgr(_expand(samples[..., 0], cmap.astype(np.uint8)))
    if photo not in (0, 1, 2) or (photo == 0 and bits != 1):
        raise _not_ported(path, f"a TIFF of photometric {photo}")
    grey = photo in (0, 1)
    if grey and bits == 1 and spp == 1:
        v = samples[..., 0] != 0
        return np.where(v != (photo == 0), 255, 0).astype(np.uint8)
    if extra not in ((), (1,), (2,)) or (grey and extra) or spp != (
            1 if grey else 3) + len(extra):
        raise _not_ported(path, f"a TIFF of {spp} samples, extra {extra}")
    if (bits, fmt) not in ((8, 1), (16, 1), (32, 3), (64, 3)):
        raise _not_ported(path, f"a TIFF of {bits}-bit samples (format "
                                f"{fmt})")
    out = samples[..., :spp]
    if bits == 8 and extra == (2,):  # the RGBA interface's UaToAa table
        a = out[..., 3:].astype(np.int32)
        rgb = (out[..., :3].astype(np.int32) * a + 127) // 255
        out = np.concatenate([rgb, a], -1).astype(np.uint8)
    return out[..., 0] if grey else _bgr(out)


# cv2's decoders by signature, in OpenCV's order of registration
_DECODERS = (
    (lambda b: b.startswith(b"BM"), _bmp),
    (lambda b: b.startswith((b"#?RADIANCE", b"#?RGBE")), "hdr"),
    (lambda b: b.startswith(b"\xff\xd8\xff"), _jpeg),
    (lambda b: b.startswith(b"RIFF") and b[8:12] == b"WEBP", _webp),
    (lambda b: b.startswith(b"\x89PNG\r\n\x1a\n"), _png),
    (lambda b: b.startswith((b"GIF87a", b"GIF89a")), _gif),
    (lambda b: len(b) >= 3 and b[:1] == b"P" and b[1:2] in b"123456"
     and chr(b[2]).isspace(), _pxm),
    (lambda b: len(b) >= 3 and b[:2] == b"P7" and chr(b[2]).isspace(),
     "PAM"),
    (lambda b: len(b) >= 3 and b[:1] == b"P" and b[1:2] in b"Ff"
     and chr(b[2]).isspace(), _pfm),
    (lambda b: b.startswith((b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")), _tiff),
    (lambda b: b.startswith(b"\x76\x2f\x31\x01"), "OpenEXR"),
    (lambda b: b.startswith((b"\0\0\0\x0cjP  \r\n\x87\n",
                             b"\xff\x4f\xff\x51")), _jpeg2000),
    (lambda b: b.startswith(b"\x59\xa6\x6a\x95"), "Sun raster"),
)


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``; OSError where cv2 gives
    None."""
    with open(path, "rb") as f:
        buf = f.read()
    for accepts, decoder in _DECODERS:
        if not accepts(buf[:16]):
            continue
        if decoder == "OpenEXR":
            break
        if isinstance(decoder, str) and decoder != "hdr":
            raise _not_ported(path, decoder)
        try:
            if decoder == "hdr":
                return _bgr(hdr.decode_hdr(buf))
            return decoder(buf, path)
        except UnreadableImageError:
            raise
        except (ValueError, EOFError, IndexError, KeyError,
                struct.error) as err:
            if "not ported" in str(err):
                raise UnreadableImageError(str(err)) from err
            raise OSError(f"cv2 could not read {path}: {err}") from err
    raise OSError(f"cv2 could not read {path}")
