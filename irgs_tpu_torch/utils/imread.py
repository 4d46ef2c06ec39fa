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
  Sun raster    OpenCV's decoder, not PIL's: types 0 and 1 (RLE and
                RGB-order files refused), depths 1, 8, 24 (BGR as stored)
                and 32 (XBGR), colour maps on 1- and 8-bit data (BGR, or
                grey where every entry is grey), grey data without a map
                read as 0 (OpenCV leaves that palette zeroed);
  PAM           P7 headers as OpenCV's line reader takes them, samples as
                stored (no channel swap, no scaling by MAXVAL), 16-bit
                above MAXVAL 255, 0/255 bits at MAXVAL 1.

The cv2 the JAX package runs here reads no OpenEXR (with or without
OPENCV_IO_ENABLE_OPENEXR), so an EXR file is not read, as bytes no decoder
takes are not: both raise
OSError, as the JAX loader raises IOError where cv2.imread gives None, and
so does a file that a decoder takes and then fails on. Content cv2 decodes
and the port does not (AVIF, HTJ2K code-blocks, the layouts above do not
list) raises UnreadableImageError "... not ported".
"""

from __future__ import annotations

import re
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


_CSPACE = b" \t\n\v\f\r"                    # C's isspace
_PAM_TUPLES = {b"": 0, b"BLACKANDWHITE": 1, b"GRAYSCALE": 1,
               b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(s: _Stream):
    """grfmt_pam.cpp's ReadPAMHeaderLine -> (field, value); field None for
    a comment. ValueError where it fails."""
    c = s.byte()
    while c in _CSPACE:
        c = s.byte()
    if c == 35:                                          # '#'
        while c not in (10, 13):
            c = s.byte()
        return None, b""
    ident = bytearray()
    for _ in range(8):
        if c in _CSPACE:
            break
        ident.append(c)
        c = s.byte()
    if c not in _CSPACE or bytes(ident) not in (
            b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR"):
        raise ValueError("PAM: bad header line")
    if c in (10, 13):
        return bytes(ident), b""
    c = s.byte()
    while c in _CSPACE:
        c = s.byte()
    value = bytearray()
    for _ in range(255):
        if c in (10, 13):
            break
        value.append(c)
        c = s.byte()
    if c not in (10, 13):
        raise ValueError("PAM: header value too long")
    while len(value) > 1 and value[-1] in _CSPACE:
        value.pop()
    return bytes(ident), bytes(value)


def _pam_number(value: bytes) -> int:
    """ParseNumber: a decimal integer, the whole value; a C long cast to
    int."""
    if not re.fullmatch(rb"-?[0-9]+", value) or abs(int(value)) > 2 ** 63:
        raise ValueError("PAM: bad number")
    return (int(value) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _pam(buf, path):
    """OpenCV's PAM decoder at IMREAD_UNCHANGED: the samples as stored (no
    channel swap, no scaling by MAXVAL), 16-bit above MAXVAL 255, and at
    MAXVAL 1 a row of WIDTH * DEPTH bytes whose first bits are the
    pixels (0 or 255; grey, or white/black at DEPTH 3)."""
    if buf[2:3] not in (b"\n", b"\r"):
        raise ValueError("PAM: bad signature")
    s = _Stream(buf, 3)
    got, tupl = {}, 0
    while True:
        field, value = _pam_line(s)
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise ValueError(f"PAM: unknown TUPLTYPE {value!r}")
            tupl = _PAM_TUPLES[value]
            continue
        if field in got:
            raise ValueError(f"PAM: {field!r} twice")
        got[field] = _pam_number(value)
    if len(got) < 4:
        raise ValueError("PAM: a field is missing")
    w, h, cn, maxval = (got[b"WIDTH"], got[b"HEIGHT"], got[b"DEPTH"],
                        got[b"MAXVAL"])
    if maxval > 65535:
        raise ValueError("PAM: MAXVAL over 65535")
    if tupl == 0:
        if cn not in (1, 3) or maxval >= 256:
            raise ValueError("PAM: Can't determine selected_fmt")
    elif cn != tupl:
        raise ValueError("PAM: DEPTH against TUPLTYPE")
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30):
        raise ValueError("PAM: image size")
    sample = 2 if maxval > 255 else 1
    row = w * cn * sample
    data = buf[s.pos:s.pos + row * h]
    if len(data) < row * h:
        raise EOFError
    rows = np.frombuffer(data, np.uint8).reshape(h, row)
    if maxval == 1:
        if cn == 2 or cn == 4:
            raise ValueError("PAM: bit mode at DEPTH 2 or 4")
        v = np.unpackbits(rows[:, :(w + 7) // 8], axis=1)[:, :w] * 255
        return np.repeat(v[..., None], 3, -1) if cn == 3 else v
    v = rows.view(">u2").astype(np.uint16) if sample == 2 else rows
    return (v.reshape(h, w, cn) if cn > 1 else v).copy()


def _sunras(buf, path):
    """OpenCV's Sun raster decoder: types 0 and 1 only (RLE and RGB-order
    files give None), depths 1, 8, 24 and 32 (XBGR), a colour map of type
    1 on 1- and 8-bit data (at most 2**depth entries), BGR where the map
    has a colour and grey where it has none; grey data without a map
    reads as 0, as OpenCV's grey palette is left zeroed then. Rows are
    padded to 16 bits; a cut file gives None."""
    if len(buf) < 32:
        raise EOFError
    w, h, bpp, _, enc, maptype, maplen = struct.unpack_from(">7i", buf, 4)
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32)):
        raise ValueError("Sun raster: bad header")
    pal_size = (1 << bpp) * 3 if bpp <= 8 else 0
    if enc not in (0, 1) or not ((maptype == 0 and maplen == 0) or (
            maptype == 1 and 0 < maplen <= pal_size and bpp <= 8)):
        raise ValueError("Sun raster: unsupported type or colour map")
    if not (w <= 1 << 20 and h <= 1 << 20 and w * h <= 1 << 30):
        raise ValueError("Sun raster: image size")
    pal = np.zeros((256, 3), np.uint8)          # BGR
    if maplen:
        raw = np.frombuffer(buf[32:32 + maplen], np.uint8)
        if len(raw) < maplen:
            raise EOFError
        n = maplen // 3
        pal[:n] = raw[:3 * n].reshape(3, n).T[:, ::-1]
    colour = bpp > 8 or bool((pal[:1 << bpp] != pal[:1 << bpp, :1]).any())
    pitch = (((w * bpp + 7) // 8) + 1) & -2
    off = 32 + maplen
    data = buf[off:off + pitch * h]
    if len(data) < pitch * h:
        raise EOFError
    rows = np.frombuffer(data, np.uint8).reshape(h, pitch)
    if bpp == 24:
        return rows[:, :3 * w].reshape(h, w, 3).copy()
    if bpp == 32:
        return rows[:, :4 * w].reshape(h, w, 4)[..., 1:].copy()
    idx = (np.unpackbits(rows, axis=1)[:, :w] if bpp == 1
           else rows[:, :w])
    if colour:
        return pal[idx]
    grey = pal[:, 0] if maptype == 1 else np.zeros(256, np.uint8)
    return grey[idx]


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


def _boxes(buf):
    """The top-level ISO BMFF boxes of `buf` -> [(type, start, end)];
    ValueError where one runs past the end of the file."""
    out, at = [], 0
    while at + 8 <= len(buf):
        size, kind = struct.unpack_from(">I4s", buf, at)
        head = 8
        if size == 1:
            if at + 16 > len(buf):
                raise ValueError("AVIF: truncated box header")
            size, head = struct.unpack_from(">Q", buf, at + 8)[0], 16
        elif size == 0:
            size = len(buf) - at
        if size < head or at + size > len(buf):
            raise ValueError(f"AVIF: box {kind!r} runs past the end")
        out.append((kind, at, at + size))
        at += size
    return out


def _is_avif(b) -> bool:
    """cv2's AVIF signature check (avifDecoderParse on the first bytes): an
    ftyp box first whose major or compatible brands hold ``avif``, or
    ``avis`` beside a top-level ``moov`` box (an image sequence's track);
    a cut or malformed ftyp box is not taken."""
    if len(b) < 16 or b[4:8] != b"ftyp":
        return False
    size = struct.unpack_from(">I", b)[0]
    if size < 16 or (size - 16) % 4 or size > len(b):
        return False
    brands = {b[8:12]} | {b[k:k + 4] for k in range(16, size, 4)}
    if b"avif" in brands:
        return True
    try:
        return b"avis" in brands and any(k == b"moov" for k, _, _ in
                                         _boxes(b))
    except ValueError:
        return False


def _avif(buf, path):
    _boxes(buf)               # a cut file: libavif's parse fails (None)
    raise _not_ported(path, "AVIF")


# cv2's decoders by signature, in OpenCV's order of registration
_DECODERS = (
    (_is_avif, _avif),
    (lambda b: b.startswith(b"BM"), _bmp),
    (lambda b: b.startswith((b"#?RADIANCE", b"#?RGBE")), "hdr"),
    (lambda b: b.startswith(b"\xff\xd8\xff"), _jpeg),
    (lambda b: b.startswith(b"RIFF") and b[8:12] == b"WEBP", _webp),
    (lambda b: b.startswith(b"\x89PNG\r\n\x1a\n"), _png),
    (lambda b: b.startswith((b"GIF87a", b"GIF89a")), _gif),
    (lambda b: len(b) >= 3 and b[:1] == b"P" and b[1:2] in b"123456"
     and chr(b[2]).isspace(), _pxm),
    (lambda b: len(b) >= 3 and b[:2] == b"P7" and chr(b[2]).isspace(),
     _pam),
    (lambda b: len(b) >= 3 and b[:1] == b"P" and b[1:2] in b"Ff"
     and chr(b[2]).isspace(), _pfm),
    (lambda b: b.startswith((b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")), _tiff),
    (lambda b: b.startswith(b"\x76\x2f\x31\x01"), "OpenEXR"),
    (lambda b: b.startswith((b"\0\0\0\x0cjP  \r\n\x87\n",
                             b"\xff\x4f\xff\x51")), _jpeg2000),
    (lambda b: b.startswith(b"\x59\xa6\x6a\x95"), _sunras),
)


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``; OSError where cv2 gives
    None."""
    with open(path, "rb") as f:
        buf = f.read()
    for accepts, decoder in _DECODERS:
        if not accepts(buf):
            continue
        if decoder == "OpenEXR":
            break
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
