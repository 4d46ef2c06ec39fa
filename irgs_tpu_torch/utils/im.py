"""IFUNC Image Memory (IM) reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.getpalette()`` give it (Pillow 12's ImImagePlugin).

The header is text lines ``key: value`` up to a NUL or ^Z (a line over 100
bytes, or one that is not ``key: value``, is not IM; at least one key must
be one of the plugin's nine tags). "Image type" picks the mode and raw mode
from the plugin's OPEN table ("1", L, P from P;2 and P;4, the planar
``;L`` layouts of RGB, LA, PA, RGBA, RGBX, CMYK and YCbCr, RGB, I;16,
I;16L, I;16B, I;32S, the float family F;8 to F;32F and the n-bit images
``L*n`` of 2 to 32 bits); "Image size" is the size (512x512 by default).
The pixels start after the ^Z that ends the header; a "Lut" line puts 768
bytes of LUT there (three planes): a LUT that is not grey makes an L or P
image P and an LA or PA image PA, with that palette; a grey one changes
nothing PIL shows. Rows are stored bottom-up. "RGB3"/"RYB3" images are
the G, R and B planes one after another; L*n images of other than 8, 16
and 32 bits go through libImaging's bit decoder (csrc/small_decode.cpp).
Only the first frame of a "File size" stack is read.

Where PIL's _open fails in a way Image.open hands on (SyntaxError, and
IndexError, TypeError, KeyError, EOFError or struct.error inside it, no
mode, or a size that is not positive) the next plugin is tried; other
failures of _open and every failure of load raise ImError.
"""

from __future__ import annotations

import io
import re

import numpy as np

from . import pil_raw, small_codecs
from .image import NotThisFormat, check_size, pil_open

COMMENT, FRAMES, LUT, SIZE, MODE = ("Comment", "File size (no of images)",
                                    "Lut", "Image size (x*y)", "Image type")
TAGS = {COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name",
        "Scale (x,y)", SIZE, MODE}

OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# the modes Image.core.new makes
MODES = {"1", "L", "P", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr", "LA", "PA",
         "La", "RGBa", "LAB", "HSV", "I", "F", "I;16", "I;16L", "I;16B",
         "I;16N"}


class ImError(ValueError):
    pass


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _open(fp):
    """ImImageFile._open on the file object `fp` -> (info, mode, rawmode,
    lut palette bytes or None, offset of the pixels)."""
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, "Scale (x,y)", SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        n += k in TAGS
    if not n:
        raise SyntaxError("Not an IM file")
    mode = info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if LUT in info:
        lut = fp.read(768)
        grey = all(lut[i] == lut[i + 256] == lut[i + 512] for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = lut
    return info, mode, rawmode, palette, fp.tell()


def decode_im(buf: bytes, name: str = "IM"):
    """(array, mode, info) of an IM file's bytes (info: the palette of mode
    P or PA, uint8 [256, 3])."""
    info, mode, rawmode, lut, offs = pil_open(_open, io.BytesIO(buf), name,
                                              ImError)
    size = info[SIZE]
    if not mode:
        raise NotThisFormat(f"{name}: no mode")
    if not isinstance(size, tuple) or len(size) < 2:
        raise NotThisFormat(f"{name}: bad size {size!r}")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ImError(f"{name}: size {size!r} is not two integers")
    w, h = size
    check_size(w, h, name)
    if mode not in MODES:
        raise ImError(f"{name}: unrecognized image mode {mode}")
    out = {}
    if lut is not None:
        out["palette"] = np.ascontiguousarray(
            np.frombuffer(lut, np.uint8).reshape(3, 256).T)
    elif mode in ("P", "PA"):            # PIL's getpalette() gives []
        out["palette"] = np.zeros((0, 3), np.uint8)
    try:
        if rawmode.startswith("F;") and rawmode[2:].isdigit() \
                and int(rawmode[2:]) not in (8, 16, 32):
            if mode != "F":
                raise ImError(f"{name}: the bit decoder needs mode F")
            if offs >= len(buf):
                raise ImError(f"{name}: image file is truncated")
            return small_codecs.bits(buf[offs:], int(rawmode[2:]), w,
                                     h), mode, out
        if rawmode in ("RGB;T", "RYB;T"):
            arr = np.zeros((h, w, 3), np.uint8)
            for k, band in enumerate("GRB"):      # one plane after another
                arr[..., "RGB".index(band)] = pil_raw.load(
                    buf, offs + k * w * h, "L", "L", (w, h), ystep=-1,
                    maps=False, name=name)
            return arr, mode, out
        return pil_raw.load(buf, offs, mode, rawmode, (w, h), ystep=-1,
                            name=name), mode, out
    except (pil_raw.RawError, small_codecs.SmallCodecError) as e:
        raise ImError(f"{name}: {e}") from None


def read_im_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an IM
    file."""
    with open(path, "rb") as f:
        return decode_im(f.read(), path)
