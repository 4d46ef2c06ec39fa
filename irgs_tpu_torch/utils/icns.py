"""macOS icon (ICNS) reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.getpalette()`` give it (Pillow 12's
IcnsImagePlugin).

The block table is walked as IcnsFile does (each block's length counts
its 8-byte header; a length of 0 hands the file on). The image is the
largest size (PIL's bestsize: the greatest (width, height, scale) with any
of its entries present; none hands the file on), read from every entry of
that size in PIL's order:
  ic07-ic14, icp4-icp6  a PNG stream (utils/png.py, read from the entry to
                        the stream's end, in its own mode) or a JPEG 2000
                        one (utils/jpeg2000.py, the entry's bytes,
                        converted to RGBA); the first such entry is the
                        image;
  is32, il32, ih32,     24-bit RGB, uncompressed where the entry holds
  it32                  exactly 3 bytes a pixel, else ICNS's RLE
                        (utils/small_codecs.icns_rle: each plane read on
                        from where the last ended, whatever the entry's
                        length); it32 after its 4 zero bytes;
  s8mk, l8mk, h8mk,     8-bit masks, which become the RGB image's alpha
  t8mk                  (mode RGBA; RGB without one).
Every entry of the size is read even where a PNG or JPEG 2000 one wins,
so a broken RLE entry beside a PNG fails the file, as in PIL. The image
found must fit one of the file's sizes at an integer scale, as
IcnsImageFile's size setter checks. Errors at load raise IcnsError.

``np.asarray`` of a freshly opened ICNS image packs it before loading it,
in the mode _open set (RGBA): a loaded image of another mode has no such
packer and raises, except RGB, whose 4-byte pixels (the pad byte 0 where
the RLE planes were put in, 255 where an unpacker wrote them) are then read
as 3-byte ones. ``info["asarray"]`` carries that answer (an array, or the
error) for `image.read_image_like_pil`; the returned array is the loaded
image, which ``convert("RGB")`` and PIL's other methods see.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jp2, jpeg2000, png, small_codecs
from .image import NotThisFormat, UnreadableImageError, check_size

PNG_OR_JP2, RGB32, RGB32T, MASK = "png_or_jpeg2000", "32", "32t", "mk"
# IcnsFile.SIZES: (width, height, scale) -> entries in the order read
SIZES = {
    (512, 512, 2): [(b"ic10", PNG_OR_JP2)],
    (512, 512, 1): [(b"ic09", PNG_OR_JP2)],
    (256, 256, 2): [(b"ic14", PNG_OR_JP2)],
    (256, 256, 1): [(b"ic08", PNG_OR_JP2)],
    (128, 128, 2): [(b"ic13", PNG_OR_JP2)],
    (128, 128, 1): [(b"ic07", PNG_OR_JP2), (b"it32", RGB32T),
                    (b"t8mk", MASK)],
    (64, 64, 1): [(b"icp6", PNG_OR_JP2)],
    (32, 32, 2): [(b"ic12", PNG_OR_JP2)],
    (48, 48, 1): [(b"ih32", RGB32), (b"h8mk", MASK)],
    (32, 32, 1): [(b"icp5", PNG_OR_JP2), (b"il32", RGB32), (b"l8mk", MASK)],
    (16, 16, 2): [(b"ic11", PNG_OR_JP2)],
    (16, 16, 1): [(b"icp4", PNG_OR_JP2), (b"is32", RGB32), (b"s8mk", MASK)],
}


class IcnsError(ValueError):
    pass


def _blocks(buf: bytes, name: str) -> dict:
    """IcnsFile.__init__: signature -> (start, length) of each block."""
    if len(buf) < 8:
        raise NotThisFormat(f"{name}: short ICNS header")
    (filesize,) = struct.unpack_from(">I", buf, 4)
    dct, i = {}, 8
    while i < filesize:
        if i + 8 > len(buf):
            raise NotThisFormat(f"{name}: ICNS block header cut short")
        sig, blocksize = struct.unpack_from(">4sI", buf, i)
        if blocksize <= 0:
            raise NotThisFormat(f"{name}: invalid block header")
        i += 8
        dct[sig] = (i, blocksize - 8)
        i += blocksize - 8
    return dct


def _png_or_jpeg2000(buf: bytes, start: int, length: int, name: str):
    sig = buf[start:start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        arr, mode, info = png.decode_png_like_pil(buf[start:], name)
        return arr, mode, ({"palette": info["palette"]} if mode == "P"
                           else {})
    if not (sig.startswith((jp2.CODESTREAM, b"\x0d\x0a\x87\x0a"))
            or sig == jp2.SIGNATURE):
        raise IcnsError(f"{name}: Unsupported icon subimage format")
    if length < -1:
        raise IcnsError(f"{name}: read length must be non-negative or -1")
    stream = buf[start:] if length == -1 else buf[start:start + length]
    header = jp2.pil_open(stream)
    check_size(*header.size, name)
    arr = jpeg2000.decode_like_pil(stream, header, name)
    mode = header.mode
    if mode in ("P", "PA"):
        raise UnreadableImageError(f"{name}: ICNS is not ported (a JPEG 2000 "
                                   f"palette entry)")
    if mode == "RGBA":
        return arr, mode, {}
    h, w = arr.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode in ("L", "LA"):
        out[..., :3] = (arr if mode == "L" else arr[..., 0])[..., None]
        if mode == "LA":
            out[..., 3] = arr[..., 1]
    elif mode.startswith("I;16"):
        out[..., :3] = np.minimum(arr, 255).astype(np.uint8)[..., None]
    elif mode == "RGB":
        out[..., :3] = arr
    else:
        raise UnreadableImageError(f"{name}: ICNS is not ported (a JPEG 2000 "
                                   f"entry of mode {mode})")
    return out, "RGBA", {}


def _rgb32(buf: bytes, start: int, length: int, side: tuple, name: str):
    """read_32: ([h, w, 3], the pad byte of PIL's 4-byte pixels)."""
    w, h = side
    if length == w * h * 3:
        data = buf[start:start + length]
        if len(data) < length:
            raise IcnsError(f"{name}: not enough image data")
        return np.frombuffer(data, np.uint8).reshape(h, w, 3).copy(), 255
    try:
        planes = small_codecs.icns_rle(buf[start:], w * h, 3)
    except small_codecs.SmallCodecError as e:
        raise IcnsError(f"{name}: {e}") from None
    return np.ascontiguousarray(planes.reshape(3, h, w).transpose(1, 2, 0)), 0


def _image(buf: bytes, dct: dict, best: tuple, name: str):
    """IcnsFile.getimage(best): (array, mode, info)."""
    side = (best[0] * best[2], best[1] * best[2])
    found = {}
    for code, kind in SIZES[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if kind == PNG_OR_JP2:
            found["RGBA"] = (start, length)
        elif kind == MASK:
            data = buf[start:start + side[0] * side[1]]
            if len(data) < side[0] * side[1]:
                raise IcnsError(f"{name}: buffer is not large enough")
            found["A"] = np.frombuffer(data, np.uint8).reshape(side[::-1])
        else:
            if kind == RGB32T:
                if buf[start:start + 4] != b"\0\0\0\0":
                    raise IcnsError(f"{name}: Unknown signature, expecting "
                                    f"0x00000000")
                start, length = start + 4, length - 4
            found["RGB"] = _rgb32(buf, start, length, side, name)
    # PIL opens the PNG (or decodes and converts the JPEG 2000) entry when
    # dataforsize reads it, before the entries after it
    if "RGBA" in found:
        return (*_png_or_jpeg2000(buf, *found["RGBA"], name), 255)
    if "RGB" not in found:
        raise IcnsError(f"{name}: no RGB entry of the best size")
    rgb, pad = found["RGB"]
    if "A" in found:
        return np.concatenate([rgb, found["A"][..., None]], -1), "RGBA", {}, \
            255
    return rgb, "RGB", {}, pad


def _fresh_asarray(arr, mode: str, pad: int, name: str):
    """np.asarray of the image before its load: its pixels packed as RGBA
    (RGB: with the pad byte) and read in the loaded mode's shape."""
    if mode == "RGB":
        h, w = arr.shape[:2]
        px = np.concatenate([arr, np.full((h, w, 1), pad, np.uint8)], -1)
        return px.reshape(-1)[:h * w * 3].reshape(h, w, 3)
    return UnreadableImageError(f"{name}: No packer found from {mode} to "
                                f"RGBA")


def decode_icns(buf: bytes, name: str = "ICNS"):
    """(array, mode, info) of an ICNS file's bytes (info: the palette of a
    PNG entry of mode P)."""
    if not buf.startswith(b"icns"):
        raise NotThisFormat(f"{name}: not an icns file")
    dct = _blocks(buf, name)
    sizes = [size for size, entries in SIZES.items()
             if any(code in dct for code, _ in entries)]
    if not sizes:
        raise NotThisFormat(f"{name}: No 32bit icon resources found")
    best = max(sizes)
    check_size(best[0] * best[2], best[1] * best[2], name)
    try:
        arr, mode, info, pad = _image(buf, dct, best, name)
    except NotThisFormat as e:         # a sub-image's header, inside load
        raise IcnsError(f"{name}: {e}") from None
    except (png.PngError, jpeg2000.Jpeg2000Error, jp2.Jp2Error) as e:
        raise IcnsError(f"{name}: {e}") from None
    h, w = arr.shape[:2]
    if not any(s[1] * s[2] / h == s[0] * s[2] // w for s in sizes):
        raise IcnsError(f"{name}: This is not one of the allowed sizes of "
                        f"this image")
    if mode != "RGBA":
        info["asarray"] = _fresh_asarray(arr, mode, pad, name)
    return arr, mode, info


def read_icns_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an ICNS
    file."""
    with open(path, "rb") as f:
        return decode_icns(f.read(), path)
