"""DirectDraw Surface reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode``, ``im.getpalette()`` and ``im.info["gamma"]`` give it
(Pillow 12's DdsImagePlugin).

The 124-byte header's pixel-format flags pick the layout:
  RGB       uncompressed pixels of bitcount / 8 bytes (little-endian)
            with a mask for R, G, B (and A with ALPHAPIXELS: mode RGBA),
            each masked value shifted down and scaled to 0-255 as
            DdsRgbDecoder does (float, truncated); the bytes past the end
            of the file read as 0, as its reads of the file do;
  LUMINANCE L at 8 bits, LA at 16 with ALPHAPIXELS;
  PALETTE   P, the 1024-byte RGBA palette after the header;
  FOURCC    DXT1/3/5, BC4U/ATI1 (L), BC5U/ATI2 and BC5S (RGB) through the
            "bcn" decoder (utils/bcn.py), and DX10 with its DXGI format:
            BC1-BC7 typeless, UNORM, SNORM (BC5) and BC7's SRGB, BC6H UF16
            and SF16, R8G8B8A8 (typeless, UNORM, SRGB) as raw RGBA;
            ``info["gamma"]`` 1/2.2 for the SRGB formats.
A header size other than 124, a short header and a pixel format _open
does not list raise DdsError (PIL's OSError and NotImplementedError,
which Image.open does not hand on); a DX10 header cut in its format
field, and a size of zero, hand the file to the next plugin. Pixel data
that ends early raises, as PIL's "image file is truncated" (DdsRgbDecoder
excepted).
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn
from .image import NotThisFormat, check_size

# pixel-format flags
ALPHAPIXELS, FOURCC, PALETTEINDEXED8, RGB, LUMINANCE = 0x1, 0x4, 0x20, 0x40, \
    0x20000
# FourCC -> (mode, bcn pixel format)
FOURCCS = {b"DXT1": ("RGBA", "DXT1"), b"DXT3": ("RGBA", "DXT3"),
           b"DXT5": ("RGBA", "DXT5"), b"BC4U": ("L", "BC4"),
           b"ATI1": ("L", "BC4"), b"BC5S": ("RGB", "BC5S"),
           b"BC5U": ("RGB", "BC5"), b"ATI2": ("RGB", "BC5")}
# DXGI format -> (mode, bcn pixel format or None for raw RGBA, SRGB)
DXGI = {70: ("RGBA", "BC1", False), 71: ("RGBA", "BC1", False),
        73: ("RGBA", "BC2", False), 74: ("RGBA", "BC2", False),
        76: ("RGBA", "BC3", False), 77: ("RGBA", "BC3", False),
        79: ("L", "BC4", False), 80: ("L", "BC4", False),
        82: ("RGB", "BC5", False), 83: ("RGB", "BC5", False),
        84: ("RGB", "BC5S", False), 95: ("RGB", "BC6H", False),
        96: ("RGB", "BC6HS", False), 97: ("RGBA", "BC7", False),
        98: ("RGBA", "BC7", False), 99: ("RGBA", "BC7", True),
        27: ("RGBA", None, False), 28: ("RGBA", None, False),
        29: ("RGBA", None, True)}


class DdsError(ValueError):
    pass


def _header(buf: bytes, name: str):
    """DdsImageFile._open: (mode, size, how the pixels are stored, offset of
    the pixel data, palette or None, info)."""
    if len(buf) < 8:
        raise NotThisFormat(f"{name}: short DDS header")
    (header_size,) = struct.unpack_from("<I", buf, 4)
    if header_size != 124:
        raise DdsError(f"{name}: Unsupported header size {header_size}")
    header = buf[8:128]
    if len(header) != 120:
        raise DdsError(f"{name}: Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack_from("<3I", header)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", header, 72)
    info, palette, at = {}, None, 128
    if pfflags & RGB:
        count = 4 if pfflags & ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", header, 84)
        return ("RGBA" if count == 4 else "RGB", (width, height),
                ("masks", bitcount, masks), at, palette, info)
    if pfflags & LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & ALPHAPIXELS:
            mode = "LA"
        else:
            raise DdsError(f"{name}: Unsupported bitcount {bitcount} for "
                           f"{pfflags}")
        return mode, (width, height), ("raw", mode), at, palette, info
    if pfflags & PALETTEINDEXED8:
        palette = np.frombuffer(buf[128:1152], np.uint8)
        return "P", (width, height), ("raw", "P"), 1152, palette, info
    if not pfflags & FOURCC:
        raise DdsError(f"{name}: Unknown pixel format flags {pfflags}")
    if fourcc in FOURCCS:
        mode, fmt = FOURCCS[fourcc]
        return mode, (width, height), ("bcn", fmt), at, palette, info
    if fourcc != b"DX10":
        raise DdsError(f"{name}: Unimplemented pixel format "
                       f"{struct.unpack('<I', fourcc)[0]!r}")
    if len(buf) < 132:
        raise NotThisFormat(f"{name}: DX10 header cut in its format")
    (dxgi,) = struct.unpack_from("<I", buf, 128)
    if dxgi not in DXGI:
        raise DdsError(f"{name}: Unimplemented DXGI format {dxgi}")
    mode, fmt, srgb = DXGI[dxgi]
    if srgb:
        info["gamma"] = 1 / 2.2
    how = ("bcn", fmt) if fmt else ("raw", "RGBA")
    return mode, (width, height), how, 148, palette, info


def _masked(buf: bytes, at: int, bitcount: int, masks, w: int,
            h: int) -> np.ndarray:
    """DdsRgbDecoder: each pixel's bitcount // 8 bytes (0 past the end of
    the file) as a little-endian value; per mask, the masked value shifted
    down by the mask's trailing zeros, over the shifted mask, times 255,
    truncated."""
    step = bitcount // 8
    n = w * h
    value = np.zeros(n, np.uint64)
    src = np.frombuffer(buf, np.uint8)
    start = at + np.arange(n, dtype=np.int64) * step
    for k in range(min(step, 4)):      # the masks see the low 32 bits
        pos = start + k
        ok = pos < len(src)
        byte = np.zeros(n, np.uint64)
        byte[ok] = src[pos[ok]]
        value |= byte << np.uint64(8 * k)
    planes = []
    for mask in masks:
        off = 0
        if mask:
            while (mask >> (off + 1)) << (off + 1) == mask:
                off += 1
        total = mask >> off
        if not total:
            planes.append(np.zeros(n, np.uint8))
            continue
        v = (value & np.uint64(mask)) >> np.uint64(off)
        planes.append((v.astype(np.float64) / total * 255).astype(np.uint8))
    return np.stack(planes, -1).reshape(h, w, len(masks))


def decode_dds(buf: bytes, name: str = "DDS"):
    """(array, mode, info) of a DDS file's bytes (info: the RGB palette of
    mode P, ``gamma`` of the SRGB formats)."""
    if not buf.startswith(b"DDS "):
        raise NotThisFormat(f"{name}: not a DDS file")
    mode, (w, h), how, at, palette, info = _header(buf, name)
    check_size(w, h, name)
    if how[0] == "masks":
        return _masked(buf, at, how[1], how[2], w, h), mode, info
    if how[0] == "bcn":
        try:
            arr = bcn.decode(buf[at:], how[1], w, h)
        except bcn.BcnError as e:
            raise DdsError(f"{name}: {e}") from None
        return (arr if mode == "L" else arr[..., :len(mode)]), mode, info
    bands = len(mode) if mode != "P" else 1
    data = buf[at:at + w * h * bands]
    if len(data) < w * h * bands:
        raise DdsError(f"{name}: image file is truncated")
    arr = np.frombuffer(data, np.uint8).reshape(h, w, bands)
    if mode == "P":
        info["palette"] = palette.reshape(-1, 4)[:, :3].copy()
    return (arr[..., 0] if bands == 1 else arr).copy(), mode, info


def read_dds_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a DDS
    file."""
    with open(path, "rb") as f:
        return decode_dds(f.read(), path)
