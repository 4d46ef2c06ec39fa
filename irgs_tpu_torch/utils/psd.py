"""Adobe Photoshop (PSD) reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode``, ``im.getpalette()`` and ``im.info["icc_profile"]`` give it
(Pillow 12's PsdImagePlugin): the composite image only, which is what
PIL's tile holds (its frame number says 1, the first layer, but the
layers are read only on seek).

Modes as PIL's MODES table maps (colour mode, depth): bitmap 1 bit "1",
grey, duotone and multichannel "L", indexed "P" (a palette only where
the colour-mode data is 768 bytes, planar R, G, B), RGB (RGBA where the
file has exactly 4 channels; extra channels otherwise ignored), CMYK
read inverted, Lab "LAB" (a and b with their top bit flipped, as PIL's
band unpackers store them). The image resources are walked for the ICC
profile (id 1039), and the layer and mask section is skipped by its
length. The composite is raw, one plane after the other, or PackBits:
a table of per-row byte counts, of which only the sums move the offset of
each channel, and then each channel's rows decoded as one stream with
libImaging's PackbitsDecode (utils/small_codecs.packbits_pil), which may
read on into the next channel's bytes.

A header that is short, not version 1, or of a (mode, depth) PIL does not
list (16 bits, for one), a section length cut short and a row-count
table cut short hand the file to the next plugin, as PIL's _open fails
there with SyntaxError, KeyError or struct.error; too few channels, an
unknown compression (ZIP) and pixel data that ends early raise PsdError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import small_codecs
from .image import NotThisFormat, bits_of, check_size

# (colour mode, bits) -> (PIL mode, channels read)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class PsdError(ValueError):
    pass


class _File:
    """A file object's read, tell and seek over the bytes (reads past the
    end return what is there, a seek past it is kept)."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def read(self, n: int) -> bytes:
        data = self.buf[self.pos:self.pos + max(n, 0)]
        self.pos += len(data)
        return data

    def u(self, n: int, name: str) -> int:
        """PIL's i16/i32 (big-endian) of the next n bytes, struct.error
        (the next plugin's turn) where they are not there."""
        data = self.read(n)
        if len(data) < n:
            raise NotThisFormat(f"{name}: PSD header cut short")
        return int.from_bytes(data, "big")


def _header(buf: bytes, name: str):
    """PsdImageFile._open: (mode, channels, size, info, palette, tiles)
    with tiles [(offset, compression)] of the composite's channels."""
    f = _File(buf)
    s = f.read(26)
    if len(s) < 26 or not s.startswith(b"8BPS") or s[4:6] != b"\0\1":
        raise NotThisFormat(f"{name}: not a PSD file")
    bits, psd_channels, psd_mode = (struct.unpack_from(">H", s, 22)[0],
                                    struct.unpack_from(">H", s, 12)[0],
                                    struct.unpack_from(">H", s, 24)[0])
    if (psd_mode, bits) not in MODES:
        raise NotThisFormat(f"{name}: PSD mode {psd_mode} at {bits} bits")
    mode, channels = MODES[(psd_mode, bits)]
    if channels > psd_channels:
        raise PsdError(f"{name}: not enough channels")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    h, w = struct.unpack_from(">II", s, 14)
    info, palette = {}, None
    size = f.u(4, name)
    if size:
        data = f.read(size)
        if mode == "P" and size == 768:
            palette = data
    size = f.u(4, name)
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            rid = f.u(2, name)
            n = f.read(1)
            if not n:
                raise NotThisFormat(f"{name}: PSD resource cut short")
            rname = f.read(n[0])
            if not len(rname) & 1:
                f.read(1)
            data = f.read(f.u(4, name))
            if len(data) & 1:
                f.read(1)
            if rid == 1039:
                info["icc_profile"] = data
    size = f.u(4, name)
    if size:
        end = f.pos + size
        f.u(4, name)
        f.pos = end
    compression = f.u(2, name)
    offset = f.pos
    tiles = []
    if compression == 0:
        for c in range(channels):
            tiles.append((offset + c * w * h, 0))
    elif compression == 1:
        counts = f.read(channels * h * 2)
        if len(counts) < channels * h * 2:
            raise NotThisFormat(f"{name}: PSD row counts cut short")
        offset = f.pos
        sums = np.frombuffer(counts, ">u2").astype(np.int64).reshape(
            channels, h).sum(1) if h else np.zeros(channels, np.int64)
        for c in range(channels):
            tiles.append((offset, 1))
            offset += int(sums[c])
    return mode, channels, (w, h), info, palette, tiles


def decode_psd(buf: bytes, name: str = "PSD"):
    """(array, mode, info) of a PSD file's bytes (info: the palette of mode
    P, ``icc_profile``)."""
    mode, channels, (w, h), info, palette, tiles = _header(buf, name)
    check_size(w, h, name)
    if not tiles:
        raise PsdError(f"{name}: cannot load this image (compression)")
    rowbytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    for offset, compression in tiles:
        if compression == 0:
            data = buf[offset:offset + rowbytes * h]
            if len(data) < rowbytes * h:
                raise PsdError(f"{name}: image file is truncated")
            rows = np.frombuffer(data, np.uint8).reshape(h, rowbytes)
        else:
            try:
                rows = small_codecs.packbits_pil(buf[offset:], rowbytes, h)
            except small_codecs.SmallCodecError as e:
                raise PsdError(f"{name}: {e}") from None
        planes.append(rows)
    if mode == "1":
        return bits_of(planes[0], 1, w).astype(bool), mode, info
    arr = planes[0] if channels == 1 else np.stack(planes, -1)
    if mode == "CMYK":
        arr = 255 - arr
    elif mode == "LAB":      # the a and b bands' unpackers flip the sign bit
        arr = arr ^ np.array([0, 128, 128], np.uint8)
    if mode == "P":
        pal = np.frombuffer(palette or b"", np.uint8)
        n = len(pal) // 3
        info["palette"] = pal[:3 * n].reshape(3, n).T.copy()
    return np.ascontiguousarray(arr), mode, info


def read_psd_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a PSD
    file."""
    with open(path, "rb") as f:
        return decode_psd(f.read(), path)
