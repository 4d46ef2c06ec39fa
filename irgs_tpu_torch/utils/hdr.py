"""Radiance RGBE (.hdr) reader in numpy, for the relighting envmaps.

Reads what the JAX package reads through ``cv2.imread(path,
IMREAD_UNCHANGED)`` with BGR -> RGB, and refuses what cv2 refuses. The
header is read as OpenCV's HdrDecoder and its vendored rgbe.cpp read it:
the file starts with ``#?RADIANCE`` or ``#?RGBE``; every line is C's
``fgets`` into 128 bytes (up to a ``\n`` only, so a CRLF header never
ends); ``#`` lines are comments; a line equal to ``FORMAT=32-bit_rle_rgbe``
must come before the blank line that ends the header; then the resolution
line is parsed as ``sscanf(line, "-Y %d +X %d")`` parses it (text after it
is ignored) and both sizes must be positive. Then flat or run-length-
encoded scanlines, decoded as Greg Ward's rgbe.c decodes them: value =
mantissa · 2^(exponent - 136), 0 where the exponent byte is 0.

A ``.hdr`` path whose bytes are not Radiance is another format to cv2,
which decodes by content: the datasets loader reads such paths through
utils/imread.py, of which this reader is the Radiance branch.
"""

from __future__ import annotations

import re

import numpy as np

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_RESOLUTION = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30      # OpenCV's CV_IO_MAX_IMAGE_*


class HdrError(ValueError):
    pass


def _fgets(buf: bytes, pos: int):
    """C's ``fgets(line, 128, f)`` at `pos`: the bytes up to and including
    the next newline, at most 127 of them -> (line, new pos); (None, pos)
    at the end of the file."""
    if pos >= len(buf):
        return None, pos
    end = buf.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(buf)) if end < 0 else end + 1
    return buf[pos:end], end


def _parse_header(buf: bytes):
    """-> (height, width, offset of the pixel data)."""
    if not buf.startswith(SIGNATURES):
        raise HdrError("not a Radiance file (no '#?RADIANCE' or '#?RGBE' "
                       "signature)")
    _, pos = _fgets(buf, 0)
    has_format = False
    while True:                       # header lines up to the blank line
        line, pos = _fgets(buf, pos)
        if line is None:
            raise HdrError("truncated header (no blank line ends it)")
        if line[:1] == b"\n":
            break
        if line.split(b"\0", 1)[0] == b"FORMAT=32-bit_rle_rgbe\n":
            has_format = True
    if not has_format:
        raise HdrError("missing FORMAT=32-bit_rle_rgbe specifier")
    line, pos = _fgets(buf, pos)
    m = _RESOLUTION.match((line or b"").split(b"\0", 1)[0])
    if m is None:
        raise HdrError(f"unsupported orientation or missing image size "
                       f"{line!r} (only -Y H +X W)")
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        raise HdrError(f"image size {h}x{w} is not positive")
    if h > _MAX_SIDE or w > _MAX_SIDE or h * w > _MAX_PIXELS:
        raise HdrError(f"image size {h}x{w} exceeds OpenCV's limits")
    return h, w, pos


def _rle_scanline(buf: bytes, pos: int, width: int):
    """One new-style RLE scanline (4 runs of `width` bytes, one per
    component) after its 4-byte marker -> ([width, 4] uint8, new pos)."""
    out = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            if pos + 2 > len(buf):
                raise HdrError("truncated scanline")
            count = buf[pos]
            if count > 128:
                count -= 128
                if count > width - x:
                    raise HdrError("bad scanline data")
                out[c, x:x + count] = buf[pos + 1]
                pos += 2
            else:
                if count == 0 or count > width - x:
                    raise HdrError("bad scanline data")
                out[c, x:x + count] = np.frombuffer(buf, np.uint8, count,
                                                    pos + 1)
                pos += 1 + count
            x += count
    return out.T, pos


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * f[..., None]


def read_hdr(path: str) -> np.ndarray:
    """A Radiance .hdr image -> float32 [H, W, 3], RGB."""
    with open(path, "rb") as f:
        return decode_hdr(f.read())


def decode_hdr(buf: bytes) -> np.ndarray:
    """`read_hdr` of a Radiance file's bytes."""
    h, w, pos = _parse_header(buf)
    n = h * w
    rgbe = np.empty((n, 4), np.uint8)
    if 8 <= w <= 0x7FFF:
        done = 0
        while done < n:
            if pos + 4 > len(buf):
                raise HdrError("truncated pixel data")
            b = buf[pos:pos + 4]
            if b[0] != 2 or b[1] != 2 or b[2] & 0x80:
                break                     # not run-length encoded: flat rest
            if (b[2] << 8 | b[3]) != w:
                raise HdrError("wrong scanline width")
            rgbe[done:done + w], pos = _rle_scanline(buf, pos + 4, w)
            done += w
    else:
        done = 0
    rest = n - done
    if rest:
        if pos + 4 * rest > len(buf):
            raise HdrError("truncated pixel data")
        rgbe[done:] = np.frombuffer(buf, np.uint8, 4 * rest, pos).reshape(-1, 4)
    return _rgbe_to_float(rgbe).reshape(h, w, 3)
