"""Radiance RGBE (.hdr) reader in numpy, for the relighting envmaps.

Reads what the JAX package reads through ``cv2.imread(path,
IMREAD_UNCHANGED)`` with BGR -> RGB: the header (``#?RADIANCE`` or
``#?RGBE``, ``FORMAT=32-bit_rle_rgbe``, a ``-Y H +X W`` resolution line), then
flat or run-length-encoded scanlines, decoded as Greg Ward's rgbe.c (which
OpenCV vendors) decodes them: value = mantissa · 2^(exponent - 136), 0 where
the exponent byte is 0.
"""

from __future__ import annotations

import numpy as np


class HdrError(ValueError):
    pass


def _parse_header(buf: bytes):
    """-> (height, width, offset of the pixel data)."""
    if not buf.startswith(b"#?"):
        raise HdrError("not a Radiance file (no '#?' magic)")
    pos = 0
    while True:                       # header lines up to the blank line
        end = buf.find(b"\n", pos)
        if end < 0:
            raise HdrError("truncated header")
        line = buf[pos:end]
        pos = end + 1
        if not line.strip():
            break
        if line.startswith(b"FORMAT=") and line.strip() != b"FORMAT=32-bit_rle_rgbe":
            raise HdrError(f"unsupported {line.decode(errors='replace')}")
    end = buf.find(b"\n", pos)
    if end < 0:
        raise HdrError("no resolution line")
    parts = buf[pos:end].split()
    if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
        raise HdrError(f"unsupported orientation {buf[pos:end]!r} (only -Y H +X W)")
    return int(parts[1]), int(parts[3]), end + 1


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
    """A .hdr image -> float32 [H, W, 3], RGB."""
    with open(path, "rb") as f:
        buf = f.read()
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
