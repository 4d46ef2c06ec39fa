"""Netpbm reader, as ``np.asarray(PIL.Image.open(path))`` and ``im.mode``
give it (Pillow 12's PpmImagePlugin): P1-P6 plain (ASCII) and raw, PFM
("Pf", mode F), and PIL's own P0CMYK, PyP, PyRGBA and PyCMYK.

The header is read as PIL reads it: a magic of up to six bytes, then
tokens of at most ten bytes split by whitespace, each "#" comment running
to the next CR or LF; a magic PIL does not know, or a size of zero, hands
the file to the next plugin. Samples follow PIL's rules: maxval 255 is
copied, 65535 on a P5 file is "I;16B" into mode I, any other maxval is
scaled by ``round(v / maxval * out_max)`` (Python's round, half to even)
into L (or I above 255), the P1-P3 tokens in SAFEBLOCK-sized blocks with
the plain decoder's comment and token checks. PFM rows run bottom-up and
the sign of the scale gives the byte order.

Streams PIL refuses raise PpmError.
"""

from __future__ import annotations

import math

import numpy as np

from .image import NotThisFormat, bits_of, check_size

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1024 * 1024           # ImageFile.SAFEBLOCK


class PpmError(ValueError):
    pass


class _Reader:
    """A file object over bytes, for the header as PIL reads it."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _magic(f: _Reader) -> bytes:
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in WHITESPACE:
            break
        magic += c
    return magic


def _token(f: _Reader, name: str) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise PpmError(f"{name}: Reached EOF while reading header")
    if len(token) > 10:
        raise PpmError(f"{name}: Token too long in file header: {token!r}")
    return token


def _int(token: bytes, name: str) -> int:
    try:
        return int(token)
    except ValueError as e:
        raise PpmError(f"{name}: {e}") from None


class _Plain:
    """PpmPlainDecoder over the data from `pos`."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos, self.spans = buf, pos, False

    def block(self) -> bytes:
        out = self.buf[self.pos:self.pos + SAFEBLOCK]
        self.pos += len(out)
        return out

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a = block.find(b"\n", start)
        b = block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def ignore_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int, name: str) -> bytes:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.ignore_comments(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise PpmError(f"{name}: Invalid token for this mode: "
                               f"{bad[:1]!r}")
            data = (data + tokens)[:total]
        return data.translate(bytes.maketrans(b"01", b"\xff\x00"))

    def blocks(self, total: int, maxval: int, out_max: int,
               name: str) -> list:
        data, half = [], b""
        while len(data) != total:
            block = self.block()
            if not block:
                if half:
                    block = b" "
                else:
                    break
            block = self.ignore_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise PpmError(f"{name}: Token too long found in data: "
                                   f"{half[:11]!r}")
            for token in tokens:
                if len(token) > 10:
                    raise PpmError(f"{name}: Token too long found in data: "
                                   f"{token[:11]!r}")
                value = _int(token, name)
                if value < 0:
                    raise PpmError(f"{name}: Channel value is negative: "
                                   f"{value}")
                if value > maxval:
                    raise PpmError(f"{name}: Channel value too large for "
                                   f"this mode: {value}")
                data.append(round(value / maxval * out_max))
                if len(data) == total:
                    break
        return data


def _shape(vals, w: int, h: int, bands: int) -> np.ndarray:
    return vals.reshape((h, w, bands) if bands > 1 else (h, w))


def _header(buf: bytes, name: str):
    f = _Reader(buf)
    magic = _magic(f)
    if magic not in MODES:
        raise NotThisFormat(f"{name}: not a PPM file")
    mode = MODES[magic]
    w = _int(_token(f, name), name)
    h = _int(_token(f, name), name)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        return f.pos, magic, mode, w, h, None, plain
    if mode == "F":
        token = _token(f, name)
        try:
            scale = float(token)
        except ValueError as e:
            raise PpmError(f"{name}: {e}") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise PpmError(f"{name}: scale must be finite and non-zero")
        return f.pos, magic, mode, w, h, scale, plain
    maxval = _int(_token(f, name), name)
    if not 0 < maxval < 65536:
        raise PpmError(f"{name}: maxval must be greater than 0 and less than "
                       f"65536")
    return f.pos, magic, mode, w, h, maxval, plain


def decode_ppm(buf: bytes, name: str = "PPM"):
    """(array, mode, info) of a Netpbm file's bytes."""
    pos, magic, mode, w, h, arg, plain = _header(buf, name)
    if mode == "L" and arg > 255:
        out_mode = "I"
    else:
        out_mode = mode
    check_size(w, h, name)
    # PIL's PyP image has a palette of no entries: every index is black
    info = {"palette": np.zeros((0, 3), np.uint8)} if mode == "P" else {}
    if mode == "F":
        info["scale"] = abs(arg)
        need = 4 * w * h
        data = buf[pos:pos + need]
        if len(data) < need:
            raise PpmError(f"{name}: image file is truncated")
        arr = np.frombuffer(data, "<f4" if arg < 0 else ">f4").reshape(h, w)
        return np.ascontiguousarray(arr[::-1], np.float32), "F", info
    bands = BANDS[out_mode]
    if mode == "1":
        if plain:
            data = _Plain(buf, pos).bitonal(w * h, name)
            if len(data) < w * h:
                raise PpmError(f"{name}: not enough image data")
            arr = np.frombuffer(data, np.uint8).reshape(h, w) > 0
        else:
            stride = (w + 7) // 8
            data = buf[pos:pos + stride * h]
            if len(data) < stride * h:
                raise PpmError(f"{name}: image file is truncated")
            rows = np.frombuffer(data, np.uint8).reshape(h, stride)
            arr = bits_of(rows, 1, w) == 0
        return arr, "1", info
    maxval = arg
    out_max = 65535 if out_mode == "I" else 255
    total = w * h * bands
    if plain:
        vals = _Plain(buf, pos).blocks(total, maxval, out_max, name)
        if len(vals) < total:
            raise PpmError(f"{name}: not enough image data")
        dtype = np.int32 if out_mode == "I" else np.uint8
        return _shape(np.asarray(vals, dtype), w, h, bands), out_mode, info
    if maxval == 255 or (maxval == 65535 and mode == "L"):
        size = 2 if maxval == 65535 else 1
        data = buf[pos:pos + total * size]
        if len(data) < total * size:
            raise PpmError(f"{name}: image file is truncated")
        vals = np.frombuffer(data, ">u2" if size == 2 else np.uint8)
        vals = vals.astype(np.int32 if size == 2 else np.uint8)
        return _shape(vals, w, h, bands), out_mode, info
    # PpmDecoder: whole pixels of 1 or 2 bytes a sample, scaled
    size = 1 if maxval < 256 else 2
    n = min(len(buf) - pos, total * size) // (size * bands) * bands
    if n < total:
        raise PpmError(f"{name}: not enough image data")
    raw = np.frombuffer(buf[pos:pos + total * size],
                        np.uint8 if size == 1 else ">u2")
    vals = np.minimum(out_max, np.round(raw / maxval * out_max))
    vals = vals.astype(np.int32 if out_mode == "I" else np.uint8)
    return _shape(vals, w, h, bands), out_mode, info


def read_ppm_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a Netpbm
    file (info: the PFM scale)."""
    with open(path, "rb") as f:
        return decode_ppm(f.read(), path)
