"""FITS reader, as ``np.asarray(PIL.Image.open(path))`` and ``im.mode``
give it (Pillow 12's FitsImagePlugin).

The header is 80-byte cards from a ``SIMPLE = T`` card; each END seeks to
the next 2,880-byte block, and the first unit with NAXIS > 0 gives the
size (NAXIS1 x NAXIS2, 1 x NAXIS1 at NAXIS 1) and the mode from BITPIX (8
L, 16 I;16, 32 I, -32 and -64 F). Its pixels are the first data unit
after the header units, read raw as PIL's mode (little-endian, as PIL
reads them), rows bottom-up. A ``BINTABLE`` extension with ``ZIMAGE = T``
and ``ZCMPTYPE = 'GZIP_1'`` takes the size and mode from ZNAXIS and
ZBITPIX and its pixels from the heap after the table (NAXIS1 x NAXIS2
bytes of it): gzip streams whose 4-byte words give one pixel each (the
last BITPIX/8 bytes of each, rows bottom-up), decoded as PIL's Python
``fits_gzip`` decoder; float images find no data there and raise.

A file that ends before the data raises "Truncated FITS file", one
without image data "No image data", as PIL does; a first card other than
``SIMPLE = T`` and a missing keyword hand the file on.
"""

from __future__ import annotations

import gzip
import io
import math

import numpy as np

from . import pil_raw
from .image import NotThisFormat, check_size, pil_open

MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


class FitsError(ValueError):
    pass


def _size(headers, prefix):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers):
    """FitsImageFile._parse_headers -> (decoder, offset, size, mode, bits)
    or None without an image."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _size(headers, prefix) or (0, 0)
        offset = table[0] * table[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, size, MODES.get(bits, ""), bits


def _open(fp):
    headers, in_progress, found = {}, False, None
    while True:
        card = fp.read(80)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not found:
                found = _parse(headers)
            in_progress = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("No image data")
    return found, fp.tell() - 80


def decode_fits(buf: bytes, name: str = "FITS"):
    """(array, mode, info) of a FITS file's bytes."""
    (decoder, offset, (w, h), mode, bits), at = pil_open(
        _open, io.BytesIO(buf), name, FitsError)
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(w, h, name)
    offset += at
    try:
        if decoder == "raw":
            return pil_raw.load(buf, offset, mode, mode, (w, h), ystep=-1,
                                name=name), mode, {}
        if offset < 0:
            raise FitsError(f"{name}: negative seek value {offset}")
        value = gzip.decompress(buf[offset:])
        nb = min(bits // 8, 4)
        words = np.frombuffer(value[:len(value) // 4 * 4], np.uint8)
        need = w * h * pil_raw.BITS[mode, mode] // 8
        if nb <= 0 or len(words) < 4 * w * h:
            raise FitsError(f"{name}: not enough image data")
        px = words[:4 * w * h].reshape(h, w, 4)[:, :, 4 - nb:]
        data = np.ascontiguousarray(px[::-1]).tobytes()
        return pil_raw.load(data[:need], 0, mode, mode, (w, h), maps=False,
                            name=name), mode, {}
    except Exception as e:     # the raw decoder's, gzip's and zlib's errors
        raise FitsError(f"{name}: {e!r}") from None


def read_fits_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a FITS
    file."""
    with open(path, "rb") as f:
        return decode_fits(f.read(), path)
