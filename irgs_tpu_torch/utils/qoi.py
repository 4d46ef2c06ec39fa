"""QOI reader, as ``np.asarray(PIL.Image.open(path))`` and ``im.mode``
give it (Pillow 12's QoiImagePlugin): the 14-byte header (big-endian
width and height; 3 channels read as RGB, any other count as RGBA), then
QoiDecoder's op stream (csrc/small_decode.cpp): QOI_OP_RGB, RGBA, INDEX
(an index never written gives 0, 0, 0, 0), DIFF, LUMA and RUN (a run is
not stored in the index), alpha kept through an RGB image's ops. Bytes
after the last pixel are not read. A header cut before its channel count,
or a size of zero, hands the file to the next plugin; a stream that ends
before the image raises QoiError."""

from __future__ import annotations

import struct

from . import small_codecs
from .image import NotThisFormat, check_size


class QoiError(ValueError):
    pass


def decode_qoi(buf: bytes, name: str = "QOI"):
    """(array, mode, info) of a QOI file's bytes."""
    if not buf.startswith(b"qoif") or len(buf) < 13:
        raise NotThisFormat(f"{name}: not a QOI file")
    w, h = struct.unpack_from(">II", buf, 4)
    mode = "RGB" if buf[12] == 3 else "RGBA"
    check_size(w, h, name)
    bands = len(mode)
    # an op yields at most 62 pixels a byte: too short a stream fails
    # before the pixels are allocated
    if w * h > 62 * (len(buf) - 14):
        raise QoiError(f"{name}: the op stream ends before the image")
    try:
        px = small_codecs.qoi(buf[14:], w * h, bands)
    except small_codecs.SmallCodecError as e:
        raise QoiError(f"{name}: {e}") from None
    return px.reshape(h, w, bands), mode, {}


def read_qoi_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a QOI
    file."""
    with open(path, "rb") as f:
        return decode_qoi(f.read(), path)
