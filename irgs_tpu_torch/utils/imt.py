"""IM Tools (IMT) reader, as ``np.asarray(PIL.Image.open(path))`` and
``im.mode`` give it (Pillow 12's ImtImagePlugin): text lines ``key
value`` (``width``, ``height``, ``pixel n8`` for mode L; a ``*`` line is
a comment) up to a form feed, then the L pixels raw (mapped as PIL maps
them). The header is parsed as the plugin's loop parses it, 100 bytes a
read; no line feed in the first 100 bytes, no mode or no size hand the
file on, a width or height that is not a number raises.
"""

from __future__ import annotations

import io
import re

from . import pil_raw
from .image import NotThisFormat, check_size, pil_open

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


class ImtError(ValueError):
    pass


def _open(fp):
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return size, mode, offset


def decode_imt(buf: bytes, name: str = "IMT"):
    """(array, mode, info) of an IM Tools file's bytes."""
    (w, h), mode, offset = pil_open(_open, io.BytesIO(buf), name, ImtError)
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: not identified by this plugin")
    check_size(w, h, name)
    if offset is None:
        raise ImtError(f"{name}: cannot load this image (no tile)")
    try:
        return pil_raw.load(buf, offset, "L", "L", (w, h), name=name), "L", {}
    except pil_raw.RawError as e:
        raise ImtError(str(e)) from None


def read_imt_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an IM
    Tools file."""
    with open(path, "rb") as f:
        return decode_imt(f.read(), path)
