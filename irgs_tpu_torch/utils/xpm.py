"""X11 pixmap (XPM) reader, as ``np.asarray(PIL.Image.open(path))``,
``im.mode``, ``im.getpalette()`` and ``im.info`` give it (Pillow 12's
XpmImagePlugin and its Python XpmDecoder).

After the ``/* XPM */`` line, the first line that holds ``"w h n cpp``
gives the size, the number of colours and the characters a pixel; the n
lines after it are the colours: the first ``c`` key of each line is read,
``#rrggbb`` (any number of hex digits, as int(..., 16) reads them) or
``None``, which PIL keeps as ``info["transparency"]`` (the pixel's key)
and leaves out of the palette. Another colour or a line without a ``c``
key raises, as PIL does. Up to 256 colours the image is P (the palette in
the order of the lines; a key given twice keeps its first place and its
last colour), else RGB. The pixels are the text between the first and
last quote of each line after the colours (one ``/* pixels */`` line
skipped), rows concatenated as the decoder reads them until it has the
image; a key the palette lacks (the transparent one included) raises, as
in PIL.

A header PIL's _open fails on with SyntaxError, IndexError or the like
hands the file to the next plugin; other failures raise XpmError.
"""

from __future__ import annotations

import io
import re

import numpy as np

from .image import check_size, pil_open

HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


class XpmError(ValueError):
    pass


def _open(fp):
    if not fp.read(9).startswith(b"/* XPM */"):
        raise SyntaxError("not an XPM file")
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = HEAD.match(line)
        if m:
            break
    size = int(m.group(1)), int(m.group(2))
    n, bpp = int(m.group(3)), int(m.group(4))
    palette, info = {}, {}
    for _ in range(n):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    info["transparency"] = c
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255,
                                        v & 255))
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    return size, bpp, palette, info


def decode_xpm(buf: bytes, name: str = "XPM"):
    """(array, mode, info) of an XPM file's bytes (info: the palette of
    mode P, uint8 [n, 3], and the transparent key where there is one)."""
    fp = io.BytesIO(buf)
    (w, h), bpp, palette, info = pil_open(_open, fp, name, XpmError)
    mode = "RGB" if len(palette) > 256 else "P"
    check_size(w, h, name)
    if mode == "P":
        info["palette"] = np.frombuffer(b"".join(palette.values()),
                                        np.uint8).reshape(-1, 3).copy()
        index = {k: bytes([i]) for i, k in enumerate(palette)}
    need = w * h * (3 if mode == "RGB" else 1)
    data = bytearray()
    header = False
    try:
        while len(data) < need:
            line = fp.readline()
            if not line:
                break
            if line.rstrip() == b"/* pixels */" and not header:
                header = True
                continue
            line = b'"'.join(line.split(b'"')[1:-1])
            lookup = palette if mode == "RGB" else index
            for i in range(0, len(line), bpp):
                data += lookup[line[i:i + bpp]]
    except (KeyError, ValueError) as e:
        raise XpmError(f"{name}: {e!r} (a key the palette lacks)") from None
    if len(data) < need:
        raise XpmError(f"{name}: not enough image data")
    arr = np.frombuffer(bytes(data[:need]), np.uint8)
    return (arr.reshape(h, w, 3) if mode == "RGB" else arr.reshape(h, w)
            ).copy(), mode, info


def read_xpm_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for an XPM
    file."""
    with open(path, "rb") as f:
        return decode_xpm(f.read(), path)
