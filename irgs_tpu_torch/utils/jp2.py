"""The JP2 container (ISO 15444-1 Annex I), read twice as the JAX loaders'
libraries read it:

* `pil_open` is Pillow 12's Jpeg2KImagePlugin._open: the mode and size
  from the ``ihdr`` box (or, for a raw codestream, from SIZ: L, or I;16
  above 8 bits, LA, RGB, RGBA), CMYK from a ``colr`` box of method 1 and
  enumerated space 12 on four components, P or PA from a ``pclr`` box of at
  most 8-bit entries on L or LA (its colours merged as ImagePalette.getcolor
  merges them), ``info["dpi"]`` from ``res ``/``resc`` and
  ``info["comment"]`` from the first COM marker. Where _open fails as PIL
  hands a file on (SyntaxError, IndexError, struct.error) it raises
  `NotThisFormat`; a short read inside a box raises `Jp2Error`, as PIL's
  OSError does.
* `opj_boxes` is OpenJPEG 2.5's opj_jp2_read_header: the signature and
  file-type boxes first, then ``jp2h`` (``ihdr``, ``bpcc``, ``colr``,
  ``pclr``, ``cmap``, ``cdef``) before ``jp2c``, whose contents start the
  codestream (which runs to the end of the file); it raises
  `j2k.J2kError` where OpenJPEG refuses the header.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .image import NotThisFormat
from .j2k import J2kError

SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
CODESTREAM = b"\xff\x4f\xff\x51"


class Jp2Error(ValueError):
    """PIL's _open raises an error it does not hand on (OSError,
    ValueError)."""


# ---------------------------------------------------------------- PIL side
class _Box:
    """Jpeg2KImagePlugin.BoxReader over bytes."""

    def __init__(self, buf: bytes, pos: int, length: int = -1):
        self.buf, self.pos = buf, pos
        self.has_length = length >= 0
        self.end = pos + length if length >= 0 else -1
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.pos + n > self.end:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def read(self, n):
        if not self._can_read(n):
            raise NotThisFormat("Not enough data in header")
        data = self.buf[self.pos:self.pos + n]
        self.pos += len(data)
        if len(data) < n:
            raise Jp2Error(f"Expected to read {n} bytes but only got "
                           f"{len(data)}.")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self):
        size = self.remaining
        data = self.read(size)
        return _Box(data, 0, size)

    def has_next(self):
        return (self.pos + self.remaining < self.end) if self.has_length \
            else True

    def next_type(self):
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox = self.fields(">Q")[0]
            hlen = 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise NotThisFormat("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _parse_codestream(buf, pos):
    """(size, mode, position after SIZ) of Jpeg2KImagePlugin.
    _parse_codestream."""
    hdr = buf[pos:pos + 2]
    if len(hdr) < 2:
        raise NotThisFormat("truncated SIZ")
    lsiz = struct.unpack(">H", hdr)[0]
    n = lsiz - 2 if lsiz >= 2 else len(buf)
    siz = hdr + buf[pos + 2:pos + 2 + n]
    if len(siz) < 38:
        raise NotThisFormat("truncated SIZ")
    (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise NotThisFormat("truncated SIZ")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise NotThisFormat("unable to determine J2K image mode")
    return size, mode, pos + 2 + min(n, len(buf) - pos - 2)


def _res_to_dpi(num, denom, exp):
    if denom == 0:
        return None
    return (254 * num * (10 ** exp)) / (10000 * denom)


def _getcolor(colors: dict, palette: bytearray, color: tuple, mode: str):
    """ImagePalette.getcolor on a fresh palette of mode RGB or RGBA."""
    if mode == "RGB" and len(color) == 4:
        if color[3] != 255:
            raise Jp2Error("cannot add non-opaque RGBA color to RGB palette")
        color = color[:3]
    elif mode == "RGBA" and len(color) == 3:
        color += (255,)
    if color in colors:
        return
    index = len(colors)
    if index >= 256:
        raise Jp2Error("cannot allocate more than 256 colors")
    colors[color] = index
    palette += bytes(color)


@dataclass
class PilHeader:
    codec: str
    size: tuple
    mode: str
    info: dict = field(default_factory=dict)
    palette: list = None          # RGB triplets of P/PA, as getpalette()


def _parse_comment(buf, pos, info):
    while True:
        marker = buf[pos:pos + 2]
        pos += len(marker)
        if not marker:
            return
        if len(marker) < 2:
            raise NotThisFormat("truncated marker")
        if marker[1] in (0x90, 0xD9):
            return
        hdr = buf[pos:pos + 2]
        pos += len(hdr)
        if len(hdr) < 2:
            raise NotThisFormat("truncated marker")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            n = length - 2 if length >= 2 else len(buf)
            info["comment"] = buf[pos:pos + n][2:]
            return
        pos = max(pos + length - 2, 0)


def pil_open(buf: bytes) -> PilHeader:
    """Jpeg2KImagePlugin._open on the file's bytes."""
    if buf[:4] == CODESTREAM:
        size, mode, pos = _parse_codestream(buf, 4)
        h = PilHeader("j2k", size, mode)
        _parse_comment(buf, pos, h.info)
        return h
    if buf[:12] != SIGNATURE:
        raise NotThisFormat("not a JPEG 2000 file")
    reader = _Box(buf, 12)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = nc = None
    info, palette, pal_mode = {}, None, None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc == 1:
                mode = "L"
            elif nc in (2, 3, 4):
                mode = {2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                pal_mode = "RGBA" if npc == 4 else "RGB"
                colors, palette = {}, bytearray()
                for _ in range(ne):
                    _getcolor(colors, palette,
                              tuple(header.fields(">" + "B" * npc)), pal_mode)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    vn, vd, hn, hd, ve, he = res.fields(">HHHHBB")
                    hres, vres = _res_to_dpi(hn, hd, he), _res_to_dpi(
                        vn, vd, ve)
                    if hres is not None and vres is not None:
                        info["dpi"] = (hres, vres)
                    break
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    h = PilHeader("jp2", size, mode, info)
    if palette is not None:
        if pal_mode == "RGB" and len(palette) % 3:
            from .image import UnreadableImageError
            raise UnreadableImageError("JPEG2000: a palette of 1 or 2 "
                                       "columns is not ported")
        step = 3 if pal_mode == "RGB" else 4
        h.palette = [v for i in range(0, len(palette), step)
                     for v in palette[i:i + 3]]
    pos = header_end = reader.pos
    if buf[header_end:header_end + 12].endswith(b"jp2c" + CODESTREAM):
        pos = header_end + 12
        hdr = buf[pos:pos + 2]
        if len(hdr) < 2:
            raise NotThisFormat("truncated SIZ")
        pos += 2 + struct.unpack(">H", hdr)[0] - 2
        _parse_comment(buf, pos, h.info)
    return h


# ---------------------------------------------------------------- OpenJPEG
@dataclass
class Jp2Boxes:
    """What opj_jp2_read_header keeps of the JP2 boxes."""
    codestream: int                  # offset of the codestream
    w: int = 0
    h: int = 0
    numcomps: int = 0
    bpc: int = 0
    meth: int = 0
    enumcs: int = 0
    pclr: tuple = None               # (entries [ne][nc], sizes, signs)
    cmap: list = None                # [(cmp, mtyp, pcol)]
    cdef: list = None                # [(cn, typ, asoc)]


def _boxhdr_char(data, at, maxsize):
    if maxsize < 8:
        raise J2kError("Cannot handle box of less than 8 bytes")
    length, typ = struct.unpack_from(">I4s", data, at)
    n = 8
    if length == 1:
        if maxsize < 16:
            raise J2kError("Cannot handle XL box of less than 16 bytes")
        hi, length = struct.unpack_from(">II", data, at + 8)
        n = 16
        if hi != 0:
            raise J2kError("Cannot handle box sizes higher than 2^32")
        if length == 0:
            raise J2kError("Cannot handle box of undefined sizes")
    elif length == 0:
        raise J2kError("Cannot handle box of undefined sizes")
    if length < n:
        raise J2kError("Box length is inconsistent.")
    return length, typ, n


def _read_jp2h(b: Jp2Boxes, data: bytes):
    at, has_ihdr = 0, False
    while at < len(data):
        length, typ, n = _boxhdr_char(data, at, len(data) - at)
        if length > len(data) - at:
            raise J2kError("Stream error while reading JP2 Header box: box "
                           "length is inconsistent.")
        body = data[at + n:at + length]
        if typ == b"ihdr":
            _ihdr(b, body)
            has_ihdr = True
        elif typ == b"colr":
            _colr(b, body)
        elif typ == b"bpcc":
            if len(body) != b.numcomps:
                raise J2kError("Bad BPCC header box (bad size)")
        elif typ == b"pclr":
            _pclr(b, body)
        elif typ == b"cmap":
            _cmap(b, body)
        elif typ == b"cdef":
            _cdef(b, body)
        at += length
    if not has_ihdr:
        raise J2kError("Stream error while reading JP2 Header box: no "
                       "'ihdr' box.")


def _ihdr(b, body):
    if b.numcomps:
        return                       # "Ignoring ihdr box"
    if len(body) != 14:
        raise J2kError("Bad image header box (bad size)")
    b.h, b.w, b.numcomps, b.bpc = struct.unpack_from(">IIHB", body)
    if b.h < 1 or b.w < 1 or b.numcomps < 1 or b.numcomps > 16384:
        raise J2kError("Wrong values in ihdr")


def _colr(b, body):
    if b.meth:
        return                       # only the first colr counts
    if len(body) < 3:
        raise J2kError("Bad COLR header box (bad size)")
    meth = body[0]
    if meth == 1:
        if len(body) < 7:
            raise J2kError("Bad COLR header box (bad size)")
        # CIELab (14) and the other spaces no decoder converts leave the
        # image's colour space unset, as an ICC profile does
        b.enumcs = struct.unpack_from(">I", body, 3)[0]
        b.meth = 1
    elif meth == 2:
        b.meth = 2


def _pclr(b, body):
    if b.pclr is not None or len(body) < 3:
        raise J2kError("Bad pclr box")
    ne, nc = struct.unpack_from(">HB", body)
    if ne == 0 or ne > 1024 or nc == 0:
        raise J2kError("Invalid PCLR box")
    if len(body) < 3 + nc:
        raise J2kError("Bad pclr box")
    sizes = [(v & 0x7F) + 1 for v in body[3:3 + nc]]
    signs = [v >> 7 for v in body[3:3 + nc]]
    at, entries = 3 + nc, []
    for _ in range(ne):
        row = []
        for i in range(nc):
            n = min((sizes[i] + 7) >> 3, 4)
            if len(body) < at + n:
                raise J2kError("Bad pclr box")
            row.append(int.from_bytes(body[at:at + n], "big"))
            at += n
        entries.append(row)
    b.pclr = (entries, sizes, signs)


def _cmap(b, body):
    if b.pclr is None:
        raise J2kError("Need to read a PCLR box before the CMAP box.")
    if b.cmap is not None:
        raise J2kError("Only one CMAP box is allowed.")
    nc = len(b.pclr[1])
    if len(body) < 4 * nc:
        raise J2kError("Insufficient data for CMAP box.")
    b.cmap = [struct.unpack_from(">HBB", body, 4 * i) for i in range(nc)]


def _cdef(b, body):
    if b.cdef is not None:
        raise J2kError("only one cdef")
    if len(body) < 2:
        raise J2kError("Insufficient data for CDEF box.")
    n = struct.unpack_from(">H", body)[0]
    if n == 0:
        raise J2kError("Number of channel description is equal to zero in "
                       "CDEF box.")
    if len(body) < 2 + 6 * n:
        raise J2kError("Insufficient data for CDEF box.")
    b.cdef = [list(struct.unpack_from(">HHH", body, 2 + 6 * i))
              for i in range(n)]


def opj_boxes(buf: bytes) -> Jp2Boxes:
    """opj_jp2_read_header's box walk up to the codestream box."""
    pos, state = 0, set()
    b = None
    while True:
        if len(buf) - pos < 8:
            break
        length, typ = struct.unpack_from(">I4s", buf, pos)
        n = 8
        if length == 0:
            length = len(buf) - pos
        elif length == 1:
            if len(buf) - pos < 16:
                break
            hi, length = struct.unpack_from(">II", buf, pos + 8)
            n = 16
            if hi:
                raise J2kError("Cannot handle box sizes higher than 2^32")
        if typ == b"jp2c":
            if "header" not in state:
                raise J2kError("bad placed jpeg codestream")
            b.codestream = pos + n
            return b
        if length < n:
            raise J2kError("invalid box size")
        size = length - n
        body_at = pos + n
        known = typ in (b"jP  ", b"ftyp", b"jp2h")
        misplaced = typ in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap",
                            b"cdef")
        if known or misplaced:
            if not known and "header" not in state:
                pos = body_at + size
                if pos > len(buf):
                    raise J2kError("Problem with skipping JPEG2000 box")
                continue
            if size > len(buf) - body_at:
                raise J2kError("Invalid box size")
            body = buf[body_at:body_at + size]
            if typ == b"jP  ":
                if state:
                    raise J2kError("The signature box must be the first box "
                                   "in the file.")
                if size != 4 or body != b"\r\n\x87\n":
                    raise J2kError("Error with JP Signature")
                state.add("signature")
                b = Jp2Boxes(0)
            elif typ == b"ftyp":
                if state != {"signature"}:
                    raise J2kError("The ftyp box must be the second box in "
                                   "the file.")
                if size < 8 or (size - 8) % 4:
                    raise J2kError("Error with FTYP signature Box size")
                state.add("ftyp")
            elif typ == b"jp2h":
                if "ftyp" not in state:
                    raise J2kError("The  box must be the first box in the "
                                   "file.")
                _read_jp2h(b, body)
                state.add("header")
            else:
                sub = {b"ihdr": _ihdr, b"colr": _colr, b"pclr": _pclr,
                       b"cmap": _cmap, b"cdef": _cdef}.get(typ)
                if sub is not None:
                    sub(b, body)
        else:
            if "signature" not in state:
                raise J2kError("Malformed JP2 file format: first box must "
                               "be JPEG 2000 signature box")
            if "ftyp" not in state:
                raise J2kError("Malformed JP2 file format: second box must "
                               "be file type box")
            if body_at + size > len(buf):
                raise J2kError("Problem with skipping JPEG2000 box")
        pos = body_at + size
    if b is None or "header" not in state:
        raise J2kError("JP2H box missing. Required.")
    b.codestream = len(buf)
    return b
