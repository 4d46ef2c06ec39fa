"""The JPEG 2000 codestream (ISO 15444-1 Annex A) as OpenJPEG 2.5 reads it,
for utils/jpeg2000.py.

`Codestream` reads the main header (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM,
TLM, PLM, CRG, COM; unknown markers are skipped two bytes at a time, as
opj_j2k_read_unk does) and then walks the tile-parts as
opj_j2k_read_tile_header and opj_j2k_decode_tile do: SOT with its tile-part
index checks, the tile-part header (COD, COC, QCD, QCC, RGN, POC, PPT, PLT,
COM), SOD and the data, Psot = 0 for the last tile-part, a stream cut in a
tile-part (refused: OpenJPEG decodes in strict mode), a missing EOC. Each
tile, once its last tile-part is read, goes to `csrc/j2k_decode.cpp`
(tier 2, tier 1, dequantization, the inverse wavelet and colour transform,
the DC level shift), which returns its components' samples.

Where OpenJPEG fails, `J2kError` is raised: Pillow then reports a broken
data stream and cv2.imread returns None. High-throughput (Part-15, HTJ2K)
code-blocks and the Part-2 markers that change how OpenJPEG decodes
(MCC, MCO, CBD: component collections, DC offsets, bit depths) raise
UnreadableImageError "JPEG2000 is not ported for ...": OpenJPEG reads
them, the port does not. An MCT marker is checked and set aside, as
OpenJPEG does while COD allows no custom transform.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import native
from .image import UnreadableImageError

SRC = Path(__file__).resolve().parents[1] / "csrc" / "j2k_decode.cpp"
_LIB = None
MAXRLVLS, MAXBANDS, MAX_POCS = 33, 3 * 33 - 2, 32

# decoder states (opj_j2k_dec_state)
MHSIZ, MH, TPHSOT, TPH, NEOC, EOC = 0x2, 0x4, 0x8, 0x10, 0x40, 0x100
SOC, SIZ, SOT, SOD, EOC_MARK = 0xFF4F, 0xFF51, 0xFF90, 0xFF93, 0xFFD9


class J2kError(ValueError):
    """OpenJPEG refuses the codestream (opj_read_header or a tile)."""


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(
            SRC, "j2k_decode", flags=("-ffp-contract=off",))))
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.j2k_decode_tile.argtypes = [i32p, u8p, i64, u8p, i64,
                                        ctypes.POINTER(i64), i32p, i64, i32p]
        lib.j2k_decode_tile.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@dataclass
class Tccp:
    """A component's coding parameters (opj_tccp_t)."""
    csty: int = 0
    numres: int = 0
    cblkw: int = 0
    cblkh: int = 0
    cblksty: int = 0
    qmfbid: int = 0
    prcw: list = field(default_factory=lambda: [15] * MAXRLVLS)
    prch: list = field(default_factory=lambda: [15] * MAXRLVLS)
    qntsty: int = 0
    numgbits: int = 0
    expn: list = field(default_factory=lambda: [0] * MAXBANDS)
    mant: list = field(default_factory=lambda: [0] * MAXBANDS)
    roishift: int = 0

    def copy(self):
        return Tccp(self.csty, self.numres, self.cblkw, self.cblkh,
                    self.cblksty, self.qmfbid, list(self.prcw),
                    list(self.prch), self.qntsty, self.numgbits,
                    list(self.expn), list(self.mant), self.roishift)


@dataclass
class Tcp:
    """A tile's coding parameters (opj_tcp_t) and its data."""
    tccps: list
    csty: int = 0
    prg: int = 0
    numlayers: int = 0
    mct: int = 0
    cod: bool = False
    pocs: list = None             # POC entries, or None
    ppt: dict = None              # Zppt -> data
    data: bytearray = None        # the tile-parts' bodies, or None
    nb_tile_parts: int = 0
    current_part: int = -1

    def copy(self):
        return Tcp([t.copy() for t in self.tccps], self.csty, self.prg,
                   self.numlayers, self.mct, False,
                   None if self.pocs is None else list(self.pocs))


@dataclass
class Comp:
    prec: int
    sgnd: int
    dx: int
    dy: int


class Region(np.ndarray):
    """A tile-component's decoded samples: an int32 [h, w] array with the
    origin (x0, y0) of its resolution (below the top one where no packet
    of the tile reached the top)."""

    def __new__(cls, arr, x0, y0):
        obj = np.asarray(arr).view(cls)
        obj.x0, obj.y0 = x0, y0
        return obj

    def __array_finalize__(self, obj):
        self.x0 = getattr(obj, "x0", 0)
        self.y0 = getattr(obj, "y0", 0)


def _u(b, at, n):
    return int.from_bytes(b[at:at + n], "big")


class Codestream:
    """A codestream from `pos` in `buf`; the stream runs to the end of
    `buf` (a JP2 file's codestream box is not bounded by its length)."""

    def __init__(self, buf: bytes, pos: int = 0, ihdr_size=None,
                 name: str = "JPEG 2000"):
        self.buf, self.pos, self.name = buf, pos, name
        self.ihdr_size = ihdr_size
        self.comment = None
        self.ppm = None                 # Zppm -> data
        self.ppm_data = None
        self.state = MHSIZ
        self._read_main_header()

    # ------------------------------------------------------------ stream
    def left(self) -> int:
        return max(len(self.buf) - self.pos, 0)

    def _read(self, n: int) -> bytes:
        if self.left() < n:
            raise J2kError(f"{self.name}: Stream too short")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def _marker(self) -> int:
        return _u(self._read(2), 0, 2)

    # ------------------------------------------------------------ main header
    def _read_main_header(self):
        if self.left() < 2 or self._marker() != SOC:
            raise J2kError(f"{self.name}: Expected a SOC marker")
        self.state = MHSIZ
        marker = self._marker()
        seen = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise J2kError(f"{self.name}: A marker ID was expected "
                               f"(0xff--) instead of {marker:08x}")
            handler, states = self._handler(marker)
            if handler is None and states == MH | TPH:       # unknown
                marker = self._skip_unknown()
                if marker == SOT:
                    break
                handler, states = self._handler(marker)
            seen.add(marker)
            if not self.state & states:
                raise J2kError(f"{self.name}: Marker is not compliant with "
                               f"its position")
            size = self._marker()
            if size < 2:
                raise J2kError(f"{self.name}: Invalid marker size")
            seg = self._read(size - 2)
            handler(seg, None)
            marker = self._marker()
        for m, what in ((SIZ, "SIZ"), (0xFF52, "COD"), (0xFF5C, "QCD")):
            if m not in seen:
                raise J2kError(f"{self.name}: required {what} marker not "
                               f"found in main header")
        self._merge_ppm()
        self.state = TPHSOT

    def _skip_unknown(self) -> int:
        """opj_j2k_read_unk: two bytes at a time up to a known marker."""
        while True:
            m = self._marker()
            if m >= 0xFF00:
                handler, states = self._handler(m)
                if not self.state & states:
                    raise J2kError(f"{self.name}: Marker is not compliant "
                                   f"with its position")
                if not (handler is None and states == MH | TPH):
                    return m

    def _handler(self, marker):
        """(handler, states) of OpenJPEG's marker table; unknown markers
        have no handler and the states MH | TPH."""
        table = {
            SOT: (self._sot, MH | TPHSOT),
            0xFF52: (self._cod, MH | TPH), 0xFF53: (self._coc, MH | TPH),
            0xFF5E: (self._rgn, MH | TPH), 0xFF5C: (self._qcd, MH | TPH),
            0xFF5D: (self._qcc, MH | TPH), 0xFF5F: (self._poc, MH | TPH),
            SIZ: (self._siz, MHSIZ), 0xFF55: (self._tlm, MH),
            0xFF57: (self._plm, MH), 0xFF58: (self._plt, TPH),
            0xFF60: (self._ppm_seg, MH), 0xFF61: (self._ppt_seg, TPH),
            0xFF91: (None, 0), 0xFF63: (self._crg, MH),
            0xFF64: (self._com, MH | TPH),
            0xFF74: (self._mct, MH | TPH), 0xFF78: (self._part2, MH),
            0xFF50: (self._cap, MH), 0xFF59: (self._cap, MH),
            0xFF75: (self._part2, MH | TPH), 0xFF77: (self._part2, MH | TPH),
        }
        return table.get(marker, (None, MH | TPH))

    def _not_ported(self, what):
        return UnreadableImageError(f"{self.name}: JPEG2000 is not ported "
                                    f"for {what} (OpenJPEG decodes it)")

    def _cap(self, seg, tcp):
        """CAP and CPF (Part 15): read and not used; the code-blocks say
        whether they are high-throughput ones."""

    def _part2(self, seg, tcp):
        raise self._not_ported("Part-2 multi-component transform markers")

    def _mct(self, seg, tcp):
        """opj_j2k_read_mct: an array kept for an MCC/MCO that would use it
        (COD allows no custom transform, so it never reaches the data)."""
        if len(seg) < 2 or (_u(seg, 0, 2) == 0 and len(seg) <= 6):
            raise self._err("Error reading MCT marker")

    def _err(self, what):
        return J2kError(f"{self.name}: {what}")

    def _siz(self, seg, tcp):
        if len(seg) < 36 or (len(seg) - 36) % 3:
            raise self._err("Error with SIZ marker size")
        (self.rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
         nc) = struct.unpack_from(">HIIIIIIIIH", seg)
        if nc >= 16385:
            raise self._err("Error with SIZ marker: number of component is "
                            "illegal")
        if nc != (len(seg) - 36) // 3:
            raise self._err("Error with SIZ marker: number of component is "
                            "not compatible with the remaining number of "
                            "parameters")
        if x0 >= x1 or y0 >= y1:
            raise self._err("Error with SIZ marker: negative or zero image "
                            "size")
        if tdx == 0 or tdy == 0:
            raise self._err("Error with SIZ marker: invalid tile size")
        tx1 = min(tx0 + tdx, 0xFFFFFFFF)
        ty1 = min(ty0 + tdy, 0xFFFFFFFF)
        if tx0 > x0 or ty0 > y0 or tx1 <= x0 or ty1 <= y0:
            raise self._err("Error with SIZ marker: illegal tile offset")
        if self.ihdr_size is not None and self.ihdr_size != (x1 - x0,
                                                             y1 - y0):
            raise self._err("Error with SIZ marker: IHDR w h vs. SIZ w h")
        comps = []
        for i in range(nc):
            s, dx, dy = seg[36 + 3 * i:39 + 3 * i]
            c = Comp((s & 0x7F) + 1, s >> 7, dx, dy)
            if not (1 <= dx <= 255 and 1 <= dy <= 255):
                raise self._err(f"Invalid values for comp = {i} : dx={dx} "
                                f"dy={dy}")
            if c.prec > 31:
                raise self._err(f"Invalid values for comp = {i} : "
                                f"prec={c.prec}")
            comps.append(c)
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.tx0, self.ty0, self.tdx, self.tdy = tx0, ty0, tdx, tdy
        self.comps = comps
        self.tw = -(-(x1 - tx0) // tdx)
        self.th = -(-(y1 - ty0) // tdy)
        if self.tw == 0 or self.th == 0 or self.tw > 65535 // self.th:
            raise self._err("Invalid number of tiles")
        self.default = Tcp([Tccp() for _ in comps])
        self.state = MH

    def _tcp(self, tcp):
        return self.default if tcp is None else tcp

    def _comp_room(self):
        return 1 if len(self.comps) <= 256 else 2

    def _spcod(self, seg, at, tccp) -> int:
        """opj_j2k_read_SPCod_SPCoc from seg[at:]; returns the bytes
        read."""
        if len(seg) - at < 5:
            raise self._err("Error reading SPCod SPCoc element")
        nres, cbw, cbh, sty, qmf = seg[at:at + 5]
        tccp.numres = nres + 1
        if tccp.numres > MAXRLVLS:
            raise self._err("Invalid value for numresolutions")
        tccp.cblkw, tccp.cblkh = cbw + 2, cbh + 2
        if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
            raise self._err("Error reading SPCod SPCoc element, Invalid "
                            "cblkw/cblkh combination")
        tccp.cblksty = sty
        if sty & 0x80:
            raise self._err("Error reading SPCod SPCoc element. Unsupported "
                            "Mixed HT code-block style found")
        if sty & 0x40:
            raise self._not_ported("high-throughput (HTJ2K) code-blocks")
        tccp.qmfbid = qmf
        if qmf > 1:
            raise self._err("Error reading SPCod SPCoc element, Invalid "
                            "transformation found")
        at += 5
        if tccp.csty & 0x01:
            if len(seg) - at < tccp.numres:
                raise self._err("Error reading SPCod SPCoc element")
            for i in range(tccp.numres):
                v = seg[at + i]
                if i != 0 and ((v & 0xF) == 0 or (v >> 4) == 0):
                    raise self._err("Invalid precinct size")
                tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
            return 5 + tccp.numres
        for i in range(tccp.numres):
            tccp.prcw[i] = tccp.prch[i] = 15
        return 5

    def _cod(self, seg, tcp):
        tcp = self._tcp(tcp)
        if tcp.cod:
            raise self._err("COD marker already read. No more than one COD "
                            "marker per tile.")
        tcp.cod = True
        if len(seg) < 5:
            raise self._err("Error reading COD marker")
        tcp.csty = seg[0]
        if tcp.csty & ~0x07:
            raise self._err("Unknown Scod value in COD marker")
        tcp.prg = seg[1] if seg[1] <= 4 else -1
        tcp.numlayers = _u(seg, 2, 2)
        if tcp.numlayers < 1:
            raise self._err("Invalid number of layers in COD marker")
        tcp.mct = seg[4]
        if tcp.mct > 1:
            raise self._err("Invalid multiple component transformation")
        for t in tcp.tccps:
            t.csty = tcp.csty & 0x01
        n = self._spcod(seg, 5, tcp.tccps[0])
        if 5 + n != len(seg):
            raise self._err("Error reading COD marker")
        t0 = tcp.tccps[0]
        for t in tcp.tccps[1:]:
            t.numres, t.cblkw, t.cblkh = t0.numres, t0.cblkw, t0.cblkh
            t.cblksty, t.qmfbid = t0.cblksty, t0.qmfbid
            t.prcw, t.prch = list(t0.prcw), list(t0.prch)

    def _coc(self, seg, tcp):
        tcp = self._tcp(tcp)
        room = self._comp_room()
        if len(seg) < room + 1:
            raise self._err("Error reading COC marker")
        c = _u(seg, 0, room)
        if c >= len(self.comps):
            raise self._err("Error reading COC marker (bad number of "
                            "components)")
        tcp.tccps[c].csty = seg[room]
        n = self._spcod(seg, room + 1, tcp.tccps[c])
        if room + 1 + n != len(seg):
            raise self._err("Error reading COC marker")

    def _sqcd(self, seg, at, tccp) -> int:
        if len(seg) - at < 1:
            raise self._err("Error reading SQcd or SQcc element")
        v = seg[at]
        tccp.qntsty, tccp.numgbits = v & 0x1F, v >> 5
        rest = len(seg) - at - 1
        if tccp.qntsty == 1:
            nband = 1
        else:
            nband = rest if tccp.qntsty == 0 else rest // 2
        at += 1
        if tccp.qntsty == 0:
            for b in range(nband):
                if b < MAXBANDS:
                    tccp.expn[b], tccp.mant[b] = seg[at + b] >> 3, 0
            used = nband
        else:
            if rest < 2 * nband:
                raise self._err("Error reading SQcd_SQcc element")
            for b in range(nband):
                if b < MAXBANDS:
                    v = _u(seg, at + 2 * b, 2)
                    tccp.expn[b], tccp.mant[b] = v >> 11, v & 0x7FF
            used = 2 * nband
        if tccp.qntsty == 1:
            for b in range(1, MAXBANDS):
                tccp.expn[b] = max(tccp.expn[0] - (b - 1) // 3, 0)
                tccp.mant[b] = tccp.mant[0]
        return 1 + used

    def _qcd(self, seg, tcp):
        tcp = self._tcp(tcp)
        n = self._sqcd(seg, 0, tcp.tccps[0])
        if n != len(seg):
            raise self._err("Error reading QCD marker")
        t0 = tcp.tccps[0]
        for t in tcp.tccps[1:]:
            t.qntsty, t.numgbits = t0.qntsty, t0.numgbits
            t.expn, t.mant = list(t0.expn), list(t0.mant)

    def _qcc(self, seg, tcp):
        tcp = self._tcp(tcp)
        room = self._comp_room()
        if len(seg) < room:
            raise self._err("Error reading QCC marker")
        c = _u(seg, 0, room)
        if c >= len(self.comps):
            raise self._err("Invalid component number in QCC")
        n = self._sqcd(seg, room, tcp.tccps[c])
        if room + n != len(seg):
            raise self._err("Error reading QCC marker")

    def _rgn(self, seg, tcp):
        tcp = self._tcp(tcp)
        room = self._comp_room()
        if len(seg) != 2 + room:
            raise self._err("Error reading RGN marker")
        c = _u(seg, 0, room)
        if c >= len(self.comps):
            raise self._err("bad component number in RGN")
        tcp.tccps[c].roishift = seg[room + 1]

    def _poc(self, seg, tcp):
        tcp = self._tcp(tcp)
        room = self._comp_room()
        chunk = 5 + 2 * room
        n, rem = divmod(len(seg), chunk)
        if n <= 0 or rem:
            raise self._err("Error reading POC marker")
        old = [] if tcp.pocs is None else tcp.pocs
        if len(old) + n >= MAX_POCS:
            raise self._err("Too many POCs")
        new = list(old)
        for i in range(n):
            at = i * chunk
            r0 = seg[at]
            c0 = _u(seg, at + 1, room)
            l1 = _u(seg, at + 1 + room, 2)
            r1 = seg[at + 3 + room]
            c1 = min(_u(seg, at + 4 + room, room), len(self.comps))
            new.append((r0, c0, l1, r1, c1, seg[at + 4 + 2 * room]))
        tcp.pocs = new

    def _tlm(self, seg, tcp):
        if len(seg) < 2:
            raise self._err("Error reading TLM marker")
        st, sp = (seg[1] >> 4) & 3, (seg[1] >> 6) & 1
        if st == 3:
            raise self._err("opj_j2k_read_tlm(): ST = 3 is invalid")
        if (len(seg) - 2) % ((sp + 1) * 2 + st):
            raise self._err("Error reading TLM marker")

    def _plm(self, seg, tcp):
        if len(seg) < 1:
            raise self._err("Error reading PLM marker")

    def _plt(self, seg, tcp):
        if len(seg) < 1:
            raise self._err("Error reading PLT marker")
        plen = 0
        for v in seg[1:]:
            plen |= v & 0x7F
            plen = plen << 7 if v & 0x80 else 0
        if plen:
            raise self._err("Error reading PLT marker")

    def _crg(self, seg, tcp):
        if len(seg) != 4 * len(self.comps):
            raise self._err("Error reading CRG marker")

    def _com(self, seg, tcp):
        if tcp is None and self.comment is None:
            self.comment = bytes(seg)

    def _ppm_seg(self, seg, tcp):
        if len(seg) < 2:
            raise self._err("Error reading PPM marker")
        self.ppm = self.ppm or {}
        if seg[0] in self.ppm:
            raise self._err(f"Zppm {seg[0]} already read")
        self.ppm[seg[0]] = bytes(seg[1:])

    def _ppt_seg(self, seg, tcp):
        if len(seg) < 2:
            raise self._err("Error reading PPT marker")
        if self.ppm is not None:
            raise self._err("Error reading PPT marker: packet header have "
                            "been previously found in the main header (PPM "
                            "marker).")
        tcp.ppt = tcp.ppt if tcp.ppt is not None else {}
        if seg[0] in tcp.ppt:
            raise self._err(f"Zppt {seg[0]} already read")
        tcp.ppt[seg[0]] = bytes(seg[1:])

    def _merge_ppm(self):
        """opj_j2k_merge_ppm: the Ippm bytes of every PPM in Zppm order,
        their Nppm lengths dropped."""
        if self.ppm is None:
            return
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm):
            data = self.ppm[z]
            if remaining >= len(data):
                remaining -= len(data)
                out += data
                continue
            out += data[:remaining]
            data = data[remaining:]
            remaining = 0
            while data:
                if len(data) < 4:
                    raise self._err("Not enough bytes to read Nppm")
                n = _u(data, 0, 4)
                data = data[4:]
                if len(data) >= n:
                    out += data[:n]
                    data = data[n:]
                else:
                    out += data
                    remaining = n - len(data)
                    data = b""
        if remaining:
            raise self._err("Corrupted PPM markers")
        self.ppm_data = bytes(out)

    # ------------------------------------------------------------ tiles
    def _sot(self, seg, tcp):
        if len(seg) != 8:
            raise self._err("Error reading SOT marker")
        tileno, psot, part, nparts = struct.unpack(">HIBB", seg)
        if tileno >= self.tw * self.th:
            raise self._err(f"Invalid tile number {tileno}")
        tcp = self.tcps[tileno]
        self.current = tileno
        if tcp.current_part + 1 != part:
            raise self._err("Invalid tile part index")
        tcp.current_part = part
        if psot != 0 and psot < 14 and psot != 12:
            raise self._err("Psot value is not correct regards to the "
                            "JPEG2000 norm")
        if psot == 0:
            self.last_tile_part = True
        if tcp.nb_tile_parts and part >= tcp.nb_tile_parts:
            self.last_tile_part = True
            raise self._err("In SOT marker, TPSot is not valid")
        if nparts:
            if part >= nparts:
                self.last_tile_part = True
                raise self._err("In SOT marker, TPSot is not valid")
            tcp.nb_tile_parts = nparts
        if tcp.nb_tile_parts and tcp.nb_tile_parts == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_tile_part else psot - 12
        self.state = TPH

    def _read_sod(self):
        tcp = self.tcps[self.current]
        if self.last_tile_part:
            self.sot_length = (self.left() - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        if self.sot_length:
            if self.sot_length > self.left():
                raise self._err("Tile part length size inconsistent with "
                                "stream length")
            if tcp.data is None:
                tcp.data = bytearray()
            got = self.buf[self.pos:self.pos + self.sot_length]
            self.pos += len(got)
            tcp.data += got
            self.state = NEOC if len(got) != self.sot_length else TPHSOT
        else:
            self.state = TPHSOT

    def _read_tile_header(self):
        """opj_j2k_read_tile_header: the next tile to decode, or None."""
        marker = SOT
        if self.state == EOC:
            marker = EOC_MARK
        elif self.state != TPHSOT:
            raise self._err("expected a tile-part")
        while not self.can_decode and marker != EOC_MARK:
            while marker != SOD:
                if self.left() == 0:
                    self.state = NEOC
                    break
                size = self._marker()
                if size < 2:
                    raise self._err("Inconsistent marker size")
                if marker == 0x8080 and self.left() == 0:
                    self.state = NEOC
                    break
                if self.state & TPH and self.sot_length != 0:
                    if self.sot_length < size + 2:
                        raise self._err("Sot length is less than marker "
                                        "size + marker ID")
                    self.sot_length -= size + 2
                handler, states = self._handler(marker)
                if not self.state & states:
                    raise self._err("Marker is not compliant with its "
                                    "position")
                seg = self._read(size - 2)
                if handler is None:
                    raise self._err("Not sure how that happened.")
                handler(seg, None if marker == SOT
                        else self.tcps[self.current])
                marker = self._marker()
            if self.left() == 0 and self.state == NEOC:
                break
            self._read_sod()
            if not self.can_decode:
                marker = self._marker()
        if marker == EOC_MARK and self.state != EOC:
            self.current = 0
            self.state = EOC
        if not self.can_decode:
            t = self.current
            while t < len(self.tcps) and self.tcps[t].data is None:
                t += 1
            if t == len(self.tcps):
                return None
            self.current = t
        return self.current

    def _after_tile(self):
        """The end of opj_j2k_decode_tile: the next marker, SOT or EOC."""
        self.can_decode = False
        if self.left() == 0 and self.state == NEOC:
            return
        if self.state != EOC:
            marker = self._marker()
            if marker == EOC_MARK:
                self.current = 0
                self.state = EOC
            elif marker != SOT:
                if self.left() == 0:
                    self.state = NEOC
                    return
                raise self._err("Stream too short, expected SOT")

    def tile_rect(self, t: int):
        p, q = t % self.tw, t // self.tw
        x0 = max(self.tx0 + p * self.tdx, self.x0)
        y0 = max(self.ty0 + q * self.tdy, self.y0)
        x1 = min(self.tx0 + (p + 1) * self.tdx, self.x1)
        y1 = min(self.ty0 + (q + 1) * self.tdy, self.y1)
        return x0, y0, x1, y1

    def tiles(self):
        """Decode the tiles in OpenJPEG's order: yields (tile index, its
        rectangle on the reference grid, [per component: its `Region`]).
        Raises J2kError where OpenJPEG fails, before or after yielding."""
        self.tcps = [self.default.copy() for _ in range(self.tw * self.th)]
        self.current = 0
        self.can_decode = False
        self.last_tile_part = False
        self.sot_length = 0
        ppm_pos = 0
        while True:
            t = self._read_tile_header()
            if t is None:
                return
            tcp = self.tcps[t]
            hdr = None
            if tcp.ppt is not None:
                hdr = b"".join(tcp.ppt[z] for z in sorted(tcp.ppt))
            if tcp.data is None:
                raise self._err(f"tile {t} has no data")
            if self.ppm_data is not None:
                hdr = self.ppm_data[ppm_pos:]
            rect = self.tile_rect(t)
            comps, used = self._decode_tile(tcp, rect, bytes(tcp.data), hdr)
            if self.ppm_data is not None:
                ppm_pos += used
            tcp.data = None
            self._after_tile()
            yield t, rect, comps

    def _params(self, tcp, rect) -> np.ndarray:
        pocs = tcp.pocs or []
        p = [*rect, len(self.comps), tcp.numlayers, tcp.prg, tcp.csty,
             tcp.mct, 0, len(pocs)]
        for poc in pocs:
            p += list(poc)
        for c, t in zip(self.comps, tcp.tccps):
            p += [c.dx, c.dy, c.prec, c.sgnd, t.numres, t.cblkw, t.cblkh,
                  t.cblksty, t.qmfbid, t.roishift, t.numgbits, t.qntsty]
            p += t.prcw + t.prch + t.expn + t.mant
        return np.asarray(p, np.int64).astype(np.int32)

    def _decode_tile(self, tcp, rect, data, hdr):
        x0, y0, x1, y1 = rect
        params = self._params(tcp, rect)
        params[9] = 1 if hdr is not None else 0
        cap = 0
        for c in self.comps:
            cap += (-(-x1 // c.dx) - -(-x0 // c.dx)) * (
                -(-y1 // c.dy) - -(-y0 // c.dy))
        out = np.zeros(max(cap, 1), np.int32)
        info = np.zeros(5 * len(self.comps), np.int32)
        src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        hb = np.frombuffer(hdr, np.uint8) if hdr else np.zeros(1, np.uint8)
        used = ctypes.c_int64(0)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = _lib().j2k_decode_tile(
            params.ctypes.data_as(i32p), src.ctypes.data_as(u8p), len(data),
            hb.ctypes.data_as(u8p), len(hdr) if hdr else 0,
            ctypes.byref(used), out.ctypes.data_as(i32p), len(out),
            info.ctypes.data_as(i32p))
        if rc:
            raise self._err(f"failed to decode tile ({rc})")
        comps, at = [], 0
        for c in range(len(self.comps)):
            w, h = int(info[5 * c + 1]), int(info[5 * c + 2])
            comps.append(Region(out[at:at + w * h].reshape(h, w),
                                int(info[5 * c + 3]), int(info[5 * c + 4])))
            at += w * h
        return comps, used.value
