"""Self-contained OpenEXR scanline codec, numpy + zlib (≙ irgs_tpu/utils/exr.py,
a copy: the port imports nothing of the JAX package).

The reference loads GT HDR envmaps with pyexr/imageio/cv2 (e.g.
eval_relighting_syn4.py reads `assets/env_map/envmap*.exr`) and writes the
envmap sidecar `point_cloud1.exr`. None of those EXR backends exist in this
image, so we implement the format directly:

  read : single-part scanline images, compression NONE / RLE / ZIPS / ZIP /
         PIZ, pixel types HALF / FLOAT / UINT.
  write: FLOAT scanline with ZIP compression.

Format per the OpenEXR spec (openexr.com/en/latest/OpenEXRFileLayout.html);
the PIZ wavelet+Huffman scheme follows the published algorithm
(ImfPizCompressor / ImfHuf / ImfWav in the OpenEXR SDK).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76

# pixel type enum
_UINT, _HALF, _FLOAT = 0, 1, 2
_DTYPES = {_UINT: np.dtype("<u4"), _HALF: np.dtype("<f2"), _FLOAT: np.dtype("<f4")}

# compression enum -> scanlines per chunk (NONE, RLE, ZIPS, ZIP, PIZ)
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}


class ExrError(ValueError):
    pass


# ---------------------------------------------------------------------------
# header parsing


def _read_cstr(buf: bytes, pos: int):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes):
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ExrError("not an EXR file")
    if version & 0x200:
        raise ExrError("tiled EXR not supported")
    if version & 0x1800:
        raise ExrError("deep/multipart EXR not supported")
    pos = 8
    attrs = {}
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            break
        atype, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (atype, buf[pos : pos + size])
        pos += size
    return attrs, pos


def _parse_chlist(raw: bytes):
    chans, pos = [], 0
    while raw[pos] != 0:
        name, pos = _read_cstr(raw, pos)
        ptype, _plin, xs, ys = struct.unpack_from("<iB3xii", raw, pos)
        if xs != 1 or ys != 1:
            raise ExrError("subsampled channels not supported")
        chans.append((name, ptype))
        pos += 16
    return chans


# ---------------------------------------------------------------------------
# ZIP / RLE predictor + interleave (shared by ZIP, ZIPS)


def _predictor_undo(data: np.ndarray) -> np.ndarray:
    # running delta decode: t[i] += t[i-1] - 128 (mod 256)
    x = data.astype(np.int64)
    x[1:] -= 128
    return (np.cumsum(x) & 0xFF).astype(np.uint8)


def _deinterleave(data: np.ndarray) -> np.ndarray:
    n = data.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def _interleave(data: np.ndarray) -> np.ndarray:
    n = data.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = data[0::2]
    out[half:] = data[1::2]
    return out


def _predictor_apply(data: np.ndarray) -> np.ndarray:
    d = data.astype(np.int64)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = (d[1:] - d[:-1] + 128) & 0xFF
    return out.astype(np.uint8)


def _unzip(raw: bytes, expected: int) -> np.ndarray:
    if len(raw) == expected:  # stored uncompressed (compressed would be bigger)
        return np.frombuffer(raw, np.uint8)
    data = np.frombuffer(zlib.decompress(raw), np.uint8)
    return _deinterleave(_predictor_undo(data))


def _unrle(raw: bytes, expected: int) -> np.ndarray:
    if len(raw) == expected:
        return np.frombuffer(raw, np.uint8)
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        count = struct.unpack_from("<b", raw, i)[0]
        if count < 0:
            out += raw[i + 1 : i + 1 - count]
            i += 1 - count
        else:
            out += raw[i + 1 : i + 2] * (count + 1)
            i += 2
    return _deinterleave(_predictor_undo(np.frombuffer(bytes(out), np.uint8)))


# ---------------------------------------------------------------------------
# PIZ: bitmap LUT + Huffman + 2D wavelet over uint16 planes

_USHORT_RANGE = 1 << 16
_HUF_ENCSIZE = _USHORT_RANGE + 1
_HUF_DECBITS = 14
_HUF_DECMASK = (1 << _HUF_DECBITS) - 1
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN


class _BitReader:
    __slots__ = ("buf", "pos", "c", "lc")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, nbits: int) -> int:
        while self.lc < nbits:
            self.c = (self.c << 8) | self.buf[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        return (self.c >> self.lc) & ((1 << nbits) - 1)


def _huf_unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = br.get(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    return lengths


def _huf_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """lengths[i] -> canonical code value (code only, shifted per ImfHuf)."""
    n = np.bincount(lengths, minlength=59).astype(np.int64)
    c = 0
    first = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        first[i] = c
        c = nc
    codes = np.zeros_like(lengths)
    counters = first.copy()
    nz = np.nonzero(lengths)[0]
    for i in nz:
        l = lengths[i]
        codes[i] = counters[l]
        counters[l] += 1
    return codes


def _huf_decode(raw: bytes, im: int, iM: int, nbits: int, nout: int) -> np.ndarray:
    br = _BitReader(raw)
    lengths = _huf_unpack_enc_table(br, im, iM)
    codes = _huf_canonical_codes(lengths)

    # short-code table: index by next HUF_DECBITS bits
    short_lit = np.zeros(1 << _HUF_DECBITS, np.int64)
    short_len = np.zeros(1 << _HUF_DECBITS, np.int64)
    long_codes = {}  # (len, code) -> symbol
    nz = np.nonzero(lengths)[0]
    for sym in nz:
        l = int(lengths[sym])
        code = int(codes[sym])
        if l <= _HUF_DECBITS:
            base = code << (_HUF_DECBITS - l)
            cnt = 1 << (_HUF_DECBITS - l)
            short_lit[base : base + cnt] = sym
            short_len[base : base + cnt] = l
        else:
            long_codes[(l, code)] = sym

    # the packed code table is byte-padded; the code stream starts fresh
    data = raw[br.pos :]
    rlc = iM
    out = np.empty(nout, np.uint16)
    oi = 0
    c = 0
    lc = 0
    pos = 0
    ndata = (nbits + 7) // 8
    maxlen = max((l for (l, _cd) in long_codes), default=0)

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi == 0 or oi + cs > nout:
                raise ExrError("corrupt PIZ data")
            out[oi : oi + cs] = out[oi - 1]
            oi += cs
        else:
            out[oi] = sym
            oi += 1

    while pos < ndata:
        c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
        pos += 1
        lc += 8
        while lc >= _HUF_DECBITS:
            idx = (c >> (lc - _HUF_DECBITS)) & _HUF_DECMASK
            l = int(short_len[idx])
            if l:
                lc -= l
                emit(int(short_lit[idx]))
            else:
                # long code: extend bits until one matches
                found = False
                for ll in range(_HUF_DECBITS + 1, maxlen + 1):
                    while lc < ll and pos < ndata:
                        c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
                        pos += 1
                        lc += 8
                    if lc < ll:
                        break
                    cd = (c >> (lc - ll)) & ((1 << ll) - 1)
                    sym = long_codes.get((ll, cd))
                    if sym is not None:
                        lc -= ll
                        emit(sym)
                        found = True
                        break
                if not found:
                    raise ExrError("corrupt PIZ Huffman stream")
    # flush: consume the leftover bits (input was nbits long)
    i = (8 - nbits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = (c << (_HUF_DECBITS - lc)) & _HUF_DECMASK
        l = int(short_len[idx])
        if l and l <= lc:
            lc -= l
            emit(int(short_lit[idx]))
        else:
            break
    if oi != nout:
        raise ExrError(f"PIZ Huffman produced {oi} of {nout} values")
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16).astype(np.uint16)
    b = (ai - hs).astype(np.int16).astype(np.uint16)
    return a, b


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(a: np.ndarray, mx: int) -> None:
    """In-place 2D wavelet decode of a uint16 [ny, nx] plane (ImfWav.cpp)."""
    ny, nx = a.shape
    w14 = mx < (1 << 14)
    dec = _wdec14 if w14 else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            g = a[np.ix_(ys, xs)]
            g01 = a[np.ix_(ys, xs + p)]
            g10 = a[np.ix_(ys + p, xs)]
            g11 = a[np.ix_(ys + p, xs + p)]
            i00, i10 = dec(g, g10)
            i01, i11 = dec(g01, g11)
            o00, o01 = dec(i00, i01)
            o10, o11 = dec(i10, i11)
            a[np.ix_(ys, xs)] = o00
            a[np.ix_(ys, xs + p)] = o01
            a[np.ix_(ys + p, xs)] = o10
            a[np.ix_(ys + p, xs + p)] = o11
        if nx & p:  # odd trailing column
            x = xs[-1] + p2 if len(xs) else 0
            if len(ys):
                i00, b = dec(a[ys, x], a[ys + p, x])
                a[ys, x] = i00
                a[ys + p, x] = b
        if ny & p:  # odd trailing row
            y = ys[-1] + p2 if len(ys) else 0
            if len(xs):
                i00, b = dec(a[y, xs], a[y, xs + p])
                a[y, xs] = i00
                a[y, xs + p] = b
        p2 = p
        p >>= 1


def _unpiz(raw: bytes, chans, width: int, nlines: int) -> np.ndarray:
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", raw, pos)
    pos += 4
    bitmap = np.zeros(_USHORT_RANGE // 8, np.uint8)
    if min_nz <= max_nz:
        nbytes = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(raw, np.uint8, nbytes, pos)
        pos += nbytes
    # reverse LUT from bitmap
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.nonzero(bits)[0].astype(np.uint16)
    max_value = len(lut) - 1

    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    sizes = [2 if t == _HALF else 4 for (_n, t) in chans]  # bytes per sample
    nshorts = sum(width * nlines * (s // 2) for s in sizes)
    hdr = raw[pos : pos + 20]
    im, iM, _tl, nbits = struct.unpack_from("<iiii", hdr, 0)
    decoded = _huf_decode(raw[pos + 20 : pos + length], im, iM, nbits, nshorts)

    # per-channel planar wavelet decode
    out = np.empty(nshorts, np.uint16)
    start = 0
    planes = []
    for (_nm, t), s in zip(chans, sizes):
        cs = s // 2
        cnt = width * nlines * cs
        plane = decoded[start : start + cnt].copy().reshape(nlines, width * cs)
        _wav2_decode(plane, max_value)
        planes.append(plane)
        start += cnt
    # apply LUT then interleave scanlines: per line, per channel
    oi = 0
    for y in range(nlines):
        for plane in planes:
            row = lut[plane[y]]
            out[oi : oi + row.shape[0]] = row
            oi += row.shape[0]
    return out.view(np.uint8)


# ---------------------------------------------------------------------------
# public API


def read_exr(path: str) -> dict:
    """Read a scanline EXR. Returns {'channels': {name: [H,W] float32/uint32},
    'height': H, 'width': W}."""
    with open(path, "rb") as f:
        buf = f.read()
    attrs, pos = _parse_header(buf)
    chans = _parse_chlist(attrs["channels"][1])  # stored sorted by name
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    if comp not in _LINES_PER_BLOCK:
        raise ExrError(f"unsupported compression {comp}")
    lpb = _LINES_PER_BLOCK[comp]
    nblocks = (height + lpb - 1) // lpb
    # line order: increasing (0) assumed for offset-table order; we use offsets
    offsets = struct.unpack_from(f"<{nblocks}q", buf, pos)

    sizes = [2 if t == _HALF else 4 for (_n, t) in chans]
    bytes_per_line = width * sum(sizes)
    planes = {
        name: np.empty((height, width), _DTYPES[t]) for (name, t) in chans
    }
    for off in offsets:
        y, packed = struct.unpack_from("<ii", buf, off)
        y -= y0
        nlines = min(lpb, height - y)
        raw = buf[off + 8 : off + 8 + packed]
        expected = bytes_per_line * nlines
        if comp in (0,):
            data = np.frombuffer(raw, np.uint8)
        elif comp == 1:
            data = _unrle(raw, expected)
        elif comp in (2, 3):
            data = _unzip(raw, expected)
        else:  # PIZ
            data = _unpiz(raw, chans, width, nlines)
        # unpack: per scanline, channels in chlist order, planar per line
        o = 0
        for line in range(nlines):
            for (name, t), s in zip(chans, sizes):
                row = data[o : o + width * s]
                planes[name][y + line] = row.view(_DTYPES[t])
                o += width * s
    out = {}
    for (name, t) in chans:
        p = planes[name]
        out[name] = p.astype(np.uint32) if t == _UINT else p.astype(np.float32)
    return {"channels": out, "height": height, "width": width}


def read_exr_rgb(path: str) -> np.ndarray:
    """Read an EXR as [H, W, 3] float32 RGB (the shape the relight eval
    loaders expect, ≙ reference pyexr.read in eval_relighting_syn4.py)."""
    img = read_exr(path)
    ch = img["channels"]
    if all(k in ch for k in "RGB"):
        return np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)
    if "Y" in ch:
        return np.repeat(ch["Y"][..., None], 3, axis=-1)
    names = sorted(ch)
    return np.stack([ch[n] for n in names[:3]], axis=-1)


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] float32 as a ZIP-compressed FLOAT scanline EXR
    (≙ reference pyexr.write of the point_cloud1.exr envmap sidecar)."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    parts = [struct.pack("<ii", _MAGIC, 2)]

    def attr(name, atype, payload):
        parts.append(name.encode() + b"\x00" + atype.encode() + b"\x00")
        parts.append(struct.pack("<i", len(payload)) + payload)

    chl = b""
    for name in ("B", "G", "R"):  # chlist must be alphabetical
        chl += name.encode() + b"\x00" + struct.pack("<iBxxxii", _FLOAT, 0, 1, 1)
    chl += b"\x00"
    attr("channels", "chlist", chl)
    attr("compression", "compression", bytes([3]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", bytes([0]))
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    parts.append(b"\x00")

    header = b"".join(parts)
    nblocks = (h + 15) // 16
    offset_table_size = 8 * nblocks
    blocks = []
    for b0 in range(0, h, 16):
        nlines = min(16, h - b0)
        scan = []
        for line in range(nlines):
            for cname in ("B", "G", "R"):
                ci = "RGB".index(cname)
                scan.append(rgb[b0 + line, :, ci].astype("<f4").tobytes())
        rawb = np.frombuffer(b"".join(scan), np.uint8)
        packed = zlib.compress(bytes(_predictor_apply(_interleave(rawb))))
        if len(packed) >= rawb.shape[0]:
            packed = rawb.tobytes()
        blocks.append((b0, packed))
    with open(path, "wb") as f:
        f.write(header)
        off = len(header) + offset_table_size
        for b0, packed in blocks:
            f.write(struct.pack("<q", off))
            off += 8 + len(packed)
        for b0, packed in blocks:
            f.write(struct.pack("<ii", b0, len(packed)))
            f.write(packed)
