"""Test-side JPEG writers for the streams PIL cannot write: arithmetic
coding, sequential (SOF9) and progressive (SOF10) with DAC conditioning,
after libjpeg's jcarith.c (ITU-T T.81 Annex D, F.1.4.4, G.1.3), and
lossless Huffman (SOF3, T.81 Annex H) with predictors 1-7, a point
transform and restart intervals.

The arithmetic writer re-encodes the quantised coefficients of a baseline
file PIL wrote (`read_baseline`, a plain reader of its Huffman data); the
lossless writer encodes the samples of an array. PIL decodes the file
written, and its array is the oracle. Used by tests/make_jpeg_fixtures.py
and the JPEG tests; pure Python, so the images stay small.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _seg(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


JFIF = _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return _seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def dqt(tables) -> bytes:
    out = b""
    for i, q in enumerate(tables):
        q = np.asarray(q).reshape(64)
        out += _seg(0xDB, bytes([i]) + bytes(int(v) for v in q[ZIGZAG]))
    return out


def sof(marker: int, w: int, h: int, comps, precision: int = 8) -> bytes:
    """comps: (id, h, v, tq) per component."""
    p = struct.pack(">BHHB", precision, h, w, len(comps))
    for cid, hs, vs, tq in comps:
        p += bytes([cid, (hs << 4) | vs, tq])
    return _seg(marker, p)


# --- arithmetic encoder (jcarith.c) ---------------------------------------

def _aritab():
    rows = [
        (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
        (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
        (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
        (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
        (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
        (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
        (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
        (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
        (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
        (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
        (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
        (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
        (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
        (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
        (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
        (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
        (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
        (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
        (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
        (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
        (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
        (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
        (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
        (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
        (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
        (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
        (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
        (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
        (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
        (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
        (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
        (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
        (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
        (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
        (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
        (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
        (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
        (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
    return [(qe << 16) | (nm << 8) | (sw << 7) | nl for qe, nl, nm, sw in rows]


ARITAB = _aritab()


class ArithEncoder:
    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        data = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return data


class _ArithScan:
    def __init__(self, dc_l, dc_u, ac_k):
        self.enc = ArithEncoder()
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.fixed = [113]
        self.restart_state(1)

    def restart_state(self, n):
        self.dc_stats = [[0] * 64 for _ in range(4)]
        self.ac_stats = [[0] * 256 for _ in range(4)]
        self.last_dc = [0] * n
        self.ctx = [0] * n

    def dc(self, ci, tbl, value):
        enc, stats = self.enc, self.dc_stats[tbl]
        i = self.ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            enc.encode(stats, i, 0)
            self.ctx[ci] = 0
            return
        self.last_dc[ci] = value
        enc.encode(stats, i, 1)
        if v > 0:
            enc.encode(stats, i + 1, 0)
            i += 2
            self.ctx[ci] = 4
        else:
            v = -v
            enc.encode(stats, i + 1, 1)
            i += 3
            self.ctx[ci] = 8
        m = 0
        v -= 1
        if v:
            enc.encode(stats, i, 1)
            m = 1
            v2 = v
            i = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(stats, i, 1)
                m <<= 1
                i += 1
        enc.encode(stats, i, 0)
        if m < ((1 << self.dc_l[tbl]) >> 1):
            self.ctx[ci] = 0
        elif m > ((1 << self.dc_u[tbl]) >> 1):
            self.ctx[ci] += 8
        i += 14
        while m >> 1:
            m >>= 1
            enc.encode(stats, i, 1 if m & v else 0)

    def _ac_value(self, stats, i, k, tbl, v):
        enc = self.enc
        i += 2
        m = 0
        v -= 1
        if v:
            enc.encode(stats, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc.encode(stats, i, 1)
                m <<= 1
                i = 189 if k <= self.ac_k[tbl] else 217
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(stats, i, 1)
                    m <<= 1
                    i += 1
        enc.encode(stats, i, 0)
        i += 14
        while m >> 1:
            m >>= 1
            enc.encode(stats, i, 1 if m & v else 0)

    def ac_first(self, tbl, zz, ss, se, al):
        """zz: the block in zig-zag order (ints)."""
        enc, stats = self.enc, self.ac_stats[tbl]
        sh = [(abs(x) >> al) * (1 if x >= 0 else -1) for x in zz]
        ke = se
        while ke > 0 and sh[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            enc.encode(stats, i, 0)
            while sh[k] == 0:
                enc.encode(stats, i + 1, 0)
                i += 3
                k += 1
            enc.encode(stats, i + 1, 1)
            enc.encode(self.fixed, 0, 0 if sh[k] > 0 else 1)
            self._ac_value(stats, i, k, tbl, abs(sh[k]))
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, tbl, zz, ss, se, ah, al):
        enc, stats = self.enc, self.ac_stats[tbl]
        a = [abs(x) for x in zz]
        ke = se
        while ke > 0 and (a[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (a[kex] >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, i, 0)
            while True:
                v = a[k] >> al
                if v:
                    if v >> 1:
                        enc.encode(stats, i + 2, v & 1)
                    else:
                        enc.encode(stats, i + 1, 1)
                        enc.encode(self.fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                enc.encode(stats, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)


def write_arith(coefs, sampling, qtables, tq, size, *, progressive=False,
                restart=0, dc_l=(0,) * 4, dc_u=(1,) * 4, ac_k=(5,) * 4,
                dac=False, header=JFIF, ids=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9 or, with progressive, SOF10 with a
    spectral-selection and successive-approximation script) of the given
    coefficients (as read_baseline returns them; size = (w, h)); DAC
    written when `dac`."""
    W, H = size
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    n = len(coefs)
    ids = ids or list(range(1, n + 1))
    comps = [(ids[i], sampling[i][0], sampling[i][1], tq[i]) for i in range(n)]
    out = b"\xff\xd8" + header + dqt(qtables)
    out += sof(0xCA if progressive else 0xC9, W, H, comps)
    if dac:
        p = b""
        for t in range(min(n, 2)):
            p += bytes([t, (dc_u[t] << 4) | dc_l[t], 0x10 | t, ac_k[t]])
        out += _seg(0xCC, p)
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    zz = [c[..., ZIGZAG].astype(int) for c in coefs]
    tbl = [min(i, 1) for i in range(n)]
    if progressive:
        script = [(list(range(n)), 0, 0, 0, 1)]
        for ci in range(n):
            script.append(([ci], 1, 5, 0, 2))
        for ci in range(n):
            script.append(([ci], 6, 63, 0, 1))
        script.append((list(range(n)), 0, 0, 1, 0))
        for ci in range(n):
            script.append(([ci], 1, 5, 2, 1))
            script.append(([ci], 1, 63, 1, 0))
    else:
        script = [(list(range(n)), 0, 63, 0, 0)]
    for cis, ss, se, ah, al in script:
        hdr = bytes([len(cis)])
        for ci in cis:
            hdr += bytes([ids[ci], (tbl[ci] << 4) | tbl[ci]])
        hdr += bytes([ss, se, (ah << 4) | al])
        out += _seg(0xDA, hdr)
        sc = _ArithScan(dc_l, dc_u, ac_k)
        sc.restart_state(n)
        if len(cis) > 1:
            units = [(x, y) for y in range(my) for x in range(mx)]
        else:
            ci = cis[0]
            hs, vs = sampling[ci]
            hmax = max(s[0] for s in sampling)
            vmax = max(s[1] for s in sampling)
            bw = -(-(-(-W * hs // hmax)) // 8)
            bh = -(-(-(-H * vs // vmax)) // 8)
            units = [(x, y) for y in range(bh) for x in range(bw)]
        data = b""
        rst = 0
        for u, (x, y) in enumerate(units):
            if restart and u and u % restart == 0:
                data += sc.enc.finish() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                sc.restart_state(n)
            blocks = []
            for ci in cis:
                hs, vs = sampling[ci] if len(cis) > 1 else (1, 1)
                for by in range(vs):
                    for bx in range(hs):
                        blocks.append((ci, zz[ci][y * vs + by, x * hs + bx]))
            for ci, b in blocks:
                slot = cis.index(ci)
                if not progressive:
                    sc.dc(slot, tbl[ci], int(b[0]))
                    sc.ac_first(tbl[ci], [int(v) for v in b], 1, 63, 0)
                elif ss == 0 and ah == 0:
                    sc.dc(slot, tbl[ci], int(b[0]) >> al)
                elif ss == 0:
                    sc.enc.encode(sc.fixed, 0, (int(b[0]) >> al) & 1)
                elif ah == 0:
                    sc.ac_first(tbl[ci], [int(v) for v in b], ss, se, al)
                else:
                    sc.ac_refine(tbl[ci], [int(v) for v in b], ss, se, ah,
                                 al)
        data += sc.enc.finish()
        out += data
    return out + b"\xff\xd9"


# --- lossless Huffman (T.81 H) --------------------------------------------

# 17 difference categories, lengths 2..11 (Kraft sum < 1: no all-ones code)
LOSSLESS_BITS = [0, 3, 0, 2, 2, 2, 2, 2, 2, 1, 1, 0, 0, 0, 0, 0]
LOSSLESS_VALS = list(range(17))


def _codes(bits, vals):
    code, k, out = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        data = bytes(self.out)
        self.out = bytearray()
        return data


def _predict(p, ra, rb, rc):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[p]


def write_lossless(img: np.ndarray, predictor: int, pt: int = 0,
                   restart_rows: int = 0, header=None, ids=None,
                   marker: int = 0xC3, sampling=None,
                   restart: int | None = None,
                   interleaved: bool = True) -> bytes:
    """A lossless Huffman JPEG of uint8 [H, W] or [H, W, C] in one
    interleaved scan (or, `interleaved` False, one scan per component),
    with `restart_rows` MCU rows per restart interval (or an interval of
    `restart` MCUs). `sampling` gives each component's (h, v) (default
    1 x 1); a component at h x v takes every (hmax / h)-th column and
    (vmax / v)-th row of its channel. An interleaved MCU holds h x v
    samples of each component, and samples past a component's width or
    height are sent as zero differences; a scan of one component has one
    sample per MCU. libjpeg's decoder undifferences an iMCU row (one MCU
    row interleaved, v MCU rows of one component) after decoding it, and
    the predictor restarts at its first component row where the scan or a
    restart interval starts inside it: so does this encoder."""
    img = np.asarray(img)
    chans = [img] if img.ndim == 2 else [img[..., i]
                                         for i in range(img.shape[-1])]
    n = len(chans)
    H, W = chans[0].shape
    sampling = sampling or [(1, 1)] * n
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mx, my = -(-W // hmax), -(-H // vmax)
    interval = restart_rows * mx if restart is None else restart
    ids = ids or list(range(1, n + 1))
    header = (adobe(0) if n == 3 else b"") if header is None else header
    codes = _codes(LOSSLESS_BITS, LOSSLESS_VALS)
    out = b"\xff\xd8" + header + sof(marker, W, H, [
        (ids[i], sampling[i][0], sampling[i][1], 0) for i in range(n)])
    out += _seg(0xC4, bytes([0x00]) + bytes(LOSSLESS_BITS)
                + bytes(LOSSLESS_VALS))
    if interval:
        out += _seg(0xDD, struct.pack(">H", interval))
    x = [c[::vmax // v, ::hmax // h].astype(np.int64) >> pt
         for c, (h, v) in zip(chans, sampling)]
    scans = [list(range(n))] if interleaved else [[c] for c in range(n)]
    for comps in scans:
        hdr = bytes([len(comps)]) + b"".join(bytes([ids[i], 0x00])
                                             for i in comps)
        out += _seg(0xDA, hdr + bytes([predictor, 0, pt]))
        out += _lossless_scan(x, sampling, comps, mx if interleaved else None,
                              my, interval, predictor, pt, codes)
    return out + b"\xff\xd9"


def _lossless_scan(x, sampling, comps, mx, my, interval, predictor, pt,
                   codes) -> bytes:
    """The entropy-coded data of one lossless scan of components `comps`
    (interleaved on an mx x my MCU grid; mx None: one component, one sample
    per MCU)."""
    if mx is None:
        (c,) = comps
        units = [(c, 1, 1)]
        my, mx = x[c].shape
        imcu = sampling[c][1]                 # MCU rows per iMCU row
    else:
        units = [(c, *sampling[c]) for c in comps]
        imcu = 1
    starts = {0} | ({u // mx for u in range(0, mx * my, interval)}
                    if interval else set())

    def first_row(r, v):
        """r starts an iMCU row (of v component rows) in which the scan or
        a restart interval starts."""
        k = r // v
        return r % v == 0 and any(q in starts
                                  for q in range(k * imcu, (k + 1) * imcu))

    def diff(s, v, r, col):
        if r >= s.shape[0] or col >= s.shape[1]:
            return 0                                 # past the edge
        if first_row(r, v):
            pred = (1 << (7 - pt)) if col == 0 else s[r, col - 1]
        elif col == 0:
            pred = s[r - 1, 0]
        else:
            pred = _predict(predictor, s[r, col - 1], s[r - 1, col],
                            s[r - 1, col - 1])
        d = int(s[r, col] - pred)
        return ((d + 32768) & 0xFFFF) - 32768

    bw = _BitWriter()
    out = b""
    rst = 0
    for mcu in range(mx * my):
        if interval and mcu and mcu % interval == 0:
            out += bw.flush() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
        ym, xm = divmod(mcu, mx)
        for c, h, v in units:
            vv = sampling[c][1]
            for y in range(v):
                for xx in range(h):
                    d = diff(x[c], vv, ym * v + y, xm * h + xx)
                    cat = 0 if d == 0 else int(abs(d)).bit_length()
                    code, length = codes[cat]
                    bw.put(code, length)
                    if cat and cat < 16:
                        bw.put(d if d > 0 else d + (1 << cat) - 1, cat)
    return out + bw.flush()


# --- coefficients of a baseline PIL file ----------------------------------

def read_baseline(data: bytes):
    """The quantised coefficients of a baseline Huffman JPEG without
    restart intervals (as PIL writes by default): (coefs [by, bx, 64]
    natural order per component, sampling [(h, v)], qtables natural order,
    component tq, (w, h)). A plain T.81 F.2.2 reader for the fixtures."""
    pos, q, huff = 2, {}, {}
    while True:
        m = data[pos + 1]
        (n,) = struct.unpack_from(">H", data, pos + 2)
        seg = data[pos + 4:pos + 2 + n]
        if m == 0xDB:
            i = 0
            while i < len(seg):
                t = np.zeros(64, int)
                t[ZIGZAG] = list(seg[i + 1:i + 65])
                q[seg[i] & 15] = t
                i += 65
        elif m == 0xC0:
            h, w, nf = struct.unpack_from(">HHB", seg, 1)
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                      seg[7 + 3 * c] & 15, seg[8 + 3 * c]) for c in range(nf)]
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                cnt = list(seg[i + 1:i + 17])
                vals = list(seg[i + 17:i + 17 + sum(cnt)])
                huff[seg[i]] = {v: k for k, v in _codes(cnt, vals).items()}
                i += 17 + sum(cnt)
        elif m == 0xDA:
            ns = seg[0]
            sel = [seg[2 + 2 * i] for i in range(ns)]
            pos += 2 + n
            break
        pos += 2 + n
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = [np.zeros((my * c[2], mx * c[1], 64), np.int16) for c in comps]
    bits = np.unpackbits(np.frombuffer(
        data[pos:].replace(b"\xff\x00", b"\xff"), np.uint8))
    p = 0

    def sym(table):
        nonlocal p
        code, length = 0, 0
        while True:
            code = (code << 1) | int(bits[p])
            p += 1
            length += 1
            if (code, length) in table:
                return table[(code, length)]

    def val(s):
        nonlocal p
        v = 0
        for _ in range(s):
            v = (v << 1) | int(bits[p])
            p += 1
        return v if v >= (1 << (s - 1)) else v - (1 << s) + 1

    pred = [0] * len(comps)
    for y in range(my):
        for x in range(mx):
            for ci, (_, hs, vs, _) in enumerate(comps):
                dc, ac = huff[sel[ci] >> 4], huff[0x10 | (sel[ci] & 15)]
                for by in range(vs):
                    for bx in range(hs):
                        blk = coefs[ci][y * vs + by, x * hs + bx]
                        s = sym(dc)
                        pred[ci] += val(s) if s else 0
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = sym(ac)
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                blk[ZIGZAG[k]] = val(s)
                                k += 1
                            elif r == 15:
                                k += 16
                            else:
                                break
    return (coefs, [(c[1], c[2]) for c in comps], [q[i] for i in sorted(q)],
            [c[3] for c in comps], (w, h))
