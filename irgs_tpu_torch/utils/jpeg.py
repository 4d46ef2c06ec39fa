"""JPEG decode, bit for bit as PIL gives it.

The JAX package reads JPEG frames with ``PIL.Image.open`` (COLMAP scenes,
irgs_tpu/scene/colmap.py; any other LDR frame, irgs_tpu/scene/datasets.py:
59-60). PIL decodes with libjpeg-turbo at libjpeg's defaults, and this
module follows that library's decoder step by step so that its arrays
equal PIL's:

  markers    SOI, APPn (JFIF, and Adobe APP14's transform flag), DQT (8-
             and 16-bit tables), SOF0/1 (sequential), SOF2 (progressive),
             SOF3 (lossless), SOF9/10 (arithmetic sequential and
             progressive), DHT, DAC, DRI and RSTn, SOS, COM, EOI;
  entropy    Huffman decoding with byte stuffing and restart intervals, the
             progressive scans (DC first and refine, AC first and refine,
             EOB runs), the QM arithmetic decoder with its conditioning
             tables, and lossless differences (csrc/jpeg_decode.cpp, built
             with g++ at first use);
  smoothing  the block smoothing libjpeg-turbo applies to a progressive
             file whose scans leave coefficient bits unsent (jdcoefct.c
             decompress_smooth_data, in jpeg_decode.cpp);
  IDCT       dequantisation and the accurate integer IDCT as
             libjpeg-turbo's SIMD code computes jidctint.c's
             jpeg_idct_islow (13-bit constants, PASS1_BITS 2, the two
             DESCALE roundings; 16-bit lanes that wrap and saturate where
             damaged data overflows them);
  lossless   the predictors 1-7 modulo 2^16, restarted at the first row of
             each iMCU row in which the scan or a restart interval starts
             (jddiffct.c undifferences an iMCU row after decoding it), and
             the point transform (jdpred.c, jdlossls.c); subsampled
             components replicated (lossless output has no fancy
             upsampling);
  upsampling libjpeg-turbo's "fancy" triangle filters (jdsample.c:
             h2v1 and h2v2 with their 1/2 and 8/7 biases, h1v2 with 1 and 2)
             over rows and columns clamped at the component's edge, plain
             replication for chroma 2 samples wide or less and for other
             integer factors (int_upsample);
  colour     the fixed-point YCbCr -> RGB tables of jdcolor.c (ONE_HALF
             rounding, 16 fraction bits); three components are RGB under
             an Adobe transform 0, with ids 'R', 'G', 'B' and no marker,
             or lossless with no marker (jdapimin.c
             default_decompress_parms), else YCbCr; grey stays one
             channel; four
             components are CMYK, or YCCK under an Adobe transform other
             than 0 (ycck_cmyk_convert), and PIL's "CMYK;I" raw mode then
             inverts all four samples.

Streams PIL refuses raise JpegError here too: samples of other than 8 bits,
a frame height given by DNL, hierarchical frames (SOF5-7, SOF13-15),
arithmetic lossless (SOF11), component counts other than 1, 3 and 4,
sampling factors that do not divide the largest (jdsample.c), a lossless
restart interval that is not a whole number of MCU rows (jddiffct.c), a
lossless frame with a colour transform, and an arithmetic-coded scan whose
data runs past the end of one of the 64 KiB reads in which PIL hands the
file to libjpeg-turbo (whose arithmetic decoder cannot suspend there).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from . import native

SRC = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cpp"

# zig-zag position -> natural (row-major) position in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# SOF marker -> (entropy coding, process)
_FRAMES = {0xC0: ("huffman", "sequential"), 0xC1: ("huffman", "sequential"),
           0xC2: ("huffman", "progressive"), 0xC3: ("huffman", "lossless"),
           0xC9: ("arith", "sequential"), 0xCA: ("arith", "progressive")}
# frames libjpeg-turbo does not decode, so PIL cannot read them either
_REFUSED = {
    0xC5: "SOF5 (hierarchical)", 0xC6: "SOF6 (hierarchical progressive)",
    0xC7: "SOF7 (hierarchical lossless)", 0xCB: "SOF11 (arithmetic "
    "lossless)", 0xCD: "SOF13 (arithmetic hierarchical)", 0xCE: "SOF14 "
    "(arithmetic hierarchical progressive)", 0xCF: "SOF15 (arithmetic "
    "hierarchical lossless)",
}
_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
# the other markers libjpeg's read_markers takes (APPn aside): DHT, DAC,
# SOS, DQT, DNL, DRI, COM
_SEGMENTS = {0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE}

_LIB = None


class JpegError(ValueError):
    pass


def _refused(what: str):
    return JpegError(f"JPEG {what}: PIL does not read such a stream either")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(SRC, "jpeg_decode")))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i16pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int16))
        i64, i32, cint = ctypes.c_int64, ctypes.c_int32, ctypes.c_int
        huff = [u8p, i64, i64, cint, i32p, u8p, u8p, i32, i32, i32]
        lib.jpeg_decode_scan.argtypes = huff + [i16pp]
        lib.jpeg_decode_scan_progressive.argtypes = huff + [
            cint, cint, cint, cint, i16pp]
        lib.jpeg_decode_scan_arith.argtypes = [
            u8p, i64, i64, cint, i32p, i32p, i32p, i32p, i32, i32, i32, cint,
            cint, cint, cint, cint, i16pp]
        lib.jpeg_decode_scan_lossless.argtypes = huff + [
            u8p, ctypes.POINTER(i32p)]
        for f in (lib.jpeg_decode_scan, lib.jpeg_decode_scan_progressive,
                  lib.jpeg_decode_scan_arith, lib.jpeg_decode_scan_lossless):
            f.restype = i64
        lib.jpeg_undifference.argtypes = [i32p, i32p, i32, i32, i32, u8p,
                                          cint, cint]
        lib.jpeg_undifference.restype = None
        lib.jpeg_smooth.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            i32, i32, i32, i32, i32, i32, i32p, i32p]
        lib.jpeg_smooth.restype = None
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# --- accurate integer IDCT (jidctint.c) -----------------------------------

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _w16(x):
    """int32 -> its low 16 bits, signed (pmullw, paddw)."""
    return x.astype(np.int16).astype(np.int32)


def _idct_1d(x, shift):
    """One pass of libjpeg-turbo's SIMD jpeg_idct_islow (jidctint-sse2.asm,
    -avx2.asm) over the last axis of `x` (8 int16 values as int32): the
    C version's products (pmaddwd pairs), but the sums in0 + in4,
    in0 - in4, in7 + in3 and in5 + in1 wrap at 16 bits, the others at 32
    (numpy's int32 arithmetic), and the descaled outputs saturate at 16
    bits (packssdw)."""
    c = {k: np.int32(v) for k, v in (
        ("e3a", FIX_0_541196100 + FIX_0_765366865), ("e3b", FIX_0_541196100),
        ("e2b", FIX_0_541196100 - FIX_1_847759065),
        ("z3a", FIX_1_175875602 - FIX_1_961570560), ("z", FIX_1_175875602),
        ("z4b", FIX_1_175875602 - FIX_0_390180644),
        ("t0", FIX_0_298631336 - FIX_0_899976223), ("m", FIX_0_899976223),
        ("t3", FIX_1_501321110 - FIX_0_899976223),
        ("t1", FIX_2_053119869 - FIX_2_562915447), ("n", FIX_2_562915447),
        ("t2", FIX_3_072711026 - FIX_2_562915447))}
    in0, in1, in2, in3, in4, in5, in6, in7 = (x[..., k] for k in range(8))
    tmp3 = in2 * c["e3a"] + in6 * c["e3b"]
    tmp2 = in2 * c["e3b"] + in6 * c["e2b"]
    tmp0 = _w16(in0 + in4) << CONST_BITS
    tmp1 = _w16(in0 - in4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(in7 + in3), _w16(in5 + in1)
    z3, z4 = z3 * c["z3a"] + z4 * c["z"], z3 * c["z"] + z4 * c["z4b"]
    t0 = in7 * c["t0"] - in1 * c["m"] + z3
    t3 = in1 * c["t3"] - in7 * c["m"] + z4
    t1 = in5 * c["t1"] - in3 * c["n"] + z4
    t2 = in3 * c["t2"] - in5 * c["n"] + z3
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)
    out = (out + np.int32(1 << (shift - 1))) >> shift
    return np.clip(out, -32768, 32767)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """int16 [..., 64] coefficients (natural order) and a [64] quantisation
    table -> uint8 [..., 8, 8] samples, as libjpeg-turbo's SIMD
    jpeg_idct_islow computes them (its results equal jidctint.c's, with
    the range-limit table, wherever no sum overflows; PIL runs the SIMD
    code, and on damaged data its 16-bit lanes wrap and saturate): the
    dequantisation keeps 16 bits (pmullw; the table is stored as int16),
    a block whose AC coefficients are all zero takes the DC shortcut
    (dequantised DC << 2, 16 bits), and the output saturates to 0..255."""
    c = coef.astype(np.int32)
    x = _w16(c * _w16(np.asarray(qt).astype(np.int32)))
    x = x.reshape(x.shape[:-1] + (8, 8))
    with np.errstate(over="ignore"):
        # pass 1: columns (the vertical frequencies are the block's rows)
        ws = np.swapaxes(_idct_1d(np.swapaxes(x, -1, -2),
                                  CONST_BITS - PASS1_BITS), -1, -2)
        ac_zero = ~np.any(c.reshape(c.shape[:-1] + (8, 8))[..., 1:, :],
                          (-1, -2))
        dc_only = np.broadcast_to(_w16(x[..., :1, :] << PASS1_BITS),
                                  x.shape)
        ws = np.where(ac_zero[..., None, None], dc_only, ws)
        # pass 2: rows
        out = _idct_1d(ws, CONST_BITS + PASS1_BITS + 3)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


# --- upsampling (jdsample.c) ----------------------------------------------

def _rows_fancy(x):
    """Each row -> two rows, 3/4 nearer + 1/4 further, rows clamped at the
    edges: the vertical half of h2v2/h1v2 (int32 column sums, not yet
    rounded). Returns [2H, W] of 3*near + far."""
    x = x.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0],) + x.shape[1:], np.int32)
    out[0::2] = 3 * x + above
    out[1::2] = 3 * x + below
    return out


def _upsample(plane, dw, dh, hx, vx):
    """One component's samples (uint8 [>= dh, >= dw]) -> the full grid, as
    libjpeg-turbo's upsampler picks its method for the expansion hx x vx."""
    p = plane[:dh, :dw]
    if hx == 1 and vx == 1:
        return p
    if hx == 2 and vx == 1 and dw > 2:       # h2v1_fancy_upsample
        x = p.astype(np.int32)
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if hx == 1 and vx == 2:                   # h1v2_fancy_upsample
        s = _rows_fancy(p)
        s[0::2] += 1
        s[1::2] += 2
        return (s >> 2).astype(np.uint8)
    if hx == 2 and vx == 2 and dw > 2:       # h2v2_fancy_upsample
        s = _rows_fancy(p)
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * s + left + 8) >> 4
        out[:, 1::2] = (3 * s + right + 7) >> 4
        return out.astype(np.uint8)
    # h2v1_upsample, h2v2_upsample, int_upsample: replication
    return np.repeat(np.repeat(p, vx, 0), hx, 1)


# --- colour (jdcolor.c) ---------------------------------------------------

def _ycc_tables():
    one_half = 1 << 15
    fix = lambda v: int(v * 65536 + 0.5)
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """uint8 planes -> uint8 [H, W, 3] (ycc_rgb_convert)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --- stream ---------------------------------------------------------------

def _segment(buf, pos):
    """The payload of the length-prefixed segment whose length is at pos."""
    if pos + 2 > len(buf):
        raise JpegError("truncated segment")
    (n,) = struct.unpack_from(">H", buf, pos)
    if n < 2 or pos + n > len(buf):
        raise JpegError("bad segment length")
    return buf[pos + 2:pos + n], pos + n


class _State:
    """What the markers define, as the decoder reads them."""

    def __init__(self, max_comps=None):
        self.max_comps = max_comps      # None: PIL's 1, 3 or 4
        # libtiff's source manager: the end of the data reads as EOI, and
        # once a one-scan sequential image's scanlines are out, what
        # follows is never checked
        self.tiff = max_comps is not None
        self.qtables = [None] * 4
        self.huff_bits = np.zeros((8, 16), np.uint8)
        self.huff_vals = np.zeros((8, 256), np.uint8)
        self.dc_l = np.zeros(4, np.int32)          # DAC: T.81 defaults
        self.dc_u = np.ones(4, np.int32)
        self.ac_k = np.full(4, 5, np.int32)
        self.restart = 0
        self.frame = None
        self.saw_jfif = self.saw_adobe = False
        self.adobe_transform = None
        self.comment = None


def decode_jpeg_like_pil(buf: bytes):
    """A JPEG stream -> (array, mode, info): ``np.asarray(im)``, ``im.mode``
    ("L", "RGB" or "CMYK") and the ``im.info`` entries the port carries
    (``comment``: the last COM segment before the first scan) of
    ``im = PIL.Image.open(...)``."""
    s = _parse(buf, _State())
    if s.frame is None:
        raise JpegError("no frame")
    info = {} if s.comment is None else {"comment": s.comment}
    return _output(s), _MODES[len(s.frame["comps"])], info


def decode_tiff_jpeg(tables: bytes | None, strip: bytes, to_rgb: bool,
                     keep: dict):
    """One strip or tile of a JPEG-in-TIFF file (compression 7), as
    libtiff's JPEG codec has libjpeg-turbo decode it: the JPEGTables
    stream (tag 347: SOI, tables, EOI) read first, its DQT and DHT kept for
    the strip's own (often abbreviated) stream. The colour space is the
    container's, not the stream's markers': `to_rgb` (photometric YCbCr,
    JPEGCOLORMODE_RGB) converts three YCbCr components to RGB after the
    fancy upsampling, which stops at the strip's edges; otherwise
    (JCS_UNKNOWN) the components pass through unconverted and uninverted,
    any count up to libjpeg's 10. `keep` (a dict, empty at the first
    strip) carries the tables from strip to strip, as libtiff's one
    decompressor keeps those a strip defines for the strips after it.
    -> (uint8 [h, w, components], frame)."""
    s = _State(max_comps=10)
    names = ("qtables", "huff_bits", "huff_vals", "dc_l", "dc_u", "ac_k")
    if keep:
        for k in names:
            setattr(s, k, keep[k].copy() if k != "qtables" else
                    list(keep[k]))
    elif tables:
        _parse(tables, s)
        s.frame, s.comment, s.restart = None, None, 0
    s = _parse(strip, s)
    for k in names:
        keep[k] = getattr(s, k)
    if s.frame is None:
        raise JpegError("no frame")
    planes = _planes(s)
    if to_rgb:
        if len(planes) != 3:
            raise JpegError(f"YCbCr with {len(planes)} components")
        return ycc_to_rgb(*planes), s.frame
    return np.stack(planes, -1), s.frame


def _parse(buf: bytes, s):
    """Read a stream's markers (and decode its scans) into the state
    `s`."""
    if buf[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG stream (no SOI)")
    pos = 2
    while True:
        # next marker, past any fill bytes
        while pos < len(buf) and buf[pos] != 0xFF:
            pos += 1
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1
        if pos >= len(buf):
            if s.tiff:
                break
            raise JpegError("no EOI marker")
        m = buf[pos]
        pos += 1
        if m == 0xD9:                                        # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:                   # RSTn, TEM
            continue
        if m in _REFUSED:
            raise _refused(_REFUSED[m])
        if m not in _FRAMES and m not in _SEGMENTS and not 0xE0 <= m <= 0xEF:
            raise JpegError(f"unsupported marker 0x{m:02x} (libjpeg stops "
                            f"there too)")
        seg, nxt = _segment(buf, pos)
        if m == 0xE0 and seg[:5] == b"JFIF\x00":
            s.saw_jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            s.saw_adobe, s.adobe_transform = True, seg[11]
        elif m == 0xFE and (s.frame is None or not s.frame["scans"]):
            s.comment = bytes(seg)      # PIL keeps the last before the scans
        elif m == 0xDB:                                      # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + n],
                                    ">u2" if pq else np.uint8)
                if tq > 3 or raw.size != 64:
                    raise JpegError("bad DQT segment")
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = raw
                s.qtables[tq] = q
                i += 1 + n
        elif m in _FRAMES:
            s.frame = _new_frame(seg, *_FRAMES[m], s.max_comps)
        elif m == 0xC4:                                      # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = np.frombuffer(seg[i + 1:i + 17], np.uint8)
                n = int(counts.sum())
                if tc > 1 or th > 3 or counts.size != 16 or n > 256 \
                        or i + 17 + n > len(seg):
                    raise JpegError("bad DHT segment")
                t = 4 * tc + th
                s.huff_bits[t] = counts
                s.huff_vals[t] = 0
                s.huff_vals[t, :n] = np.frombuffer(seg[i + 17:i + 17 + n],
                                                   np.uint8)
                i += 17 + n
        elif m == 0xCC:                                      # DAC
            for i in range(0, len(seg) - 1, 2):
                tc, tb, cs = seg[i] >> 4, seg[i] & 15, seg[i + 1]
                if tb > 3:
                    raise JpegError("bad DAC segment")
                if tc:
                    s.ac_k[tb] = cs
                else:
                    s.dc_l[tb], s.dc_u[tb] = cs & 15, cs >> 4
        elif m == 0xDD:                                      # DRI
            if len(seg) != 2:
                raise JpegError("bad DRI length")
            (s.restart,) = struct.unpack_from(">H", seg, 0)
        elif m == 0xDA:                                      # SOS
            if s.frame is None:
                raise JpegError("SOS before SOF")
            if not seg or len(seg) != 2 * seg[0] + 4:
                raise JpegError("bad SOS length")
            nxt = _decode_scan(buf, seg, nxt, s)
            s.frame["scans"] += 1
            if (s.tiff and s.frame["process"] == "sequential"
                    and seg[0] == len(s.frame["comps"])):
                break
        pos = nxt
    return s


def decode_jpeg(buf: bytes) -> np.ndarray:
    """A JPEG stream -> what ``np.asarray(PIL.Image.open(...))`` gives for
    it: uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (CMYK)."""
    return decode_jpeg_like_pil(buf)[0]


def _new_frame(seg, coding, process, max_comps=None):
    if len(seg) < 6:
        raise JpegError("bad SOF length")
    prec, h, w, nf = struct.unpack_from(">BHHB", seg, 0)
    if prec != 8:
        raise _refused(f"with {prec}-bit samples")
    if h == 0:
        raise _refused("with its height given by a DNL marker")
    if (nf not in _MODES) if max_comps is None else not 1 <= nf <= max_comps:
        raise _refused(f"with {nf} components")
    if len(seg) != 6 + 3 * nf:
        raise JpegError("bad SOF length")
    comps = []
    for c in range(nf):
        cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * c)
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    lossless = process == "lossless"
    unit = 1 if lossless else 8
    mcus_x, mcus_y = -(-w // (unit * hmax)), -(-h // (unit * vmax))
    for c in comps:
        if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
            raise JpegError("bad sampling factors")
        if hmax % c["h"] or vmax % c["v"]:
            raise _refused("with fractional sampling factors")
        c["dw"] = -(-w * c["h"] // hmax)          # downsampled width
        c["dh"] = -(-h * c["v"] // vmax)
        c["bw"] = -(-c["dw"] // unit)             # blocks of real samples
        c["bh"] = -(-c["dh"] // unit)
        shape = (mcus_y * c["v"], mcus_x * c["h"])
        if lossless:
            c["diff"] = np.zeros(shape, np.int32)
            c["samples"] = None
        else:
            c["coef"] = np.zeros(shape + (64,), np.int16)
        c["coef_bits"] = np.full(64, -1, np.int32)
        c["qt"] = None
    return dict(w=w, h=h, comps=comps, hmax=hmax, vmax=vmax, mcus_x=mcus_x,
                mcus_y=mcus_y, coding=coding, process=process, scans=0)


_SCAN_ERRORS = {-1: "scan uses an undefined Huffman table",
                -2: "corrupt entropy-coded data",
                -3: "missing restart marker",
                -4: "corrupt arithmetic-coded data",
                -6: "bogus Huffman table definition"}


def _std_huff_tables(s):
    """libjpeg-turbo's std_huff_tables at the Huffman decoder's start: the
    T.81 K.3 tables in DC and AC slots 0 and 1 that no DHT has defined
    (Motion-JPEG frames leave them out)."""
    from .jpeg_encode import AC_CHROM, AC_LUM, DC_CHROM, DC_LUM
    for t, (bits, vals) in ((0, DC_LUM), (1, DC_CHROM), (4, AC_LUM),
                            (5, AC_CHROM)):
        if not s.huff_bits[t].any():
            s.huff_bits[t] = bits
            s.huff_vals[t] = 0
            s.huff_vals[t, :len(vals)] = np.frombuffer(bytes(vals), np.uint8)


def _decode_scan(buf, seg, pos, s):
    frame = s.frame
    if frame["scans"] == 0 and frame["coding"] == "huffman":
        _std_huff_tables(s)
    ns = seg[0]
    by_id = {c["id"]: c for c in frame["comps"]}
    comps, params = [], []
    for i in range(ns):
        cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise JpegError(f"scan names unknown component {cid}")
        c = by_id[cid]
        if c["qt"] is None and frame["process"] != "lossless":
            # latched at the component's first scan
            if s.qtables[c["tq"]] is None:
                raise JpegError(f"quantisation table {c['tq']} undefined")
            c["qt"] = s.qtables[c["tq"]]
        td, ta = tt >> 4, tt & 15
        if td > 3 or ta > 3:
            raise JpegError("bad table selector")
        comps.append(c)
        h, v = (c["h"], c["v"]) if ns > 1 else (1, 1)
        arr = c["diff"] if frame["process"] == "lossless" else c["coef"]
        params += [td, ta, h, v, arr.shape[1], arr.shape[0]]
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if ns > 1:
        mx, my = frame["mcus_x"], frame["mcus_y"]
    else:   # a non-interleaved scan: one block per MCU, real blocks only
        mx, my = comps[0]["bw"], comps[0]["bh"]
    data = np.frombuffer(buf, np.uint8)
    lib = _lib()
    cp = np.asarray(params, np.int32)
    head = (_ptr(data, ctypes.c_uint8), len(buf), pos, ns,
            _ptr(cp, ctypes.c_int32))
    huff = (_ptr(s.huff_bits, ctypes.c_uint8),
            _ptr(s.huff_vals, ctypes.c_uint8), mx, my, s.restart)
    process = frame["process"]
    if process == "lossless":
        return _lossless_scan(lib, head, huff, comps, my, ss, al, frame)
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptrs = (i16p * ns)(*[c["coef"].ctypes.data_as(i16p) for c in comps])
    if process == "sequential":
        ss, se, ah, al = 0, 63, 0, 0
    elif not (ss <= se <= 63 and (ss == 0) == (se == 0) and (ss == 0 or ns == 1)
              and ah <= 13 and al <= 13):
        raise JpegError(f"bad progressive scan {ss}-{se}, {ah}/{al}")
    for c in comps:
        c["coef_bits"][ss:se + 1] = al
    if frame["coding"] == "arith":
        end = lib.jpeg_decode_scan_arith(
            *head, _ptr(s.dc_l, ctypes.c_int32), _ptr(s.dc_u, ctypes.c_int32),
            _ptr(s.ac_k, ctypes.c_int32), mx, my, s.restart,
            int(process == "progressive"), ss, se, ah, al, ptrs)
    elif process == "progressive":
        end = lib.jpeg_decode_scan_progressive(*head, *huff, ss, se, ah, al,
                                               ptrs)
    else:
        end = lib.jpeg_decode_scan(*head, *huff, ptrs)
    if end == -5:
        raise _refused("arithmetic-coded scan whose data runs past one of "
                       "PIL's 64 KiB reads")
    if end < 0:
        raise JpegError(_SCAN_ERRORS[int(end)])
    return int(end)


def _lossless_scan(lib, head, huff, comps, my, predictor, pt, frame):
    if not 1 <= predictor <= 7:
        raise JpegError(f"lossless predictor {predictor}")
    mx = huff[2]
    if huff[4] and huff[4] % mx:
        raise _refused("lossless with a restart interval that is not a "
                       "whole number of MCU rows")
    i32p = ctypes.POINTER(ctypes.c_int32)
    ptrs = (i32p * len(comps))(*[c["diff"].ctypes.data_as(i32p)
                                 for c in comps])
    first = np.zeros(my, np.uint8)
    end = lib.jpeg_decode_scan_lossless(*head, *huff,
                                        _ptr(first, ctypes.c_uint8), ptrs)
    if end < 0:
        raise JpegError(_SCAN_ERRORS[int(end)])
    for c in comps:
        rows, stride = c["diff"].shape
        # an iMCU row is v rows of the component: one MCU row of an
        # interleaved scan, v of a scan of this component alone; its first
        # row restarts the predictor where a restart (or the scan) starts
        # inside it
        v, per = c["v"], (c["v"] if len(comps) == 1 else 1)
        n_imcu = -(-rows // v)
        starts = np.zeros(n_imcu * per, bool)
        starts[:my] = first
        restarts = np.zeros(rows, np.uint8)
        restarts[::v] = starts.reshape(n_imcu, per).any(1)
        out = np.zeros_like(c["diff"])
        lib.jpeg_undifference(_ptr(c["diff"], ctypes.c_int32),
                              _ptr(out, ctypes.c_int32), rows, stride,
                              c["bw"], _ptr(restarts, ctypes.c_uint8),
                              predictor, pt)
        c["samples"] = ((out << pt) & 0xFF).astype(np.uint8)
    return int(end)


def _smoothing_ok(frame):
    """jdcoefct.c smoothing_ok: a progressive frame, every component's
    DC and first nine AC quantisers nonzero and its DC sent, and some of
    the first ten coefficients' bits still unsent."""
    if frame["process"] != "progressive":
        return False
    useful = False
    for c in frame["comps"]:
        if c["qt"] is None or np.any(c["qt"][ZIGZAG[:10]] == 0):
            return False
        if c["coef_bits"][0] < 0:
            return False
        useful |= bool(np.any(c["coef_bits"][1:10] != 0))
    return useful


def _smoothed(c, frame):
    out = np.empty_like(c["coef"])
    bits = np.ascontiguousarray(c["coef_bits"][:10], np.int32)
    q = np.ascontiguousarray(c["qt"][ZIGZAG[:10]], np.int32)
    h, w = c["coef"].shape[:2]
    _lib().jpeg_smooth(_ptr(c["coef"], ctypes.c_int16),
                       _ptr(out, ctypes.c_int16), w, h, c["bw"], c["bh"],
                       c["v"], frame["mcus_y"], _ptr(bits, ctypes.c_int32),
                       _ptr(q, ctypes.c_int32))
    return out


def _planes(s):
    """Each component's samples at full size (uint8 [h, w])."""
    frame = s.frame
    w, h = frame["w"], frame["h"]
    smooth = _smoothing_ok(frame)
    planes = []
    for c in frame["comps"]:
        hx, vx = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
        if frame["process"] == "lossless":
            if c["samples"] is None:
                raise JpegError(f"component {c['id']} has no scan")
            # jdsample.c: no fancy upsampling of 1 x 1 data units
            p = c["samples"][:c["dh"], :c["dw"]]
            planes.append(np.repeat(np.repeat(p, vx, 0), hx, 1)[:h, :w])
            continue
        if c["qt"] is None:
            raise JpegError(f"component {c['id']} has no scan")
        coef = _smoothed(c, frame) if smooth else c["coef"]
        blocks = idct_islow(coef, c["qt"])               # [by, bx, 8, 8]
        by, bx = blocks.shape[:2]
        plane = blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        planes.append(_upsample(plane, c["dw"], c["dh"], hx, vx)[:h, :w])
    return planes


def _output(s):
    frame = s.frame
    planes = _planes(s)
    if len(planes) == 1:
        return planes[0]
    lossless = frame["process"] == "lossless"
    if len(planes) == 4:
        if lossless and s.saw_adobe and s.adobe_transform != 0:
            raise _refused("lossless with a YCCK colour transform")
        # jdapimin.c default_decompress_parms: Adobe transform 0 (or no
        # Adobe marker) is CMYK, any other YCCK; PIL's "CMYK;I" inverts
        if s.saw_adobe and s.adobe_transform != 0:
            rgb = ycc_to_rgb(*planes[:3])
            return np.concatenate([rgb, 255 - planes[3][..., None]], -1)
        return 255 - np.stack(planes, -1)
    # the colour space of 3 components (default_decompress_parms): with no
    # marker, lossless is RGB whatever the ids
    ids = tuple(c["id"] for c in frame["comps"])
    if s.saw_jfif:
        rgb = False
    elif s.saw_adobe:
        rgb = s.adobe_transform == 0
    else:
        rgb = lossless or ids == (82, 71, 66)      # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, -1)
    if lossless:    # libjpeg-turbo converts no colour in lossless mode
        raise _refused("lossless with a YCbCr colour transform")
    return ycc_to_rgb(*planes)


def read_jpeg_like_pil(path: str):
    """(array, mode, info) of a JPEG file, as decode_jpeg_like_pil."""
    with open(path, "rb") as f:
        return decode_jpeg_like_pil(f.read())


def read_jpeg(path: str) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path))`` of a JPEG file: uint8 [H, W]
    for grey, [H, W, 3] for colour, [H, W, 4] for CMYK."""
    return read_jpeg_like_pil(path)[0]

