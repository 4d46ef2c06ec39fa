"""JPEG encode: the file ``PIL.Image.save(path)`` writes at its defaults.

The JAX package's ``process_images.py crop`` re-saves a JPEG source with
``im.save(path)``; PIL encodes with libjpeg-turbo at libjpeg's defaults
and quality 75. This module writes the same bytes without PIL:

  markers    SOI; a JFIF APP0 (version 1.01, no density) for grey and
             colour, an Adobe APP14 (transform 0) for CMYK; the source's
             COM comment, which PIL carries from ``im.info``; one DQT per
             table, SOF0, one DHT per table, SOS, EOI (jcmarker.c);
  tables     jcparam.c's quality scaling of the Annex K tables (quality
             75: scale 50, rounded, clamped to 1..255) and the standard
             Huffman tables of K.3;
  layout     grey: one component; colour: YCbCr 2x2, 1x1, 1x1 (4:2:0),
             chroma on table 1; CMYK: four 1x1 components, the samples
             inverted (PIL's "CMYK;I");
  samples    colour conversion, downsampling, the forward DCT,
             quantisation and Huffman coding in csrc/jpeg_encode.cpp
             (built with g++ at first use).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from . import native

SRC = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_encode.cpp"

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Annex K.1, natural order
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMINANCE = np.full(64, 99)
STD_CHROMINANCE[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# T.81 Annex K.3: (bits, values) of the DC and AC luminance and chrominance
DC_LUM = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROM = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUM = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROM = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(SRC, "jpeg_encode")))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.jpeg_rgb_to_ycc.argtypes = [u8p, ctypes.c_int64, u8p, u8p, u8p]
        lib.jpeg_rgb_to_ycc.restype = None
        lib.jpeg_encode_scan.argtypes = [
            ctypes.POINTER(u8p), ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, ctypes.POINTER(ctypes.c_uint16), u8p, u8p, u8p,
            ctypes.c_int64]
        lib.jpeg_encode_scan.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def quality_table(base: np.ndarray, quality: int = 75) -> np.ndarray:
    """jcparam.c jpeg_quality_scaling and jpeg_add_quant_table with
    force_baseline: natural-order uint16 [64]."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)


def _seg(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def _dht(index: int, table) -> bytes:
    bits, vals = table
    return _seg(0xC4, bytes([index]) + bytes(bits) + bytes(vals))


def encode_jpeg(img: np.ndarray, mode: str, comment: bytes | None = None,
                quality: int = 75) -> bytes:
    """The bytes ``PIL.Image.fromarray(img, mode).save(f, "JPEG")`` writes
    (with ``im.info["comment"] = comment``): mode "L" (or "1"), "RGB" or
    "CMYK"; img uint8 [H, W] or [H, W, C] (bool for "1")."""
    img = np.asarray(img)
    if mode == "1":
        img, mode = np.where(img, 255, 0).astype(np.uint8), "L"
    if mode not in ("L", "RGB", "CMYK"):
        raise OSError(f"cannot write mode {mode} as JPEG")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("cannot write empty image as JPEG")
    if w > 65535 or h > 65535:
        raise ValueError("Maximum supported image dimension is 65500 pixels")
    img = np.ascontiguousarray(img, np.uint8)
    lum = quality_table(STD_LUMINANCE, quality)
    chrom = quality_table(STD_CHROMINANCE, quality)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if mode == "L":
        planes = [img]
        ids, hs, vs, tq = [1], [1], [1], [0]
        header = _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif mode == "RGB":
        planes = [np.empty((h, w), np.uint8) for _ in range(3)]
        _lib().jpeg_rgb_to_ycc(img.ctypes.data_as(u8p), h * w,
                               *[p.ctypes.data_as(u8p) for p in planes])
        ids, hs, vs, tq = [1, 2, 3], [2, 1, 1], [2, 1, 1], [0, 1, 1]
        header = _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    else:
        planes = [np.ascontiguousarray(255 - img[..., i]) for i in range(4)]
        ids, hs, vs, tq = [67, 77, 89, 75], [1] * 4, [1] * 4, [0] * 4
        header = _seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    n = len(planes)
    qts = [lum, chrom]
    huff = [(DC_LUM, AC_LUM), (DC_CHROM, AC_CHROM)]
    bits = np.zeros((n, 2, 16), np.uint8)
    vals = np.zeros((n, 2, 256), np.uint8)
    for i in range(n):
        for j, (b, v) in enumerate(huff[tq[i]]):
            bits[i, j] = b
            vals[i, j, :len(v)] = list(v)
    qt = np.stack([qts[t] for t in tq]).astype(np.uint16)
    hs_a, vs_a = np.asarray(hs, np.int32), np.asarray(vs, np.int32)
    cap = 2 * h * w * n + 65536
    out = np.empty(cap, np.uint8)
    pp = (u8p * n)(*[p.ctypes.data_as(u8p) for p in planes])
    size = _lib().jpeg_encode_scan(
        pp, n, w, h, hs_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vs_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        bits.ctypes.data_as(u8p), vals.ctypes.data_as(u8p),
        out.ctypes.data_as(u8p), cap)
    if size < 0:
        raise RuntimeError(f"jpeg_encode_scan failed ({size})")
    data = b"\xff\xd8" + header
    if comment:
        data += _seg(0xFE, bytes(comment))
    for t in sorted(set(tq)):
        data += _seg(0xDB, bytes([t]) + qts[t][ZIGZAG].astype(np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, h, w, n)
    for i in range(n):
        sof += bytes([ids[i], (hs[i] << 4) | vs[i], tq[i]])
    data += _seg(0xC0, sof)
    for t in sorted(set(tq)):
        data += _dht(t, huff[t][0]) + _dht(0x10 | t, huff[t][1])
    sos = bytes([n]) + b"".join(bytes([ids[i], (tq[i] << 4) | tq[i]])
                                for i in range(n)) + b"\x00\x3f\x00"
    data += _seg(0xDA, sos) + out[:size].tobytes() + b"\xff\xd9"
    return data


def write_jpeg(path: str, img: np.ndarray, mode: str = "RGB",
               info: dict | None = None) -> None:
    """``im.save(path)`` for a ".jpg"/".jpeg" path: encode_jpeg with the
    comment PIL carries from ``im.info``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, mode, (info or {}).get("comment")))
