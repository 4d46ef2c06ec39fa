"""ctypes bindings of ``csrc/small_decode.cpp``: the run-length and op-stream
decoders of PIL's small readers (Targa RLE, PCX RLE, SGI RLE, QOI,
libImaging's PackBits for PSD, ICNS's RLE, Sun RLE, XBM's hex, MSP's
RLE, FLI/FLC frames, PhotoCD's base image, IM's n-bit floats) and the
TIFF reader's ThunderScan, built with g++ at first use
(`native.build_library`). Each returns the decoder's line buffers, which
the reader unpacks to PIL's mode, and raises `SmallCodecError` where PIL's
decoder fails ("image file is truncated", "buffer overrun when reading
image file")."""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import native

SRC = Path(__file__).resolve().parents[1] / "csrc" / "small_decode.cpp"
_LIB = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


class SmallCodecError(ValueError):
    pass


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(SRC, "small_decode")))
        i32, i64 = ctypes.c_int, ctypes.c_int64
        lib.tga_rle_decode.argtypes = [_U8P, i64, i32, i64, i64, _U8P]
        lib.pcx_decode.argtypes = [_U8P, i64, i64, i32, i64, i64, _U8P]
        lib.sgi_rle_decode.argtypes = [_U8P, i64, i64, i64, i32, i32, _U8P,
                                       ctypes.POINTER(ctypes.c_int64)]
        lib.qoi_decode.argtypes = [_U8P, i64, i64, i32, _U8P]
        lib.thunder_decode.argtypes = [_U8P, i64, i64, i64, _U8P, _U8P]
        lib.packbits_pil_decode.argtypes = [_U8P, i64, i64, i64, _U8P]
        lib.packbits_pil_decode.restype = i64
        lib.icns_rle_decode.argtypes = [_U8P, i64, i64, i32, _U8P]
        lib.sun_rle_decode.argtypes = [_U8P, i64, i64, i64, _U8P]
        lib.xbm_decode.argtypes = [_U8P, i64, i64, i64, _U8P]
        lib.msp_rle_decode.argtypes = [_U8P, i64, ctypes.POINTER(
            ctypes.c_uint16), i64, i64, _U8P, i64]
        lib.msp_rle_decode.restype = i64
        lib.fli_decode.argtypes = [_U8P, i64, i64, i64, i64, _U8P]
        lib.pcd_decode.argtypes = [_U8P, i64, i64, i64, _U8P]
        lib.bit_decode.argtypes = [_U8P, i64, i32, i64, i64,
                                   ctypes.POINTER(ctypes.c_float)]
        for f in (lib.tga_rle_decode, lib.pcx_decode, lib.sgi_rle_decode,
                  lib.qoi_decode, lib.thunder_decode, lib.icns_rle_decode,
                  lib.sun_rle_decode, lib.xbm_decode, lib.fli_decode,
                  lib.pcd_decode, lib.bit_decode):
            f.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc == 1:
        raise SmallCodecError(f"{what}: image file is truncated")
    if rc < 0:
        raise SmallCodecError(f"{what}: buffer overrun when reading image "
                              f"file")


def _src(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)


def tga_rle(data: bytes, depth: int, linebytes: int, rows: int) -> np.ndarray:
    """TgaRleDecode: [rows, linebytes] uint8 lines in the order decoded;
    `depth` bytes a pixel."""
    out = np.zeros((rows, linebytes), np.uint8)
    src = _src(data)
    _check(_lib().tga_rle_decode(src.ctypes.data_as(_U8P), len(data), depth,
                                 linebytes, rows, out.ctypes.data_as(_U8P)),
           "Targa RLE")
    return out


def pcx(data: bytes, xsize: int, bits: int, linebytes: int,
        rows: int) -> np.ndarray:
    """PcxDecode: [rows, linebytes] uint8 lines as handed to the unpacker
    (`bits` bits a pixel for `xsize` pixels)."""
    out = np.zeros((rows, linebytes), np.uint8)
    src = _src(data)
    _check(_lib().pcx_decode(src.ctypes.data_as(_U8P), len(data), xsize, bits,
                             linebytes, rows, out.ctypes.data_as(_U8P)),
           "PCX RLE")
    return out


def sgi_rle(data: bytes, xsize: int, ysize: int, bands: int,
            bpc: int) -> np.ndarray:
    """SgiRleDecode on the file's bytes past its 512-byte header: [ysize,
    xsize * bands * bpc] uint8 lines in the order decoded; lines after a
    row that stopped the decoder stay 0, as PIL leaves them."""
    out = np.zeros((ysize, xsize * bands * bpc), np.uint8)
    src = _src(data)
    rows = ctypes.c_int64(0)
    _check(_lib().sgi_rle_decode(src.ctypes.data_as(_U8P), len(data), xsize,
                                 ysize, bands, bpc, out.ctypes.data_as(_U8P),
                                 ctypes.byref(rows)), "SGI RLE")
    return out


def qoi(data: bytes, npix: int, bands: int) -> np.ndarray:
    """QoiDecoder: [npix, bands] uint8 pixels."""
    out = np.zeros((npix, bands), np.uint8)
    src = _src(data)
    _check(_lib().qoi_decode(src.ctypes.data_as(_U8P), len(data), npix, bands,
                             out.ctypes.data_as(_U8P)), "QOI")
    return out


def thunder(data: bytes, rows: int, cols: int):
    """A ThunderScan strip of `rows` rows of `cols` 4-bit pixels -> (the
    rows packed two pixels a byte, bool [rows, cols]: the pixels whose byte
    libtiff wrote), or None where libtiff fails the strip."""
    src = np.frombuffer(data, np.uint8)
    rowbytes = (cols + 1) // 2
    out = np.zeros(max(rows * rowbytes, 1), np.uint8)
    wrote = np.zeros(max(rows * rowbytes, 1), np.uint8)
    rc = _lib().thunder_decode(src.ctypes.data_as(_U8P), len(src), rows,
                               cols, out.ctypes.data_as(_U8P),
                               wrote.ctypes.data_as(_U8P))
    if rc < 0:
        return None
    w = wrote[:rows * rowbytes].reshape(rows, rowbytes).astype(bool)
    return out[:rows * rowbytes].tobytes(), np.repeat(w, 2, 1)[:, :cols]


def packbits_pil(data: bytes, rowbytes: int, rows: int) -> np.ndarray:
    """libImaging's PackbitsDecode on the stream `data`: [rows, rowbytes]
    uint8 lines (a run or literal cut at a line's end)."""
    out = np.zeros((rows, rowbytes), np.uint8)
    src = _src(data)
    if _lib().packbits_pil_decode(src.ctypes.data_as(_U8P), len(data),
                                  rowbytes, rows,
                                  out.ctypes.data_as(_U8P)) < 0:
        raise SmallCodecError("PackBits: image file is truncated")
    return out


def icns_rle(data: bytes, count: int, bands: int) -> np.ndarray:
    """IcnsImagePlugin.read_32's RLE: [bands, count] uint8 planes."""
    out = np.zeros((bands, count), np.uint8)
    src = _src(data)
    rc = _lib().icns_rle_decode(src.ctypes.data_as(_U8P), len(data), count,
                                bands, out.ctypes.data_as(_U8P))
    if rc == 1:
        raise SmallCodecError("ICNS RLE: Error reading channel")
    if rc == 2:
        raise SmallCodecError("ICNS RLE: buffer is not large enough")
    return out


def sun_rle(data: bytes, linebytes: int, rows: int) -> np.ndarray:
    """SunRleDecode: [rows, linebytes] uint8 lines in the order decoded."""
    out = np.zeros((rows, linebytes), np.uint8)
    src = _src(data)
    _check(_lib().sun_rle_decode(src.ctypes.data_as(_U8P), len(data),
                                 linebytes, rows, out.ctypes.data_as(_U8P)),
           "Sun RLE")
    return out


def xbm(data: bytes, linebytes: int, rows: int) -> np.ndarray:
    """XbmDecode: [rows, linebytes] uint8 lines (bits LSB first)."""
    out = np.zeros((rows, linebytes), np.uint8)
    src = _src(data)
    _check(_lib().xbm_decode(src.ctypes.data_as(_U8P), len(data), linebytes,
                             rows, out.ctypes.data_as(_U8P)), "XBM")
    return out


def msp_rle(data: bytes, rowlen, stride: int, need: int) -> bytes:
    """MspDecoder's rows after the row map: their bytes concatenated (at
    most `need` of them kept)."""
    lens = np.ascontiguousarray(rowlen, np.uint16)
    out = np.zeros(max(need, 1), np.uint8)
    src = _src(data)
    got = _lib().msp_rle_decode(
        src.ctypes.data_as(_U8P), len(data),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), len(lens),
        stride, out.ctypes.data_as(_U8P), need)
    if got < 0:
        raise SmallCodecError("MSP: Truncated or corrupted MSP file")
    return out[:min(got, need)].tobytes()


def fli(data: bytes, block: int, w: int, h: int,
        img: np.ndarray) -> np.ndarray:
    """One FLI/FLC frame (the file from the frame's offset) decoded over
    `img` ([h, w] uint8, changed in place and returned)."""
    src = _src(data)
    _check(_lib().fli_decode(src.ctypes.data_as(_U8P), len(data), block, w,
                             h, img.ctypes.data_as(_U8P)), "FLI")
    return img


def pcd(data: bytes, w: int, rows: int) -> np.ndarray:
    """PcdDecode with the YCC;P unpacker: [rows, w, 3] uint8 RGB."""
    out = np.zeros((rows, w, 3), np.uint8)
    src = _src(data)
    _check(_lib().pcd_decode(src.ctypes.data_as(_U8P), len(data), w, rows,
                             out.ctypes.data_as(_U8P)), "PCD")
    return out


def bits(data: bytes, nbits: int, w: int, rows: int) -> np.ndarray:
    """BitDecode as IM's F;n tile drives it: float32 [rows, w]."""
    out = np.zeros((rows, w), np.float32)
    src = _src(data)
    rc = _lib().bit_decode(src.ctypes.data_as(_U8P), len(data), nbits, w,
                           rows, out.ctypes.data_as(
                               ctypes.POINTER(ctypes.c_float)))
    if rc < 0:
        raise SmallCodecError("bit decoder: decoder error -8")
    _check(rc, "bit decoder")
    return out
