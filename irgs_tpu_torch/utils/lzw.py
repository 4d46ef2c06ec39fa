"""ctypes binding of ``csrc/lzw_decode.cpp``, the host decoders that the TIFF
and GIF readers share: TIFF's LZW (codes MSB-first, widened one code early,
as libtiff; old-style streams LSB-first, widened one code late), PackBits, and GIF's LZW (codes LSB-first, as Pillow's
GifDecode.c). The library is built with g++ at first use
(`native.build_library`)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import native

SRC = Path(__file__).resolve().parents[1] / "csrc" / "lzw_decode.cpp"

_LIB = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(SRC, "lzw_decode")))
        i64 = ctypes.c_int64
        for f in (lib.tiff_lzw_decode, lib.tiff_lzw_compat_decode,
                  lib.packbits_decode):
            f.argtypes = [_U8P, i64, _U8P, i64]
            f.restype = i64
        lib.gif_lzw_decode.argtypes = [_U8P, i64, ctypes.c_int, _U8P, i64,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.gif_lzw_decode.restype = i64
        _LIB = lib
    return _LIB


def _strip(fn, data: bytes, need: int) -> bytes | int:
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(need, 1), np.uint8)
    rc = fn(src.ctypes.data_as(_U8P), len(src), out.ctypes.data_as(_U8P),
            need)
    return rc if rc < 0 else out[:need].tobytes()


def tiff_lzw(data: bytes, need: int) -> bytes | int:
    """A TIFF LZW strip or tile -> its first `need` bytes, or the decoder's
    negative code (-3: old-style LZW)."""
    return _strip(_lib().tiff_lzw_decode, data, need)


def tiff_lzw_compat(data: bytes, need: int) -> bytes | int:
    """An old-style (LSB-first) TIFF LZW strip or tile -> its first `need`
    bytes, or the decoder's negative code."""
    return _strip(_lib().tiff_lzw_compat_decode, data, need)


def packbits(data: bytes, need: int) -> bytes | int:
    """A PackBits strip or tile -> its first `need` bytes, or the decoder's
    negative code."""
    return _strip(_lib().packbits_decode, data, need)


def gif_lzw(data: bytes, bits: int, need: int) -> tuple[np.ndarray, int,
                                                         int]:
    """A GIF frame's LZW data (minimum code size `bits`) -> (`need` uint8
    indices, how many were decoded, status: -1 for a broken code)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(need, np.uint8)
    status = ctypes.c_int(0)
    got = _lib().gif_lzw_decode(src.ctypes.data_as(_U8P), len(src), bits,
                                out.ctypes.data_as(_U8P), need,
                                ctypes.byref(status))
    return out, int(got), status.value
