"""ctypes bindings of the TIFF reader's host decoders for the codecs PIL
reaches through libtiff: ``csrc/ccitt_decode.cpp`` (CCITT modified
Huffman, T.4 and T.6, as tif_fax3.c decodes them), ``csrc/zstd_decode.cpp``
(a Zstandard frame, as libtiff's ZSTDDecode has libzstd decode a strip)
and ``csrc/xz_decode.cpp`` (an .xz stream of LZMA2, as libtiff's
LZMADecode has liblzma decode one). Each library is built with g++ at
first use (`native.build_library`)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import native

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_LIBS = {}
_U8P = ctypes.POINTER(ctypes.c_uint8)
# ccitt_decode's modes
CCITT_RLE, CCITT_G3_1D, CCITT_G3_2D, CCITT_G4, CCITT_RLEW = 0, 1, 2, 3, 4
_ZSTD_ERRORS = {-1: "corrupt data", -2: "a dictionary id (not ported)",
                -3: "a window too large", -4: "not a Zstandard frame"}
_XZ_ERRORS = {-1: "corrupt data", -2: "a filter other than delta and LZMA2 "
              "(not ported)"}


def _lib(stem: str):
    lib = _LIBS.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(native.build_library(CSRC / f"{stem}.cpp",
                                                   stem)))
        i64 = ctypes.c_int64
        if stem == "ccitt_decode":
            lib.ccitt_decode.argtypes = [
                _U8P, i64, ctypes.c_int, i64, i64, _U8P, _U8P,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32)]
            lib.ccitt_decode.restype = ctypes.c_int
            lib.ccitt_runs.argtypes = [i64, ctypes.c_int]
            lib.ccitt_runs.restype = ctypes.c_uint32
        else:
            f = getattr(lib, stem)
            f.argtypes = [_U8P, i64, _U8P, i64]
            f.restype = i64
        _LIBS[stem] = lib
    return lib


def ccitt(data: bytes, mode: int, width: int, rows: int, buf: np.ndarray,
          state: dict) -> tuple[bool, np.ndarray]:
    """Decode a CCITT strip or tile of `rows` rows into `buf` (uint8,
    rows * ceil(width / 8) bytes, holding what the caller's strip buffer
    held before) -> (ok, the rows written). ok is False where libtiff's
    decoder fails. `state` carries what libtiff's decoder keeps from one
    strip to the next (its mode, its run arrays; start with an empty
    dict)."""
    lib = _lib("ccitt_decode")
    src = np.frombuffer(data, np.uint8)
    written = np.zeros(rows, np.uint8)
    if "runs" not in state:
        state["flags"] = np.zeros(2, np.int32)
        state["runs"] = np.zeros(lib.ccitt_runs(width, mode), np.uint32)
    rc = lib.ccitt_decode(
        src.ctypes.data_as(_U8P), len(src), mode, width, rows,
        buf.ctypes.data_as(_U8P), written.ctypes.data_as(_U8P),
        state["flags"].ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        state["runs"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return rc > 0, written.astype(bool)


def _frame(stem: str, errors: dict, what: str, data: bytes,
           need: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(need, 1), np.uint8)
    got = getattr(_lib(stem), stem)(src.ctypes.data_as(_U8P), len(src),
                                    out.ctypes.data_as(_U8P), need)
    if got < 0:
        raise ValueError(f"{what} {errors.get(int(got), got)}")
    if got < need:
        raise ValueError(f"{what} data ends {need - got} bytes short")
    return out[:need].tobytes()


def zstd(data: bytes, need: int) -> bytes:
    """The first `need` bytes of a Zstandard frame, decoded as libzstd's
    ZSTD_decompressStream gives them to a buffer of `need` bytes. Raises
    ValueError where libzstd reports an error or the frame is short."""
    return _frame("zstd_decode", _ZSTD_ERRORS, "Zstandard", data, need)


def lzma(data: bytes, need: int) -> bytes:
    """The first `need` bytes of an .xz stream, as libtiff's LZMADecode
    reads them: what liblzma checks once they are out (the block's check,
    the index, the footer) never fails a strip. Raises ValueError where
    liblzma reports an error first or the stream is short."""
    return _frame("xz_decode", _XZ_ERRORS, "LZMA", data, need)
