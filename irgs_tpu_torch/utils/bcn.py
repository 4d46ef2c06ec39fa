"""ctypes binding of ``csrc/bcn_decode.cpp``: the S3TC/BCn block decoders
behind Pillow's ``"bcn"`` tile (libImaging's BcnDecode.c: BC1-BC7, BC5
signed, BC6H unsigned and signed), which the DDS and FTEX readers use,
and BlpImagePlugin's own DXT1/3/5 colours (`decode_blp_dxt`). Built with
g++ at first use (`native.build_library`)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import native

SRC = Path(__file__).resolve().parents[1] / "csrc" / "bcn_decode.cpp"
_LIB = None
_U8P = ctypes.POINTER(ctypes.c_uint8)
# Pillow's pixel formats -> (BCn number, signed)
FORMATS = {"DXT1": (1, 0), "BC1": (1, 0), "DXT3": (2, 0), "BC2": (2, 0),
           "DXT5": (3, 0), "BC3": (3, 0), "BC4": (4, 0), "BC5": (5, 0),
           "BC5S": (5, 1), "BC6H": (6, 0), "BC6HS": (6, 1), "BC7": (7, 0)}


class BcnError(ValueError):
    pass


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(SRC, "bcn_decode")))
        i64 = ctypes.c_int64
        lib.bcn_decode.argtypes = [_U8P, i64, ctypes.c_int, ctypes.c_int, i64,
                                   i64, _U8P]
        lib.bcn_decode.restype = i64
        _LIB = lib
    return _LIB


def block_bytes(n: int) -> int:
    """Bytes of one 4x4 block of BCn number `n`."""
    return 8 if n in (1, 4) else 16


def _run(data: bytes, n: int, flags: int, w: int, h: int) -> np.ndarray:
    out = np.zeros((h, w, 1 if n == 4 else 4), np.uint8)
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    if _lib().bcn_decode(src.ctypes.data_as(_U8P), len(data), n, flags, w, h,
                         out.ctypes.data_as(_U8P)) < 0:
        raise BcnError("image file is truncated")
    return out


def decode(data: bytes, pixel_format: str, w: int, h: int) -> np.ndarray:
    """The "bcn" decoder on `data` for a w x h image: uint8 [h, w, 4]
    (RGBA as the decoder writes it; the caller keeps the mode's bands), or
    [h, w] for BC4. Raises BcnError where the data holds fewer blocks than
    the image needs (PIL: "image file is truncated")."""
    n, sign = FORMATS[pixel_format]
    out = _run(data, n, sign, w, h)
    return out[..., 0] if n == 4 else out


def decode_blp_dxt(data: bytes, n: int, bw: int, bh: int) -> np.ndarray:
    """BlpImagePlugin's decode_dxt1/3/5 (n = 1, 2, 3) over bh rows of bw
    blocks: uint8 [4 bh, 4 bw, 4] RGBA (their 5:6:5 colours shifted, not
    widened; DXT1's transparent black where c0 <= c1)."""
    return _run(data, n, 2, 4 * bw, 4 * bh)
