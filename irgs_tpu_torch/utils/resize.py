"""cv2.resize on float images, in numpy, as OpenCV computes it; and PIL's
Lanczos resize of 8-, 16- and 32-bit images (`resize_lanczos_like_pil`).

The JAX package resizes dataset frames and masks with ``cv2.resize``
(irgs_tpu/scene/datasets.py:197-198 for Stanford-ORB's 512² frames,
:249-256 for ``-r``). The card's machine has no cv2, so this module follows
OpenCV's ``hal::resize`` (imgproc/src/resize.cpp) for float32 and float64
images of shape [H, W] or [H, W, C], branch by branch, with its
single-precision weights and its order of operations:

  INTER_AREA, integer factor     ``resizeAreaFast_``: the box sum over the
                                 factor² source pixels in row-major order,
                                 times ``1.f / area`` (at 2 x 2 on one or
                                 four float32 channels, the pairwise sum of
                                 its 128-bit vector loop);
  INTER_AREA, shrinking          ``resizeArea_`` with the
                                 ``computeResizeAreaTab`` overlap weights:
                                 per source row the weighted sum across,
                                 then the weighted rows summed down;
  INTER_AREA, enlarging          the bilinear variant of ``resize`` in area
                                 mode: ``sx = floor(dx * scale)`` and
                                 ``fx = (dx+1) - (sx+1) / scale`` wrapped
                                 into [0, 1);
  INTER_LINEAR                   half-pixel centres
                                 ``fx = (dx + 0.5) * scale - 0.5``, columns
                                 and rows clamped at the edges.

The area branches accumulate in the image's own precision with float32
weights, as OpenCV's ``WT`` and ``AT`` types are, and equal cv2's results
bit for bit. cv2's default build hands a float INTER_LINEAR resize to Intel
IPP (before OpenCV's own switch of an exact 2x shrink to area), which keeps
the source coordinate in double precision where OpenCV's own loop rounds it
to float; this module computes that branch in double and equals cv2 within
~2e-7 on [0, 1] data (float32; ~1e-13 for float64), not bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np

INTER_LINEAR = 1
INTER_AREA = 3

_DBL_EPSILON = np.finfo(np.float64).eps


def resize(src: np.ndarray, dsize, interpolation: int = INTER_LINEAR):
    """``cv2.resize(src, dsize, interpolation=...)``: dsize is (width,
    height); src is float32 or float64 [H, W] or [H, W, C]."""
    src = np.asarray(src)
    if src.dtype not in (np.float32, np.float64):
        raise TypeError(f"resize takes float32 or float64 images, got "
                        f"{src.dtype}")
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape[:2]
    if (dw, dh) == (sw, sh):
        return src.copy()
    inv_x, inv_y = dw / sw, dh / sh
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    iscale_x, iscale_y = round(scale_x), round(scale_y)
    area_fast = (abs(scale_x - iscale_x) < _DBL_EPSILON
                 and abs(scale_y - iscale_y) < _DBL_EPSILON)
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        if area_fast:
            return _area_fast(src, dw, dh, iscale_x, iscale_y)
        return _area(src, dw, dh, scale_x, scale_y)
    if interpolation not in (INTER_LINEAR, INTER_AREA):
        raise NotImplementedError(f"interpolation {interpolation}")
    return _linear(src, dw, dh, scale_x, scale_y, inv_x, inv_y,
                   area_mode=interpolation == INTER_AREA)


def _area_fast(src, dw, dh, fx, fy):
    """resizeAreaFast_: an integer factor. The box of fy x fx pixels is summed
    in row-major order (four at a time, each four added left to right before
    joining the sum) and scaled by the float 1/area."""
    area = fx * fy
    scale = np.float32(1.0 / area)
    box = src[:dh * fy, :dw * fx].reshape((dh, fy, dw, fx) + src.shape[2:])
    terms = [box[:, sy, :, sx] for sy in range(fy) for sx in range(fx)]
    total = np.zeros_like(terms[0])
    k = 0
    while k <= area - 4:
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2])
                         + terms[k + 3])
        k += 4
    for t in terms[k:]:
        total = total + t
    out = total * scale.astype(src.dtype)
    cn = 1 if src.ndim == 2 else src.shape[2]
    if src.dtype == np.float32 and fx == fy == 2 and cn in (1, 4):
        # ResizeAreaFastVec_SIMD_32f: four float lanes at a time add the
        # two rows' pairs first, over the whole vectors of a row
        a, b, c, d = terms
        n = (dw * cn // 4 * 4) // cn
        out[:, :n] = (((a + b) + (c + d)) * np.float32(0.25))[:, :n]
    return out


def _area_tab(ssize, dsize, scale):
    """computeResizeAreaTab: (destination index, source index, weight) of
    every overlap, in OpenCV's order."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1)
            alpha.append(np.float32((sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx)
            alpha.append(np.float32(1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2)
            alpha.append(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))
    return np.array(di), np.array(si), np.array(alpha, np.float32)


def _slots(di, si, alpha, dsize):
    """The table as [taps, dsize] source indices and weights, one slot per
    overlap in OpenCV's order (unused slots weigh nothing and are skipped)."""
    counts = np.bincount(di, minlength=dsize)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    taps = int(counts.max())
    idx = np.zeros((taps, dsize), np.int64)
    w = np.zeros((taps, dsize), np.float32)
    used = np.zeros((taps, dsize), bool)
    slot = np.arange(len(di)) - first[di]
    idx[slot, di], w[slot, di], used[slot, di] = si, alpha, True
    return idx, w, used


def _area(src, dw, dh, scale_x, scale_y):
    """resizeArea_: fractional shrink."""
    sh, sw = src.shape[:2]
    wt = src.dtype
    xi, xw, xu = _slots(*_area_tab(sw, dw, scale_x), dw)
    yi, yw, yu = _slots(*_area_tab(sh, dh, scale_y), dh)
    chan = (slice(None),) * 0 if src.ndim == 2 else (None,)
    # across: buf[dx] += S[si] * alpha, slot by slot (every row at once)
    buf = np.zeros((sh, dw) + src.shape[2:], wt)
    for k in range(xi.shape[0]):
        term = src[:, xi[k]] * xw[k][(slice(None),) + chan].astype(wt)
        buf = np.where(xu[k][(slice(None),) + chan], buf + term, buf)
    # down: sum[dy] = beta0 * buf[sy0], then sum += beta * buf[sy]
    out = np.zeros((dh, dw) + src.shape[2:], wt)
    bshape = (slice(None), None) + chan
    for k in range(yi.shape[0]):
        term = yw[k][bshape].astype(wt) * buf[yi[k]]
        out = np.where(yu[k][bshape], out + term, out)
    return out


def _axis_area(dsize, scale, inv):
    """Area mode's source index and float32 weight per output (resize.cpp:
    ``sx = floor(dx * scale)``, ``fx = (dx+1) - (sx+1) * inv`` wrapped)."""
    d = np.arange(dsize, dtype=np.float64)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f).astype(np.float32))
    return s, f.astype(np.float32)


def _axis_linear(dsize, scale):
    """Half-pixel source index and weight per output, the coordinate kept
    in double precision as IPP keeps it (OpenCV's own loop rounds it to
    float first, which cv2's default build does not run for float
    images)."""
    f = (np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    return s, f - s


def _linear(src, dw, dh, scale_x, scale_y, inv_x, inv_y, area_mode):
    """Two-tap interpolation across, then down: resizeGeneric_ with
    HResizeLinear and VResizeLinear in area mode (float32 weights, the
    image's precision), IPP's linear resize otherwise (double)."""
    sh, sw = src.shape[:2]
    if area_mode:
        wt = src.dtype
        (sx, fx), (sy, fy) = (_axis_area(dw, scale_x, inv_x),
                              _axis_area(dh, scale_y, inv_y))
    else:
        wt = np.float64
        (sx, fx), (sy, fy) = _axis_linear(dw, scale_x), _axis_linear(dh,
                                                                     scale_y)
    # columns: sx < 0 -> 0 with weight 0; sx >= sw - 1 -> sw - 1, one tap
    left = sx < 0
    fx = np.where(left, 0, fx).astype(fx.dtype)
    sx = np.where(left, 0, sx)
    right = sx + 1 >= sw
    sx = np.where(right, sw - 1, sx)
    chan = () if src.ndim == 2 else (None,)
    a0 = (1 - fx).astype(fx.dtype).astype(wt)[(slice(None),) + chan]
    a1 = fx.astype(wt)[(slice(None),) + chan]
    x = src.astype(wt, copy=False)
    s0 = x[:, sx]
    s1 = x[:, np.minimum(sx + 1, sw - 1)]
    rows = np.where(right[(slice(None),) + chan], s0, s0 * a0 + s1 * a1)
    # rows: sy and sy + 1 clamped into the image, weights as computed
    b0 = (1 - fy).astype(fy.dtype).astype(wt)[(slice(None), None) + chan]
    b1 = fy.astype(wt)[(slice(None), None) + chan]
    r0 = rows[np.clip(sy, 0, sh - 1)]
    r1 = rows[np.clip(sy + 1, 0, sh - 1)]
    return (r0 * b0 + r1 * b1).astype(src.dtype, copy=False)


# --- PIL's Image.resize(..., LANCZOS) -------------------------------------

_RESAMPLE_SRC = Path(__file__).resolve().parents[1] / "csrc" / "resample.cpp"
_RESAMPLE_LIB = None


def _resample_lib():
    global _RESAMPLE_LIB
    if _RESAMPLE_LIB is None:
        from . import native
        lib = ctypes.CDLL(str(native.build_library(_RESAMPLE_SRC,
                                                   "resample")))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.resample_lanczos.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, u8p,
                                         ctypes.c_int, ctypes.c_int]
        lib.resample_lanczos.restype = ctypes.c_int
        _RESAMPLE_LIB = lib
    return _RESAMPLE_LIB


def _lanczos(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H, W(, bands)], little-endian uint16 [H, W] or int32 [H, W]
    -> the same type at [h, w]."""
    bits = arr.dtype.itemsize * 8
    src = np.ascontiguousarray(arr)
    bands = 1 if arr.ndim == 2 else arr.shape[2]
    out = np.empty((h, w) + arr.shape[2:], src.dtype)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _resample_lib().resample_lanczos(
        src.ctypes.data_as(u8p), arr.shape[1], arr.shape[0], bands, bits,
        out.ctypes.data_as(u8p), w, h)
    return out


def _nearest(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pillow's ImagingScaleAffine at NEAREST: the source position of each
    output pixel accumulated in double from the pixel's centre."""
    def taps(n_in, n_out):
        step = n_in / n_out
        pos, out = step * 0.5, np.empty(n_out, np.int64)
        for i in range(n_out):
            out[i] = int(pos)
            pos += step
        return out
    return arr[taps(arr.shape[0], h)][:, taps(arr.shape[1], w)]


def _muldiv255(a, b):
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def resize_lanczos_like_pil(arr: np.ndarray, mode: str, size) -> np.ndarray:
    """``np.asarray(im.resize(size, Image.LANCZOS))`` for an image `im` of
    PIL mode `mode` whose ``np.asarray`` is `arr`; size is (width, height).

    Modes "1" and "P" resample with NEAREST, as PIL does; "LA" and "RGBA"
    are premultiplied by alpha (MULDIV255) before and divided after (PIL's
    "La"/"RGBa" modes); "L", "RGB", "CMYK", "PA" (the palette indices too)
    and "LAB" (a and b as signed bytes, as PIL's Resample.c reads them) go
    band by band through the 8-bit Lanczos of csrc/resample.cpp, "I;16"
    through its 16-bit one, "I;16B" through the same reading each sample's
    bytes little-endian (PIL's Resample.c does, and the result is stored
    back in the image's big-endian order), "I" through its 32-bit one. "F"
    raises: no caller reads a float resize (PIL cannot save mode F as PNG
    or JPEG)."""
    w, h = int(size[0]), int(size[1])
    arr = np.asarray(arr)
    if (w, h) == (arr.shape[1], arr.shape[0]):
        return arr.copy()
    if mode in ("1", "P"):
        return _nearest(arr, w, h)
    if mode in ("LA", "RGBA"):
        a = arr[..., -1:].astype(np.int32)
        pre = arr.copy()
        pre[..., :-1] = _muldiv255(arr[..., :-1], a)
        out = _lanczos(pre, w, h).astype(np.int32)
        alpha = out[..., -1:]
        safe = np.maximum(alpha, 1)
        un = np.where((alpha == 0) | (alpha == 255), out[..., :-1],
                      np.minimum(255 * out[..., :-1] // safe, 255))
        return np.concatenate([un, alpha], -1).astype(np.uint8)
    if mode == "I;16":
        return _lanczos(arr.astype("<u2"), w, h).astype(np.uint16)
    if mode == "I;16B":
        raw = np.ascontiguousarray(arr, ">u2").view("<u2")
        return _lanczos(raw, w, h).view(">u2")
    if mode == "I":
        return _lanczos(arr.astype(np.int32), w, h)
    if mode == "LAB":
        sign = np.array([0, 0x80, 0x80], np.uint8)
        return _lanczos(arr.astype(np.uint8) ^ sign, w, h) ^ sign
    if mode in ("L", "RGB", "CMYK", "PA"):
        return _lanczos(arr.astype(np.uint8), w, h)
    raise NotImplementedError(f"LANCZOS resize of mode {mode}")
