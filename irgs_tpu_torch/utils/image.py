"""Image helpers: PIL's reading and mode conversions without PIL, and
resampling for the eval CLIs.

The JAX package reads LDR frames with ``np.asarray(Image.open(p))``
(irgs_tpu/scene/datasets.py:59-60) and COLMAP frames with
``Image.open(p).convert("RGB")`` (irgs_tpu/scene/colmap.py:122). The port's
readers (utils/png.py, utils/jpeg.py) return PIL's array together with its
mode (and palette); `to_rgb_like_pil` then converts as Pillow's Convert.c
does for each mode.
"""

from __future__ import annotations

import os

import numpy as np
import torch.nn.functional as F


def read_image_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a PNG or
    JPEG file: ``np.asarray(im)``, ``im.mode`` and ``im.info``'s palette,
    transparency and comment where the file has them."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        from . import png
        return png.read_png_like_pil(path)
    if ext in (".jpg", ".jpeg"):
        from . import jpeg
        return jpeg.read_jpeg_like_pil(path)
    raise NotImplementedError(f"{path}: only PNG and JPEG images are read")


def _muldiv255(a, b):
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def to_rgb_like_pil(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """``np.asarray(im.convert("RGB"))`` for an image of PIL mode `mode`
    whose ``np.asarray`` is `arr`: uint8 [H, W, 3].

      1      0 or 255;                L, LA   the grey replicated;
      I;16   the grey clamped at 255;  P       the palette's colour, black
                                               past its last entry;
      RGB    as is;                    RGBA    alpha dropped;
      CMYK   cmyk2rgb: each of R, G, B is 255 - K - C (M, Y) * (255 - K)
             / 255, rounded as MULDIV255.
    """
    arr = np.asarray(arr)
    if mode == "1":
        g = np.where(arr, 255, 0).astype(np.uint8)
    elif mode == "L":
        g = arr.astype(np.uint8)
    elif mode == "I;16":
        g = np.minimum(arr, 255).astype(np.uint8)
    elif mode == "LA":
        g = arr[..., 0].astype(np.uint8)
    elif mode == "P":
        lut = np.zeros((256, 3), np.uint8)
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
        return lut[arr]
    elif mode == "RGB":
        return arr.astype(np.uint8)
    elif mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3], np.uint8)
    elif mode == "CMYK":
        nk = 255 - arr[..., 3:4].astype(np.int32)
        return np.clip(nk - _muldiv255(arr[..., :3], nk), 0, 255).astype(
            np.uint8)
    else:
        raise NotImplementedError(f"convert('RGB') from mode {mode}")
    return np.repeat(g[..., None], 3, -1)


def read_rgb_like_pil(path: str) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path).convert("RGB"))``: uint8
    [H, W, 3]."""
    arr, mode, info = read_image_like_pil(path)
    return to_rgb_like_pil(arr, mode, info.get("palette"))


def resize_bilinear(img, h: int, w: int):
    """[H, W, C] -> [h, w, C], as ``jax.image.resize(img, (h, w, C),
    "bilinear")`` computes it: half-pixel centres, and a triangle filter
    widened by the scale when downscaling (JAX's default antialias)."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)
