"""Image helpers: PIL's reading and mode conversions without PIL, and
resampling for the eval CLIs.

The JAX package reads LDR frames with ``np.asarray(Image.open(p))``
(irgs_tpu/scene/datasets.py:59-60) and COLMAP frames with
``Image.open(p).convert("RGB")`` (irgs_tpu/scene/colmap.py:122). PIL picks
the decoder from the file's first bytes, whatever its name, and so does
`read_image_like_pil`; the port's readers (utils/png.py, jpeg.py, tiff.py,
bmp.py, gif.py, webp.py) return PIL's array together with its mode (and
palette); `to_rgb_like_pil` then converts as Pillow's Convert.c does for
each mode.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

# first bytes -> reader, as PIL's plugins accept them
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                  b"MM\x00\x2b", b"II\x2b\x00")


class UnreadableImageError(ValueError):
    """None of the port's readers (PNG, JPEG, TIFF, BMP, GIF, WebP) takes
    the file: PIL's UnidentifiedImageError where PIL has no reader for it
    either, else a container PIL reads that is not ported yet."""


def read_image_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)``, the decoder
    chosen by the file's content: ``np.asarray(im)``, ``im.mode`` and
    ``im.info``'s palette, transparency and comment where the file has
    them."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        from . import png
        return png.read_png_like_pil(path)
    if head.startswith(b"\xff\xd8\xff"):
        from . import jpeg
        return jpeg.read_jpeg_like_pil(path)
    if head.startswith(_TIFF_PREFIXES):
        from . import tiff
        return tiff.read_tiff_like_pil(path)
    if head.startswith(b"BM"):
        from . import bmp
        return bmp.read_bmp_like_pil(path)
    if head.startswith((b"GIF87a", b"GIF89a")):
        from . import gif
        return gif.read_gif_like_pil(path)
    if (head.startswith(b"RIFF") and head[8:12] == b"WEBP"
            and head[12:16] in (b"VP8 ", b"VP8L", b"VP8X")):
        from . import webp
        return webp.read_webp_like_pil(path)
    raise UnreadableImageError(f"cannot identify image file {path}")


def _muldiv255(a, b):
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def to_rgb_like_pil(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """``np.asarray(im.convert("RGB"))`` for an image of PIL mode `mode`
    whose ``np.asarray`` is `arr`: uint8 [H, W, 3].

      1      0 or 255;                L, LA   the grey replicated;
      I;16,  the grey clamped at 255;  I       the grey clipped to 0..255;
      I;16B
      F      the grey truncated, 0 at or below 0 (and NaN), 255 at or
             above 255;
      P, PA  the palette's colour, black past its last entry (so too an
             "L" image that carries a palette, as a GIF frame can);
      RGB    as is;                    RGBA    alpha dropped;
      CMYK   cmyk2rgb: each of R, G, B is 255 - K - C (M, Y) * (255 - K)
             / 255, rounded as MULDIV255.
    CIELab (LAB) raises: PIL converts it, the port does not yet.
    """
    arr = np.asarray(arr)
    if mode == "1":
        g = np.where(arr, 255, 0).astype(np.uint8)
    elif mode == "L" and palette is None:
        g = arr.astype(np.uint8)
    elif mode in ("I;16", "I;16B"):
        g = np.minimum(arr, 255).astype(np.uint8)
    elif mode == "I":
        g = np.clip(arr, 0, 255).astype(np.uint8)
    elif mode == "F":
        with np.errstate(invalid="ignore"):
            g = np.where(arr >= 255, 255, np.where(arr > 0, arr, 0))
        g = np.nan_to_num(g, nan=0.0).astype(np.uint8)
    elif mode == "LA":
        g = arr[..., 0].astype(np.uint8)
    elif mode in ("P", "PA", "L"):
        lut = np.zeros((256, 3), np.uint8)
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
        return lut[arr[..., 0] if mode == "PA" else arr]
    elif mode == "RGB":
        return arr.astype(np.uint8)
    elif mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3], np.uint8)
    elif mode == "CMYK":
        nk = 255 - arr[..., 3:4].astype(np.int32)
        return np.clip(nk - _muldiv255(arr[..., :3], nk), 0, 255).astype(
            np.uint8)
    else:
        raise UnreadableImageError(f"convert('RGB') from mode {mode} is not "
                                   f"ported")
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
