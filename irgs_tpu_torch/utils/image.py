"""Image resampling for the eval CLIs."""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(img, h: int, w: int):
    """[H, W, C] -> [h, w, C], as ``jax.image.resize(img, (h, w, C),
    "bilinear")`` computes it: half-pixel centres, and a triangle filter
    widened by the scale when downscaling (JAX's default antialias)."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)
