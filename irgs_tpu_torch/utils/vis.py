"""Training visualisation grids (≙ irgs_tpu/utils/vis.py): one view's AOV
panels tiled into one PNG, and envmap snapshots, written through
utils/png.py."""

from __future__ import annotations

import os

import numpy as np
import torch

from .png import write_png


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_panel(x, normalize=False):
    x = _numpy(x)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, -1)
    x = x[..., :3]
    if normalize:
        lo, hi = np.nanmin(x), np.nanmax(x)
        x = (x - lo) / max(hi - lo, 1e-9)
    return np.clip(np.nan_to_num(x), 0.0, 1.0)


def save_aov_grid(path: str, panels: dict, cols: int = 6):
    """Tile named images (H, W, C) into one grid PNG with per-panel scaling
    for depth-like channels."""
    names = list(panels.keys())
    imgs = []
    for k in names:
        norm = k in ("surf_depth", "rend_dist", "depth")
        imgs.append(_to_panel(panels[k], normalize=norm))
    h, w = imgs[0].shape[:2]
    imgs = [i if i.shape[:2] == (h, w) else np.zeros((h, w, 3)) for i in imgs]
    rows = (len(imgs) + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, 3), np.float32)
    for i, img in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, (grid * 255).astype(np.uint8))
    return names


def save_envmap_png(path: str, env_linear):
    """HDR envmap -> tonemapped PNG snapshot (≙ envmap dumps in
    save_training_vis)."""
    from .math3d import rgb_to_srgb
    img = _numpy(rgb_to_srgb(torch.as_tensor(env_linear).detach()))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
