"""What the eval CLIs share: the trained model's latest PLY, the GT map
lookup, and 8-bit image output through utils/png.py."""

from __future__ import annotations

import os

import numpy as np


def load_trained(model_path: str, iteration: int, cfg, device):
    """The Gaussians of `point_cloud/iteration_<it>/point_cloud.ply`, the
    latest iteration unless `iteration` > 0 -> (params, aux, it)."""
    from ..scene import gaussians as G
    pc_dir = os.path.join(model_path, "point_cloud")
    iters = sorted(int(d.split("_")[1]) for d in os.listdir(pc_dir))
    it = iteration if iteration > 0 else iters[-1]
    params, aux = G.load_ply(
        os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply"),
        cfg.model.max_gaussians, cfg.model.sh_degree,
        env_activation=cfg.model.envmap_activation, device=device)
    return params, aux, it


def find_gt_map(source_path: str, subdir: str, name: str):
    """The file of `source_path/subdir` whose stem is the view's name (r_1
    must not match r_10.png), else the first that contains it, else None."""
    d = os.path.join(source_path, subdir)
    if not os.path.isdir(d):
        return None
    base = os.path.basename(name).split(".")[0]
    for f in sorted(os.listdir(d)):
        if os.path.splitext(f)[0] == base:
            return os.path.join(d, f)
    for f in sorted(os.listdir(d)):
        if base in f:
            return os.path.join(d, f)
    return None


def write_png8(path: str, img) -> None:
    """[H, W, C] in [0, 1] (a tensor or an array; 1 channel is repeated to
    3) as an 8-bit PNG, truncated as (x * 255).astype(uint8) truncates."""
    from ..utils import png
    a = img.detach().cpu().numpy() if hasattr(img, "detach") else np.asarray(img)
    a = np.clip(a, 0.0, 1.0)
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, -1)
    png.write_png(path, (a * 255).astype(np.uint8))
