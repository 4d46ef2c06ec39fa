"""Cameras (≙ irgs_tpu/scene/cameras.py:22-134).

`Camera` holds host-side numpy matrices and, for a dataset view, its image
and mask; `Camera.params(device)` gives the small per-view tensors
(`CameraParams`) the rasterizer and the G-buffer code consume.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import math3d


class CameraParams(NamedTuple):
    """Per-view tensors. cx/cy are the principal point in continuous pixel
    coordinates (pixel i spans [i, i+1))."""
    w2c: torch.Tensor        # [4, 4] world -> camera (column-vector)
    full_proj: torch.Tensor  # [4, 4] world -> clip
    cam_pos: torch.Tensor    # [3]
    fx: float
    fy: float
    cx: float
    cy: float

    def pixmat(self, W: int, H: int) -> torch.Tensor:
        """[3, 4] world-homogeneous -> pixel-homogeneous transform
        (px = ndc_x * W/2 + (W-1)/2, the CUDA ndc2pix convention)."""
        P = self.full_proj
        row0 = (W / 2.0) * P[0] + ((W - 1) / 2.0) * P[3]
        row1 = (H / 2.0) * P[1] + ((H - 1) / 2.0) * P[3]
        return torch.stack([row0, row1, P[3]])

    def ray_dirs(self, W: int, H: int, normalize: bool = True) -> torch.Tensor:
        """[H, W, 3] world-space ray directions through pixel centers."""
        dev = self.w2c.device
        u = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
        v = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
        x = (u + 0.5 - self.cx) / self.fx
        y = (v + 0.5 - self.cy) / self.fy
        ones = torch.ones_like(x + y)
        d_cam = torch.cat([x + 0 * y, y + 0 * x, ones], dim=-1)
        R_c2w = self.w2c[:3, :3].T
        d_world = d_cam @ R_c2w.T
        if normalize:
            d_world = math3d.safe_normalize(d_world)
        return d_world


class Camera:
    """One view: a pinhole of the given field of view (or intrinsics `K`).
    With an `image` ([H, W, 3], clipped to [0, 1] as float32) the width and
    height are the image's; without one they must be given."""

    def __init__(self, uid: int, R: np.ndarray, T: np.ndarray,
                 fovx: float, fovy: float, image: np.ndarray | None = None,
                 image_name: str = "", mask: np.ndarray | None = None,
                 znear: float = 0.01, zfar: float = 100.0,
                 width: int | None = None, height: int | None = None,
                 K: np.ndarray | None = None, image_path: str = ""):
        self.uid = uid
        self.R = R  # camera-to-world rotation
        self.T = T  # world-to-camera translation
        self.fovx, self.fovy = float(fovx), float(fovy)
        self.image_name = image_name
        self.image_path = image_path
        self.znear, self.zfar = znear, zfar
        if image is not None:
            self.image = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
            self.height, self.width = self.image.shape[:2]
        else:
            self.image = None
            self.height, self.width = int(height), int(width)
        self.mask = (None if mask is None else np.asarray(mask).astype(bool)
                     .reshape(self.height, self.width))
        self.K = None if K is None else np.asarray(K)
        self.w2c = math3d.world_to_view(R, T)
        if K is None:
            self.proj = math3d.projection_matrix(znear, zfar, self.fovx,
                                                 self.fovy)
        else:
            self.proj = math3d.projection_matrix_from_K(
                znear, zfar, self.height, self.width, K)
        self.full_proj = (self.proj @ self.w2c).astype(np.float32)
        self.c2w = np.linalg.inv(self.w2c)
        self.cam_pos = self.c2w[:3, 3].astype(np.float32)
        if K is None:
            self.fx = math3d.fov2focal(self.fovx, self.width)
            self.fy = math3d.fov2focal(self.fovy, self.height)
            self.cx = self.width / 2.0
            self.cy = self.height / 2.0
        else:
            self.fx, self.fy = float(K[0, 0]), float(K[1, 1])
            self.cx, self.cy = float(K[0, 2]), float(K[1, 2])

    def params(self, device=None) -> CameraParams:
        """The camera as tensors on `device` (default cuda)."""
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        # scalars are rounded to f32 like the reference's jnp.float32 scalars
        s = lambda a: float(np.float32(a))
        return CameraParams(w2c=f32(self.w2c), full_proj=f32(self.full_proj),
                            cam_pos=f32(self.cam_pos), fx=s(self.fx),
                            fy=s(self.fy), cx=s(self.cx), cy=s(self.cy))
