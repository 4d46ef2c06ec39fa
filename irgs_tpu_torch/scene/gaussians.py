"""The Gaussian-surfel parameter set at static capacity (≙ irgs_tpu/scene/
gaussians.py:39-105).

Every tensor has a fixed capacity `n_capacity` with an `alive` mask, so the
parameters map 1:1 onto the JAX package's `GaussianParams` (same field names
and layouts). Raw (pre-activation) parameters:
  scaling: log-scale (2D surfels) -> exp;  opacity: logit -> sigmoid;
  base_color -> sigmoid * 0.77 + 0.03;  metallic/roughness -> sigmoid;
  rotation: unnormalized (w,x,y,z) quaternion;  env: raw lat-long grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..utils import math3d

PARAM_FIELDS = ("xyz", "base_color", "metallic", "roughness", "features_dc",
                "features_rest", "scaling", "rotation", "opacity", "env")


@dataclasses.dataclass
class GaussianParams:
    """Optimized parameters; each field is a leaf tensor."""
    xyz: torch.Tensor            # [N, 3]
    base_color: torch.Tensor     # [N, 3] raw
    metallic: torch.Tensor       # [N, 1] raw
    roughness: torch.Tensor      # [N, 1] raw
    features_dc: torch.Tensor    # [N, 1, 3] SH dc
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor        # [N, 2] log
    rotation: torch.Tensor       # [N, 4] unnormalized quats
    opacity: torch.Tensor        # [N, 1] logit
    env: torch.Tensor            # [He, We, 3] raw lat-long envmap
    max_sh_degree: int = 3

    @property
    def n_capacity(self) -> int:
        return self.xyz.shape[0]

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    def get_base_color(self):
        return torch.sigmoid(self.base_color) * 0.77 + 0.03

    def get_roughness(self):
        return torch.sigmoid(self.roughness)

    def get_features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def world_normals(self, cam_pos=None):
        """3rd rotation column, optionally flipped toward the camera."""
        n = math3d.quat_to_rotmat(self.rotation)[:, :, 2]
        if cam_pos is not None:
            n, _ = math3d.flip_align_view(n, self.xyz - cam_pos)
        return math3d.safe_normalize(n)


@dataclasses.dataclass
class GaussianAux:
    """Non-optimized bookkeeping."""
    alive: torch.Tensor          # [N] bool
    active_sh_degree: int = 3


def inverse_base_color_activation(x):
    return math3d.inverse_sigmoid((x - 0.03) / 0.77)


def params_from_numpy(fields: dict, alive: np.ndarray, device,
                      max_sh_degree: int = 3, active_sh_degree: int = 3):
    """Carry a parameter set across: numpy arrays of the JAX `GaussianParams`
    fields (same names and layouts) -> (GaussianParams, GaussianAux) on
    `device`, as float32 leaf tensors."""
    missing = [f for f in PARAM_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing parameter fields: {missing}")
    device = resolve_device(device)
    t = {f: torch.tensor(np.asarray(fields[f], np.float32), device=device)
         for f in PARAM_FIELDS}
    n = t["xyz"].shape[0]
    alive_t = torch.tensor(np.asarray(alive, bool), device=device)
    if alive_t.shape != (n,):
        raise ValueError(f"alive must have shape ({n},), got {tuple(alive_t.shape)}")
    return (GaussianParams(**t, max_sh_degree=max_sh_degree),
            GaussianAux(alive=alive_t, active_sh_degree=active_sh_degree))

