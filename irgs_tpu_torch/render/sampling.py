"""Monte-Carlo direction sampling (≙ irgs_tpu/render/sampling.py:20-47)."""

from __future__ import annotations

import math

import torch

from ..utils.math3d import maximum, rotation_between_z, safe_normalize

_DELTA = math.pi * (3.0 - math.sqrt(5.0))
_ZMIN = math.sin(10.0 / 180.0 * math.pi)


def fibonacci_sphere_sampling(normals, sample_num: int, u=None):
    """Hemisphere sampling around each normal.

    normals [N, 3] unit; `u` [N, 1] uniforms in [0, 1) for the random
    azimuthal rotation (training), None for the deterministic pattern.
    Returns incident_dirs [N, S, 3], incident_areas [N, S, 1] (2π)."""
    dev = normals.device
    idx = torch.arange(sample_num, dtype=torch.float32, device=dev)[None]
    z = maximum(1.0 - 2.0 * idx / (2.0 * sample_num - 1.0), _ZMIN)
    rad = torch.sqrt(1.0 - z * z)
    theta = _DELTA * idx
    if u is not None:
        theta = theta + u * 2.0 * math.pi
    y = torch.cos(theta) * rad
    x = torch.sin(theta) * rad
    z_samples = torch.stack([x, y, z.expand(y.shape)], dim=-2)   # [N, 3, S]

    rot = rotation_between_z(normals)                            # [N, 3, 3]
    dirs = torch.bmm(rot, z_samples.expand(rot.shape[0], -1, -1))
    dirs = safe_normalize(dirs.transpose(-1, -2))                # [N, S, 3]
    areas = torch.full(dirs.shape[:-1] + (1,), 2.0 * math.pi,
                       dtype=dirs.dtype, device=dev)
    return dirs, areas
