"""TSDF fusion and SDF ray marching: the half of irgs_tpu/ops/tsdf.py
(:28-139) that stage 1's training loop runs.

A dense bounded voxel grid: `integrate` fuses one depth map by projecting
every voxel into it (no scatter); `ray_march_visibility` marches rays
through the fused TSDF at one-voxel strides and reports whether they cross
the surface before t_max (≙ the reference's mesh ray caster for reflection
visibility, refl_utils.py:82-96). Nothing is differentiated through either
(the march yields a discrete `visible`), so both run without autograd.
Mesh extraction (marching tetrahedra, the unbounded path) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor    # [R, R, R] in [-1, 1], indexed [z, y, x]
    weight: torch.Tensor  # [R, R, R]
    origin: torch.Tensor  # [3]
    voxel: torch.Tensor   # [] voxel size


def init_volume(bb_min, bb_max, res: int, device=None) -> TSDFVolume:
    """An empty volume (TSDF 1, weight 0) over the box, cubic voxels of the
    box's largest side / res (≙ irgs_tpu init_volume)."""
    bb_min = torch.as_tensor(bb_min, dtype=torch.float32, device=device)
    bb_max = torch.as_tensor(bb_max, dtype=torch.float32, device=device)
    voxel = torch.max(bb_max - bb_min) / res
    return TSDFVolume(
        tsdf=torch.ones((res, res, res), dtype=torch.float32, device=device),
        weight=torch.zeros((res, res, res), dtype=torch.float32,
                           device=device),
        origin=bb_min, voxel=voxel)


@torch.no_grad()
def integrate(vol: TSDFVolume, depth, cam_w2c, fx, fy, cx, cy, sdf_trunc,
              depth_trunc) -> TSDFVolume:
    """Fuse one depth map [H, W] seen by the world-to-camera matrix
    `cam_w2c` [4, 4] (≙ irgs_tpu integrate, :46)."""
    res = vol.tsdf.shape[0]
    idx = torch.arange(res, dtype=torch.float32, device=depth.device) + 0.5
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    pts = torch.stack([xx, yy, zz], -1) * vol.voxel + vol.origin

    pc = pts @ cam_w2c[:3, :3].T + cam_w2c[:3, 3]
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = pc[..., 0] / zs * fx + cx
    v = pc[..., 1] / zs * fy + cy
    h, w = depth.shape
    ui = torch.clamp(u.to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, h - 1).long()
    d = depth[vi, ui]
    valid = ((z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
             & (d > 0) & (d < depth_trunc))
    sdf = d - z
    valid = valid & (sdf > -sdf_trunc)
    tsdf_new = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)

    w_new = vol.weight + valid.to(torch.float32)
    fused = torch.where(
        valid, (vol.tsdf * vol.weight + tsdf_new) / torch.clamp(w_new, min=1e-6),
        vol.tsdf)
    return vol._replace(tsdf=fused, weight=w_new)


def _sample_tsdf(vol: TSDFVolume, p):
    """Trilinear TSDF at world points [..., 3]; 1 outside the grid."""
    res = vol.tsdf.shape[0]
    g = (p - vol.origin) / vol.voxel - 0.5
    g0 = torch.floor(g)
    f = g - g0
    gi = g0.to(torch.int32)

    def at(dx, dy, dz):
        q = torch.clamp(gi + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                          device=p.device), 0, res - 1).long()
        return vol.tsdf[q[..., 2], q[..., 1], q[..., 0]]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c = ((at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx) * (1 - fy)
         + (at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx) * fy)
    c2 = ((at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx) * (1 - fy)
          + (at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx) * fy)
    val = c * (1 - fz) + c2 * fz
    inside = torch.all((g >= 0) & (g < res - 1), dim=-1)
    return torch.where(inside, val, torch.ones_like(val))


@torch.no_grad()
def ray_march_visibility(vol: TSDFVolume, rays_o, rays_d, *,
                         t_max: float = 10.0, max_steps: int = 256,
                         t_min: float = 0.05):
    """March rays [N, 3] through the TSDF -> (hit depth [N], visible [N]):
    visible = no zero crossing before t_max, at one-voxel strides with a
    linear locate of the crossing (≙ irgs_tpu ray_march_visibility, :98)."""
    step = vol.voxel
    n = rays_o.shape[0]
    dev = rays_o.device
    t = torch.full((n,), t_min, dtype=torch.float32, device=dev)
    depth = torch.full((n,), t_max, dtype=torch.float32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    prev = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(max_steps):
        s = _sample_tsdf(vol, rays_o + t[:, None] * rays_d)
        crossed = (prev > 0) & (s <= 0) & ~hit & (t > t_min)
        frac = prev / torch.clamp(prev - s, min=1e-9)
        depth = torch.where(crossed, t - step + frac * step, depth)
        hit = hit | crossed
        t = t + step
        prev = s
    return depth, ~hit
