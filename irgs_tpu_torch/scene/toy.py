"""Procedural toy scenes (≙ irgs_tpu/scene/toy.py:20-234): the surfel sphere
the bench workload and the tests use, its blob envmap, ring cameras, and the
shadow scene (a ground disk under a sphere) whose wide ground surfels the
oversize merge exists for. numpy, with the activations' inverses routed
through the port's math3d so that the arrays equal the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..utils import math3d
from ..utils import sh as sh_utils
from .cameras import Camera
from .gaussians import GaussianAux, GaussianParams, inverse_base_color_activation


def fibonacci_sphere_points(n: int, radius: float = 1.0):
    i = np.arange(n, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    pts = np.stack([np.cos(theta) * r, y, np.sin(theta) * r], axis=-1)
    return (pts * radius).astype(np.float32)


def make_sphere_scene(n_surface: int = 4096, radius: float = 1.0,
                      n_capacity: int = 8192, env_resolution: int = 64,
                      seed: int = 0, device=None):
    """A surfel sphere with varying base color/roughness under a two-blob
    envmap. Returns (GaussianParams, GaussianAux) on `device` (default
    cuda; pass "cpu" for the CPU)."""
    device = resolve_device(device)
    pts = fibonacci_sphere_points(n_surface, radius)
    normals = pts / np.linalg.norm(pts, axis=-1, keepdims=True)

    up = np.where(np.abs(normals[:, 2:3]) < 0.9,
                  np.array([[0.0, 0, 1]]), np.array([[1.0, 0, 0]]))
    tu = np.cross(up, normals)
    tu /= np.linalg.norm(tu, axis=-1, keepdims=True)
    tv = np.cross(normals, tu)
    R = np.stack([tu, tv, normals], axis=-1)  # columns

    spacing = math.sqrt(4 * math.pi * radius ** 2 / n_surface)
    scale = spacing * 1.2

    base_color = np.where(
        (np.sin(6 * np.arctan2(pts[:, 0], pts[:, 2]))[:, None] > 0),
        np.array([[0.7, 0.25, 0.2]]), np.array([[0.2, 0.45, 0.7]]))
    roughness = (0.25 + 0.5 * (pts[:, 1:2] / radius + 1) / 2)

    k = 16  # deg-3 SH
    fdc = sh_utils.rgb2sh(base_color * 0.6)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)

    def pad(x, fill=0.0):
        out = np.full((n_capacity,) + x.shape[1:], fill, np.float32)
        out[:n_surface] = x
        return torch.tensor(out, device=device)

    quats = math3d.rotmat_to_quat(f32(R)).numpy()
    logit95 = float(math3d.inverse_sigmoid(torch.tensor(0.95, dtype=torch.float32)))
    params = GaussianParams(
        xyz=pad(pts),
        base_color=pad(inverse_base_color_activation(f32(base_color)).numpy()),
        metallic=pad(np.full((n_surface, 1), -2.0, np.float32)),
        roughness=pad(math3d.inverse_sigmoid(f32(roughness)).numpy()),
        features_dc=pad(fdc.reshape(n_surface, 1, 3).astype(np.float32)),
        features_rest=pad(np.zeros((n_surface, k - 1, 3), np.float32)),
        scaling=pad(np.full((n_surface, 2), math.log(scale), np.float32),
                    fill=-10.0),
        rotation=pad(quats, fill=1.0),
        opacity=pad(np.full((n_surface, 1), logit95, np.float32), fill=-12.0),
        env=torch.tensor(make_blob_env(env_resolution // 2, env_resolution,
                                       seed), device=device),
        max_sh_degree=3,
    )
    aux = GaussianAux(alive=torch.arange(n_capacity, device=device) < n_surface,
                      active_sh_degree=3)
    return params, aux


def make_shadow_scene(n_ground: int = 6000, n_sphere: int = 6000,
                      n_capacity: int = 16384, env_resolution: int = 64,
                      seed: int = 0, device=None):
    """A checker-textured ground disk under a two-tone sphere, lit by one
    sharp sun blob (≙ irgs_tpu make_shadow_scene, toy.py:139-234). The
    ground surfels span the scene, so a grid of a few dozen cells per axis
    finds them wider than `span_cap` cells: the scene of the oversize merge.
    Returns (GaussianParams, GaussianAux) on `device` (default cuda)."""
    device = resolve_device(device)
    # ground disk (sunflower spiral), y = -0.65
    i = np.arange(n_ground, dtype=np.float64) + 0.5
    r_g = 2.0 * np.sqrt(i / n_ground)
    th = math.pi * (3.0 - math.sqrt(5.0)) * i
    gx, gz = r_g * np.cos(th), r_g * np.sin(th)
    g_pts = np.stack([gx, np.full_like(gx, -0.65), gz], -1).astype(np.float32)
    g_nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n_ground, 1))
    checker = ((np.floor(gx / 0.35) + np.floor(gz / 0.35)) % 2).astype(bool)
    g_color = np.where(checker[:, None],
                       np.array([[0.75, 0.72, 0.65]]),
                       np.array([[0.18, 0.16, 0.22]])).astype(np.float32)
    g_rough = np.full((n_ground, 1), 0.6, np.float32)
    g_spacing = math.sqrt(math.pi * 2.0 ** 2 / n_ground)

    # sphere above the ground
    s_pts = fibonacci_sphere_points(n_sphere, 0.6)
    s_pts[:, 1] += 0.05
    s_nrm = s_pts - np.array([0.0, 0.05, 0.0], np.float32)
    s_nrm /= np.linalg.norm(s_nrm, axis=-1, keepdims=True)
    s_color = np.where(
        (np.sin(8 * np.arctan2(s_pts[:, 0], s_pts[:, 2]))[:, None] > 0),
        np.array([[0.7, 0.3, 0.15]]), np.array([[0.15, 0.4, 0.65]])).astype(np.float32)
    s_rough = (0.15 + 0.6 * (s_pts[:, 1:2] - s_pts[:, 1].min())
               / (s_pts[:, 1].max() - s_pts[:, 1].min())).astype(np.float32)
    s_spacing = math.sqrt(4 * math.pi * 0.6 ** 2 / n_sphere)

    pts = np.concatenate([g_pts, s_pts]).astype(np.float32)
    normals = np.concatenate([g_nrm, s_nrm]).astype(np.float32)
    base_color = np.concatenate([g_color, s_color])
    roughness = np.concatenate([g_rough, s_rough])
    scales = np.concatenate([
        np.full((n_ground, 2), math.log(g_spacing * 1.2), np.float32),
        np.full((n_sphere, 2), math.log(s_spacing * 1.2), np.float32)])
    n = pts.shape[0]

    up = np.where(np.abs(normals[:, 2:3]) < 0.9,
                  np.array([[0.0, 0, 1]]), np.array([[1.0, 0, 0]]))
    tu = np.cross(up, normals)
    tu /= np.linalg.norm(tu, axis=-1, keepdims=True)
    tv = np.cross(normals, tu)
    R = np.stack([tu, tv, normals], axis=-1)

    # sharp sun + dim sky: hard shadow boundaries
    h, w = env_resolution // 2, env_resolution
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    env = np.full((h, w, 3), 0.06, np.float32)
    d2 = (u - 0.22) ** 2 + (v - 0.25) ** 2
    env += 40.0 * np.exp(-d2 / (2 * 0.03 ** 2))[..., None] * np.array([1.0, 0.95, 0.8])
    env = np.log(env).astype(np.float32)

    k = 16
    fdc = sh_utils.rgb2sh(base_color * 0.6)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)

    def pad(x, fill=0.0):
        out = np.full((n_capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.tensor(out, device=device)

    quats = math3d.rotmat_to_quat(f32(R)).numpy()
    logit95 = float(math3d.inverse_sigmoid(torch.tensor(0.95, dtype=torch.float32)))
    params = GaussianParams(
        xyz=pad(pts),
        base_color=pad(inverse_base_color_activation(f32(base_color)).numpy()),
        metallic=pad(np.full((n, 1), -4.0, np.float32)),
        roughness=pad(math3d.inverse_sigmoid(f32(roughness)).numpy()),
        features_dc=pad(fdc.reshape(n, 1, 3).astype(np.float32)),
        features_rest=pad(np.zeros((n, k - 1, 3), np.float32)),
        scaling=pad(scales, fill=-10.0),
        rotation=pad(quats, fill=1.0),
        opacity=pad(np.full((n, 1), logit95, np.float32), fill=-12.0),
        env=torch.tensor(env, device=device),
        max_sh_degree=3,
    )
    aux = GaussianAux(alive=torch.arange(n_capacity, device=device) < n,
                      active_sh_degree=3)
    return params, aux


def make_blob_env(h: int, w: int, seed: int = 0):
    """Log-space lat-long envmap: dim sky + two bright gaussian blobs."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    env = np.full((h, w, 3), 0.15, np.float32)
    for color, (cu, cv), s, amp in [
        (np.array([1.0, 0.9, 0.7]), (0.3, 0.3), 0.05, 6.0),
        (np.array([0.5, 0.7, 1.0]), (0.75, 0.45), 0.08, 3.0),
    ]:
        d2 = (u - cu) ** 2 + (v - cv) ** 2
        env += amp * np.exp(-d2 / (2 * s * s))[..., None] * color
    return np.log(env).astype(np.float32)


def make_ring_cameras(n: int, radius: float = 3.0, height: float = 0.8,
                      width: int = 256, height_px: int = 256, fov: float = 0.8):
    """Cameras on a ring looking at the origin."""
    cams = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        pos = np.array([radius * math.cos(ang), height, radius * math.sin(ang)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=-1)  # camera-to-world columns
        T = -R.T @ pos                             # world-to-camera translation
        cams.append(Camera(i, R, T, fovx=fov, fovy=fov, width=width,
                           height=height_px))
    return cams
