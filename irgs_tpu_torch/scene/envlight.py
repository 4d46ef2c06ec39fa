"""Trainable lat-long environment light (≙ irgs_tpu/scene/envlight.py:23-112).

Raw [H, W, 3] grid with an activation, equirect bilinear queries (wrap in
longitude, clamp in latitude) and the luminance·sin(θ) texel pdf. Direction
convention: for texel (u∈[0,1), v∈[0,1]), θ = vπ, φ = (2u-1)π,
dir = (sinθ·sinφ, cosθ, -sinθ·cosφ).
"""

from __future__ import annotations

import math

import torch

from ..utils.math3d import clip, maximum


def activate(env_raw, activation: str):
    if activation == "exp":
        return torch.exp(env_raw)
    if activation == "sigmoid":
        return torch.sigmoid(env_raw)
    if activation == "softplus":
        return torch.nn.functional.softplus(env_raw)
    if activation == "none":
        return env_raw
    raise NotImplementedError(activation)


def dirs_to_uv(dirs):
    """[..., 3] unit dirs -> equirect (u, v) in [0, 1]²."""
    u = torch.atan2(dirs[..., 0], -dirs[..., 2]) / (2.0 * math.pi) + 0.5
    v = torch.acos(clip(dirs[..., 1], -1 + 1e-6, 1 - 1e-6)) / math.pi
    return clip(torch.nan_to_num(u), 0.0, 1.0), clip(v, 0.0, 1.0)


def bilinear_latlong(img, u, v):
    """Bilinear fetch from [H, W, C]: wrap in u (longitude), clamp in v."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def query_env(env_raw, dirs, activation: str = "exp"):
    """Radiance along world directions (mode 'pure_env')."""
    u, v = dirs_to_uv(dirs)
    light = bilinear_latlong(env_raw, u, v)
    return maximum(activate(light, activation), 0.0)


def build_pdf(env_raw, activation: str = "exp"):
    """Normalized texel pdf: max-channel radiance × sin(θ)."""
    h = env_raw.shape[0]
    v = (torch.arange(h, dtype=torch.float32, device=env_raw.device) + 0.5) / h
    pdf = torch.amax(maximum(activate(env_raw, activation), 0.0), dim=-1)
    pdf = pdf * torch.sin(v * math.pi)[:, None]
    return pdf / maximum(torch.sum(pdf), 1e-20)
