"""Trainable lat-long environment light (≙ irgs_tpu/scene/envlight.py).

Raw [H, W, 3] grid with an activation, equirect bilinear queries (wrap in
longitude, clamp in latitude), the luminance·sin(θ) texel pdf, light
direction draws with in-texel jitter and the solid-angle pdf lookup of the
balance heuristic. Direction convention: for texel (u∈[0,1), v∈[0,1]),
θ = vπ, φ = (2u-1)π, dir = (sinθ·sinφ, cosθ, -sinθ·cosφ).

The draws (`draw_light`) sample the same distribution as the JAX package's
Gumbel-max `jax.random.categorical`, but by inverse CDF: an int64 CDF of the
texel pdf quantised to 2^-50, searched with 53-bit uniforms from the
counter-based hash of utils/rng.py keyed by (seed, pixel id, sample). A
pixel's draws are a pure function of its id (as JAX's `fold_in(key,
pixel_id)` makes them), the integer CDF is exact in any summation order,
so the card and the CPU draw the same texels, and a zero-pdf texel is never
drawn. The samples are not JAX's; `sample_light_dirs` takes the texel
indices and jitter as `LightDraws`, so a caller can feed JAX's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import rng
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


def init_env(resolution: int, init_value: float, activation: str = "exp",
             device=None):
    """Constant raw [resolution/2, resolution, 3] grid whose activation is
    `init_value` (≙ irgs_tpu init_env, envlight.py:36-46)."""
    h, w = resolution // 2, resolution
    if activation == "exp":
        raw = math.log(init_value)
    elif activation == "sigmoid":
        raw = math.log(init_value / (1 - init_value))
    elif activation == "softplus":
        raw = math.log(math.expm1(max(init_value, 1e-6)))
    else:
        raw = init_value
    return torch.full((h, w, 3), raw, dtype=torch.float32, device=device)


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


def query_env(env_raw, dirs, activation: str = "exp", transform=None):
    """Radiance along world directions (mode 'pure_env'); `transform` [3, 3]
    rotates the directions first (dirs @ transform.T)."""
    if transform is not None:
        dirs = dirs @ transform.T
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


def init_direct_light(generator: torch.Generator, max_res: int = 16,
                      init_value: float = 0.5):
    """Uniform random raw [max_res, 2·max_res, 3] grid for the softplus
    activation (≙ irgs_tpu init_direct_light, envlight.py:49), drawn from
    `generator` on its device."""
    return init_value * torch.rand((max_res, max_res * 2, 3),
                                   generator=generator,
                                   device=generator.device)


def _texel_to_dir(gx, gy):
    sinth, costh = torch.sin(gy * math.pi), torch.cos(gy * math.pi)
    sinph, cosph = torch.sin(gx * math.pi), torch.cos(gx * math.pi)
    return torch.stack([sinth * sinph, costh, -sinth * cosph], dim=-1)


def env_image_dirs(h: int, w: int, device=None):
    """[H, W, 3] direction of every texel centre of an H x W lat-long map."""
    gy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    gx = -1.0 + 1.0 / w + (2.0 / w) * torch.arange(w, dtype=torch.float32,
                                                   device=device)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    return _texel_to_dir(gxx, gyy)


def light_pdf(pdf, dirs, transform=None):
    """pdf per steradian of directions [..., S, 3] -> [..., S, 1]: the texel's
    probability × H·W/(2π² sinθ) (≙ irgs_tpu light_pdf, envlight.py:164)."""
    h, w = pdf.shape
    flat = dirs.reshape(-1, 3)
    if transform is not None:
        flat = flat @ transform.T
    u = torch.nan_to_num(torch.atan2(flat[:, 0], -flat[:, 2])) \
        / (2.0 * math.pi) + 0.5
    v = torch.acos(clip(flat[:, 1], -1 + 1e-6, 1 - 1e-6)) / math.pi
    ui = torch.clamp((u * w).long(), 0, w - 1)
    vi = torch.clamp((v * h).long(), 0, h - 1)
    weight = h * w / (2.0 * math.pi ** 2
                      * maximum(torch.sin(v * math.pi), 1e-6))
    prob = pdf[vi, ui] * weight
    return prob.reshape(*dirs.shape[:-1], 1)


class LightDraws(NamedTuple):
    """One batch of light-sample draws."""
    idx: torch.Tensor             # [B, S] int64 texel index (row-major H x W)
    jitter: torch.Tensor | None   # [B, S, 2] uniforms inside the texel
    #                               (training), or None (texel centres)


def texel_cdf(pdf):
    """Inclusive int64 CDF of the flat texel pdf, each texel's weight its pdf
    rounded down to a multiple of 2^-50 (all-zero pdf: uniform weights, as
    JAX's equal logits are)."""
    wgt = torch.floor(pdf.reshape(-1).double() * 2.0 ** 50).long()
    wgt = torch.where(wgt.sum() > 0, wgt, torch.ones_like(wgt))
    return torch.cumsum(wgt, 0)


def draw_light(pdf, ids, sample_num: int, seed=0,
               training: bool = False) -> LightDraws:
    """Draw `sample_num` texels ∝ `pdf` for each id of `ids` (an int64
    tensor [B] of pixel ids, or an int B for the ids 0..B-1), with in-texel
    jitter when `training`. `seed` (an int or an int64 tensor scalar) keys
    the draw; each id's draws depend only on (seed, id)."""
    dev = pdf.device
    if isinstance(ids, int):
        ids = torch.arange(ids, device=dev)
    ids = ids.to(device=dev, dtype=torch.int64)[:, None]
    s = torch.arange(sample_num, device=dev)[None]
    cdf = texel_cdf(pdf)
    total = cdf[-1]
    r = torch.floor(rng.uniform53(seed, ids, s, 0) * total.double()).long()
    idx = torch.searchsorted(cdf, torch.minimum(r, total - 1), right=True)
    jitter = None
    if training:
        jitter = torch.stack([rng.uniform24(seed, ids, s, 2),
                              rng.uniform24(seed, ids, s, 3)], -1)
    return LightDraws(idx, jitter)


def sample_light_dirs(pdf, draws: LightDraws, transform=None):
    """Directions [B, S, 3] of the drawn texels (centres, or jittered inside
    the texel) and their pdf per steradian [B, S, 1] (≙ irgs_tpu
    sample_light_dirs, envlight.py:142-161, given its texel indices and
    jitter)."""
    h, w = pdf.shape
    b, s = draws.idx.shape
    idx = draws.idx.reshape(-1)
    gx = ((idx % w).float() + 0.5) / w * 2.0 - 1.0
    gy = (torch.div(idx, w, rounding_mode="floor").float() + 0.5) / h
    if draws.jitter is not None:
        u = draws.jitter.reshape(-1, 2)
        gx = gx + (u[:, 0] - 0.5) / w * 2.0
        gy = gy + (u[:, 1] - 0.5) / h
    dirs = _texel_to_dir(gx, gy)
    if transform is not None:
        dirs = dirs @ transform
    dirs = dirs.reshape(b, s, 3)
    return dirs, light_pdf(pdf, dirs, transform=transform)
