"""Cubemaps and split-sum IBL prefiltering (≙ irgs_tpu/scene/cubemap.py).

Faces are ordered +x, -x, +y, -y, +z, -z (OpenGL / nvdiffrast), each face
[res, res, C], uv in [-1, 1] with the usual cube-face axes. Bilinear cube
fetches (clamped at face edges, or seam-exact through the adjacent face),
lat-long <-> cube resampling, the 2x2 box mip, the cosine (diffuse) and GGX
(specular, Hammersley importance sampled) prefilters, the roughness -> mip
map and the split-sum environment-BRDF (FG) table.
"""

from __future__ import annotations

import math

import torch

from ..utils.math3d import clip, maximum, safe_normalize


def _face_stack(u, v):
    """[6, ..., 3] unnormalised face vectors of (u, v) for every face."""
    one = torch.ones_like(u)
    return torch.stack([
        torch.stack([one, -v, -u], -1),    # +x
        torch.stack([-one, -v, u], -1),    # -x
        torch.stack([u, one, v], -1),      # +y
        torch.stack([u, -one, -v], -1),    # -y
        torch.stack([u, -v, one], -1),     # +z
        torch.stack([-u, -v, -one], -1),   # -z
    ])


def _grid(res: int, device=None):
    return (torch.arange(res, dtype=torch.float32, device=device) + 0.5) \
        / res * 2.0 - 1.0


def _face_dirs(res: int, device=None):
    """[6, res, res, 3] unit direction of every texel centre."""
    g = _grid(res, device)
    v, u = torch.meshgrid(g, g, indexing="ij")
    return safe_normalize(_face_stack(u, v))


def dir_to_cube_uv(d):
    """[..., 3] dirs -> (face [...] int64, u, v in [0, 1])."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    w = torch.where
    face = w(is_x, w(x > 0, 0, 1), w(is_y, w(y > 0, 2, 3), w(z > 0, 4, 5)))
    ma = maximum(w(is_x, ax, w(is_y, ay, az)), 1e-12)
    u = w(is_x, w(x > 0, -z, z), w(is_y, x, w(z > 0, x, -x)))
    v = w(is_x, -y, w(is_y, w(y > 0, z, -z), -y))
    return face.long(), (u / ma + 1) / 2, (v / ma + 1) / 2


def sample_cubemap(cube, dirs):
    """Bilinear fetch from [6, R, R, C], clamped at face edges."""
    res = cube.shape[1]
    face, u, v = dir_to_cube_uv(dirs)
    x = u * res - 0.5
    y = v * res - 0.5
    x0 = torch.clamp(torch.floor(x).long(), 0, res - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, res - 1)
    x1 = torch.clamp(x0 + 1, 0, res - 1)
    y1 = torch.clamp(y0 + 1, 0, res - 1)
    fx = clip(x - x0, 0.0, 1.0)[..., None]
    fy = clip(y - y0, 0.0, 1.0)[..., None]
    c00 = cube[face, y0, x0]
    c01 = cube[face, y0, x1]
    c10 = cube[face, y1, x0]
    c11 = cube[face, y1, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def _uv_to_dir(face, u, v):
    """The unnormalised face vector of continuous (u, v) on `face` (|u| or
    |v| may exceed 1 for taps outside the face)."""
    cand = _face_stack(u, v)                       # [6, ..., 3]
    idx = face[None, ..., None].expand(1, *face.shape, 3)
    return torch.gather(cand, 0, idx)[0]


def sample_cubemap_smooth(cube, dirs):
    """Seam-exact bilinear fetch (≙ dr.texture boundary_mode='cube'): a tap
    outside its face is re-projected through its direction and fetched from
    the adjacent face."""
    res = cube.shape[1]
    face, u, v = dir_to_cube_uv(dirs)
    x = u * res - 0.5
    y = v * res - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    out = 0.0
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi = x0f + dx
        yi = y0f + dy
        oob = ((xi < 0) | (xi > res - 1) | (yi < 0) | (yi > res - 1))[..., None]
        xi_c = clip(xi, 0, res - 1).long()
        yi_c = clip(yi, 0, res - 1).long()
        val_in = cube[face, yi_c, xi_c]
        tap_dir = _uv_to_dir(face, (xi + 0.5) / res * 2.0 - 1.0,
                             (yi + 0.5) / res * 2.0 - 1.0)
        val_out = sample_cubemap(cube, tap_dir)
        out = out + w * torch.where(oob, val_out, val_in)
    return out


def seam_blend(cube):
    """Blend each border texel with the adjacent texel across the cube edge
    (found by pushing its direction one texel outward and re-projecting),
    halving the seam jump of clamped fetches."""
    res = cube.shape[1]
    g = _grid(res, cube.device)
    border = torch.minimum((g - g[0]).abs(), (g - g[-1]).abs()) < 1.0 / res
    bmask = border[:, None] | border[None, :]
    step = 2.0 / res
    push = torch.where(g > 0, g + step, g - step)
    v_grid, u_grid = torch.meshgrid(g, g, indexing="ij")
    pushed = torch.where(border, push, g)
    vp_grid, up_grid = torch.meshgrid(pushed, pushed, indexing="ij")
    u_out = torch.where(border[None, :], up_grid, u_grid)
    v_out = torch.where(border[:, None], vp_grid, v_grid)
    other = sample_cubemap(cube, safe_normalize(_face_stack(u_out, v_out)))
    return torch.where(bmask[None, :, :, None], 0.5 * (cube + other), cube)


def sample_cubemap_mip(mips: list, dirs, mip_level, smooth: bool = False):
    """Trilinear: two bilinear fetches blended by the fractional mip level
    (≙ dr.texture 'linear-mipmap-linear')."""
    n = len(mips)
    lvl = clip(mip_level, 0.0, n - 1.0)
    l0 = torch.clamp(torch.floor(lvl).long(), 0, n - 1)
    l1 = torch.clamp(l0 + 1, 0, n - 1)
    frac = (lvl - l0.to(lvl.dtype))[..., None]
    flat0 = torch.zeros(dirs.shape[:-1] + (mips[0].shape[-1],),
                        dtype=dirs.dtype, device=dirs.device)
    flat1 = torch.zeros_like(flat0)
    sampler = sample_cubemap_smooth if smooth else sample_cubemap
    for i in range(n):
        s = sampler(mips[i], dirs)
        flat0 = torch.where((l0 == i)[..., None], s, flat0)
        flat1 = torch.where((l1 == i)[..., None], s, flat1)
    return flat0 * (1 - frac) + flat1 * frac


def latlong_to_cubemap(latlong, res: int):
    """[H, W, C] equirect -> [6, res, res, C]."""
    from .envlight import bilinear_latlong, dirs_to_uv
    u, v = dirs_to_uv(_face_dirs(res, latlong.device))
    return bilinear_latlong(latlong, u, v)


def cubemap_to_latlong(cube, h: int, w: int):
    """[6, R, R, C] -> [h, w, C] equirect."""
    from .envlight import env_image_dirs
    return sample_cubemap(cube, env_image_dirs(h, w, cube.device))


def cubemap_mip(cube):
    """2x2 box downsample of every face."""
    c = cube
    return 0.25 * (c[:, 0::2, 0::2] + c[:, 0::2, 1::2]
                   + c[:, 1::2, 0::2] + c[:, 1::2, 1::2])


def _texel_solid_angles(res: int, device=None):
    """[6, res, res] solid angle of each cubemap texel."""
    g = _grid(res, device)
    v, u = torch.meshgrid(g, g, indexing="ij")
    r2 = 1.0 + u * u + v * v
    w = 4.0 / (res * res) / (r2 * torch.sqrt(r2))
    return w.expand(6, res, res)


def diffuse_cubemap(cube, res: int | None = None):
    """Cosine convolution over the source texels with solid-angle weights:
    out(n) = Σ max(n·d, 0)·w·L / Σ max(n·d, 0)·w (one dense product)."""
    out_res = res or cube.shape[1]
    dirs_src = _face_dirs(cube.shape[1], cube.device).reshape(-1, 3)
    w_src = _texel_solid_angles(cube.shape[1], cube.device).reshape(-1)
    dirs_out = _face_dirs(out_res, cube.device).reshape(-1, 3)
    cos = maximum(dirs_out @ dirs_src.T, 0.0) * w_src[None]
    denom = torch.sum(cos, dim=-1, keepdim=True)
    out = (cos @ cube.reshape(-1, cube.shape[-1])) / maximum(denom, 1e-12)
    return out.reshape(6, out_res, out_res, cube.shape[-1])


def _radical_inverse(n: int, device=None):
    """Van der Corput radical inverse of 0..n-1 in base 2 (the uint32 bit
    reversal, done in int64 and masked), as float32."""
    bits = torch.arange(n, dtype=torch.int64, device=device)
    m = 0xFFFFFFFF
    bits = ((bits << 16) | (bits >> 16)) & m
    for mask, sh in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4),
                     (0x00FF00FF, 8)):
        bits = (((bits & mask) << sh) | ((bits & (mask << sh)) >> sh)) & m
    return bits.to(torch.float32) * 2.3283064365386963e-10


def _hammersley(n: int, device=None):
    i = torch.arange(n, dtype=torch.float32, device=device)
    return i / n, _radical_inverse(n, device)


def specular_cubemap(cube, roughness: float, cutoff: float = 0.99,
                     samples: int = 128):
    """GGX prefilter at `roughness`: the split-sum importance-sampled
    estimator (Hammersley half vectors around n = v = r, NdotL-weighted),
    over 4096 output texels at a time. `cutoff` is the reference's argument
    and, as there, unused by this estimator."""
    res = cube.shape[1]
    dev = cube.device
    dirs = _face_dirs(res, dev).reshape(-1, 3)
    alpha = max(roughness * roughness, 1e-4)
    xi1, xi2 = _hammersley(samples, dev)
    phi = 2.0 * math.pi * xi1
    ct = torch.sqrt((1.0 - xi2) / (1.0 + (alpha * alpha - 1.0) * xi2))
    st = torch.sqrt(maximum(1.0 - ct * ct, 0.0))
    h_local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    up = torch.where(dirs[:, 2:3].abs() < 0.999,
                     torch.tensor([[0.0, 0.0, 1.0]], device=dev),
                     torch.tensor([[1.0, 0.0, 0.0]], device=dev))
    t = safe_normalize(torch.linalg.cross(up, dirs, dim=-1))
    b = torch.linalg.cross(dirs, t, dim=-1)
    outs = []
    for a in range(0, dirs.shape[0], 4096):
        n, t_, b_ = dirs[a:a + 4096], t[a:a + 4096], b[a:a + 4096]
        h = (h_local[None, :, 0:1] * t_[:, None]
             + h_local[None, :, 1:2] * b_[:, None]
             + h_local[None, :, 2:3] * n[:, None])
        l = 2.0 * torch.sum(n[:, None] * h, -1, keepdim=True) * h - n[:, None]
        nl = maximum(torch.sum(n[:, None] * l, -1), 0.0)
        vals = sample_cubemap(cube, l)
        num = torch.sum(vals * nl[..., None], dim=1)
        den = maximum(torch.sum(nl, dim=1), 1e-6)[..., None]
        outs.append(num / den)
    return torch.cat(outs).reshape(6, res, res, cube.shape[-1])


def build_specular_mips(base_cube, min_res: int = 16,
                        min_roughness: float = 0.08, max_roughness: float = 0.5,
                        cutoff: float = 0.99):
    """Mip chain by 2x2 box, each level GGX-filtered at its roughness, and a
    diffuse map from the smallest level (≙ EnvLight.build_mips)."""
    chain = [base_cube]
    while chain[-1].shape[1] > min_res:
        chain.append(cubemap_mip(chain[-1]))
    diffuse = seam_blend(diffuse_cubemap(chain[-1]))
    n = len(chain)
    specular = []
    for i, c in enumerate(chain[:-1]):
        rough = (i / max(n - 2, 1)) * (max_roughness - min_roughness) \
            + min_roughness
        samples = int(min(256, max(16, 256 * rough * rough)))
        specular.append(seam_blend(specular_cubemap(c, rough, cutoff,
                                                     samples=samples)))
    specular.append(seam_blend(specular_cubemap(chain[-1], 1.0, cutoff,
                                                samples=256)))
    return specular, diffuse


def roughness_to_mip(roughness, n_mips: int, min_roughness: float = 0.08,
                     max_roughness: float = 0.5):
    """≙ EnvLight.get_mip."""
    return torch.where(
        roughness < max_roughness,
        (clip(roughness, min_roughness, max_roughness) - min_roughness)
        / (max_roughness - min_roughness) * (n_mips - 2),
        (clip(roughness, max_roughness, 1.0) - max_roughness)
        / (1.0 - max_roughness) + n_mips - 2)


def compute_fg_lut(res: int = 256, samples: int = 8192, device=None):
    """Split-sum environment BRDF (scale, bias) over (roughness, NdotV):
    GGX importance sampling with the height-correlated Smith term,
    [res (roughness), res (NdotV), 2]. One roughness row at a time, as
    much as 2^22 sample terms a call (at the default size a whole table's
    intermediates would take 2 GB each)."""
    nv = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    rough = nv.clone()
    i = torch.arange(samples, dtype=torch.float32, device=device)
    xi2 = _radical_inverse(samples, device)
    xi1 = (i + 0.5) / samples
    phi = 2 * math.pi * xi1

    def lam(c, a2):  # Smith Lambda for GGX
        c = clip(c, 1e-7, 1.0)
        t2 = (1.0 - c * c) / (c * c)
        return 0.5 * (torch.sqrt(1.0 + a2 * t2) - 1.0)

    rows_per = max(1, (1 << 22) // (res * samples))
    out = []
    for r0 in range(0, res, rows_per):
        r = rough[r0:r0 + rows_per][:, None, None]          # [R, 1, 1]
        n = nv[None, :, None]                               # [1, res, 1]
        a = maximum(r * r, 1e-4)
        a2 = a * a
        ct = torch.sqrt((1 - xi2) / (1 + (a2 - 1) * xi2))  # [R, 1, S]
        st = torch.sqrt(maximum(1 - ct * ct, 0.0))
        hx, hy, hz = st * torch.cos(phi), st * torch.sin(phi), ct
        vx = torch.sqrt(1 - n ** 2)
        vdoth = vx * hx + n * hz                            # v = (vx, 0, n)
        lz = 2 * vdoth * hz - n
        nl = maximum(lz, 0.0)
        nh = maximum(hz, 0.0)
        vh = maximum(vdoth, 0.0)
        g = 1.0 / (1.0 + lam(n, a2) + lam(nl, a2))
        g_vis = torch.where(nl > 0, g * vh / maximum(nh * n, 1e-6),
                            torch.zeros_like(g))
        fc = torch.pow(1 - vh, 5.0)
        out.append(torch.stack([torch.mean((1 - fc) * g_vis, -1),
                                torch.mean(fc * g_vis, -1)], -1))
    return torch.cat(out)


def sample_fg_lut(lut, ndotv, roughness):
    """Bilinear fetch of the FG table at uv = (NdotV, roughness) in [0, 1]."""
    res = lut.shape[0]
    u = clip(ndotv[..., 0], 0.0, 1.0) * res - 0.5
    v = clip(roughness[..., 0], 0.0, 1.0) * res - 0.5
    x0 = torch.clamp(torch.floor(u).long(), 0, res - 1)
    y0 = torch.clamp(torch.floor(v).long(), 0, res - 1)
    x1 = torch.clamp(x0 + 1, 0, res - 1)
    y1 = torch.clamp(y0 + 1, 0, res - 1)
    fu = clip(u - x0, 0, 1)[..., None]
    fv = clip(v - y0, 0, 1)[..., None]
    c00 = lut[y0, x0]
    c01 = lut[y0, x1]
    c10 = lut[y1, x0]
    c11 = lut[y1, x1]
    return (c00 * (1 - fu) + c01 * fu) * (1 - fv) + (c10 * (1 - fu) + c11 * fu) * fv
