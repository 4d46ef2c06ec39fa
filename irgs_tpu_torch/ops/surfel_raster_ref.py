"""Brute-force per-pixel reference rasterizer, a test oracle
(≙ irgs_tpu/ops/surfel_raster_ref.py).

`rasterize_reference` evaluates every surfel at every pixel in global depth
order, with the same masks and blend semantics as the production
rasterizer, but with no binning, no per-tile sort and no blend kernel: it
shares only `surfel_raster.preprocess` and the rasterizer's constants with
the code it checks. O(H·W·N): tiny scenes only. `preprocess_reference`
re-derives what `preprocess` computes from first principles (numpy, one
surfel at a time), sharing none of its code.
"""

from __future__ import annotations

import numpy as np
import torch

from . import surfel_raster as sr

_C = sr.rb                      # the rasterizer's constants (raster_blend)


def _np64(x):
    return np.asarray(torch.as_tensor(x).detach().cpu(), np.float64)


def preprocess_reference(means3d, scales, quats, opacities, shs, cam,
                         img_w: int, img_h: int, active_sh_degree: int,
                         n_boundary: int = 4096):
    """Independent per-surfel preprocess oracle (numpy, looped; ≙ the JAX
    package's, :18).

    Re-derives what compute_transmat / compute_aabb / computeColorFromSH
    observably compute: the rotation by the outer-product-and-skew
    identity, the pixel projection from the focal lengths instead of the
    composed projection matrix, and the screen box by sampling the 3σ
    ellipse's boundary densely, so that a sign or convention slip in
    `sr.preprocess` cannot agree with itself here.

    Returns dict(M, center, extent, depth, normal, rgb) as float64 arrays:
    `center` is the midpoint of the sampled pixel extent per axis and
    `extent` its half-width.
    """
    means3d, scales, quats, shs = map(_np64, (means3d, scales, quats, shs))
    w2c, cam_pos = _np64(cam.w2c), _np64(cam.cam_pos)
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = (img_w - 1) / 2.0, (img_h - 1) / 2.0
    n = means3d.shape[0]

    def pix_lin(p):           # linear part of the pixel-homogeneous map
        return np.array([fx * p[0] + cx * p[2], fy * p[1] + cy * p[2], p[2]])

    theta = np.linspace(0.0, 2.0 * np.pi, n_boundary, endpoint=False)
    bu, bv = 3.0 * np.cos(theta), 3.0 * np.sin(theta)

    M = np.zeros((n, 3, 3))
    ctr_mid = np.zeros((n, 2))
    ext = np.zeros((n, 2))
    depth = np.zeros(n)
    normal = np.zeros((n, 3))
    rgb = np.zeros((n, 3))
    for i in range(n):
        q = quats[i] / np.linalg.norm(quats[i])
        w, v = q[0], q[1:]
        skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = (w * w - v @ v) * np.eye(3) + 2.0 * np.outer(v, v) + 2.0 * w * skew
        tu = scales[i, 0] * R[:, 0]
        tv = scales[i, 1] * R[:, 1]

        Rv, tcam = w2c[:3, :3], w2c[:3, 3]
        mean_v = Rv @ means3d[i] + tcam
        tu_v, tv_v = Rv @ tu, Rv @ tv
        Lu, Lv, Lc = pix_lin(tu_v), pix_lin(tv_v), pix_lin(mean_v)
        # row r of M: the coefficients of pixel-homogeneous coordinate r
        # over (u, v, 1)
        M[i] = np.stack([np.stack([Lu[r], Lv[r], Lc[r]]) for r in range(3)])

        # the 3σ disk's boundary, projected: [2, n_boundary]
        hom = (np.outer(Lu, bu) + np.outer(Lv, bv) + Lc[:, None])
        pix = hom[:2] / hom[2:3]
        ctr_mid[i] = (pix.max(axis=1) + pix.min(axis=1)) / 2.0
        ext[i] = (pix.max(axis=1) - pix.min(axis=1)) / 2.0

        depth[i] = mean_v[2]
        nrm_v = Rv @ R[:, 2]
        normal[i] = nrm_v if -(mean_v @ nrm_v) > 0 else -nrm_v

        # SH -> RGB: the real spherical harmonics written out from the
        # standard table (not utils/sh.py's code)
        d = means3d[i] - cam_pos
        d = d / np.linalg.norm(d)
        x, y, z = d
        basis = [0.28209479177387814]
        if active_sh_degree >= 1:
            basis += [-0.4886025119029199 * y, 0.4886025119029199 * z,
                      -0.4886025119029199 * x]
        if active_sh_degree >= 2:
            basis += [1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
                      0.31539156525252005 * (2 * z * z - x * x - y * y),
                      -1.0925484305920792 * x * z,
                      0.5462742152960396 * (x * x - y * y)]
        if active_sh_degree >= 3:
            basis += [-0.5900435899266435 * y * (3 * x * x - y * y),
                      2.890611442640554 * x * y * z,
                      -0.4570457994644658 * y * (4 * z * z - x * x - y * y),
                      0.3731763325901154 * z * (2 * z * z - 3 * x * x - 3 * y * y),
                      -0.4570457994644658 * x * (4 * z * z - x * x - y * y),
                      1.445305721320277 * z * (x * x - y * y),
                      -0.5900435899266435 * x * (x * x - 3 * y * y)]
        if active_sh_degree >= 4:
            xx, yy, zz = x * x, y * y, z * z
            basis += [2.5033429417967046 * x * y * (xx - yy),
                      -1.7701307697799304 * y * z * (3 * xx - yy),
                      0.9461746957575601 * x * y * (7 * zz - 1),
                      -0.6690465435572892 * y * z * (7 * zz - 3),
                      0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
                      -0.6690465435572892 * x * z * (7 * zz - 3),
                      0.47308734787878004 * (xx - yy) * (7 * zz - 1),
                      -1.7701307697799304 * x * z * (xx - 3 * yy),
                      0.6258357354491761 * (xx * (xx - 3 * yy)
                                            - yy * (3 * xx - yy))]
        rgb[i] = np.maximum(
            np.asarray(basis) @ shs[i, :len(basis)] + 0.5, 0.0)

    return dict(M=M, center=ctr_mid, extent=ext, depth=depth, normal=normal,
                rgb=rgb)


def rasterize_reference(means3d, scales, quats, opacities, shs, features,
                        cam, bg_color, *, img_w, img_h, active_sh_degree,
                        alive=None, means2d_offset=None) -> sr.RasterOut:
    """Every surfel at every pixel in global depth order (≙ the JAX
    package's, :112). Differentiable by autograd; runs on the device of its
    inputs."""
    prep = sr.preprocess(means3d, scales, quats, opacities, shs, cam,
                         img_w, img_h, active_sh_degree,
                         means2d_offset=means2d_offset, alive=alive)
    n = means3d.shape[0]
    dev = means3d.device
    order = torch.argsort(prep.depth.detach(), stable=True)

    M = prep.M[order]
    center = prep.center[order]
    opa = torch.where(prep.valid, prep.opacity,
                      torch.zeros_like(prep.opacity))[order]
    rgb = prep.rgb[order]
    feat = features[order]
    normal = prep.normal[order]
    rect_min = prep.rect_min[order]
    rect_max = prep.rect_max[order]

    px = torch.arange(img_w, dtype=torch.float32, device=dev)[None, :].repeat(
        img_h, 1).reshape(-1)
    py = torch.arange(img_h, dtype=torch.float32, device=dev)[:, None].repeat(
        1, img_w).reshape(-1)
    tx = torch.div(px, sr.TILE, rounding_mode="floor").to(torch.int32)
    ty = torch.div(py, sr.TILE, rounding_mode="floor").to(torch.int32)

    # [P, N] pairwise
    Tu, Tv, Tw = M[:, 0], M[:, 1], M[:, 2]
    k = px[:, None, None] * Tw[None] - Tu[None]
    l = py[:, None, None] * Tw[None] - Tv[None]
    p = torch.linalg.cross(k, l, dim=-1)
    pz = p[..., 2]
    pz_safe = torch.where(pz == 0, torch.ones_like(pz), pz)
    sx, sy = p[..., 0] / pz_safe, p[..., 1] / pz_safe
    rho3d = sx * sx + sy * sy
    dx = center[None, :, 0] - px[:, None]
    dy = center[None, :, 1] - py[:, None]
    rho2d = _C.FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(rho3d <= rho2d,
                        sx * Tw[None, :, 0] + sy * Tw[None, :, 1]
                        + Tw[None, :, 2],
                        Tw[None, :, 2].expand_as(sx))

    in_rect = ((tx[:, None] >= rect_min[None, :, 0])
               & (tx[:, None] < rect_max[None, :, 0])
               & (ty[:, None] >= rect_min[None, :, 1])
               & (ty[:, None] < rect_max[None, :, 1]))
    alpha = torch.clamp(opa[None, :] * torch.exp(-0.5 * rho), max=0.99)
    bad = ((pz == 0) | (depth < _C.NEAR_N) | (alpha < _C.ALPHA_EPS)
           | ~in_rect)
    alpha = torch.where(bad, torch.zeros_like(alpha), alpha)

    lg = torch.log1p(-alpha)
    T = torch.exp(torch.cumsum(lg, dim=1) - lg)           # incoming T
    w = alpha * T
    w = torch.where(T * (1 - alpha) < _C.T_DONE, torch.zeros_like(w), w)

    # median depth: the last contributing splat with incoming T > 0.5, found
    # by a masked max over the depth-order index
    mmask = (w > 0) & (T > 0.5)
    ordi = torch.arange(n, dtype=torch.float32, device=dev)[None].expand_as(w)
    mord = torch.where(mmask, ordi, torch.full_like(ordi, -1.0)).amax(dim=1)
    dmed = torch.where(mmask & (ordi == mord[:, None]), depth,
                       torch.zeros_like(depth)).sum(dim=1)

    color = w @ rgb
    feature = w @ feat
    nrm = w @ normal
    a = w.sum(dim=1)
    d = (w * depth).sum(dim=1)
    d2 = (w * depth * depth).sum(dim=1)

    m = _C.FAR_N / (_C.FAR_N - _C.NEAR_N) * (
        1 - _C.NEAR_N / torch.clamp(depth, min=1e-6))
    mw, m2w = m * w, m * m * w
    A = torch.cumsum(w, 1) - w
    M1 = torch.cumsum(mw, 1) - mw
    M2 = torch.cumsum(m2w, 1) - m2w
    dist = (m * m * w * A + w * M2 - 2 * m * w * M1).sum(dim=1)

    color = color + (1 - a)[:, None] * bg_color[None]

    def img(x):
        return (x.reshape(img_h, img_w, -1) if x.dim() == 2
                else x.reshape(img_h, img_w))

    return sr.RasterOut(
        color=img(color), feature=img(feature), alpha=img(a),
        depth=img(d), depth2=img(d2), depth_median=img(dmed),
        normal=img(nrm), distortion=img(dist),
        radii=prep.radius.detach().to(torch.int32),
        overflow=torch.zeros((), dtype=torch.int64, device=dev))
