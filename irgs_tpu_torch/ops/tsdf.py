"""TSDF fusion, SDF ray marching and mesh extraction (≙ irgs_tpu/ops/tsdf.py).

A dense bounded voxel grid: `integrate` fuses one depth map by projecting
every voxel into it (no scatter); `ray_march_visibility` marches rays
through the fused TSDF at one-voxel strides and reports whether they cross
the surface before t_max (≙ the reference's mesh ray caster for reflection
visibility, refl_utils.py:82-96). Nothing is differentiated through either
(the march yields a discrete `visible`), so both run without autograd.

Mesh artifacts: `extract_mesh` runs marching tetrahedra over a volume on the
volume's device, with the JAX package's dtypes (corner positions and
vertices in float64, the interpolation weight in float32) and its triangle
order; `extract_mesh_unbounded` fuses the views' depths on a contracted grid
slab by slab and meshes it. The weld (`merge_vertices`), the floater
clean-up (`post_process_mesh`, scipy's connected components) and the
Möller–Trumbore oracle `ray_triangle_intersect` run on the host in numpy,
as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# ---------------------------------------------------------------------------
# marching tetrahedra mesh extraction
# ---------------------------------------------------------------------------

# six tetrahedra per cube (corner indices into the 8 cube corners)
_TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
         (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))
_CUBE = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
# a tetrahedron's corners other than each apex, ascending
_OTHERS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _edge_point(tv, tp, a, b, level):
    """The crossing of `level` on the edge a -> b of each tetrahedron
    (a, b [m] corner indices; tv [m, 4] values, tp [m, 4, 3] float64
    positions): the weight in float32, the point in float64, as the
    reference's numpy computes them."""
    va = tv.gather(1, a[:, None])
    vb = tv.gather(1, b[:, None])
    d = vb - va
    t = torch.clamp((level - va) / torch.where(d.abs() < 1e-12, 1e-12, d),
                    0, 1)
    pa = tp[torch.arange(tp.shape[0], device=tp.device), a]
    pb = tp[torch.arange(tp.shape[0], device=tp.device), b]
    return pa * (1 - t).double() + pb * t.double()


@torch.no_grad()
def extract_mesh(vol: TSDFVolume, level: float = 0.0,
                 weight_min: float = 1.0):
    """Triangle soup at the TSDF's `level` set by marching tetrahedra, on the
    volume's device (≙ irgs_tpu extract_mesh, :142) -> (verts [3F, 3]
    float32, faces [F, 3] int32). Triangles come in the reference's order:
    by tetrahedron of `_TETS`, then the cases one corner inside, three
    inside, two inside (two triangles a quad, all first halves first), then
    the cubes in C order over [z, y, x]."""
    dev = vol.tsdf.device
    n = vol.tsdf.shape[0] - 1
    vals = torch.where(vol.weight >= weight_min, vol.tsdf,
                       torch.ones_like(vol.tsdf))
    # cubes with a sign change, from the corners' shifted views of the grid
    inside = sum((vals[dz:dz + n, dy:dy + n, dx:dx + n] < level).to(torch.int8)
                 for dx, dy, dz in _CUBE)
    active = (inside > 0) & (inside < 8)
    corners = (active.nonzero().flip(1)[:, None, :]
               + torch.tensor(_CUBE, device=dev)[None])        # [M, 8, xyz]
    cv = vals[corners[..., 2], corners[..., 1], corners[..., 0]]
    voxel = float(vol.voxel)
    corner_pos = (corners.double() * voxel + vol.origin.double()
                  + 0.5 * voxel)
    others = torch.tensor(_OTHERS, device=dev)
    tris = []
    for tet in _TETS:
        tv, tp = cv[:, tet], corner_pos[:, tet]
        neg = tv < level
        for inside_count in (1, 3, 2):
            if inside_count == 2:
                rows = (neg.sum(-1) == 2).nonzero()[:, 0]
                if rows.numel() == 0:
                    continue
                negr, rv, rp = neg[rows], tv[rows], tp[rows]
                # the two inside and the two outside corners, ascending
                ins = torch.argsort((~negr).to(torch.int8), stable=True,
                                    dim=-1)[:, :2]
                outs = torch.argsort(negr.to(torch.int8), stable=True,
                                     dim=-1)[:, :2]
                p00, p01, p10, p11 = (
                    _edge_point(rv, rp, ins[:, i], outs[:, o], level)
                    for i, o in ((0, 0), (0, 1), (1, 0), (1, 1)))
                tris += [torch.stack([p00, p01, p11], 1),
                         torch.stack([p00, p11, p10], 1)]
            else:
                want = neg if inside_count == 1 else ~neg
                rows = (want.sum(-1) == 1).nonzero()[:, 0]
                if rows.numel() == 0:
                    continue
                rv, rp = tv[rows], tp[rows]
                # argmax takes the first True, as numpy's does
                apex = torch.argmax(want[rows].to(torch.int32), -1)
                tris.append(torch.stack(
                    [_edge_point(rv, rp, apex, others[apex, k], level)
                     for k in range(3)], 1))
    if not tris:
        return (torch.zeros((0, 3), device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    verts = torch.cat(tris).reshape(-1, 3).float()
    faces = torch.arange(verts.shape[0], dtype=torch.int32,
                         device=dev).reshape(-1, 3)
    return verts, faces


# ---------------------------------------------------------------------------
# unbounded (contracted) extraction + mesh post-processing
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """a·b + c rounded once (in float64, then to float32): the reference's
    XLA CPU code contracts such expressions into fused multiply-adds, and a
    rounding apart moves a depth sample across a silhouette edge."""
    return (a.double() * b.double() + c.double()).float()


def _norm(x):
    """|x| over the last axis [..., 3] -> [..., 1], rounded as the
    reference's XLA CPU reduction: a multiply-add chain over x, y, z and a
    correctly rounded square root (taken in float64; torch's vectorised
    float32 sqrt on the CPU is not), the same bits on the card."""
    sq = _fma(x[..., 2:3], x[..., 2:3],
              _fma(x[..., 1:2], x[..., 1:2], x[..., 0:1] * x[..., 0:1]))
    return torch.sqrt(sq.double()).float()


def contract(x):
    """Mip-NeRF-360 scene contraction (≙ irgs_tpu contract, :249)."""
    mag = _norm(x)
    safe = torch.clamp(mag, min=1e-9)
    return torch.where(mag < 1, x, (2.0 - 1.0 / safe) * (x / safe))


def uncontract(y):
    """Inverse contraction (≙ irgs_tpu uncontract, :256)."""
    mag = _norm(y)
    return torch.where(mag < 1, y, 1.0 / torch.clamp(2.0 - mag, min=1e-2)
                       * (y / torch.clamp(mag, min=1e-9)))


def _sample_depth_bilinear(depthmap, pix, h, w):
    """Bilinear sample of a [H, W] map at NDC coordinates pix [..., 2] in
    [-1, 1], border padding, corners aligned (≙ irgs_tpu
    _sample_depth_bilinear, :263)."""
    u = torch.clamp((pix[..., 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1.0)
    v = torch.clamp((pix[..., 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1.0)
    u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, w - 2).long()
    v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, h - 2).long()
    fu = u - u0
    fv = v - v0
    top = _fma(depthmap[v0, u0 + 1], fu, depthmap[v0, u0] * (1 - fu))
    bottom = _fma(depthmap[v0 + 1, u0 + 1], fu, depthmap[v0 + 1, u0] * (1 - fu))
    return _fma(top, 1 - fv, bottom * fv)


def _sdf_perframe(points, depthmap, full_proj):
    """Sampled depth minus view z at world points [N, 3], and whether the
    point projects inside the frame in front of the camera (≙ irgs_tpu
    _sdf_perframe, :283). full_proj: the [4, 4] world -> clip matrix."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    # hom @ full_proj.T as pairwise sums of the four products, which is how
    # the reference's XLA CPU dot rounds it: the same bits, on the card as
    # on the CPU (a matmul's other rounding moves a sample across a depth
    # edge)
    prod = hom[..., None, :] * full_proj
    clip = (prod[..., 0] + prod[..., 1]) + (prod[..., 2] + prod[..., 3])
    z = clip[..., 3:4]
    pix = clip[..., :2] / torch.clamp(z, min=1e-9)
    mask = torch.all((pix > -1.0) & (pix < 1.0), -1) & (z[..., 0] > 0)
    h, w = depthmap.shape
    return _sample_depth_bilinear(depthmap, pix, h, w) - z[..., 0], mask


@torch.no_grad()
def fuse_unbounded_tsdf(samples_contracted, depths, full_projs, center,
                        radius, voxel_size):
    """TSDF at contracted-space samples [M, 3], fused over the views' depths
    [V, H, W] (full_projs [V, 4, 4]) as a running mean from tsdf 1, weight 1,
    with the truncation widening outside the unit ball (≙ irgs_tpu
    fuse_unbounded_tsdf, :298) -> (tsdf [M], weight [M])."""
    f32 = dict(dtype=torch.float32, device=samples_contracted.device)
    voxel_size = torch.as_tensor(voxel_size, **f32)
    radius = torch.as_tensor(radius, **f32)
    center = torch.as_tensor(center, **f32)
    mag = _norm(samples_contracted)[..., 0]
    sdf_trunc = 5.0 * voxel_size * torch.where(
        mag > 1, 1.0 / (2.0 - torch.clamp(mag, max=1.9)),
        torch.ones_like(mag))
    world = _fma(uncontract(samples_contracted), radius, center)
    tsdfs = torch.ones_like(mag)
    weights = torch.ones_like(mag)
    for depth, proj in zip(depths, full_projs):
        sdf, mask = _sdf_perframe(world, depth, proj)
        mask = mask & (sdf > -sdf_trunc)
        sdf_n = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
        wp = weights + 1.0
        tsdfs = torch.where(mask, _fma(tsdfs, weights, sdf_n) / wp, tsdfs)
        weights = torch.where(mask, wp, weights)
    return tsdfs, weights


# points fused a call by extract_mesh_unbounded (whole z slabs of the grid)
SLAB_POINTS = 2 ** 21


@torch.no_grad()
def extract_mesh_unbounded(depths, full_projs, xyz, center, radius,
                           resolution: int = 256):
    """Marching tetrahedra on a contracted grid (≙ irgs_tpu
    extract_mesh_unbounded, :328): the grid spans the 95th percentile of the
    Gaussian centres' contracted radius (+0.01, at most 1.9), is fused from
    depths [V, H, W] (full_projs [V, 4, 4]) in slabs of about SLAB_POINTS
    points on their device, and its vertices map back to world space,
    clipped to ±32 -> (verts [V', 3] float32, faces [F, 3] int32).

    The percentile and the grid axis are the reference's numpy float64
    computations; its grid origin is -R - voxel_size / 2 with voxel_size =
    2 / resolution, while its spacing is 2R / (resolution - 1), kept so."""
    dev = depths.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    voxel_size = 2.0 / resolution
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
    # divided by a tensor on the device: CUDA divides by a host scalar as a
    # product with its reciprocal, which rounds apart
    radius_t = torch.tensor(radius, dtype=torch.float32, device=dev)
    rmag = _norm(contract((xyz - center) / radius_t))[..., 0]
    R = min(float(np.quantile(rmag.cpu().numpy(), 0.95)) + 0.01, 1.9)

    res = resolution
    axis = torch.from_numpy(np.linspace(-R, R, res, dtype=np.float32)).to(dev)
    tsdf = torch.empty((res, res, res), dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(axis, axis, indexing="ij")
    nz = max(1, SLAB_POINTS // (res * res))
    for z0 in range(0, res, nz):
        zs = axis[z0:z0 + nz]
        pts = torch.stack([xx.expand(len(zs), res, res),
                           yy.expand(len(zs), res, res),
                           zs[:, None, None].expand(len(zs), res, res)], -1)
        tsdf[z0:z0 + nz] = fuse_unbounded_tsdf(
            pts.reshape(-1, 3), depths, full_projs, center, radius,
            voxel_size)[0].reshape(len(zs), res, res)

    vol = TSDFVolume(
        tsdf=tsdf,
        weight=torch.full((), 2.0, device=dev).expand(res, res, res),
        origin=torch.tensor([-R - voxel_size * 0.5] * 3, dtype=torch.float32,
                            device=dev),
        voxel=torch.tensor((2 * R) / (res - 1), dtype=torch.float32,
                           device=dev))
    verts_c, faces = extract_mesh(vol, level=0.0, weight_min=1.0)
    if verts_c.shape[0] == 0:
        return verts_c, faces
    world = uncontract(verts_c) * radius + center
    return torch.clamp(world, -32.0, 32.0), faces


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def merge_vertices(verts, faces, digits: int = 6):
    """Weld vertices equal to `digits` decimals and drop the triangles that
    collapse (≙ irgs_tpu merge_vertices, :375; trimesh's
    merge_vertices(digits_vertex=6)). numpy on the host; takes numpy arrays
    or tensors -> numpy (verts float32, faces int32)."""
    verts, faces = _host(verts), _host(faces)
    key = np.round(verts, digits)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    new_faces = inv[faces]
    ok = ((new_faces[:, 0] != new_faces[:, 1])
          & (new_faces[:, 1] != new_faces[:, 2])
          & (new_faces[:, 0] != new_faces[:, 2]))
    return uniq.astype(np.float32), new_faces[ok].astype(np.int32)


def post_process_mesh(verts, faces, cluster_to_keep: int = 1000):
    """Weld, then keep the connected clusters of at least as many triangles
    as the `cluster_to_keep`-th largest (floor 50), dropping floaters
    (≙ irgs_tpu post_process_mesh, :388). numpy and scipy on the host."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    verts, faces = merge_vertices(verts, faces)
    if len(faces) == 0:
        return verts, faces
    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    tri_label = labels[faces[:, 0]]
    sizes = np.bincount(tri_label)
    order = np.sort(sizes)
    thresh = order[-cluster_to_keep] if len(order) >= cluster_to_keep else 0
    thresh = max(thresh, 50)
    faces = faces[sizes[tri_label] >= thresh]
    used = np.unique(faces)
    remap = np.full(n, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces].astype(np.int32)


def ray_triangle_intersect(rays_o, rays_d, verts, faces, t_min: float = 1e-4):
    """Nearest Möller–Trumbore hit t of each ray on the mesh (inf = miss):
    the numpy test oracle of ray_march_visibility (≙ irgs_tpu
    ray_triangle_intersect, :417)."""
    rays_o, rays_d = _host(rays_o), _host(rays_d)
    verts, faces = _host(verts), _host(faces)
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    best = np.full(len(rays_o), np.inf, np.float64)
    for i in range(len(rays_o)):
        o, d = rays_o[i], rays_d[i]
        p = np.cross(d, e2)
        det = (e1 * p).sum(-1)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = o - v0
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1)
        v = (q * d[None]).sum(-1) * inv
        t = (e2 * q).sum(-1) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
        if hit.any():
            best[i] = t[hit].min()
    return best
