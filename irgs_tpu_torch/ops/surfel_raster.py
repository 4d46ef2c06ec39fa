"""Differentiable 2D-Gaussian-surfel rasterizer (≙ irgs_tpu/ops/surfel_raster.py
with its ``backend="pallas"`` path, :51-308 and :501-576).

1. ``preprocess`` — per-Gaussian splat->pixel transform M (rows Tu, Tv, Tw),
   AABB, projected center, SH->RGB, frustum cull.
2. ``bin_and_sort`` — duplicate-with-keys done gather-style (each duplicate
   slot finds its Gaussian by a search on the tiles-touched prefix sum),
   then one stable sort on a combined int64 (tile, depth) key. Capacity is
   static (`dup_capacity`); overflow is reported.
3. ``rasterize`` — K-aligned per-tile slab, the blend (``ops/raster_blend``:
   the CUDA kernels on the card, their plain version on the CPU), unpacking.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.cameras import CameraParams
from ..utils import sh as sh_utils
from ..utils.math3d import gather_rows, maximum, quat_to_rotmat
from . import raster_blend as rb

TILE = 16
TILE_PIX = TILE * TILE


class RasterOut(NamedTuple):
    color: torch.Tensor         # [H, W, 3] (bg composited with final T)
    feature: torch.Tensor       # [H, W, S]
    alpha: torch.Tensor         # [H, W] accumulated Σw
    depth: torch.Tensor         # [H, W] Σ w·z
    depth2: torch.Tensor        # [H, W] Σ w·z²
    depth_median: torch.Tensor  # [H, W] depth of the last splat with T_in > 0.5
    normal: torch.Tensor        # [H, W, 3] view-space Σ w·n
    distortion: torch.Tensor    # [H, W]
    radii: torch.Tensor         # [N] int32 screen radius (0 = culled)
    overflow: torch.Tensor      # scalar int: duplicates dropped by capacity


class Prep(NamedTuple):
    M: torch.Tensor         # [N, 3, 3] rows (Tu, Tv, Tw)
    center: torch.Tensor    # [N, 2]
    depth: torch.Tensor     # [N]
    normal: torch.Tensor    # [N, 3] view-space, camera-facing
    opacity: torch.Tensor   # [N]
    rgb: torch.Tensor       # [N, 3]
    radius: torch.Tensor    # [N] float
    rect_min: torch.Tensor  # [N, 2] int (tx, ty)
    rect_max: torch.Tensor  # [N, 2] int, exclusive
    valid: torch.Tensor     # [N] bool


def preprocess(means3d, scales, quats, opacities, shs, cam: CameraParams,
               img_w: int, img_h: int, active_sh_degree: int,
               means2d_offset=None, alive=None, colors_precomp=None) -> Prep:
    """Per-Gaussian screen-space setup (≙ irgs_tpu preprocess, :87). With
    `colors_precomp` [N, 3] the splats carry those colours, and the SH are
    not evaluated (nor differentiated)."""
    n = means3d.shape[0]
    grid_x = (img_w + TILE - 1) // TILE
    grid_y = (img_h + TILE - 1) // TILE

    hom = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)
    p_view = hom @ cam.w2c.T
    in_front = p_view[:, 2] > 0.2

    R = quat_to_rotmat(quats)
    tu = R[:, :, 0] * scales[:, 0:1]
    tv = R[:, :, 1] * scales[:, 1:2]
    tw = R[:, :, 2]

    pixmat = cam.pixmat(img_w, img_h)
    A3, b3 = pixmat[:, :3], pixmat[:, 3]
    M = torch.stack([tu @ A3.T, tv @ A3.T, means3d @ A3.T + b3], dim=-1)

    normal_view = tw @ cam.w2c[:3, :3].T
    cos = -torch.sum(p_view[:, :3] * normal_view, dim=-1)
    normal_view = torch.where((cos > 0)[:, None], normal_view, -normal_view)

    Tu, Tv, Tw = M[:, 0], M[:, 1], M[:, 2]
    temp = torch.tensor([9.0, 9.0, -1.0], dtype=means3d.dtype,
                        device=means3d.device)
    distance = torch.sum(Tw * Tw * temp, dim=-1)
    dist_ok = distance != 0.0
    f = temp / torch.where(dist_ok, distance, torch.ones_like(distance))[:, None]
    center = torch.stack([torch.sum(f * Tu * Tw, -1),
                          torch.sum(f * Tv * Tw, -1)], dim=-1)
    if means2d_offset is not None:
        center = center + means2d_offset
    temp2 = torch.stack([torch.sum(f * Tu * Tu, -1),
                         torch.sum(f * Tv * Tv, -1)], dim=-1)
    extent = torch.sqrt(maximum(center * center - temp2, 1e-4))
    radius = torch.ceil(torch.maximum(extent[:, 0], extent[:, 1]))

    c, r = center.detach(), radius.detach()
    tile_of = lambda x, hi: torch.clamp((x / TILE).to(torch.int32), 0, hi)
    rect_min = torch.stack([tile_of(c[:, 0] - r, grid_x),
                            tile_of(c[:, 1] - r, grid_y)], dim=-1)
    rect_max = torch.stack([tile_of(c[:, 0] + r + TILE - 1, grid_x),
                            tile_of(c[:, 1] + r + TILE - 1, grid_y)], dim=-1)
    area = ((rect_max[:, 0] - rect_min[:, 0])
            * (rect_max[:, 1] - rect_min[:, 1]))

    valid = in_front & dist_ok & (area > 0)
    if alive is not None:
        valid = valid & alive

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = means3d - cam.cam_pos
        dirs = dirs / maximum(torch.linalg.vector_norm(dirs, dim=-1,
                                                       keepdim=True), 1e-12)
        rgb = sh_utils.eval_sh_color(active_sh_degree, shs.transpose(-1, -2),
                                     dirs)

    return Prep(M=M, center=center, depth=p_view[:, 2], normal=normal_view,
                opacity=opacities.reshape(n), rgb=rgb,
                radius=torch.where(valid, radius, torch.zeros_like(radius)),
                rect_min=rect_min, rect_max=rect_max, valid=valid)


def float_to_sortable_int(x):
    """Positive finite floats: IEEE-754 bits increase with the value."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def rank_against_arange(sorted_vals, capacity: int):
    """result[j] = #{i: sorted_vals[i] <= j} for j in [0, capacity)
    (= searchsorted(sorted_vals, arange(capacity), side='right'))."""
    q = torch.arange(capacity, device=sorted_vals.device,
                     dtype=sorted_vals.dtype)
    return torch.searchsorted(sorted_vals.contiguous(), q, right=True)


def counts_by_id(ids, num_ids: int):
    """Histogram of int ids in [0, num_ids]; ids == num_ids are dropped."""
    return torch.bincount(ids.long(), minlength=num_ids + 1)[:num_ids]


class Binning(NamedTuple):
    sorted_gauss: torch.Tensor  # [B] int64 gaussian id per duplicate, sorted
    tile_start: torch.Tensor    # [T] int64
    tile_count: torch.Tensor    # [T] int64
    overflow: torch.Tensor      # scalar int64


def bin_and_sort(prep: Prep, grid_x: int, grid_y: int,
                 dup_capacity: int) -> Binning:
    """Duplicate-with-keys + sort (≙ irgs_tpu bin_and_sort, :196). The
    reference's two-key (tile_id, depth_bits) sort is one stable sort on
    tile_id·2^32 + depth_bits (depth_bits > 0, so the packing cannot wrap):
    equal-depth splats in a tile keep their duplicate-slot order."""
    n = prep.valid.shape[0]
    n_tiles = grid_x * grid_y
    w = (prep.rect_max[:, 0] - prep.rect_min[:, 0]).long()
    h = (prep.rect_max[:, 1] - prep.rect_min[:, 1]).long()
    touched = torch.where(prep.valid, w * h, torch.zeros_like(w))
    cum = torch.cumsum(touched, 0)
    total = cum[-1]
    offsets = cum - touched

    slots = torch.arange(dup_capacity, device=cum.device)
    gauss = torch.clamp(rank_against_arange(cum, dup_capacity), max=n - 1)
    local = slots - offsets[gauss]
    rw = torch.clamp(w[gauss], min=1)
    tx = prep.rect_min[gauss, 0].long() + local % rw
    ty = prep.rect_min[gauss, 1].long() + local // rw
    tile_id = torch.where(slots < total, ty * grid_x + tx,
                          torch.full_like(tx, n_tiles))

    depth = prep.depth.detach()[gauss]
    depth_bits = float_to_sortable_int(
        torch.maximum(depth, torch.full_like(depth, 1e-8))).long()
    key = tile_id * (1 << 32) + depth_bits
    order = torch.sort(key, stable=True).indices
    per_tile = counts_by_id(tile_id, n_tiles)
    return Binning(sorted_gauss=gauss[order],
                   tile_start=torch.cumsum(per_tile, 0) - per_tile,
                   tile_count=per_tile,
                   overflow=torch.clamp(total - dup_capacity, min=0))


def _to_image(x, grid_x, grid_y, img_w, img_h):
    """[T, 256, C] -> [H, W, C]."""
    c = x.shape[-1]
    img = x.reshape(grid_y, grid_x, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(grid_y * TILE, grid_x * TILE, c)[:img_h, :img_w]


def build_slab(prep: Prep, binning: Binning, features, grid_x: int,
               n_tiles: int, dup_capacity: int):
    """K-aligned per-tile segments (≙ surfel_raster.py:519-547): every
    backward chunk then belongs to exactly one tile. Returns
    (splat [F, B_pad], starts [T] int32, counts [T] int32)."""
    K = rb.K
    S = features.shape[-1]
    aligned = ((binning.tile_count + K - 1) // K) * K
    acum = torch.cumsum(aligned, 0)
    astart = acum - aligned
    b_pad = dup_capacity + n_tiles * K
    q = torch.arange(b_pad, device=acum.device)
    t_of_q = torch.clamp(rank_against_arange(acum, b_pad), max=n_tiles - 1)
    local = q - astart[t_of_q]
    src = torch.clamp(binning.tile_start[t_of_q] + local,
                      max=binning.sorted_gauss.shape[0] - 1)
    valid = local < binning.tile_count[t_of_q]
    padded_gauss = binning.sorted_gauss[src]

    n = prep.M.shape[0]
    table = torch.cat([prep.M.reshape(n, 9), prep.center,
                       prep.opacity[:, None], prep.rgb, features,
                       prep.normal], dim=-1)
    table = torch.nn.functional.pad(table, (0, rb.slab_width(S) - table.shape[1]))
    # the scatter of dslab back to the Gaussians is this gather's autograd
    splat = (gather_rows(table, padded_gauss)
             * valid[:, None].to(table.dtype)).T.contiguous()
    return splat, astart.to(torch.int32), aligned.to(torch.int32)


def rasterize(means3d, scales, quats, opacities, shs, features,
              means2d_offset, cam: CameraParams, bg_color, *, img_w: int,
              img_h: int, active_sh_degree: int, dup_capacity: int = 2 ** 21,
              alive=None, colors_precomp=None) -> RasterOut:
    """Differentiable surfel rasterization (≙ irgs_tpu rasterize with
    backend="pallas"). Runs on the device of its inputs. `colors_precomp`
    [N, 3] replaces the SH colours (stage 1's render_volume)."""
    grid_x = (img_w + TILE - 1) // TILE
    grid_y = (img_h + TILE - 1) // TILE
    n_tiles = grid_x * grid_y
    S = features.shape[-1]

    prep = preprocess(means3d, scales, quats, opacities, shs, cam, img_w,
                      img_h, active_sh_degree, means2d_offset=means2d_offset,
                      alive=alive, colors_precomp=colors_precomp)
    binning = bin_and_sort(prep, grid_x, grid_y, dup_capacity)
    splat, starts, counts = build_slab(prep, binning, features, grid_x,
                                       n_tiles, dup_capacity)
    tile_out = rb.blend_tiles(splat, starts, counts, grid_x, n_tiles, S)

    na, co = rb.n_attr(S), rb.c_out(S)
    img = _to_image(tile_out, grid_x, grid_y, img_w, img_h)
    color = img[..., 0:3] + img[..., co - 1:co] * bg_color
    return RasterOut(
        color=color, feature=img[..., 3:3 + S], alpha=img[..., na + 2],
        depth=img[..., na], depth2=img[..., na + 1],
        depth_median=img[..., na + 6], normal=img[..., 3 + S:6 + S],
        distortion=img[..., na + 5],
        radii=prep.radius.detach().to(torch.int32),
        overflow=binning.overflow)
