"""Differentiable 2D-Gaussian-surfel ray tracer (≙ irgs_tpu/ops/grid_tracer.py).

A uniform voxel grid over per-Gaussian bounding spheres (disk-slab insertion),
a loop-free DDA that records each ray's visited cells, a hit selection that
keeps each ray's nearest `hit_budget` hits, and a differentiable
front-to-back blend of the selected hits. Segmented re-trace rounds extend
rays whose hit list was truncated while still transmissive, with the carried
transmittance differentiable.

Cell collection and hit selection are index-only: they run under
``torch.no_grad()`` on detached inputs (≙ stop_gradient in the reference);
only ``blend_hits`` and the carried T are differentiated.

Every option of the reference's `TracerConfig` is ported. Cell collection
hands the select every visited segment (``tiled_direct``) or packs the first
`max_cells` non-empty ones. The select is tiled (`select_tiles` > 0: whole
tile rows of a pair-ordered candidate table, f32 or with `table_bf16` bf16,
dedup by hit cell, optionally ordered as `select_topk`) or per candidate
(`select_tiles` == 0, the default: candidates expanded from the recorded
cells, optionally screened first by the two-tier prefilter). Re-trace rounds
are unrolled (with the `adaptive` capacity ladder) or, with
`retrace_while`, iterative deepening, forward only. The exact oversize merge
(`oversize_cap` > 0) depth-merges the widest Gaussians, kept out of the
grid, into every hit list. On the card the tiled select fetches its table
rows with the row-gather kernel of ops/gather_rows.py; `pallas_gather`, the
JAX package's switch for its Pallas gather, is kept as a config field and
changes nothing here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..utils import sh as sh_utils
from ..utils.math3d import gather_rows_many, maximum, minimum
from .gather_rows import gather_rows as gather_rows_kernel

INF = 1e16


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    """Same fields and defaults as irgs_tpu's TracerConfig (:63-257)."""
    grid_res: int = 64
    pair_capacity: int = 2 ** 21
    max_cells: int = 12
    max_hits: int = 48
    prefilter_width: int = 0
    hit_budget: int = 16
    max_crossings: int = 0
    span_cap: int = 6
    oversize_cap: int = 0
    select_tiles: int = 0
    tile: int = 16
    retrace_select_tiles: int = 0
    select_topk: bool = False
    pallas_gather: int = 0
    table_bf16: bool = False
    tiled_direct: bool = False
    coarse_scan: bool = True
    transmittance_min: float = 0.03
    alpha_min: float = 1.0 / 255.0
    n_segments: int = 1
    retrace_frac: float = 0.25
    retrace_max_cells: int = 0
    retrace_max_hits: int = 0
    retrace_prefilter_width: int = 0
    retrace_hit_budget: int = 0
    retrace_max_crossings: int = -1
    retrace_decay: float = 1.0
    adaptive: bool = False
    retrace_while: bool = False
    retrace_bulk: int = 2
    retrace_tail_frac: float = 0.02

    def round_capacity(self, n_rays: int, rnd: int) -> int:
        frac = self.retrace_frac * (self.retrace_decay ** rnd)
        return max(1, min(n_rays, int(n_rays * frac)))

    def retrace_cfg(self) -> "TracerConfig":
        return dataclasses.replace(
            self,
            max_cells=self.retrace_max_cells or self.max_cells,
            max_hits=self.retrace_max_hits or self.max_hits,
            prefilter_width=(self.retrace_prefilter_width
                             or self.prefilter_width),
            select_tiles=self.retrace_select_tiles or self.select_tiles,
            hit_budget=self.retrace_hit_budget or self.hit_budget,
            max_crossings=(self.max_crossings if self.retrace_max_crossings < 0
                           else self.retrace_max_crossings))

    @classmethod
    def from_pipe(cls, pipe, eval: bool = False) -> "TracerConfig":
        """The training or (with `eval`) eval budgets of a PipelineConfig
        (config.py), as irgs_tpu's from_pipe (:202-257)."""
        if eval:
            return cls(
                grid_res=pipe.tracer_grid_res,
                max_cells=pipe.tracer_max_cells_eval,
                max_hits=pipe.tracer_max_hits_eval,
                prefilter_width=pipe.tracer_prefilter_width_eval,
                retrace_prefilter_width=pipe.tracer_retrace_prefilter_width_eval,
                select_tiles=pipe.tracer_select_tiles_eval,
                retrace_select_tiles=pipe.tracer_retrace_select_tiles_eval,
                tile=pipe.tracer_tile,
                tiled_direct=pipe.tracer_tiled_direct,
                hit_budget=pipe.tracer_hit_budget_eval,
                max_crossings=pipe.tracer_max_crossings_eval,
                n_segments=pipe.tracer_n_segments_eval,
                retrace_frac=pipe.tracer_retrace_frac_eval,
                retrace_decay=pipe.tracer_retrace_decay_eval,
                retrace_while=pipe.tracer_retrace_while_eval,
                retrace_bulk=pipe.tracer_retrace_bulk_eval,
                retrace_tail_frac=pipe.tracer_retrace_tail_frac_eval,
                retrace_max_cells=pipe.tracer_retrace_max_cells_eval,
                retrace_max_hits=pipe.tracer_retrace_max_hits_eval,
                retrace_hit_budget=pipe.tracer_retrace_hit_budget_eval,
                retrace_max_crossings=pipe.tracer_retrace_max_crossings_eval,
                table_bf16=pipe.tracer_table_bf16_eval,
                select_topk=pipe.tracer_select_topk_eval,
                adaptive=pipe.tracer_adaptive_eval,
                oversize_cap=pipe.tracer_oversize_cap,
                transmittance_min=pipe.transmittance_min,
                alpha_min=pipe.alpha_min)
        return cls(
            grid_res=pipe.tracer_grid_res,
            max_cells=pipe.tracer_max_cells,
            max_hits=pipe.tracer_max_hits,
            prefilter_width=pipe.tracer_prefilter_width,
            select_tiles=pipe.tracer_select_tiles,
            tile=pipe.tracer_tile,
            tiled_direct=pipe.tracer_tiled_direct,
            hit_budget=pipe.tracer_hit_budget,
            max_crossings=pipe.tracer_max_crossings,
            n_segments=pipe.tracer_n_segments,
            retrace_frac=pipe.tracer_retrace_frac,
            table_bf16=pipe.tracer_table_bf16,
            adaptive=pipe.tracer_adaptive,
            oversize_cap=pipe.tracer_oversize_cap,
            transmittance_min=pipe.transmittance_min,
            alpha_min=pipe.alpha_min)


# cell_meta packing: one int per cell = (CSR start << 10) | min(count, 1023)
_COUNT_BITS = 10
_COUNT_MASK = (1 << _COUNT_BITS) - 1


def pack_cell_meta(start, count):
    start = torch.clamp(start, max=(1 << (31 - _COUNT_BITS)) - 1)
    return (start << _COUNT_BITS) | torch.clamp(count, max=_COUNT_MASK)


def unpack_cell_meta(meta):
    return meta >> _COUNT_BITS, meta & _COUNT_MASK


class Grid(NamedTuple):
    sorted_gauss: torch.Tensor  # [P] gaussian id per (cell, gaussian) pair,
                                # cell-major, gaussian-id order inside a cell
    sorted_cell: torch.Tensor   # [P] cell id per pair (G^3 = padding)
    cell_meta: torch.Tensor     # [G^3] packed (start, count)
    bb_min: torch.Tensor        # [3]
    inv_cell: torch.Tensor      # [3]
    cell_size: torch.Tensor     # [3]
    overflow: torch.Tensor      # scalar: pairs dropped by capacity
    oversize: torch.Tensor      # scalar: gaussians truncated to span_cap
    oversize_ids: torch.Tensor  # [oversize_cap] int64 ids of the Gaussians
                                # kept OUT of the grid and depth-merged per
                                # ray (merge_oversize); -1 padding. Shape
                                # [0] when oversize_cap == 0
    coarse_occ: torch.Tensor    # [Gc^3] 0/1 occupancy of 4^3 supercells


COARSE_FACTOR = 4


class TraceInputs(NamedTuple):
    means3d: torch.Tensor   # [N, 3]
    opacity: torch.Tensor   # [N]
    ru: torch.Tensor        # [N, 3] R[:,0] / s_u
    rv: torch.Tensor        # [N, 3] R[:,1] / s_v
    normals: torch.Tensor   # [N, 3] unit, pre-flipped toward the camera
    shs: torch.Tensor       # [N, C, 3]
    features: torch.Tensor  # [N, S]


class TraceOut(NamedTuple):
    color: torch.Tensor    # [R, 3]
    normal: torch.Tensor   # [R, 3]
    feature: torch.Tensor  # [R, S]
    depth: torch.Tensor    # [R]
    alpha: torch.Tensor    # [R]
    trans: torch.Tensor    # [R] Π(1-α) over blended hits (re-trace carry)


class Cells(NamedTuple):
    starts: torch.Tensor     # [R, C] CSR start per visited segment
    counts: torch.Tensor     # [R, C] candidates in the cell (0 = none)
    tin: torch.Tensor        # [R, C]
    tout: torch.Tensor       # [R, C]
    truncated: torch.Tensor  # [R] bool: traversal incomplete
    resume: torch.Tensor     # [R] horizon to resume from (0 otherwise)


class SelectedHits(NamedTuple):
    gs: torch.Tensor         # [R, kb] gaussian ids, depth order
    valid: torch.Tensor      # [R, kb]
    t_last: torch.Tensor     # [R] acceptance restart
    t_cell: torch.Tensor     # [R] collection restart
    more: torch.Tensor       # [R] bool: hit list truncated
    cand_skip: torch.Tensor  # [R] tiles of the first cell already examined


def _floor_cell(x, g: int):
    """clip(floor(x).astype(int32), 0, g-1) with XLA's saturating convert."""
    return torch.clamp(torch.floor(x), 0, g - 1).long()


def _f32_bits(x):
    return x.contiguous().view(torch.int32)


def _bits_f32(x):
    return x.to(torch.int32).contiguous().view(torch.float32)


def bounding_radius(opacity, scales, alpha_min: float):
    """√(2·ln(o/α_min)) · max(s_u, s_v); 0 when o ≤ α_min."""
    ratio = maximum(opacity / alpha_min, 1.0)
    return torch.sqrt(2.0 * torch.log(ratio)) * torch.amax(scales, dim=-1)


@torch.no_grad()
def build_grid(means3d, radius, alive, *, grid_res: int, pair_capacity: int,
               span_cap: int = 6, normals=None, oversize_cap: int = 0) -> Grid:
    """Uniform grid over per-Gaussian bounding spheres (≙ build_grid,
    :374-538). With `normals`, cells are culled to those the surfel's disk
    plane passes through. The two-key (cell, gaussian) sort is one sort on
    cell·2^32 + gaussian.

    With `oversize_cap` > 0 a first pass takes the (up to) `oversize_cap`
    widest Gaussians that span more than `span_cap` cells out of the grid
    into `oversize_ids` (ties by the lower id, as lax.top_k), and the bounds
    are computed again without them (:405-423). Gaussians still oversize
    after that are truncated to a centered window and counted in
    `oversize`."""
    g = grid_res
    n = means3d.shape[0]
    dev = means3d.device

    def bounds(alive_m):
        rr = torch.where(alive_m, radius, torch.zeros_like(radius))
        am = alive_m[:, None]
        bmn = torch.where(am, means3d - rr[:, None],
                          torch.full_like(means3d, math.inf)).amin(0)
        bmx = torch.where(am, means3d + rr[:, None],
                          torch.full_like(means3d, -math.inf)).amax(0)
        bmn = torch.where(torch.isinf(bmn), torch.full_like(bmn, -1.0), bmn) - 1e-3
        bmx = torch.where(torch.isinf(bmx), torch.full_like(bmx, 1.0), bmx) + 1e-3
        # XLA compiles the reference's division by the constant g as a
        # product with its f32 reciprocal; so does the port, for the same bits
        cl = (bmx - bmn) * (1.0 / g)
        ic = 1.0 / cl
        lo_ = _floor_cell((means3d - rr[:, None] - bmn) * ic, g)
        hi_ = _floor_cell((means3d + rr[:, None] - bmn) * ic, g)
        ov = (alive_m & (rr > 0)) & torch.any(hi_ - lo_ + 1 > span_cap, dim=-1)
        return rr, bmn, cl, ic, lo_, hi_, ov

    if oversize_cap > 0:
        r_a, *_, ov_a = bounds(alive)
        score = torch.where(ov_a, r_a, torch.full_like(r_a, -1.0))
        top_i = _top_index(score, min(oversize_cap, n))
        taken = score[top_i] > 0.0
        ov_ids = torch.where(taken, top_i, torch.full_like(top_i, -1))
        handled = torch.zeros(n, dtype=torch.bool, device=dev)
        handled[top_i[taken]] = True
        alive = alive & ~handled
    else:
        ov_ids = torch.zeros(0, dtype=torch.long, device=dev)

    rr, bb_min, cell, inv_cell, lo, hi, oversize_mask = bounds(alive)
    n_oversize = oversize_mask.sum()
    span = torch.clamp(hi - lo + 1, max=span_cap)
    cc = _floor_cell((means3d - bb_min) * inv_cell, g)
    lo = torch.minimum(torch.maximum(cc - (span - 1) // 2, lo), hi - span + 1)

    from .surfel_raster import counts_by_id, rank_against_arange
    slots = torch.arange(pair_capacity, device=dev)
    r = rr
    if normals is not None:
        W = span_cap
        off = torch.arange(W, device=dev)
        wx_all = off[:, None, None].expand(W, W, W).reshape(-1)
        wy_all = off[None, :, None].expand(W, W, W).reshape(-1)
        wz_all = off[None, None, :].expand(W, W, W).reshape(-1)
        in_win = ((wx_all[None] < span[:, 0:1]) & (wy_all[None] < span[:, 1:2])
                  & (wz_all[None] < span[:, 2:3]))
        f32 = torch.float32
        cxw = (lo[:, 0:1] + wx_all[None]).to(f32)
        cyw = (lo[:, 1:2] + wy_all[None]).to(f32)
        czw = (lo[:, 2:3] + wz_all[None]).to(f32)
        dx = bb_min[0] + (cxw + 0.5) * cell[0] - means3d[:, 0:1]
        dy = bb_min[1] + (cyw + 0.5) * cell[1] - means3d[:, 1:2]
        dz = bb_min[2] + (czw + 0.5) * cell[2] - means3d[:, 2:3]
        plane = torch.abs(dx * normals[:, 0:1] + dy * normals[:, 1:2]
                          + dz * normals[:, 2:3])
        cell_norm = torch.linalg.vector_norm(cell)
        slab = (0.5 * (torch.abs(normals[:, 0:1]) * cell[0]
                       + torch.abs(normals[:, 1:2]) * cell[1]
                       + torch.abs(normals[:, 2:3]) * cell[2])
                * (1.0 + 1e-4) + 1e-6 * cell_norm)
        rad2 = dx * dx + dy * dy + dz * dz
        rmax = (r + 0.5 * cell_norm)[:, None]
        keep = in_win & (plane <= slab) & (rad2 <= rmax * rmax)
        keep = keep & (alive & (r > 0))[:, None]
        kcum = torch.cumsum(keep.long(), dim=-1)
        count = kcum[:, -1]
        cum = torch.cumsum(count, 0)
        total = cum[-1]
        offsets = cum - count
        gi = torch.clamp(rank_against_arange(cum, pair_capacity), max=n - 1)
        local = slots - offsets[gi]
        # slot -> local-th kept window index: the same fixed-step bisection
        # on the gaussian's kcum row as the reference
        kflat = kcum.reshape(-1)
        lo_w = torch.zeros_like(slots)
        hi_w = torch.full_like(slots, W ** 3 - 1)
        for _ in range(max(1, int(math.ceil(math.log2(W ** 3))))):
            mid = (lo_w + hi_w) // 2
            gt_ = kflat[gi * (W ** 3) + mid] > local
            lo_w, hi_w = torch.where(gt_, lo_w, mid + 1), torch.where(gt_, mid, hi_w)
        lo_w = torch.clamp(lo_w, max=W ** 3 - 1)  # JAX gathers clamp
        cx = lo[gi, 0] + wx_all[lo_w]
        cy = lo[gi, 1] + wy_all[lo_w]
        cz = lo[gi, 2] + wz_all[lo_w]
    else:
        count = torch.where(alive & (r > 0), span[:, 0] * span[:, 1] * span[:, 2],
                            torch.zeros_like(span[:, 0]))
        cum = torch.cumsum(count, 0)
        total = cum[-1]
        offsets = cum - count
        gi = torch.clamp(rank_against_arange(cum, pair_capacity), max=n - 1)
        local = slots - offsets[gi]
        sx, sy = span[gi, 0], span[gi, 1]
        cx = lo[gi, 0] + local % sx
        cy = lo[gi, 1] + (local // sx) % sy
        cz = lo[gi, 2] + local // (sx * sy)

    cell_id = (cz * g + cy) * g + cx
    cell_id = torch.where(slots < total, cell_id, torch.full_like(cell_id, g ** 3))
    order = torch.sort(cell_id * (1 << 32) + gi, stable=True).indices
    sorted_cell, sorted_gauss = cell_id[order], gi[order]
    per_cell = counts_by_id(cell_id, g ** 3)
    start = torch.cumsum(per_cell, 0) - per_cell

    gc = -(-g // COARSE_FACTOR)
    occ = (per_cell > 0).reshape(g, g, g)
    pad = gc * COARSE_FACTOR - g
    occ = torch.nn.functional.pad(occ.to(torch.uint8), (0, pad, 0, pad, 0, pad))
    occ = occ.reshape(gc, COARSE_FACTOR, gc, COARSE_FACTOR, gc, COARSE_FACTOR)
    occ = occ.amax(dim=(1, 3, 5))
    return Grid(sorted_gauss=sorted_gauss, sorted_cell=sorted_cell,
                cell_meta=pack_cell_meta(start, per_cell),
                bb_min=bb_min, inv_cell=inv_cell, cell_size=cell,
                overflow=torch.clamp(total - pair_capacity, min=0),
                oversize=n_oversize, oversize_ids=ov_ids,
                coarse_occ=occ.reshape(-1).long())


@torch.no_grad()
def build_grid_from_gaussians(params, aux, cfg: TracerConfig) -> Grid:
    """≙ build_grid_from_gaussians (:540): disk-slab insertion."""
    from ..utils.math3d import quat_to_rotmat
    radius = bounding_radius(params.get_opacity()[:, 0], params.get_scaling(),
                             cfg.alpha_min)
    normals = quat_to_rotmat(params.rotation)[:, :, 2]
    return build_grid(params.xyz, radius, aux.alive, grid_res=cfg.grid_res,
                      pair_capacity=cfg.pair_capacity, span_cap=cfg.span_cap,
                      normals=normals, oversize_cap=cfg.oversize_cap)


# ---------------------------------------------------------------------------
# local hit math
# ---------------------------------------------------------------------------

def _hit_geom(mean, opa, ru, rv, nrm, ray_o, ray_d):
    """Gaussian x ray hit -> (alpha, n_flip, depth)."""
    o_g = torch.sum(nrm * (ray_o - mean), dim=-1)
    d_g = torch.sum(nrm * ray_d, dim=-1)
    d = -o_g * d_g / maximum(d_g * d_g, 1e-6)
    pos = ray_o + d[..., None] * ray_d - mean
    pg_u = torch.sum(ru * pos, dim=-1)
    pg_v = torch.sum(rv * pos, dim=-1)
    alpha = minimum(opa * torch.exp(-0.5 * (pg_u * pg_u + pg_v * pg_v)), 0.99)
    cosr = -torch.sum(ray_d * nrm, dim=-1)
    n_flip = torch.where((cosr > 0)[..., None], nrm, -nrm)
    return alpha, n_flip, d


def _hit_geom_cols10(cols, ray_o, ray_d):
    """Hit math on the 10-component candidate slab (mean3 | opacity | ru3 |
    rv3); the plane normal is the normalized ru x rv (flip folded into ru)."""
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
    mx, my, mz, opa = cols[0], cols[1], cols[2], cols[3]
    rux, ruy, ruz = cols[4], cols[5], cols[6]
    rvx, rvy, rvz = cols[7], cols[8], cols[9]
    cx = ruy * rvz - ruz * rvy
    cy = ruz * rvx - rux * rvz
    cz = rux * rvy - ruy * rvx
    inv = torch.rsqrt(maximum(cx * cx + cy * cy + cz * cz, 1e-30))
    nx, ny, nz = cx * inv, cy * inv, cz * inv
    o_g = nx * (ox - mx) + ny * (oy - my) + nz * (oz - mz)
    d_g = nx * dx + ny * dy + nz * dz
    d = -o_g * d_g / maximum(d_g * d_g, 1e-6)
    px = ox + d * dx - mx
    py = oy + d * dy - my
    pz = oz + d * dz - mz
    pu = rux * px + ruy * py + ruz * pz
    pv = rvx * px + rvy * py + rvz * pz
    alpha = minimum(opa * torch.exp(-0.5 * (pu * pu + pv * pv)), 0.99)
    return alpha, d, d_g


def _sh_basis(sh_deg: int, dirs):
    """SH basis [..., C]: pre-clamp color = Σ_j b_j·sh_j + 0.5. The JAX
    tracer's basis stops at degree 3 (so its blend raises on 25
    coefficients); the degree-4 terms here are utils/sh.py's."""
    from ..utils.sh import C0, C1, C2, C3, C4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    terms = [C0 * torch.ones_like(x)]
    if sh_deg > 0:
        terms += [-C1 * y, C1 * z, -C1 * x]
    if sh_deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [C2[0] * xy, C2[1] * yz, C2[2] * (2 * zz - xx - yy),
                  C2[3] * xz, C2[4] * (xx - yy)]
    if sh_deg > 2:
        terms += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                  C3[2] * y * (4 * zz - xx - yy),
                  C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                  C3[6] * x * (xx - 3 * yy)]
    if sh_deg > 3:
        terms += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
                  C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
                  C4[4] * (zz * (35 * zz - 30) + 3),
                  C4[5] * xz * (7 * zz - 3), C4[6] * (xx - yy) * (7 * zz - 1),
                  C4[7] * xz * (xx - 3 * yy),
                  C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(terms, dim=-1)


def _hit_quantities(mean, opa, ru, rv, nrm, sh, feat, ray_o, ray_d, sh_deg: int):
    """Full per-hit outputs (the brute-force oracle's)."""
    alpha, n_flip, d = _hit_geom(mean, opa, ru, rv, nrm, ray_o, ray_d)
    shape = torch.broadcast_shapes(ray_d.shape, mean.shape)
    color = sh_utils.eval_sh_color(sh_deg, sh.transpose(-1, -2),
                                   ray_d.expand(shape))
    color = color.expand(torch.broadcast_shapes(color.shape, mean.shape))
    return alpha, color, n_flip, feat, d


# ---------------------------------------------------------------------------
# phase 1: DDA cell collection (index-only)
# ---------------------------------------------------------------------------

def _safe_inv(ray_d):
    small = torch.abs(ray_d) < 1e-12
    return small, torch.where(small, torch.full_like(ray_d, INF), 1.0 / ray_d)


def _ray_setup(ray_o, ray_d, grid: Grid, g: int, t_start=None):
    bb_max = grid.bb_min + grid.cell_size * g
    small, inv_d = _safe_inv(ray_d)
    t_lo = (grid.bb_min - ray_o) * inv_d
    t_hi = (bb_max - ray_o) * inv_d
    t0 = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t1 = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    t_enter = torch.clamp(t0, min=1e-6)
    if t_start is not None:
        t_enter = torch.maximum(t_enter, t_start)
    hit_box = t1 > t_enter
    p = ray_o + (t_enter[:, None] + 1e-5) * ray_d
    cell = _floor_cell((p - grid.bb_min) * grid.inv_cell, g)
    sgn = torch.where(ray_d >= 0, 1, -1)
    tdelta = torch.abs(grid.cell_size * inv_d)
    next_bound = grid.bb_min + (cell + (sgn > 0).long()).float() * grid.cell_size
    tmax = torch.where(small, torch.full_like(ray_d, INF),
                       (next_bound - ray_o) * inv_d)
    return cell, sgn, tdelta, tmax, t_enter, t1, hit_box


def _merge_crossings(tmax, tdelta, n_k: int):
    """The DDA's visited-cell sequence as one sort: crossing times of the
    three axes merged by a single int sort with the axis label packed into
    the two mantissa LSBs. Returns (sorted times [R, 3n], per-axis step
    counts [R, 3n, 3])."""
    R = tmax.shape[0]
    k = torch.arange(n_k, dtype=torch.float32, device=tmax.device)
    times = (tmax[:, :, None] + k * tdelta[:, :, None]).reshape(R, 3 * n_k)
    lbl = torch.arange(3, device=tmax.device).repeat_interleave(n_k)
    tbits = _f32_bits(torch.clamp(times, min=1e-30)).long()
    key = torch.sort((tbits & ~3) | lbl, dim=-1).values
    t_sorted = _bits_f32(key & ~3)
    steps = torch.cumsum(torch.nn.functional.one_hot(key & 3, 3), dim=1)
    return t_sorted, steps


def _coarse_scan(ray_o, ray_d, grid: Grid, g: int):
    """Exact loop-free DDA over the coarse occupancy supercells. Returns
    (t_first_occ, t_in [R,Sc+1], t_out [R,Sc+1], occ [R,Sc+1])."""
    gc = -(-g // COARSE_FACTOR)
    csize = grid.cell_size * COARSE_FACTOR
    bb_max = grid.bb_min + grid.cell_size * g
    R = ray_o.shape[0]
    small, inv_d = _safe_inv(ray_d)
    t_lo = (grid.bb_min - ray_o) * inv_d
    t_hi = (bb_max - ray_o) * inv_d
    t0 = torch.clamp(torch.amax(torch.minimum(t_lo, t_hi), dim=-1), min=1e-6)
    t1 = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit_box = t1 > t0
    p = ray_o + (t0[:, None] + 1e-5) * ray_d
    cell0 = _floor_cell((p - grid.bb_min) / csize, gc)
    sgn = torch.where(ray_d >= 0, 1, -1)
    tdelta = torch.abs(csize * inv_d)
    next_bound = grid.bb_min + (cell0 + (sgn > 0).long()).float() * csize
    tmax = torch.where(small, torch.full_like(ray_d, INF),
                       (next_bound - ray_o) * inv_d)
    t_sorted, steps = _merge_crossings(tmax, tdelta, gc)
    cells_j = torch.cat([cell0[:, None], cell0[:, None] + sgn[:, None] * steps], 1)
    t_in_j = torch.cat([t0[:, None], t_sorted], dim=1)
    t_out_j = torch.minimum(
        torch.cat([t_sorted, torch.full((R, 1), INF, device=ray_o.device)], 1),
        t1[:, None])
    in_bounds = torch.all((cells_j >= 0) & (cells_j < gc), dim=-1)
    seg_valid = in_bounds & hit_box[:, None] & (t_in_j < t_out_j)
    cc = torch.clamp(cells_j, 0, gc - 1)
    cid = (cc[..., 2] * gc + cc[..., 1]) * gc + cc[..., 0]
    occ_seg = (grid.coarse_occ[cid] > 0) & seg_valid
    t_first = torch.amin(torch.where(occ_seg, t_in_j, torch.full_like(t_in_j, INF)), -1)
    return t_first, t_in_j, t_out_j, occ_seg


@torch.no_grad()
def collect_cells(ray_o, ray_d, grid: Grid, cfg: TracerConfig,
                  t_start=None) -> Cells:
    """[R] rays -> the DDA's visited segments (≙ collect_cells, :754-896):
    for the tiled select with ``tiled_direct`` every segment, unpacked;
    otherwise the first `max_cells` non-empty ones in traversal order.
    `t_start` [R] restricts to windows ending past it (the re-trace
    restart)."""
    g = cfg.grid_res
    R = ray_o.shape[0]
    k_ax = min(cfg.max_crossings if cfg.max_crossings > 0 else g, g)

    if cfg.coarse_scan:
        t_first_c, _, tout_c, occ_c = _coarse_scan(ray_o, ray_d, grid, g)
        eps_skip = 1e-4 * torch.amin(grid.cell_size)
        t_skip = torch.clamp(t_first_c - eps_skip, max=INF)
        base = t_start if t_start is not None else torch.zeros(
            R, dtype=ray_o.dtype, device=ray_o.device)
        t_start = torch.maximum(base, t_skip)

    cell0, sgn, tdelta, tmax, t_enter, t_exit, hit_box = _ray_setup(
        ray_o, ray_d, grid, g, t_start=t_start)
    t_sorted, steps = _merge_crossings(tmax, tdelta, k_ax)
    cells_j = torch.cat([cell0[:, None], cell0[:, None] + sgn[:, None] * steps], 1)
    t_in_j = torch.cat([t_enter[:, None], t_sorted], dim=1)
    t_out_j = torch.cat([t_sorted, torch.full((R, 1), INF, device=ray_o.device)], 1)
    t_out_j = torch.minimum(t_out_j, t_exit[:, None])

    in_bounds = torch.all((cells_j >= 0) & (cells_j < g), dim=-1)
    seg_valid = (in_bounds & hit_box[:, None] & (t_in_j < t_out_j)
                 & (t_in_j < t_exit[:, None]))
    # crossing-budget horizon: the enumerated sequence is valid only up to
    # the first missing crossing of any axis
    horizon = torch.amin(tmax + k_ax * tdelta, dim=-1)
    incomplete = hit_box & (horizon < t_exit)
    if cfg.coarse_scan:
        beyond = torch.any(occ_c & (tout_c > horizon[:, None]), dim=-1)
        incomplete = incomplete & beyond
    t_out_j = torch.minimum(t_out_j, horizon[:, None])
    seg_valid = seg_valid & (t_in_j < horizon[:, None])
    if t_start is not None:
        seg_valid = seg_valid & (t_out_j > t_start[:, None])
        t_in_j = torch.maximum(t_in_j, t_start[:, None])
    cc = torch.clamp(cells_j, 0, g - 1)
    cid = (cc[..., 2] * g + cc[..., 1]) * g + cc[..., 0]
    meta = grid.cell_meta[cid]
    meta_v = torch.where(seg_valid & ((meta & _COUNT_MASK) > 0), meta,
                         torch.zeros_like(meta))
    starts, counts = unpack_cell_meta(meta_v)
    resume = torch.where(incomplete, horizon, torch.zeros_like(horizon))
    if cfg.select_tiles > 0 and cfg.tiled_direct:
        return Cells(starts, counts, t_in_j, t_out_j, incomplete, resume)

    # packed: the first max_cells non-empty segments, padded with empty
    # slots. The reference pulls them out with a one-hot einsum in f32, exact
    # for these values (start < 2^21, count < 2^10); they are gathered here
    C = cfg.max_cells
    nonempty = meta_v != 0
    n_seg = meta_v.shape[1]
    big = 1 << 30
    seg = torch.arange(n_seg, device=ray_o.device).expand(R, n_seg)
    pos = torch.sort(torch.where(nonempty, seg, big), dim=-1).values
    if C > n_seg:
        pos = torch.nn.functional.pad(pos, (0, C - n_seg), value=big)
    pos = pos[:, :C]
    kept = pos < big
    pos = torch.clamp(pos, max=n_seg - 1)
    take = lambda x: torch.where(kept, torch.gather(x, 1, pos),
                                 torch.zeros((), dtype=x.dtype,
                                             device=x.device))
    truncated = (nonempty.sum(-1) > C) | incomplete
    return Cells(take(starts), take(counts), take(t_in_j), take(t_out_j),
                 truncated, resume)


# ---------------------------------------------------------------------------
# phase 2: tiled hit selection (index-only) and the differentiable blend
# ---------------------------------------------------------------------------

def _pack_geom(inputs: TraceInputs):
    return torch.cat([inputs.means3d, inputs.opacity[:, None], inputs.ru,
                      inputs.rv, inputs.normals], dim=-1)          # [N, 13]


_TAB_COMPS = 11    # mean3 | opacity | ru3 | rv3 | cell id bits


def _pack_prefilter(geom):
    """[7, N] table of the two-tier select's screen (≙ _pack_prefilter,
    :911-921): centre | normal | a bounding radius with the opacity folded
    in, at alpha_min = 1/255 whatever the config's (a plane hit farther than
    r from the centre provably has alpha < 1/255)."""
    norm = lambda x: torch.sqrt(torch.sum(x * x, dim=-1))
    su = 1.0 / maximum(norm(geom[:, 4:7]), 1e-12)
    sv = 1.0 / maximum(norm(geom[:, 7:10]), 1e-12)
    r = bounding_radius(geom[:, 3], torch.stack([su, sv], -1), 1.0 / 255.0)
    return torch.cat([geom[:, 0:3].T, geom[:, 10:13].T, r[None]], dim=0)


@torch.no_grad()
def _pair_tab_from_geom(grid: Grid, geom, tile: int = 16, bf16: bool = False):
    """Tile-row candidate table (≙ _pair_tab_from_geom, :938-1002): row t
    holds pairs [t·tile, (t+1)·tile), component-major. f32: [ceil(P/tile),
    11·tile], the components mean3 | opacity | ru3 (the stored normal's
    flip folded into its sign) | rv3 | the pair's cell id as its raw int32
    bits. `bf16`: [ceil(P/tile), 12·tile] bfloat16, the mean stored
    relative to the centre of the pair's cell, the 10 geometry components
    rounded to nearest even, and the cell id's int32 bits in two lanes (low
    half first). One row gather fetches all of a tile. Rows are not padded
    to 128 lanes as on the TPU: the card's gather needs none."""
    rows13 = geom[grid.sorted_gauss]
    ru, rv, n_st = rows13[:, 4:7], rows13[:, 7:10], rows13[:, 10:13]
    cr = torch.linalg.cross(ru, rv, dim=-1)
    flip = torch.where(torch.sum(cr * n_st, dim=-1) < 0.0, -1.0, 1.0)
    rows = torch.cat([rows13[:, 0:4], ru * flip[:, None], rv], dim=-1)
    cid = grid.sorted_cell.to(torch.int32)
    if bf16:
        # the grid resolution as the reference recovers it from the cell
        # table's length
        n_cells = grid.cell_meta.shape[0]
        g = round(n_cells ** (1 / 3))
        while g ** 3 < n_cells:
            g += 1
        cell = torch.stack([cid % g, (cid % (g * g)) // g, cid // (g * g)],
                           dim=-1).to(torch.float32)
        center = grid.bb_min[None] + (cell + 0.5) * grid.cell_size[None]
        geo = torch.cat([rows[:, 0:3] - center, rows[:, 3:10]], dim=-1)
        tab = torch.cat([geo.to(torch.bfloat16),
                         cid.contiguous().view(torch.bfloat16).reshape(-1, 2)],
                        dim=-1)                                 # [P, 12]
    else:
        tab = torch.cat([rows, cid.view(torch.float32)[:, None]],
                        dim=-1)                                 # [P, 11]
    P, nc = tab.shape
    pad = (-P) % tile
    tab = torch.nn.functional.pad(tab, (0, 0, 0, pad))
    T = (P + pad) // tile
    return tab.reshape(T, tile, nc).transpose(1, 2).reshape(T, nc * tile)


def _table_rows(pair_tab, row_idx):
    """The table rows `row_idx` through the row-gather kernel (plain
    indexing for a table on the CPU). The kernel copies 32-bit words, so a
    bf16 table goes through it viewed as int32, bit for bit."""
    if pair_tab.dtype == torch.bfloat16:
        return gather_rows_kernel(pair_tab.view(torch.int32),
                                  row_idx).view(torch.bfloat16)
    return gather_rows_kernel(pair_tab, row_idx)


@torch.no_grad()
def select_hits_tiled(ray_o, ray_d, grid: Grid, cells: Cells,
                      pair_tab, cfg: TracerConfig,
                      back_culling: bool, t_start=None,
                      cand_skip=None) -> SelectedHits:
    """Tiled hit selection (≙ select_hits_tiled, :1005-1243): examine
    candidates in `tile`-wide blocks of the pair table, exact hit math,
    dedup by hit-cell == pair-cell, keep the `hit_budget` nearest: by the
    (depth, pair position) key, or with `select_topk` by (depth, lane), the
    stable top-k order of the reference — one int64 key, depth bits high.
    The table rows come through ops/gather_rows.py: the row-gather kernel
    for a table on the card, plain indexing for one on the CPU. A bf16
    table's rows are read back to f32 and accepted at alpha_min / 2
    (:1079-1110)."""
    TILE, ST = cfg.tile, cfg.select_tiles
    S1 = ST * TILE
    R, C = cells.starts.shape
    P = grid.sorted_gauss.shape[0]
    kb = cfg.hit_budget
    g = cfg.grid_res
    dev = ray_o.device
    zero = lambda x: torch.zeros_like(x)

    starts, counts, tout = cells.starts, cells.counts, cells.tout
    if cand_skip is not None:
        ne = counts > 0
        fne = ne & (torch.cumsum(ne.long(), dim=-1) == 1)
        s0 = torch.where(fne, starts, zero(starts)).sum(-1)
        c0 = torch.where(fne, counts, zero(counts)).sum(-1)
        skip0 = torch.minimum(cand_skip, (s0 % TILE + c0 + TILE - 1) // TILE)
        adv = torch.minimum(skip0 * TILE - s0 % TILE * (skip0 > 0).long(), c0)
        adv = torch.clamp(adv, min=0)
        starts = torch.where(fne, starts + adv[:, None], starts)
        counts = torch.where(fne, counts - adv[:, None], counts)

    tcnt = torch.where(counts > 0, (starts % TILE + counts + TILE - 1) // TILE,
                       zero(counts))
    cumT = torch.cumsum(tcnt, dim=-1)
    exclT = cumT - tcnt
    s = torch.arange(ST, device=dev)[None]
    cidx = torch.searchsorted(cumT.contiguous(), s.expand(R, ST).contiguous(),
                              right=True)
    take_rc = lambda x: torch.gather(x, 1, torch.clamp(cidx, max=C - 1))
    tt = s - take_rc(exclT)
    start_c = take_rc(starts)
    count_c = take_rc(counts)
    row_idx = start_c // TILE + tt
    tile_valid = (s < cumT[:, -1:]) & (cidx < C)
    n_rows = pair_tab.shape[0]
    row_idx = torch.where(tile_valid, torch.clamp(row_idx, max=n_rows - 1),
                          zero(row_idx))

    # ONE row gather: [R·ST] tile rows of 11·TILE f32 (12·TILE bf16)
    rows = _table_rows(pair_tab, row_idx.reshape(-1))
    if pair_tab.dtype == torch.bfloat16:
        blocks = rows.view(R, ST, _TAB_COMPS + 1, TILE)
        pair_cid = blocks[:, :, 10:12, :].transpose(2, 3).contiguous().view(
            torch.int32).reshape(R, S1)
        cols = [blocks[:, :, i, :].reshape(R, S1).to(torch.float32)
                for i in range(10)]
        # the means are cell-relative: add back the pair's cell centre (f32)
        pc = (pair_cid % g, (pair_cid % (g * g)) // g, pair_cid // (g * g))
        for a in range(3):
            cols[a] = cols[a] + (grid.bb_min[a] + (pc[a].to(torch.float32)
                                                    + 0.5) * grid.cell_size[a])
        # accept at half the threshold: bf16 rounding can depress a true
        # alpha_min hit, and the blend re-tests with the exact f32 alpha
        accept_min = cfg.alpha_min * 0.5
    else:
        blocks = rows.view(R, ST, _TAB_COMPS, TILE)
        cols = [blocks[:, :, i, :].reshape(R, S1) for i in range(10)]
        pair_cid = blocks[:, :, 10, :].reshape(R, S1).view(torch.int32)
        accept_min = cfg.alpha_min
    lane = torch.arange(TILE, device=dev)
    pos3 = row_idx[:, :, None] * TILE + lane
    lane_valid = (tile_valid[:, :, None] & (pos3 >= start_c[:, :, None])
                  & (pos3 < (start_c + count_c)[:, :, None])).reshape(R, S1)

    alpha, d, d_g = _hit_geom_cols10(cols, ray_o, ray_d)
    hc = [_floor_cell((ray_o[:, a:a + 1] + d * ray_d[:, a:a + 1] - grid.bb_min[a])
                      * grid.inv_cell[a], g) for a in range(3)]
    hcid = (hc[2] * g + hc[1]) * g + hc[0]
    accept = (lane_valid & (alpha >= accept_min) & (d > 1e-6)
              & (hcid == pair_cid))
    if t_start is not None:
        accept = accept & (d > t_start[:, None])
    accept = accept & (d < torch.where(cells.resume > 0, cells.resume,
                                       torch.full_like(cells.resume, INF))[:, None])
    if back_culling:
        accept = accept & (d_g < 0)

    pair_pos = pos3.reshape(R, S1)
    d_key = torch.where(accept, d, torch.full_like(d, INF))
    n_accepted = accept.sum(-1)
    more = (n_accepted > kb) | (cumT[:, -1] > ST) | cells.truncated
    fully = (cumT <= ST) & (counts > 0)
    tout_frontier = torch.where(fully, tout, zero(tout)).amax(-1)
    all_ex = cumT[:, -1] <= ST
    frontier = torch.where(all_ex, torch.maximum(tout_frontier, cells.resume),
                           tout_frontier)
    overflowed = n_accepted > kb
    nT_before = torch.where(fully, cumT, zero(cumT)).amax(-1)

    # the kb smallest keys; depths > 0 so their f32 bits order like the
    # values. The second key is the pair position (the reference's two-key
    # sort) or, with select_topk, the lane: jax.lax.top_k keeps equal keys
    # in lane order, and lanes are not in pair order across cells
    lane_id = torch.arange(S1, device=dev)
    key = _f32_bits(d_key).long() * (1 << 32) + (
        lane_id if cfg.select_topk else pair_pos)
    kk = min(kb, S1)
    top = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
    d_kb = _bits_f32(top >> 32)
    pos_kb = top & 0xFFFFFFFF
    if cfg.select_topk:
        pos_kb = torch.gather(pair_pos, 1, pos_kb)
    valid_kb = d_kb < INF
    gs_kb = grid.sorted_gauss[torch.clamp(pos_kb, 0, P - 1)]
    t_last_raw = torch.where(valid_kb, d_kb, zero(d_kb)).amax(-1)

    # exact partial-cell handling (see the reference, :1204-1242)
    part = ~all_ex & (nT_before > 0)
    starv = ~all_ex & (nT_before == 0)
    keep_all = ~part | (overflowed & (t_last_raw <= frontier))
    valid_kb = valid_kb & (keep_all[:, None] | (d_kb < frontier[:, None]))
    t_last_blend = torch.where(valid_kb, d_kb, zero(d_kb)).amax(-1)
    t_in0 = t_start if t_start is not None else zero(t_last_raw)
    t_last = torch.where(all_ex | (part & keep_all) | (starv & overflowed),
                         t_last_raw,
                         torch.where(part, t_last_blend, t_in0))
    t_cell = torch.where(
        all_ex,
        torch.where(overflowed, t_last_raw, torch.maximum(t_last_raw, frontier)),
        torch.where(part, torch.where(keep_all, t_last_raw, frontier),
                    torch.where(overflowed, t_last_raw, t_in0)))
    starv_fresh = starv & ~overflowed
    skip_next = torch.where(starv_fresh, ST, 0)
    if cand_skip is not None:
        skip_next = skip_next + torch.where(starv_fresh, skip0, zero(skip0))
    return SelectedHits(gs_kb, valid_kb, t_last, t_cell, more, skip_next)


def _hit_geom_cols(cols, ray_o, ray_d):
    """Hit math on the 13 candidate columns (mean3 | opacity | ru3 | rv3 |
    normal3), each [R, H] (≙ _hit_geom_cols, :573-594) -> (alpha, depth,
    d·n)."""
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
    mx, my, mz, opa = cols[0], cols[1], cols[2], cols[3]
    nx, ny, nz = cols[10], cols[11], cols[12]
    o_g = nx * (ox - mx) + ny * (oy - my) + nz * (oz - mz)
    d_g = nx * dx + ny * dy + nz * dz
    d = -o_g * d_g / maximum(d_g * d_g, 1e-6)
    px = ox + d * dx - mx
    py = oy + d * dy - my
    pz = oz + d * dz - mz
    pu = cols[4] * px + cols[5] * py + cols[6] * pz
    pv = cols[7] * px + cols[8] * py + cols[9] * pz
    alpha = minimum(opa * torch.exp(-0.5 * (pu * pu + pv * pv)), 0.99)
    return alpha, d, d_g


@torch.no_grad()
def select_hits_candidates(ray_o, ray_d, sorted_gauss, cells: Cells, geom,
                           cfg: TracerConfig, back_culling: bool,
                           t_start=None, cand_skip=None) -> SelectedHits:
    """Per-candidate hit selection (≙ the select_tiles == 0 branch of
    select_hits, :1246-1437): the recorded cells' pairs expanded into
    `max_hits` candidate slots, exact hit math, acceptance inside the
    candidate's cell window, and the `hit_budget` nearest kept by the
    (depth, slot) order. With `prefilter_width` > `max_hits` (two-tier) a
    wider enumeration is screened first on the [7, N] prefilter table —
    exact plane hit against the bounding radius and the cell window, with a
    tolerance of 1e-4 of the window — and the survivors are compacted into
    the exact slots. `cand_skip` counts candidates of the first recorded
    cell that the previous segment examined.

    The reference sorts depth with one key and no promise of stability;
    XLA's CPU sort keeps ties in slot order up to 16 candidates (an
    insertion sort) and not above. The port keeps the slot order at every
    width: coplanar hits then blend in the order the oracle and the tiled
    select use."""
    starts, counts, tin, tout = cells.starts, cells.counts, cells.tin, cells.tout
    if cand_skip is not None:
        skip0 = torch.minimum(cand_skip, counts[:, 0])
        starts = torch.cat([starts[:, :1] + skip0[:, None], starts[:, 1:]], 1)
        counts = torch.cat([counts[:, :1] - skip0[:, None], counts[:, 1:]], 1)
    R, C = starts.shape
    P = sorted_gauss.shape[0]
    H2 = cfg.max_hits                                 # exact-test width
    H1 = max(cfg.prefilter_width, H2)                 # enumeration width
    big = 1 << 30
    dev = ray_o.device
    cum = torch.cumsum(counts, dim=-1)
    excl = cum - counts

    def expand(h):
        """candidate h [R, W] -> (pair position, valid, its cell window)."""
        cidx = torch.searchsorted(cum.contiguous(), h.contiguous(), right=True)
        take = lambda x: torch.gather(x, 1, torch.clamp(cidx, max=C - 1))
        offset = h - take(excl)
        valid = (h < cum[:, -1:]) & (cidx < C) & (offset < take(counts))
        pos = torch.clamp(take(starts) + offset, 0, P - 1)
        return pos, valid, take(tin), take(tout)

    h1 = torch.arange(H1, device=dev).expand(R, H1)
    pos1, valid1, tin1, tout1 = expand(h1)
    gs = sorted_gauss[pos1]
    if H1 > H2:
        # tier 1: the screen on the prefilter table; a rejected candidate
        # provably has alpha < 1/255
        c7 = _pack_prefilter(geom)[:, gs]                  # [7, R, H1]
        ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
        dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
        nx, ny, nz, r_b = c7[3], c7[4], c7[5], c7[6]
        o_g = nx * (ox - c7[0]) + ny * (oy - c7[1]) + nz * (oz - c7[2])
        d_g = nx * dx + ny * dy + nz * dz
        d1 = -o_g * d_g / maximum(d_g * d_g, 1e-6)
        px = ox + d1 * dx - c7[0]
        py = oy + d1 * dy - c7[1]
        pz = oz + d1 * dz - c7[2]
        q2 = px * px + py * py + pz * pz
        tol = 1e-4 * (tout1 - tin1)
        pass1 = (valid1 & (q2 <= r_b * r_b) & (d1 >= tin1 - tol)
                 & (d1 < tout1 + tol))
        if t_start is not None:
            pass1 = pass1 & (d1 > t_start[:, None] - tol)
        # survivors compacted by their enumeration index; E: the first
        # untested survivor's index (everything before it was decided)
        key = torch.sort(torch.where(pass1, h1, big), dim=-1).values
        h_s = key[:, :H2]
        valid = h_s < big
        E = torch.where(key[:, H2] < big, key[:, H2], H1)
        pos2, _, t_in_h, t_out_h = expand(torch.where(valid, h_s, 0))
        gs = sorted_gauss[pos2]
    else:
        valid, t_in_h, t_out_h = valid1, tin1, tout1
        E = torch.full((R,), H1, dtype=torch.long, device=dev)

    rows = geom.index_select(0, gs.reshape(-1)).reshape(R, H2, 13)
    alpha, d, d_dot_n = _hit_geom_cols(rows.unbind(-1), ray_o, ray_d)
    accept = (valid & (alpha >= cfg.alpha_min) & (d >= maximum(t_in_h, 1e-6))
              & (d < t_out_h))
    if t_start is not None:
        accept = accept & (d > t_start[:, None])
    if back_culling:
        accept = accept & (d_dot_n < 0)

    # the depth sort as one int64 key: depth bits high (accepted depths are
    # > 0, so their f32 bits order like the values), the slot low
    kb = min(cfg.hit_budget, H2)
    d_key = torch.where(accept, d, torch.full_like(d, INF))
    slot = torch.arange(H2, device=dev)
    top = torch.topk(_f32_bits(d_key).long() * (1 << 32) + slot, kb, dim=-1,
                     largest=False, sorted=True).values
    d_s = _bits_f32(top >> 32)
    slot_s = top & 0xFFFFFFFF
    valid_kb = torch.gather(accept, 1, slot_s)
    gs_s = torch.gather(gs, 1, slot_s)

    # re-trace metadata (:1398-1437)
    zero = lambda x: torch.zeros_like(x)
    n_accepted = accept.sum(-1)
    t_last = torch.where(valid_kb, d_s, zero(d_s)).amax(-1)
    overflowed = n_accepted > kb
    more = overflowed | (cum[:, -1] > E) | cells.truncated
    fully = (cum <= E[:, None]) & (counts > 0)
    tout_frontier = torch.where(fully, tout, zero(tout)).amax(-1)
    all_ex = cum[:, -1] <= E
    frontier = torch.where(all_ex, torch.maximum(tout_frontier, cells.resume),
                           tout_frontier)
    t_cell = torch.where(overflowed, t_last, torch.maximum(t_last, frontier))
    n_before = torch.where(fully, cum, zero(cum)).amax(-1)
    skip_next = torch.where(overflowed | all_ex, zero(E),
                            torch.clamp(E - n_before, min=0))
    skip_next = torch.where(t_cell > frontier, zero(skip_next), skip_next)
    if cand_skip is not None:
        same_cell = ~overflowed & ~all_ex & (n_before == 0)
        skip_next = skip_next + torch.where(same_cell, skip0, zero(skip0))
    return SelectedHits(gs_s, valid_kb, t_last, t_cell, more, skip_next)


def select_hits(ray_o, ray_d, grid: Grid, cells: Cells, geom, cfg: TracerConfig,
                back_culling: bool, t_start=None, cand_skip=None,
                pair_tab=None) -> SelectedHits:
    """Index-only hit selection (≙ select_hits, :1246): the tiled select
    when `select_tiles` > 0 (on `pair_tab`, built here when not given), the
    per-candidate select otherwise."""
    if cfg.select_tiles <= 0:
        return select_hits_candidates(ray_o, ray_d, grid.sorted_gauss, cells,
                                      geom, cfg, back_culling, t_start=t_start,
                                      cand_skip=cand_skip)
    if pair_tab is None:
        pair_tab = _maybe_pair_tab(grid, geom, cfg)
    return select_hits_tiled(ray_o, ray_d, grid, cells, pair_tab, cfg,
                             back_culling, t_start=t_start, cand_skip=cand_skip)


def _maybe_pair_tab(grid: Grid, geom, cfg: TracerConfig):
    """The tiled select's candidate table, or None for the per-candidate
    select, which reads none (≙ :1812-1814)."""
    if cfg.select_tiles <= 0:
        return None
    return _pair_tab_from_geom(grid, geom, cfg.tile, bf16=cfg.table_bf16)


def blend_hits(ray_o, ray_d, inputs: TraceInputs, gs_s, valid_s,
               cfg: TracerConfig, sh_deg: int, t0=None) -> TraceOut:
    """Differentiable front-to-back blend of a depth-ordered hit list
    (≙ blend_hits, :1440). `t0` [R]: incoming transmittance carried from
    the previous segment (differentiable)."""
    n_coeff = (sh_deg + 1) ** 2
    # one gather of every table, so that the backward sorts gs_s once and
    # sums all their gradient rows in one scatter-add
    means, opac, ru, rv, normals, sh_g, feat = gather_rows_many(
        (inputs.means3d, inputs.opacity, inputs.ru, inputs.rv, inputs.normals,
         inputs.shs[:, :n_coeff], inputs.features), gs_s)
    alpha, n_flip, d = _hit_geom(means, opac, ru, rv, normals, ray_o[:, None],
                                 ray_d[:, None])
    alpha = torch.where(valid_s & (alpha >= cfg.alpha_min), alpha,
                        torch.zeros_like(alpha))
    lg = torch.log1p(-alpha)
    T_in = torch.exp(torch.cumsum(lg, -1) - lg)
    if t0 is not None:
        T_in = T_in * t0[:, None]
    w = alpha * T_in
    w = torch.where(T_in > cfg.transmittance_min, w, torch.zeros_like(w))

    basis = _sh_basis(sh_deg, ray_d)                           # [R, C]
    color = maximum(torch.einsum("rc,rhcd->rhd", basis, sh_g) + 0.5, 0.0)
    trans = torch.exp(torch.sum(lg, -1))
    if t0 is not None:
        trans = trans * t0
    return TraceOut(
        color=torch.einsum("rh,rhd->rd", w, color),
        normal=torch.einsum("rh,rhd->rd", w, n_flip),
        feature=torch.einsum("rh,rhs->rs", w, feat),
        depth=torch.sum(w * d, -1),
        alpha=torch.sum(w, -1),
        trans=trans)


def _f32_order(x):
    """int64 keys that order like the float32 values `x` (negatives too)."""
    b = _f32_bits(x).long()
    return torch.where(b < 0, -(b & 0x7FFFFFFF) - 1, b)


@torch.no_grad()
def merge_oversize(gs, valid, more, t_last, ro, rd, geom, grid: Grid,
                   cfg: TracerConfig, back_culling: bool, t_lo=None):
    """Depth-merge the Gaussians kept out of the grid (Grid.oversize_ids)
    into a selected hit list before the blend (≙ merge_oversize,
    :1504-1554) -> ([R, kb + K] ids, valid), by the two-key (depth, id)
    order as one stable int64 sort. A round accepts an oversize hit in the
    window (t_lo, bound(t_hi)], where t_hi is the round's grid watermark
    `t_last` while `more` grid matter may follow and INF once the traversal
    is exhausted, and bound() is the next round's acceptance restart
    t·(1 + 1e-5) + 1e-6: the windows of successive rounds partition the ray,
    so each oversize hit is blended once, in depth order. Identity when the
    grid holds no oversize list."""
    K = grid.oversize_ids.shape[0]
    if K == 0:
        return gs, valid
    ro, rd = ro.detach(), rd.detach()
    ov = grid.oversize_ids
    ov_c = torch.clamp(ov, min=0)
    rows = geom[ov_c]                                         # [K, 13]
    alpha, _, d = _hit_geom(
        rows[None, :, 0:3], rows[None, :, 3], rows[None, :, 4:7],
        rows[None, :, 7:10], rows[None, :, 10:13], ro[:, None], rd[:, None])
    v = (ov >= 0)[None] & (alpha >= cfg.alpha_min) & (d > 1e-6)
    if back_culling:
        v = v & (torch.sum(rows[None, :, 10:13] * rd[:, None], -1) < 0)
    t_hi = torch.where(more, t_last, torch.full_like(t_last, INF))
    if t_lo is not None:
        v = v & (d > t_lo[:, None])
    v = v & (d <= t_hi[:, None] * (1.0 + 1e-5) + 1e-6)
    # the grid hits' depths again from their geometry, as the reference
    rows_e = geom[gs]                                         # [R, kb, 13]
    _, _, d_e = _hit_geom(
        rows_e[..., 0:3], rows_e[..., 3], rows_e[..., 4:7],
        rows_e[..., 7:10], rows_e[..., 10:13], ro[:, None], rd[:, None])
    R = gs.shape[0]
    gs_all = torch.cat([gs, ov_c[None].expand(R, K)], dim=-1)
    v_all = torch.cat([valid, v], dim=-1)
    inf = torch.full_like(d, INF)
    d_all = torch.cat([torch.where(valid, d_e, torch.full_like(d_e, INF)),
                       torch.where(v, d, inf)], dim=-1)
    order = torch.sort(_f32_order(d_all) * (1 << 32) + gs_all, dim=-1,
                       stable=True).indices
    return (torch.gather(gs_all, 1, order), torch.gather(v_all, 1, order))


def _detached_geom(inputs: TraceInputs):
    return _pack_geom(inputs).detach()


def trace(ray_o, ray_d, grid: Grid, inputs: TraceInputs, *, cfg: TracerConfig,
          sh_deg: int, back_culling: bool = False, cells=None,
          hits=None) -> TraceOut:
    """Differentiable trace of [R, 3] rays; hit selection detached. The
    oversize Gaussians (if the grid has any) are merged into the hits."""
    geom = None
    if hits is None:
        ro, rd = ray_o.detach(), ray_d.detach()
        if cells is None:
            cells = collect_cells(ro, rd, grid, cfg)
        geom = _detached_geom(inputs)
        hits = select_hits(ro, rd, grid, cells, geom, cfg, back_culling)
    gs, valid = hits.gs, hits.valid
    if grid.oversize_ids.shape[0] > 0:
        if geom is None:
            geom = _detached_geom(inputs)
        gs, valid = merge_oversize(gs, valid, hits.more, hits.t_last, ray_o,
                                   ray_d, geom, grid, cfg, back_culling)
    return blend_hits(ray_o, ray_d, inputs, gs, valid, cfg, sh_deg)


def ladder_capacity(capacity: int, n_need: int) -> int:
    """The `adaptive` ladder's rung for `n_need` rays (:1602-1626): the
    smallest of {max(1024, c/16), max(1024, c/4), c} that holds them, else
    the full capacity `c`."""
    rungs = sorted({max(1024, capacity // 16), max(1024, capacity // 4),
                    capacity})
    rungs = [c for c in rungs if c <= capacity] or [capacity]
    return next((c for c in rungs if c >= n_need), rungs[-1])


def retrace_pass(out: TraceOut, hits: SelectedHits, ray_o, ray_d, grid: Grid,
                 inputs: TraceInputs, cfg: TracerConfig, sh_deg: int,
                 capacity: int, back_culling: bool = False, pair_tab=None):
    """One compacted re-trace round (:1585-1637). The reference's
    lax.cond(any(need)) and, with `adaptive`, its lax.switch over the
    capacity ladder are decided here from one host read of the need count
    per round. The ladder's result equals full capacity: the top-k
    compaction places every needy ray before the padding slots, whose
    contributions are masked to zero."""
    need = hits.more & (out.trans.detach() > cfg.transmittance_min)
    n_need = int(need.sum())
    if n_need == 0:
        return out, hits
    if cfg.adaptive:
        capacity = ladder_capacity(capacity, n_need)
    return _retrace_body(out, hits, need, ray_o, ray_d, grid, inputs, cfg,
                         sh_deg, capacity, back_culling, pair_tab=pair_tab)


def _top_index(score, k: int):
    """jax.lax.top_k's indices: largest first, lower index among ties."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _sel_chunk(cfg: TracerConfig) -> int:
    """Rays per collect+select call: bounds the [rays, candidates] working
    set (:1670-1672, and make_trace_fn's `target`)."""
    width = max(cfg.select_tiles * cfg.tile, cfg.prefilter_width, cfg.max_hits)
    return max(2 ** 12, (2 ** 18 * 48) // max(width, 48))


def _blend_chunk(cfg: TracerConfig, n_oversize: int = 0) -> int:
    """Rays per re-trace blend (:1694-1697): bounds the [rays, kb + K]
    gathers of the blend (K merged oversize Gaussians)."""
    kb = min(cfg.hit_budget, cfg.max_hits) + n_oversize
    return max(2 ** 12, (2 ** 22) // max(kb, 1))


def _retrace_body(out, hits, need, ray_o, ray_d, grid, inputs, cfg, sh_deg,
                  capacity, back_culling, pair_tab=None):
    ro, rd = ray_o.detach(), ray_d.detach()
    idx = _top_index(torch.where(need, out.trans.detach(),
                                 torch.zeros_like(out.trans)), capacity)
    picked = need[idx]
    t_accept = hits.t_last[idx] * (1.0 + 1e-5) + 1e-6
    t_collect = torch.clamp(hits.t_cell[idx], min=0.0)
    geom = _detached_geom(inputs)
    if pair_tab is None:
        pair_tab = _maybe_pair_tab(grid, geom, cfg)

    # per-ray independent: groups only bound the working set
    group = _sel_chunk(cfg)
    args = (ro[idx], rd[idx], t_collect, t_accept, hits.cand_skip[idx])
    parts = []
    for a in range(0, capacity, group):
        o_i, d_i, t_c, t_a, sk = (x[a:a + group] for x in args)
        cells2 = collect_cells(o_i, d_i, grid, cfg, t_start=t_c)
        parts.append(select_hits(o_i, d_i, grid, cells2, geom, cfg,
                                 back_culling, t_start=t_a, cand_skip=sk,
                                 pair_tab=pair_tab))
    h2 = SelectedHits(*[torch.cat(xs) for xs in zip(*parts)])
    valid2 = h2.valid & picked[:, None]
    gs2 = h2.gs
    n_ov = grid.oversize_ids.shape[0]
    if n_ov > 0:
        # this round's oversize window: (t_accept, bound(new watermark)];
        # rays not picked get an empty one
        gs2, valid2 = merge_oversize(
            gs2, valid2, h2.more, torch.maximum(h2.t_last, hits.t_last[idx]),
            ro[idx], rd[idx], geom, grid, cfg, back_culling,
            t_lo=torch.where(picked, t_accept, torch.full_like(t_accept, INF)))
    # blend in bounded ray groups as well: the blend gathers [rays, kb + K]
    # rows of every per-Gaussian table
    bc = _blend_chunk(cfg, n_ov)
    b_args = (ray_o[idx], ray_d[idx], gs2, valid2, out.trans[idx])
    segs = []
    for a in range(0, capacity, bc):
        o_i, d_i, g_i, v_i, t_i = (x[a:a + bc] for x in b_args)
        segs.append(blend_hits(o_i, d_i, inputs, g_i, v_i, cfg, sh_deg,
                               t0=t_i))
    seg = TraceOut(*[torch.cat(xs) for xs in zip(*segs)])

    pk1 = picked
    pk2 = picked[:, None]
    z = lambda x: torch.zeros_like(x)
    add = lambda a, b, m: a.index_add(0, idx, torch.where(m, b, z(b)))
    new_out = TraceOut(
        color=add(out.color, seg.color, pk2),
        normal=add(out.normal, seg.normal, pk2),
        feature=add(out.feature, seg.feature, pk2),
        depth=add(out.depth, seg.depth, pk1),
        alpha=add(out.alpha, seg.alpha, pk1),
        trans=out.trans.index_copy(0, idx, torch.where(pk1, seg.trans,
                                                       out.trans[idx])))
    put = lambda a, v: a.index_copy(0, idx, v)
    new_hits = SelectedHits(
        gs=hits.gs, valid=hits.valid,
        t_last=put(hits.t_last, torch.where(
            pk1, torch.maximum(h2.t_last, hits.t_last[idx]), hits.t_last[idx])),
        t_cell=put(hits.t_cell, torch.where(
            pk1, torch.maximum(h2.t_cell, hits.t_cell[idx]), hits.t_cell[idx])),
        more=put(hits.more, torch.where(pk1, h2.more, z(h2.more))),
        cand_skip=put(hits.cand_skip, torch.where(pk1, h2.cand_skip,
                                                  hits.cand_skip[idx])))
    return new_out, new_hits


def retrace_rounds(out: TraceOut, hits: SelectedHits, ray_o, ray_d,
                   grid: Grid, inputs: TraceInputs, cfg: TracerConfig,
                   sh_deg: int, back_culling: bool = False, pair_tab=None):
    """The configured re-trace rounds (:1744-1797): unrolled, at capacities
    that decay by round; or with `retrace_while`, iterative deepening:
    `retrace_bulk` rounds at the full capacity, then rounds at the tail
    capacity until no ray is truncated and still transmissive, within
    n_segments - 1 rounds in all. Each round reads the host once. The
    iterative schedule is forward only, as the reference's while_loop, which
    has no reverse-mode derivative: under autograd with inputs that require
    grad it raises."""
    if cfg.n_segments <= 1:
        return out, hits
    rcfg = cfg.retrace_cfg()
    if pair_tab is None:
        pair_tab = _maybe_pair_tab(grid, _detached_geom(inputs), rcfg)
    n_rays = ray_o.shape[0]
    if not cfg.retrace_while:
        for rnd in range(cfg.n_segments - 1):
            out, hits = retrace_pass(out, hits, ray_o, ray_d, grid, inputs,
                                     rcfg, sh_deg,
                                     cfg.round_capacity(n_rays, rnd),
                                     back_culling, pair_tab=pair_tab)
        return out, hits

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (out.trans, ray_o, ray_d, *inputs)):
        raise RuntimeError(
            "retrace_while is forward only (the reference's while_loop has no "
            "reverse-mode derivative): trace under torch.no_grad(), or use "
            "the unrolled re-trace rounds")
    clamp = lambda c: max(1, min(n_rays, c))
    cap = clamp(int(n_rays * cfg.retrace_frac))
    tail_cap = clamp(int(n_rays * cfg.retrace_tail_frac))
    n_bulk = min(cfg.retrace_bulk, cfg.n_segments - 1)
    for _ in range(n_bulk):
        out, hits = retrace_pass(out, hits, ray_o, ray_d, grid, inputs, rcfg,
                                 sh_deg, cap, back_culling, pair_tab=pair_tab)
    for _ in range(cfg.n_segments - 1 - n_bulk):
        need = hits.more & (out.trans > cfg.transmittance_min)
        if not bool(need.any()):
            break
        out, hits = _retrace_body(out, hits, need, ray_o, ray_d, grid, inputs,
                                  rcfg, sh_deg, tail_cap, back_culling,
                                  pair_tab=pair_tab)
    return out, hits


def trace_forward_only(ray_o, ray_d, grid: Grid, inputs: TraceInputs, *,
                       cfg: TracerConfig, sh_deg: int,
                       back_culling: bool = False) -> TraceOut:
    """trace() with no autograd graph (≙ trace_forward_only, :1826)."""
    with torch.no_grad():
        return trace(ray_o, ray_d, grid, inputs, cfg=cfg, sh_deg=sh_deg,
                     back_culling=back_culling)


def trace_segments(ray_o, ray_d, grid: Grid, inputs: TraceInputs, *,
                   cfg: TracerConfig, sh_deg: int,
                   back_culling: bool = False) -> TraceOut:
    """Differentiable trace with segmented re-trace (:1800-1823)."""
    ro, rd = ray_o.detach(), ray_d.detach()
    cells = collect_cells(ro, rd, grid, cfg)
    geom = _detached_geom(inputs)
    pair_tab = _maybe_pair_tab(grid, geom, cfg)
    hits = select_hits(ro, rd, grid, cells, geom, cfg, back_culling,
                       pair_tab=pair_tab)
    gs1, valid1 = merge_oversize(hits.gs, hits.valid, hits.more, hits.t_last,
                                 ray_o, ray_d, geom, grid, cfg, back_culling)
    out = blend_hits(ray_o, ray_d, inputs, gs1, valid1, cfg, sh_deg)
    out, _ = retrace_rounds(out, hits, ray_o, ray_d, grid, inputs, cfg, sh_deg,
                            back_culling, pair_tab=pair_tab)
    return out


def first_hit(ray_o, ray_d, grid: Grid, inputs: TraceInputs, *,
              cfg: TracerConfig):
    """Boolean any-hit test of [R] rays (≙ first_hit, :1833-1837)."""
    out = trace_forward_only(ray_o, ray_d, grid, inputs, cfg=cfg, sh_deg=0)
    return out.alpha > 0.0


# ---------------------------------------------------------------------------
# brute-force reference (test oracle)
# ---------------------------------------------------------------------------

def trace_reference(ray_o, ray_d, inputs: TraceInputs, alive, *,
                    alpha_min: float = 1.0 / 255.0,
                    transmittance_min: float = 0.03, t_min: float = 1e-6,
                    sh_deg: int = 3, back_culling: bool = False) -> TraceOut:
    """O(R·N): every Gaussian against every ray, sorted by (depth, index),
    terminated at T < transmittance_min. Differentiable by autograd."""
    alpha, color, n_flip, feat, d = _hit_quantities(
        inputs.means3d[None], inputs.opacity[None], inputs.ru[None],
        inputs.rv[None], inputs.normals[None], inputs.shs[None],
        inputs.features[None], ray_o[:, None], ray_d[:, None], sh_deg)
    accept = alive[None] & (alpha >= alpha_min) & (d >= t_min)
    if back_culling:
        accept = accept & (torch.sum(ray_d[:, None] * inputs.normals[None], -1) < 0)
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    d_key = torch.where(accept, d, torch.full_like(d, INF)).detach()
    idx = torch.arange(d.shape[-1], device=d.device)
    order = torch.sort(_f32_bits(d_key).long() * (1 << 32) + idx, dim=-1).indices
    take = lambda x: torch.take_along_dim(x, order, dim=-1)
    take3 = lambda x: torch.take_along_dim(x, order[..., None], dim=1)
    alpha_s, d_s = take(alpha), take(d)
    color_s = take3(color)
    nrm_s = take3(n_flip)
    feat_s = take3(feat.expand(d.shape + (feat.shape[-1],)))
    lg = torch.log1p(-alpha_s)
    T = torch.exp(torch.cumsum(lg, -1) - lg)
    w = torch.where(T > transmittance_min, alpha_s * T, torch.zeros_like(T))
    return TraceOut(
        color=torch.einsum("rk,rkc->rc", w, color_s),
        normal=torch.einsum("rk,rkc->rc", w, nrm_s),
        feature=torch.einsum("rk,rks->rs", w, feat_s),
        depth=torch.sum(w * d_s, -1), alpha=torch.sum(w, -1),
        trans=torch.exp(torch.sum(lg, -1)))


def normalize_trace(out: TraceOut, transmittance_min: float) -> TraceOut:
    """Saturated rays (alpha ≥ 1 - t_min) get outputs divided by alpha and
    alpha snapped to 1 (:1895-1909)."""
    a = out.alpha[:, None]
    sat = a >= (1.0 - transmittance_min)
    safe = maximum(a, 1e-6)
    return TraceOut(
        color=torch.where(sat, out.color / safe, out.color),
        normal=torch.where(sat, out.normal / safe, out.normal),
        feature=torch.where(sat, out.feature / safe, out.feature),
        depth=torch.where(sat[:, 0], out.depth / safe[:, 0], out.depth),
        alpha=torch.where(sat[:, 0], torch.ones_like(out.alpha), out.alpha),
        trans=out.trans)
