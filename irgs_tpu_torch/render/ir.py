"""Stage-2 renderer: G-buffer maps -> Monte-Carlo rendering equation with
traced visibility and indirect light (≙ irgs_tpu/render/ir.py).

Training picks a fixed-size random subset of eligible pixels by the largest
masked random scores; `select_train_pixels` and the sampler take their
uniforms as tensors so a caller (or a test) controls every draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..ops import grid_tracer as gt
from ..ops import surfel_raster as sr
from ..scene import envlight
from ..scene.cameras import CameraParams
from ..utils import math3d
from ..utils.math3d import maximum, safe_normalize
from .sampling import fibonacci_sphere_sampling

F0 = 0.04


def ggx_specular(normal, pts2c, pts2l, roughness, fresnel: float = 0.04):
    """Analytic GGX lobe: normal/pts2c [B,3], pts2l [B,S,3], roughness [B,1]
    -> [B,S,1] (≙ ggx_specular, :33)."""
    L = safe_normalize(pts2l)
    V = safe_normalize(pts2c)
    H = safe_normalize((L + V[:, None, :]) / 2.0)
    N = safe_normalize(normal)
    N = N * torch.sign(torch.sum(V * N, dim=-1, keepdim=True))

    clamp = lambda x: math3d.clip(x, 1e-6, 1.0)
    NoL = clamp(torch.sum(N[:, None, :] * L, -1, keepdim=True))
    NoV = clamp(torch.sum(N * V, -1, keepdim=True))
    NoH = clamp(torch.sum(N[:, None, :] * H, -1, keepdim=True))
    VoH = clamp(torch.sum(V[:, None, :] * H, -1, keepdim=True))

    alpha = roughness * roughness
    alpha2 = alpha * alpha
    k = (alpha + 2 * roughness + 1.0) / 8.0
    FMi = (-5.55473 * VoH - 6.98316) * VoH
    frac0 = fresnel + (1 - fresnel) * torch.pow(2.0, FMi)
    frac = frac0 * alpha2[:, None, :]
    nom0 = NoH * NoH * (alpha2[:, None, :] - 1) + 1
    nom1 = NoV * (1 - k) + k
    nom2 = NoL * (1 - k[:, None, :]) + k[:, None, :]
    nom = math3d.clip(4 * math.pi * nom0 * nom0 * nom1[:, None, :] * nom2,
                      1e-6, 4 * math.pi)
    return frac / nom


@dataclasses.dataclass(frozen=True)
class ShadeConfig:
    diffuse_sample_num: int = 256
    light_sample_num: int = 0
    light_t_min: float = 0.05
    wo_indirect: bool = False
    detach_indirect: bool = False
    training: bool = True
    env_activation: str = "exp"


def mis_directions(diffuse_dirs, diffuse_areas, env_pdf, cfg: ShadeConfig,
                   draws: envlight.LightDraws, env_transform=None):
    """The multiple-importance sample set: the s_d hemisphere samples and the
    s_l light samples of `draws`, each weighted by the balance heuristic
    over both strategies' pdfs (≙ irgs_tpu rendering_equation, ir.py:105-124,
    and rendering_equation_relight, relight.py:120-141). Returns
    (incident_dirs [B, s_d+s_l, 3], incident_areas [B, s_d+s_l, 1],
    light_dirs [B, s_l, 3])."""
    s_d, s_l = cfg.diffuse_sample_num, cfg.light_sample_num
    p_diffuse = s_d / (s_d + s_l)
    p_light = s_l / (s_d + s_l)
    diffuse_pdfs = 1.0 / diffuse_areas
    light_dirs, light_pdfs = envlight.sample_light_dirs(
        env_pdf, draws, transform=env_transform)
    light_pdfs_diffuse = envlight.light_pdf(env_pdf, diffuse_dirs,
                                            transform=env_transform)
    diffuse_pdfs = diffuse_pdfs * p_diffuse + light_pdfs_diffuse * p_light
    light_pdfs = (1.0 / (2.0 * math.pi)) * p_diffuse + light_pdfs * p_light
    incident_dirs = torch.cat([diffuse_dirs, light_dirs], dim=1)
    incident_areas = 1.0 / maximum(torch.cat([diffuse_pdfs, light_pdfs], 1),
                                   1e-6)
    return incident_dirs, incident_areas, light_dirs


def light_draws_for(env_pdf, cfg: ShadeConfig, batch: int, pixel_ids=None,
                    light_draws=None, light_seed=0):
    """`light_draws` if given, else the sampler's draws for the batch: keyed
    by `pixel_ids` where given, by the batch slot otherwise."""
    if light_draws is not None:
        return light_draws
    return envlight.draw_light(
        env_pdf, batch if pixel_ids is None else pixel_ids,
        cfg.light_sample_num, seed=light_seed, training=cfg.training)


def rendering_equation(base_color, roughness, normals, position, viewdirs,
                       env_raw, env_pdf, trace_fn: Callable, cfg: ShadeConfig,
                       theta_u=None, env_transform=None, pixel_ids=None,
                       light_draws: envlight.LightDraws | None = None,
                       light_seed=0, shard=None):
    """MC estimate of the rendering equation at [B] surface points
    (≙ rendering_equation, :78-178): s_d hemisphere samples, and with
    `light_sample_num` > 0 the MIS mixture with s_l light samples.
    `theta_u` [B, 1]: the hemisphere sampler's uniforms (training).
    `env_transform` [3, 3] rotates the environment lookups. The light
    samples are `light_draws` when given (a test feeds JAX's), else drawn
    with `light_seed` and keyed by `pixel_ids` (or by the batch slot).

    `shard`, a parallel.Mesh: every rank builds the full sample set, traces
    only its slice [rank·s, (rank+1)·s) of each pixel's s·size samples, and
    every result is averaged over the ranks (equal slices: the mean of the
    partial means is the full-sample mean)."""
    s_d, s_l = cfg.diffuse_sample_num, cfg.light_sample_num
    if s_d <= 0:
        raise NotImplementedError("diffuse_sample_num must be > 0")
    incident_dirs, incident_areas = fibonacci_sphere_sampling(
        normals, s_d, u=theta_u if cfg.training else None)
    if s_l > 0:
        draws = light_draws_for(env_pdf, cfg, base_color.shape[0], pixel_ids,
                                light_draws, light_seed)
        incident_dirs, incident_areas, _ = mis_directions(
            incident_dirs, incident_areas, env_pdf, cfg, draws, env_transform)

    if shard is not None:
        s_total = incident_dirs.shape[1]
        if s_total % shard.size:
            raise ValueError(f"sample count {s_total} must divide the mesh "
                             f"size {shard.size}")
        s_loc = s_total // shard.size
        mine = slice(shard.rank * s_loc, (shard.rank + 1) * s_loc)
        incident_dirs = incident_dirs[:, mine]
        incident_areas = incident_areas[:, mine]

    global_incident = envlight.query_env(env_raw, incident_dirs,
                                         activation=cfg.env_activation,
                                         transform=env_transform)
    rays_o = position[:, None] + incident_dirs * cfg.light_t_min
    trace_out = trace_fn(rays_o, incident_dirs)
    incident_visibility = 1.0 - trace_out.alpha[..., None]
    local_incident = trace_out.color
    if cfg.wo_indirect:
        local_incident = torch.zeros_like(local_incident)
    if cfg.detach_indirect:
        incident_visibility = incident_visibility.detach()
        local_incident = local_incident.detach()
    incident_lights = incident_visibility * global_incident + local_incident

    n_d_i = maximum(torch.sum(normals[:, None] * incident_dirs, -1,
                              keepdim=True), 0.0)
    f_d = base_color[:, None] / math.pi
    f_s = ggx_specular(normals, viewdirs, incident_dirs, roughness, fresnel=F0)
    transport = incident_lights * incident_areas * n_d_i
    results = {"diffuse": torch.mean(f_d * transport, dim=-2),
               "specular": torch.mean(f_s * transport, dim=-2),
               "light_direct": torch.mean(global_incident, dim=1)}
    if not cfg.training:
        results.update({
            "visibility": torch.mean(incident_visibility, dim=1),
            "light": torch.mean(incident_lights, dim=1),
            "light_indirect": torch.mean(local_incident, dim=1)})
    if shard is not None:
        names = list(results)
        results = dict(zip(names, shard.pmean([results[k] for k in names])))
    return results


def trace_inputs(params, aux, cam_pos,
                 with_materials: bool = False) -> gt.TraceInputs:
    """The tracer's view of the Gaussians (dead ones at opacity 0), with
    base colour and roughness as features or none."""
    s = params.get_scaling()
    R = math3d.quat_to_rotmat(params.rotation)
    opacity = torch.where(aux.alive, params.get_opacity()[:, 0],
                          torch.zeros_like(params.opacity[:, 0]))
    if with_materials:
        features = torch.cat([params.get_base_color(), params.get_roughness()], -1)
    else:
        features = torch.zeros((params.n_capacity, 0), dtype=torch.float32,
                               device=params.xyz.device)
    return gt.TraceInputs(
        means3d=params.xyz, opacity=opacity, ru=R[:, :, 0] / s[:, 0:1],
        rv=R[:, :, 1] / s[:, 1:2], normals=params.world_normals(cam_pos=cam_pos),
        shs=params.get_features(), features=features)


def make_trace_fn(params, aux, grid, tracer_cfg: gt.TracerConfig, cam_pos,
                  sh_deg: int, with_materials: bool = False,
                  ray_chunk: int = 65536, stats_out: dict | None = None):
    """Bind the Gaussian state into a trace closure (≙ make_trace_fn,
    :181-336). More than `ray_chunk` rays take the chunked path: coherence
    sort, one collect+select over all rays (in memory-bounded groups),
    blends per chunk, re-trace rounds, and the `trace_trunc_frac` /
    `trace_more_frac` stats in `stats_out`. Fewer rays take trace_segments."""
    inputs = trace_inputs(params, aux, cam_pos, with_materials)
    g = tracer_cfg.grid_res
    tmin = tracer_cfg.transmittance_min

    def trace_fn(rays_o, rays_d):
        shape = rays_o.shape[:-1]
        ro = rays_o.reshape(-1, 3)
        rd = rays_d.reshape(-1, 3)
        m = ro.shape[0]
        if m > ray_chunk:
            with torch.no_grad():
                oct_ = ((rd[:, 0] > 0).long() * 4 + (rd[:, 1] > 0).long() * 2
                        + (rd[:, 2] > 0).long())
                cell = torch.clamp(((ro - grid.bb_min) * grid.inv_cell).long(),
                                   0, g - 1)
                ckey = (cell[:, 2] * g + cell[:, 1]) * g + cell[:, 0]
                order = torch.sort(oct_ * g ** 3 + ckey, stable=True).indices
                inv_order = torch.empty_like(order)
                inv_order[order] = torch.arange(m, device=order.device)
            ro, rd = ro[order], rd[order]
            pad = (-m) % ray_chunk
            rop = torch.nn.functional.pad(ro, (0, 0, 0, pad))
            rdp = torch.nn.functional.pad(rd, (0, 0, 0, pad), value=1.0)
            mp = rop.shape[0]
            ro_sg, rd_sg = rop.detach(), rdp.detach()
            geom = gt._detached_geom(inputs)
            pair_tab = gt._maybe_pair_tab(grid, geom, tracer_cfg)
            # collect + select once over all rays, in groups that bound the
            # working set (per-ray independent, so grouping changes nothing)
            group = gt._sel_chunk(tracer_cfg)
            parts = []
            for a in range(0, mp, group):
                o_i, d_i = ro_sg[a:a + group], rd_sg[a:a + group]
                cl = gt.collect_cells(o_i, d_i, grid, tracer_cfg)
                parts.append(gt.select_hits(o_i, d_i, grid, cl, geom,
                                            tracer_cfg, False,
                                            pair_tab=pair_tab))
            hits = gt.SelectedHits(*[torch.cat(x) for x in zip(*parts)])
            outs = [gt.trace(rop[a:a + ray_chunk], rdp[a:a + ray_chunk], grid,
                             inputs, cfg=tracer_cfg, sh_deg=sh_deg,
                             hits=gt.SelectedHits(*[x[a:a + ray_chunk]
                                                    for x in hits]))
                    for a in range(0, mp, ray_chunk)]
            out = gt.TraceOut(*[torch.cat(x) for x in zip(*outs)])
            row_ok = torch.arange(mp, device=rop.device) < m
            hits = hits._replace(more=hits.more & row_ok)
            if stats_out is not None:
                need0 = hits.more & (out.trans.detach() > tmin)
                stats_out["trace_trunc_frac"] = need0.sum() / m
            if tracer_cfg.n_segments > 1:
                out, hits = gt.retrace_rounds(out, hits, rop, rdp, grid,
                                              inputs, tracer_cfg, sh_deg,
                                              pair_tab=pair_tab)
            if stats_out is not None:
                need_end = hits.more & (out.trans.detach() > tmin)
                stats_out["trace_more_frac"] = need_end.sum() / m
            out = gt.TraceOut(*[x[:m][inv_order] for x in out])
        elif tracer_cfg.n_segments > 1:
            out = gt.trace_segments(ro, rd, grid, inputs, cfg=tracer_cfg,
                                    sh_deg=sh_deg)
        else:
            out = gt.trace(ro, rd, grid, inputs, cfg=tracer_cfg, sh_deg=sh_deg)
        out = gt.normalize_trace(out, tmin)
        return gt.TraceOut(*[x.reshape(shape + x.shape[1:]) for x in out])

    return trace_fn


def derive_geometry_maps(out: sr.RasterOut, cam: CameraParams, img_w: int,
                         img_h: int, depth_ratio: float = 0.0):
    """G-buffer post-processing (≙ derive_geometry_maps, :339): world
    normals, expected/median depth, world points, finite-difference surface
    normal. The clamps (1e-12, 1e-6) are the reference's."""
    alpha = out.alpha[..., None]
    r_c2w = cam.w2c[:3, :3].T
    rend_normal = out.normal @ r_c2w.T
    depth_expected = torch.nan_to_num(out.depth / maximum(alpha[..., 0], 1e-12))
    depth_median = torch.nan_to_num(out.depth_median)
    surf_depth = depth_expected * (1 - depth_ratio) + depth_ratio * depth_median

    rays_unnorm = cam.ray_dirs(img_w, img_h, normalize=False)
    points = surf_depth[..., None] * rays_unnorm + cam.cam_pos

    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    sn = safe_normalize(torch.linalg.cross(dx, dy, dim=-1))
    surf_normal = torch.nn.functional.pad(sn, (0, 0, 1, 1, 1, 1))
    surf_normal = surf_normal * alpha.detach()

    normal_map = safe_normalize(rend_normal / maximum(alpha, 1e-6))
    return dict(alpha=alpha, rend_normal=rend_normal, surf_depth=surf_depth,
                depth_expected=depth_expected, depth_median=depth_median,
                points=points, surf_normal=surf_normal, normal_map=normal_map,
                rays_d=cam.ray_dirs(img_w, img_h, normalize=True))


def select_train_pixels(uniforms, eligible, num_pixels: int):
    """`num_pixels` pixels among `eligible` [H, W] by the largest masked
    scores (≙ select_train_pixels, :372; `uniforms` [H*W] replaces its
    jax.random.uniform draw). Ties keep the lower index first, as
    jax.lax.top_k does. Returns flat indices [P] and a validity mask [P]."""
    flat = eligible.reshape(-1)
    scores = torch.where(flat, uniforms, torch.full_like(uniforms, -1.0))
    idx = torch.sort(scores, descending=True, stable=True).indices[:num_pixels]
    return idx, flat[idx]
