"""Relighting (≙ irgs_tpu/render/relight.py): swap in an HDR envmap and
re-shade the traced hits with split-sum IBL.

`build_relight_env` prefilters the envmap (cube mips, diffuse map, texel
pdf); `rendering_equation_relight` shades surface points with the MIS
mixture of hemisphere and light samples, the traced hits re-shaded from
their own materials, which the trace function returns
(`make_trace_fn(..., with_materials=True)`). `trace_diffuse_cache` traces the
envmap-independent hemisphere half once per view for every envmap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import cubemap as cm
from ..scene import envlight
from ..utils.math3d import maximum, safe_normalize
from . import ir
from .sampling import fibonacci_sphere_sampling


class RelightEnv(NamedTuple):
    """A prefiltered environment (≙ EnvLight after build_mips)."""
    base: torch.Tensor             # [H, W, 3] lat-long, raw
    pdf: torch.Tensor              # [H, W]
    specular_mips: tuple           # [6, R, R, 3] each
    diffuse: torch.Tensor          # [6, Rd, Rd, 3]
    transform: torch.Tensor | None
    activation: str = "none"


def build_relight_env(latlong_hdr, transform=None, max_res: int = 128,
                      min_res: int = 16, activation: str = "none") -> RelightEnv:
    """≙ EnvLight.build_mips + update_pdf."""
    base_cube = cm.latlong_to_cubemap(latlong_hdr, max_res)
    specular, diffuse = cm.build_specular_mips(base_cube, min_res=min_res)
    pdf = envlight.build_pdf(latlong_hdr, activation=activation)
    return RelightEnv(base=latlong_hdr, pdf=pdf, specular_mips=tuple(specular),
                      diffuse=diffuse, transform=transform,
                      activation=activation)


def _activate(env: RelightEnv, light):
    return maximum(envlight.activate(light, env.activation), 0.0)


def env_query(env: RelightEnv, dirs, mode: str = "pure_env", roughness=None):
    """Radiance of `env` along `dirs`: the lat-long map ("pure_env"), the
    diffuse cube ("diffuse") or the specular mips at `roughness`
    ("specular") (≙ EnvLight.__call__)."""
    d = dirs if env.transform is None else dirs @ env.transform.T
    if mode == "pure_env":
        return envlight.query_env(env.base, dirs, activation=env.activation,
                                  transform=env.transform)
    if mode == "diffuse":
        return _activate(env, cm.sample_cubemap_smooth(env.diffuse, d))
    if mode == "specular":
        mip = cm.roughness_to_mip(roughness[..., 0], len(env.specular_mips))
        return _activate(env, cm.sample_cubemap_mip(list(env.specular_mips),
                                                    d, mip, smooth=True))
    raise ValueError(mode)


class _TraceLike(NamedTuple):
    alpha: torch.Tensor
    normal: torch.Tensor
    feature: torch.Tensor


class DiffuseTraceCache(NamedTuple):
    """The envmap-independent half of the relight shading of one pixel
    chunk: the hemisphere directions and what their rays hit (geometry and
    materials, not radiance), reused for every envmap."""
    dirs: torch.Tensor       # [B, s_d, 3]
    areas: torch.Tensor      # [B, s_d, 1] hemisphere sampler areas
    alpha: torch.Tensor      # [B, s_d]
    normal: torch.Tensor     # [B, s_d, 3]
    feature: torch.Tensor    # [B, s_d, 4] premultiplied base colour | roughness


def trace_diffuse_cache(normals, position, trace_fn, cfg: ir.ShadeConfig,
                        theta_u=None) -> DiffuseTraceCache:
    """Trace the hemisphere half of the relight sample set (deterministic at
    eval; `theta_u` rotates it when training)."""
    dirs, areas = fibonacci_sphere_sampling(
        normals, cfg.diffuse_sample_num, u=theta_u if cfg.training else None)
    out = trace_fn(position[:, None] + dirs * cfg.light_t_min, dirs)
    return DiffuseTraceCache(dirs=dirs, areas=areas, alpha=out.alpha,
                             normal=out.normal, feature=out.feature[..., :4])


def rendering_equation_relight(base_color, roughness, normals, position,
                               viewdirs, env: RelightEnv, trace_fn,
                               cfg: ir.ShadeConfig, fg_lut, theta_u=None,
                               f0: float = 0.02,
                               wo_indirect_relight: bool = False,
                               pixel_ids=None,
                               diffuse_cache: DiffuseTraceCache | None = None,
                               light_draws: envlight.LightDraws | None = None,
                               light_seed=0):
    """Relit MC shading at [B] surface points (≙ rendering_equation_relight,
    relight.py:100-198). `trace_fn` returns the hits' materials in
    TraceOut.feature[..., :4]. `diffuse_cache` skips re-tracing the
    hemisphere half (the light half still traces against this env's pdf);
    the light draws are `light_draws`, or the sampler's keyed by
    `pixel_ids` (or the batch slot) with `light_seed`."""
    s_d, s_l = cfg.diffuse_sample_num, cfg.light_sample_num
    tf = env.transform
    if diffuse_cache is not None:
        incident_dirs, incident_areas = diffuse_cache.dirs, diffuse_cache.areas
    else:
        incident_dirs, incident_areas = fibonacci_sphere_sampling(
            normals, s_d, u=theta_u if cfg.training else None)
    if s_l > 0:
        draws = ir.light_draws_for(env.pdf, cfg, base_color.shape[0],
                                   pixel_ids, light_draws, light_seed)
        incident_dirs, incident_areas, light_dirs = ir.mis_directions(
            incident_dirs, incident_areas, env.pdf, cfg, draws, tf)

    global_incident = env_query(env, incident_dirs, "pure_env")

    if diffuse_cache is not None and s_l > 0:
        lt = trace_fn(position[:, None] + light_dirs * cfg.light_t_min,
                      light_dirs)
        trace_out = _TraceLike(
            alpha=torch.cat([diffuse_cache.alpha, lt.alpha], 1),
            normal=torch.cat([diffuse_cache.normal, lt.normal], 1),
            feature=torch.cat([diffuse_cache.feature, lt.feature[..., :4]], 1))
    elif diffuse_cache is not None:
        trace_out = _TraceLike(diffuse_cache.alpha, diffuse_cache.normal,
                               diffuse_cache.feature)
    else:
        trace_out = trace_fn(position[:, None] + incident_dirs * cfg.light_t_min,
                             incident_dirs)
    trace_alpha = trace_out.alpha[..., None]
    incident_visibility = 1.0 - trace_alpha
    trace_feature = trace_out.feature / maximum(trace_alpha, 1e-6)
    trace_normal = safe_normalize(trace_out.normal)
    trace_base, trace_rough = trace_feature[..., :3], trace_feature[..., 3:4]

    # the hits re-shaded with split-sum IBL
    trace_diffuse = trace_base * env_query(env, trace_normal, "diffuse")
    trace_wi = -incident_dirs
    ndotv = torch.sum(trace_normal * trace_wi, -1, keepdim=True)
    reflected = safe_normalize(2.0 * ndotv * trace_normal - trace_wi)
    fg_uv = torch.clamp(torch.cat([ndotv, trace_rough], -1), 0.0, 1.0)
    fg = cm.sample_fg_lut(fg_lut, fg_uv[..., 0:1], fg_uv[..., 1:2])
    trace_spec = env_query(env, reflected, "specular", roughness=trace_rough) \
        * (f0 * fg[..., 0:1] + fg[..., 1:2])
    local_incident = (trace_diffuse + trace_spec) * trace_alpha
    if wo_indirect_relight:
        local_incident = torch.zeros_like(local_incident)
    incident_lights = incident_visibility * global_incident + local_incident

    n_d_i = maximum(torch.sum(normals[:, None] * incident_dirs, -1,
                              keepdim=True), 0.0)
    f_d = base_color[:, None] / torch.pi
    f_s = ir.ggx_specular(normals, viewdirs, incident_dirs, roughness,
                          fresnel=0.04)
    transport = incident_lights * incident_areas * n_d_i
    return {
        "diffuse": torch.mean(f_d * transport, dim=-2),
        "specular": torch.mean(f_s * transport, dim=-2),
        "visibility": torch.mean(incident_visibility, dim=1),
        "light": torch.mean(incident_lights, dim=1),
        "light_indirect": torch.mean(local_incident, dim=1),
        "light_direct": torch.mean(global_incident, dim=1),
    }
