"""Stage-1 (Ref-Gaussian) renderers (≙ irgs_tpu/render/ref_gaussian.py):
plain 2DGS (`render_initial`), per-Gaussian forward shading then splat
(`render_volume`), the simplified metallic workflow (`render_surfel2`) and
pixel-space deferred shading with split-sum IBL (`render_surfel`).
Reflection visibility, where asked for, ray-marches the fused TSDF
(ops/tsdf.py).

The feature widths they rasterize are the blend kernels' S: 0 (initial),
11 (volume; 18 with the indirect features), 5 (surfel2) and 8 (surfel).
"""

from __future__ import annotations

import torch

from ..ops import surfel_raster as sr
from ..ops import tsdf as tsdf_ops
from ..scene import cubemap as cm
from ..scene.cameras import CameraParams
from ..utils import sh as sh_utils
from ..utils.math3d import clip, maximum, rgb_to_srgb, safe_normalize
from . import ir


def _offset(params, means2d_offset):
    if means2d_offset is not None:
        return means2d_offset
    return torch.zeros((params.n_capacity, 2), dtype=torch.float32,
                       device=params.xyz.device)


def _rasterize(params, aux, cam, features, means2d_offset, *, img_w, img_h,
               active_sh_degree, dup_capacity, colors_precomp=None):
    dev = params.xyz.device
    return sr.rasterize(
        params.xyz, params.get_scaling(), params.rotation,
        params.get_opacity()[:, 0], params.get_features(), features,
        _offset(params, means2d_offset), cam, torch.zeros(3, device=dev),
        img_w=img_w, img_h=img_h, active_sh_degree=active_sh_degree,
        dup_capacity=dup_capacity, alive=aux.alive,
        colors_precomp=colors_precomp)


def render_initial(params, aux, cam: CameraParams, bg, *, img_w, img_h,
                   active_sh_degree, dup_capacity=2 ** 21, depth_ratio=0.0,
                   means2d_offset=None):
    """Plain 2DGS pass (≙ render_initial, :24)."""
    feats = torch.zeros((params.n_capacity, 0), dtype=torch.float32,
                        device=params.xyz.device)
    raster = _rasterize(params, aux, cam, feats, means2d_offset, img_w=img_w,
                        img_h=img_h, active_sh_degree=active_sh_degree,
                        dup_capacity=dup_capacity)
    maps = ir.derive_geometry_maps(raster, cam, img_w, img_h, depth_ratio)
    image = raster.color + bg[None, None] * (1 - maps["alpha"])
    return dict(render=image, raster=raster, **maps)


def _per_gaussian_view(params, cam: CameraParams):
    dir_pp = safe_normalize(params.xyz - cam.cam_pos)
    normals = params.world_normals(cam_pos=cam.cam_pos)
    w_o = -dir_pp
    refl = safe_normalize(2.0 * torch.sum(normals * w_o, -1, keepdim=True)
                          * normals - w_o)
    return normals, w_o, refl


def _indirect(params, refl):
    return maximum(sh_utils.eval_sh(3, params.get_indirect().transpose(-1, -2),
                                    refl), 0.0)


def render_volume(params, aux, cam: CameraParams, bg, env2, fg_lut, *, img_w,
                  img_h, active_sh_degree, dup_capacity=2 ** 21,
                  depth_ratio=0.0, vol=None, use_indirect=False,
                  means2d_offset=None):
    """Per-Gaussian forward shading, then splat (≙ render_volume, :50):
    colours precomputed per Gaussian, 11 features (18 with indirect)."""
    metallic = params.get_metallic()
    rough = params.get_roughness()
    base_color = params.get_base_color()
    normals, w_o, refl = _per_gaussian_view(params, cam)

    fg = cm.sample_fg_lut(fg_lut,
                          clip(torch.sum(normals * w_o, -1, keepdim=True), 0, 1),
                          clip(rough, 0, 1))
    diffuse = env2.query(normals, mode="diffuse") * (1 - metallic) * base_color
    direct = env2.query(refl, mode="specular", roughness=rough)
    spec_weight = ((0.04 * (1 - metallic) + base_color * metallic)
                   * fg[..., 0:1] + fg[..., 1:2])

    indirect_on = use_indirect and vol is not None
    if indirect_on:
        indirect = _indirect(params, refl)
        _, visible = tsdf_ops.ray_march_visibility(vol, params.xyz.detach(),
                                                   refl.detach())
        vis = visible.to(torch.float32)[:, None]
        specular_light = direct * vis + (1 - vis) * indirect
        extra = [vis, indirect, direct]
    else:
        specular_light = direct
        extra = []
    specular = specular_light * spec_weight

    colors_precomp = diffuse + specular
    features = torch.cat([rough, metallic, diffuse, specular, base_color,
                          *extra], -1)
    raster = _rasterize(params, aux, cam, features, means2d_offset,
                        img_w=img_w, img_h=img_h,
                        active_sh_degree=active_sh_degree,
                        dup_capacity=dup_capacity,
                        colors_precomp=colors_precomp)
    maps = ir.derive_geometry_maps(raster, cam, img_w, img_h, depth_ratio)
    final = raster.color + bg[None, None] * (1 - maps["alpha"])
    f = raster.feature
    out = dict(render=final, raster=raster, roughness_map=f[..., 0:1],
               metallic_map=f[..., 1:2], diffuse_map=f[..., 2:5],
               specular_map=f[..., 5:8], base_color_map=f[..., 8:11], **maps)
    if indirect_on:
        out.update(visibility=f[..., 11:12], indirect_light=f[..., 12:15],
                   direct_light=f[..., 15:18])
    return out


def _pixel_reflection(maps):
    w_o_px = -maps["rays_d"]
    normal_map = maps["normal_map"]
    ndotv = torch.sum(normal_map * w_o_px, -1, keepdim=True)
    return ndotv, safe_normalize(2.0 * ndotv * normal_map - w_o_px)


def render_surfel2(params, aux, cam: CameraParams, bg, env, *, img_w, img_h,
                   active_sh_degree, dup_capacity=2 ** 21, depth_ratio=0.0,
                   means2d_offset=None):
    """Simplified metallic workflow (≙ render_surfel2, :109): specular is a
    direct envmap query at the pixel's reflection direction; final =
    (1 - metallic)·sh_colour + metallic·specular, in sRGB. 5 features."""
    features = torch.cat([params.get_metallic(), params.get_roughness(),
                          params.get_base_color()], -1)
    raster = _rasterize(params, aux, cam, features, means2d_offset,
                        img_w=img_w, img_h=img_h,
                        active_sh_degree=active_sh_degree,
                        dup_capacity=dup_capacity)
    maps = ir.derive_geometry_maps(raster, cam, img_w, img_h, depth_ratio)
    base_color = raster.color
    metallic = raster.feature[..., 0:1]
    _, rays_refl = _pixel_reflection(maps)
    specular = env.query(rays_refl, mode="pure_env")
    final = rgb_to_srgb((1 - metallic) * base_color + specular * metallic)
    final = final + bg[None, None] * (1 - maps["alpha"])
    return dict(render=final, raster=raster, metallic_map=metallic,
                roughness_map=raster.feature[..., 1:2],
                base_color_map=raster.feature[..., 2:5],
                diffuse_map=(1 - metallic) * base_color,
                specular_map=specular * metallic, **maps)


def render_surfel(params, aux, cam: CameraParams, bg, env1, fg_lut, *, img_w,
                  img_h, active_sh_degree, dup_capacity=2 ** 21,
                  depth_ratio=0.0, vol=None, use_indirect=False,
                  means2d_offset=None):
    """Deferred pixel-space shading (≙ render_surfel, :150): metallic,
    roughness, base colour and the indirect light per Gaussian as 8
    features, then the split-sum specular per pixel."""
    _, _, refl = _per_gaussian_view(params, cam)
    features = torch.cat([params.get_metallic(), params.get_roughness(),
                          params.get_base_color(), _indirect(params, refl)],
                         -1)
    raster = _rasterize(params, aux, cam, features, means2d_offset,
                        img_w=img_w, img_h=img_h,
                        active_sh_degree=active_sh_degree,
                        dup_capacity=dup_capacity)
    maps = ir.derive_geometry_maps(raster, cam, img_w, img_h, depth_ratio)
    alpha = maps["alpha"]
    base_color = raster.color
    metallic = raster.feature[..., 0:1]
    roughness = raster.feature[..., 1:2]
    albedo = raster.feature[..., 2:5]
    indirect_light = raster.feature[..., 5:8]

    ndotv, rays_refl = _pixel_reflection(maps)
    fg = cm.sample_fg_lut(fg_lut, clip(ndotv, 0, 1), clip(roughness, 0, 1))
    direct_light = env1.query(rays_refl, mode="specular", roughness=roughness)
    spec_weight = ((0.04 * (1 - metallic) + albedo * metallic) * fg[..., 0:1]
                   + fg[..., 1:2])

    indirect_on = use_indirect and vol is not None
    if indirect_on:
        _, visible = tsdf_ops.ray_march_visibility(
            vol, maps["points"].reshape(-1, 3).detach(),
            rays_refl.reshape(-1, 3).detach())
        mask = (alpha > 0).to(torch.float32)
        visibility = visible.to(torch.float32).reshape(alpha.shape)
        visibility = visibility * mask + (1 - mask)
        specular_light = (direct_light * visibility
                          + (1 - visibility) * indirect_light)
    else:
        specular_light = direct_light

    specular = specular_light * alpha * spec_weight
    final = (1 - metallic) * base_color + specular
    final = final + bg[None, None] * (1 - alpha)
    out = dict(render=final, raster=raster, metallic_map=metallic,
               diffuse_map=(1 - metallic) * base_color, specular_map=specular,
               base_color_map=albedo, roughness_map=roughness, **maps)
    if indirect_on:
        out.update(visibility=visibility, indirect_light=indirect_light,
                   direct_light=direct_light)
    return out
