"""Stage-2 trainer: material + environment-light fitting
(≙ irgs_tpu/train/stage2.py:37-338, the train_ray branch).

One step: rasterize the surfels with base colour and roughness as features
(the blend runs as the CUDA kernels on the card), derive the G-buffer maps,
pick a fixed number of eligible pixels, shade them with the Monte-Carlo
rendering equation through the grid tracer, compute calculate_loss2 and take
one Adam step. Geometry stays frozen at lr_scale = 0.

Every random draw comes in `Stage2Draws` (made by `draw_stage2` from a
torch.Generator, or handed in by a caller that wants the JAX draws).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import grid_tracer as gt
from ..ops import surfel_raster as sr
from ..render import ir
from ..scene import envlight
from ..scene.cameras import CameraParams
from ..scene.gaussians import GaussianAux, GaussianParams
from ..utils.math3d import rgb_to_srgb
from . import losses as L
from .optim import GaussianOptimizer


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    aux: GaussianAux
    optimizer: GaussianOptimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class Stage2Static:
    """Static configuration of one training step (same fields as the
    reference's, less its raster backend switch)."""
    img_w: int
    img_h: int
    active_sh_degree: int
    diffuse_sample_num: int
    light_sample_num: int
    trace_num_rays: int
    light_t_min: float
    wo_indirect: bool
    detach_indirect: bool
    white_background: bool
    dup_capacity: int
    tracer: gt.TracerConfig
    train_ray: bool = True
    env_activation: str = "exp"
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal_render_depth: float = 0.05
    lambda_normal_smooth: float = 0.01
    lambda_depth_smooth: float = 0.0
    lambda_mask_entropy: float = 0.01
    lambda_base_color_smooth: float = 0.0
    lambda_roughness_smooth: float = 0.0
    lambda_light: float = 0.0
    lambda_light_smooth: float = 0.0
    normal_loss_start: int = 1000
    dist_loss_start: int = 1000
    depth_ratio: float = 0.0

    @property
    def num_shaded_pixels(self) -> int:
        return self.trace_num_rays // (self.diffuse_sample_num
                                       + self.light_sample_num)


def from_configs(cfg, img_w: int, img_h: int,
                 active_sh_degree: int = 3) -> Stage2Static:
    p, o, m = cfg.pipe, cfg.opt, cfg.model
    return Stage2Static(
        img_w=img_w, img_h=img_h, active_sh_degree=active_sh_degree,
        diffuse_sample_num=p.diffuse_sample_num,
        light_sample_num=p.light_sample_num,
        trace_num_rays=o.trace_num_rays, light_t_min=p.light_t_min,
        train_ray=o.train_ray, env_activation=m.envmap_activation,
        wo_indirect=p.wo_indirect, detach_indirect=p.detach_indirect,
        white_background=m.white_background,
        dup_capacity=p.dup_capacity or 2 ** 21,
        tracer=gt.TracerConfig.from_pipe(p),
        lambda_dssim=o.lambda_dssim, lambda_dist=o.lambda_dist,
        lambda_normal_render_depth=o.lambda_normal_render_depth,
        lambda_normal_smooth=o.lambda_normal_smooth,
        lambda_depth_smooth=o.lambda_depth_smooth,
        lambda_mask_entropy=o.lambda_mask_entropy,
        lambda_base_color_smooth=o.lambda_base_color_smooth,
        lambda_roughness_smooth=o.lambda_roughness_smooth,
        lambda_light=o.lambda_light, lambda_light_smooth=o.lambda_light_smooth,
        normal_loss_start=o.normal_loss_start,
        dist_loss_start=o.dist_loss_start, depth_ratio=p.depth_ratio)


class Stage2Draws(NamedTuple):
    """The uniforms one step consumes (≙ the two halves of the reference's
    jax.random.split(key), stage2.py:158)."""
    pixel_u: torch.Tensor  # [H*W] pixel-selection scores (ir.py:377)
    theta_u: torch.Tensor  # [P, 1] sampler rotations (sampling.py:37)


def draw_stage2(generator: torch.Generator, st: Stage2Static,
                device) -> Stage2Draws:
    """Draw one step's uniforms from `generator` (which lives on `device`)."""
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    return Stage2Draws(pixel_u=torch.rand(st.img_w * st.img_h, **kw),
                       theta_u=torch.rand(st.num_shaded_pixels, 1, **kw))


def stage2_forward_loss(params: GaussianParams, aux: GaussianAux,
                        grid: gt.Grid, cam: CameraParams, gt_image, cam_mask,
                        draws: Stage2Draws, iteration: int, st: Stage2Static):
    """One forward pass + calculate_loss2 -> (loss, metrics)."""
    if not st.train_ray:
        raise NotImplementedError("the full-image branch (train_ray=False) "
                                  "is not ported yet")
    dev = params.xyz.device
    bg = torch.full((3,), 1.0 if st.white_background else 0.0, device=dev)
    features = torch.cat([params.get_base_color(), params.get_roughness()], -1)
    raster = sr.rasterize(
        params.xyz, params.get_scaling(), params.rotation,
        params.get_opacity()[:, 0], params.get_features(), features, None, cam,
        torch.zeros(3, device=dev), img_w=st.img_w, img_h=st.img_h,
        active_sh_degree=st.active_sh_degree, dup_capacity=st.dup_capacity,
        alive=aux.alive)

    maps = ir.derive_geometry_maps(raster, cam, st.img_w, st.img_h,
                                   depth_ratio=st.depth_ratio)
    alpha = maps["alpha"]
    base_color_img = raster.feature[..., :3]
    rough_img = raster.feature[..., 3:4]
    shade_cfg = ir.ShadeConfig(
        diffuse_sample_num=st.diffuse_sample_num,
        light_sample_num=st.light_sample_num, light_t_min=st.light_t_min,
        wo_indirect=st.wo_indirect, detach_indirect=st.detach_indirect,
        training=True, env_activation=st.env_activation)
    pdf = envlight.build_pdf(params.env.detach(), activation=st.env_activation)
    flat = lambda x: x.reshape(-1, x.shape[-1])
    unit_z = torch.tensor([0.0, 0.0, 1.0], device=dev)
    trace_stats = {}

    eligible = alpha[..., 0] > 0.9
    if cam_mask is not None:
        eligible = eligible & cam_mask
    idx, ray_valid = ir.select_train_pixels(draws.pixel_u, eligible,
                                            st.num_shaded_pixels)
    px_base = flat(base_color_img)[idx]
    px_rough = flat(rough_img)[idx]
    px_alpha = flat(alpha)[idx]
    # padding rays (beyond the eligible count) get safe inputs: degenerate
    # normals would turn into NaNs inside the sampling frame
    safe = ray_valid[:, None]
    px_normal = torch.where(safe, flat(maps["normal_map"])[idx], unit_z)
    px_wo = torch.where(safe, -flat(maps["rays_d"])[idx], unit_z)
    px_points = torch.where(safe, flat(maps["points"])[idx],
                            torch.zeros_like(unit_z))

    trace_fn = ir.make_trace_fn(params, aux, grid, st.tracer, cam.cam_pos,
                                st.active_sh_degree, stats_out=trace_stats)
    re = ir.rendering_equation(px_base, px_rough, px_normal, px_points, px_wo,
                               params.env, pdf, trace_fn, shade_cfg,
                               theta_u=draws.theta_u)
    full = rgb_to_srgb(re["diffuse"] + re["specular"])
    ray_rgb = full * px_alpha + bg[None] * (1 - px_alpha)
    gt_flat = flat(gt_image)[idx]
    ray_rgb = torch.where(safe, ray_rgb, torch.zeros_like(ray_rgb))
    gt_flat = torch.where(safe, gt_flat, torch.zeros_like(gt_flat))
    vw = ray_valid.float()[:, None]
    denom = torch.clamp(vw.sum() * 3, min=1.0)

    l_l1 = torch.sum(torch.abs(ray_rgb - gt_flat) * vw) / denom
    loss = l_l1
    metrics = {"loss_l1": l_l1, "ray_psnr": L.psnr(ray_rgb * vw, gt_flat * vw)}

    render_sh = rgb_to_srgb(raster.color) + bg * (1 - alpha)
    sh_mask = (alpha > 0.9).float()
    masked_render = render_sh * sh_mask
    masked_gt = gt_image * sh_mask
    l_sh = ((1 - st.lambda_dssim) * L.l1_loss(masked_render, masked_gt)
            + st.lambda_dssim * (1 - L.ssim(masked_render, masked_gt)))
    loss = loss + l_sh
    metrics.update({"loss_sh": l_sh,
                    "raster_overflow": raster.overflow.float(),
                    "grid_overflow": grid.overflow.float(),
                    "grid_oversize": grid.oversize.float()})
    metrics.update({k: v.detach().float() for k, v in trace_stats.items()})

    if st.lambda_normal_render_depth > 0:
        l_normal = L.normal_consistency_loss(maps["rend_normal"],
                                             maps["surf_normal"])
        on = float(iteration > st.normal_loss_start)
        loss = loss + st.lambda_normal_render_depth * l_normal * on
        metrics["loss_normal"] = l_normal
    if st.lambda_dist > 0:
        on = float(iteration > st.dist_loss_start)
        loss = loss + st.lambda_dist * raster.distortion.mean() * on
    if st.lambda_depth_smooth > 0:
        on = float(iteration > 3000)
        loss = loss + st.lambda_depth_smooth * L.first_order_edge_aware_loss(
            maps["surf_depth"][..., None], gt_image) * on
    if cam_mask is not None and st.lambda_mask_entropy > 0:
        loss = loss + st.lambda_mask_entropy * L.mask_entropy_loss(
            alpha[..., 0], cam_mask)
    for lam, img in ((st.lambda_base_color_smooth, base_color_img),
                     (st.lambda_roughness_smooth, rough_img)):
        if lam > 0:
            img = img * alpha
            if cam_mask is not None:
                img = img * cam_mask[..., None]
            loss = loss + lam * L.first_order_edge_aware_loss(img, gt_image)
    if st.lambda_normal_smooth > 0:
        img = maps["rend_normal"]
        if cam_mask is not None:
            img = img * cam_mask[..., None]
        loss = loss + st.lambda_normal_smooth * L.first_order_edge_aware_loss(
            img, gt_image)
    if st.lambda_light > 0:
        ld = re["light_direct"]
        loss = loss + st.lambda_light * torch.sum(
            torch.abs(ld - ld.mean(-1, keepdim=True)) * vw) / denom
    if st.lambda_light_smooth > 0:
        env_img = rgb_to_srgb(envlight.query_env(params.env, maps["rays_d"]))
        loss = loss + st.lambda_light_smooth * L.tv_loss(env_img)

    metrics["loss"] = loss
    return loss, metrics


def stage2_step(state: TrainState, grid: gt.Grid, cam: CameraParams, gt_image,
                cam_mask, draws: Stage2Draws, *, st: Stage2Static):
    """Loss, gradients (left in each parameter's .grad) and one Adam step.
    Updates `state` in place and returns (state, detached metrics)."""
    state.optimizer.zero_grad()
    loss, metrics = stage2_forward_loss(state.params, state.aux, grid, cam,
                                        gt_image, cam_mask, draws, state.step,
                                        st)
    loss.backward()
    state.optimizer.step(state.step)
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


def init_state(params: GaussianParams, aux: GaussianAux, opt_cfg,
               spatial_lr_scale: float = 1.0) -> TrainState:
    for t in params.tensors().values():
        t.requires_grad_(True)
    return TrainState(params, aux, GaussianOptimizer(params, opt_cfg,
                                                     spatial_lr_scale))
