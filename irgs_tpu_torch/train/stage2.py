"""Stage-2 trainer: material + environment-light fitting
(≙ irgs_tpu/train/stage2.py:37-338).

One step: rasterize the surfels with base colour and roughness as features
(the blend runs as the CUDA kernels on the card), derive the G-buffer maps,
shade pixels with the Monte-Carlo rendering equation through the grid
tracer, compute calculate_loss2 and take one Adam step. Geometry stays
frozen at lr_scale = 0. With `train_ray` (the reference's --train_ray) a
fixed number of eligible pixels is shaded and the loss is their L1; without
it every pixel is shaded in chunks, each recomputed in the backward pass
(`torch.utils.checkpoint`), and the loss is the full image's L1 + D-SSIM.

Every random draw comes in `Stage2Draws` (made by `draw_stage2` from a
torch.Generator, or handed in by a caller that wants the JAX draws), before
the step runs: nothing inside it draws, so that a chunk's recomputation
shades with the samples its forward pass used. With `light_sample_num` > 0
the shading is the MIS mixture, its light samples drawn from the detached
env's pdf.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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

    @property
    def chunk_pixels(self) -> int:
        """Pixels a chunk of the full-image branch shades."""
        return min(self.num_shaded_pixels, self.img_w * self.img_h)

    @property
    def n_chunks(self) -> int:
        """Chunks of the full-image branch (the last one zero-padded)."""
        return -(-(self.img_w * self.img_h) // self.chunk_pixels)

    @property
    def shaded_rows(self) -> int:
        """Rows the sampler shades a step: the pixel subset, or every
        chunk's rows."""
        return (self.num_shaded_pixels if self.train_ray
                else self.n_chunks * self.chunk_pixels)


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
    """The draws one step consumes (≙ the reference's jax.random.split(key),
    stage2.py:158, and the light draws of its k_shade half). P is
    `Stage2Static.shaded_rows`: the pixel subset, or with train_ray off
    every chunk's rows in order (the reference draws each chunk's from its
    own key of jax.random.split(k_shade, n_chunks))."""
    pixel_u: torch.Tensor  # [H*W] pixel-selection scores (ir.py:377)
    theta_u: torch.Tensor  # [P, 1] sampler rotations (sampling.py:37)
    # light_sample_num > 0: the key of the light draws ([] int64; keyed by
    # the ray's slot, or with train_ray off by its pixel), or the draws
    # themselves (envlight.LightDraws [P, S_l], e.g. JAX's), which take
    # precedence
    light_seed: torch.Tensor | None = None
    light: envlight.LightDraws | None = None

    def to(self, device) -> "Stage2Draws":
        move = lambda x: None if x is None else x.to(device)
        light = None if self.light is None else envlight.LightDraws(
            *(move(x) for x in self.light))
        return Stage2Draws(self.pixel_u.to(device), self.theta_u.to(device),
                           move(self.light_seed), light)


def draw_stage2(generator: torch.Generator, st: Stage2Static,
                device) -> Stage2Draws:
    """Draw one step's uniforms from `generator` (which lives on `device`);
    with light samples, also the key of the step's light draws (drawn
    last, so that the uniforms do not depend on the light sample count)."""
    kw = dict(generator=generator, device=device)
    pixel_u = torch.rand(st.img_w * st.img_h, dtype=torch.float32, **kw)
    theta_u = torch.rand(st.shaded_rows, 1, dtype=torch.float32, **kw)
    light_seed = None
    if st.light_sample_num > 0:
        light_seed = torch.randint(0, 2 ** 31, (), dtype=torch.int64, **kw)
    return Stage2Draws(pixel_u, theta_u, light_seed)


def stage2_forward_loss(params: GaussianParams, aux: GaussianAux,
                        grid: gt.Grid, cam: CameraParams, gt_image, cam_mask,
                        draws: Stage2Draws, iteration: int, st: Stage2Static):
    """One forward pass + calculate_loss2 -> (loss, metrics)."""
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
    zero3 = torch.zeros_like(unit_z)
    light_seed = 0 if draws.light_seed is None else draws.light_seed
    trace_stats = {}

    if st.train_ray:
        eligible = alpha[..., 0] > 0.9
        if cam_mask is not None:
            eligible = eligible & cam_mask
        idx, ray_valid = ir.select_train_pixels(draws.pixel_u, eligible,
                                                st.num_shaded_pixels)
        px_base = flat(base_color_img)[idx]
        px_rough = flat(rough_img)[idx]
        px_alpha = flat(alpha)[idx]
        # padding rays (beyond the eligible count) get safe inputs:
        # degenerate normals would turn into NaNs inside the sampling frame
        safe = ray_valid[:, None]
        px_normal = torch.where(safe, flat(maps["normal_map"])[idx], unit_z)
        px_wo = torch.where(safe, -flat(maps["rays_d"])[idx], unit_z)
        px_points = torch.where(safe, flat(maps["points"])[idx], zero3)

        trace_fn = ir.make_trace_fn(params, aux, grid, st.tracer, cam.cam_pos,
                                    st.active_sh_degree,
                                    stats_out=trace_stats)
        # the light draws are keyed by the ray's slot (no pixel ids), as the
        # reference's train_ray branch draws them (stage2.py:185-187)
        re = ir.rendering_equation(
            px_base, px_rough, px_normal, px_points, px_wo, params.env, pdf,
            trace_fn, shade_cfg, theta_u=draws.theta_u,
            light_draws=draws.light, light_seed=light_seed)
        full = rgb_to_srgb(re["diffuse"] + re["specular"])
        ray_rgb = full * px_alpha + bg[None] * (1 - px_alpha)
        gt_flat = flat(gt_image)[idx]
        ray_rgb = torch.where(safe, ray_rgb, torch.zeros_like(ray_rgb))
        gt_flat = torch.where(safe, gt_flat, torch.zeros_like(gt_flat))
        vw = ray_valid.float()[:, None]
        denom = torch.clamp(vw.sum() * 3, min=1.0)
        l_l1 = torch.sum(torch.abs(ray_rgb - gt_flat) * vw) / denom
        metrics = {"loss_l1": l_l1,
                   "ray_psnr": L.psnr(ray_rgb * vw, gt_flat * vw)}
        light_direct = re["light_direct"]
    else:
        # the full-image branch (reference train.py:163 else-branch): every
        # pixel shaded in chunks of chunk_pixels, the background (alpha = 0)
        # with safe inputs and masked afterwards, the last chunk padded
        # with zero rows; then L1 + D-SSIM of the composite over the whole
        # image (loss_utils.py:173-175)
        n_px, pc = st.img_w * st.img_h, st.chunk_pixels
        fg = alpha[..., 0].reshape(-1) > 0
        safe = fg[:, None]
        pad = lambda x: F.pad(x, (0, 0, 0, st.n_chunks * pc - n_px))
        px = [pad(x) for x in (
            flat(base_color_img), flat(rough_img),
            torch.where(safe, flat(maps["normal_map"]), unit_z),
            torch.where(safe, flat(maps["points"]), zero3),
            torch.where(safe, -flat(maps["rays_d"]), unit_z))]
        pid = pad(torch.arange(n_px, device=dev)[:, None])[:, 0]
        trace_fn = ir.make_trace_fn(params, aux, grid, st.tracer, cam.cam_pos,
                                    st.active_sh_degree)

        def shade_chunk(base, rough, normal, points, wo, theta_u, ids,
                        light):
            re = ir.rendering_equation(
                base, rough, normal, points, wo, params.env, pdf, trace_fn,
                shade_cfg, theta_u=theta_u, pixel_ids=ids, light_draws=light,
                light_seed=light_seed)
            return re["diffuse"], re["specular"], re["light_direct"]

        outs = []
        for c in range(st.n_chunks):
            rows = slice(c * pc, (c + 1) * pc)
            light = None if draws.light is None else envlight.LightDraws(
                *(None if x is None else x[rows] for x in draws.light))
            args = (*(x[rows] for x in px), draws.theta_u[rows], pid[rows],
                    light)
            # each chunk's backward recomputes its shading instead of
            # keeping its [pc, S, 3] intermediates (the reference's
            # jax.checkpoint); its samples come in as inputs, so the
            # recomputation draws nothing and takes the forward's samples
            outs.append(shade_chunk(*args) if st.n_chunks == 1 else
                        checkpoint(shade_chunk, *args, use_reentrant=False))
        diffuse, specular, light_direct = (torch.cat(x)[:n_px]
                                           for x in zip(*outs))
        full = rgb_to_srgb(diffuse + specular)
        full = torch.where(safe, full, torch.zeros_like(full))
        render = (full.reshape(st.img_h, st.img_w, 3) * alpha
                  + bg * (1 - alpha))
        l_l1 = (L.l1_loss(render, gt_image)
                + st.lambda_dssim * (1 - L.ssim(render, gt_image)))
        metrics = {"loss_l1": l_l1, "psnr": L.psnr(render, gt_image)}
        vw = fg.float()[:, None]
        denom = torch.clamp(vw.sum() * 3, min=1.0)
    loss = l_l1

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
        ld = light_direct
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


def state_tensors(state: TrainState) -> dict:
    """A copy of the full state (params, alive mask, Adam moments, step) as
    the nested dict of tensors a checkpoint holds. The copy is taken now:
    the step updates the state in place."""
    return {"params": {k: v.detach().clone()
                       for k, v in state.params.tensors().items()},
            "alive": state.aux.alive.clone(),
            "active_sh_degree": state.aux.active_sh_degree,
            "optimizer": state.optimizer.state_dict(),
            "step": state.step}


def save_stage2_checkpoint(path: str, state: TrainState, iteration: int):
    """Mid-run capture of the full stage-2 state (≙ irgs_tpu
    save_stage2_checkpoint, stage2.py:341-350), with the same manifest
    keys."""
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(path, state_tensors(state), iteration, extra={
        "kind": "stage2",
        "n_capacity": int(state.params.n_capacity),
        "sh_degree": int(state.params.max_sh_degree),
        "env_shape": [int(s) for s in state.params.env.shape]})


def latest_checkpoint(path: str) -> str | None:
    """`path` itself, or for a directory its chkpnt*.ckpt of the highest
    iteration (None if it has none)."""
    if not os.path.isdir(path):
        return path
    ckpts = sorted(glob.glob(os.path.join(path, "chkpnt*.ckpt")),
                   key=lambda q: int("".join(filter(str.isdigit,
                                                    os.path.basename(q)))))
    return ckpts[-1] if ckpts else None


def state_from_tensors(tensors: dict, opt_cfg, device,
                       spatial_lr_scale: float = 1.0, shapes=None,
                       where: str = "checkpoint") -> TrainState:
    """A TrainState on `device` from the tensors `state_tensors` gave (a
    checkpoint's or a reproducer's). `shapes` (n_capacity, sh_degree,
    env_shape), a manifest's, is checked against the tensors; by default
    the tensors' own shapes are taken."""
    from ..scene.gaussians import PARAM_FIELDS, empty_params

    p = tensors["params"]
    if shapes is None:
        k = p["features_rest"].shape[1] + 1
        shapes = (p["xyz"].shape[0], int(round(k ** 0.5)) - 1,
                  tuple(p["env"].shape))
    params, aux = empty_params(*shapes, device)
    for f in PARAM_FIELDS:
        dst, src = getattr(params, f), p[f]
        if dst.shape != src.shape:
            raise ValueError(f"{where}: {f} has shape {tuple(src.shape)}, the "
                             f"manifest gives {tuple(dst.shape)}")
        dst.copy_(src)
    aux.alive.copy_(tensors["alive"])
    aux.active_sh_degree = int(tensors["active_sh_degree"])
    state = init_state(params, aux, opt_cfg, spatial_lr_scale)
    state.optimizer.load_state_dict(tensors["optimizer"])
    state.step = int(tensors["step"])
    return state


def load_stage2_checkpoint(path: str, opt_cfg, device=None,
                           spatial_lr_scale: float = 1.0):
    """Restore a full stage-2 TrainState for in-place resume on `device`
    (≙ irgs_tpu load_stage2_checkpoint, stage2.py:353-382). `path` is a
    chkpnt*.ckpt file or a stage-2 model dir (latest taken). Returns
    (state, iteration)."""
    from .. import resolve_device
    from ..utils.checkpoint import load_checkpoint

    device = resolve_device(device)
    ckpt = latest_checkpoint(path)
    if ckpt is None:
        raise FileNotFoundError(f"no chkpnt*.ckpt under {path}")
    with open(ckpt + ".json") as f:
        manifest = json.load(f)
    if manifest.get("kind") != "stage2":
        raise ValueError(f"{ckpt} is not a stage-2 checkpoint "
                         f"(kind={manifest.get('kind')!r})")
    tensors, _ = load_checkpoint(ckpt, device)
    shapes = (int(manifest["n_capacity"]), int(manifest["sh_degree"]),
              tuple(manifest["env_shape"]))
    state = state_from_tensors(tensors, opt_cfg, device, spatial_lr_scale,
                               shapes, where=ckpt)
    return state, int(manifest["iteration"])
