"""Stage-1-lite trainer: geometry reconstruction with plain 2DGS rendering
(≙ irgs_tpu/train/stage1.py).

The `render_initial` phase alone (ref_gaussian.py:69-179) on a
GaussianParams, with calculate_loss (utils/loss_utils.py:90-157): L1 and
D-SSIM, the normal-consistency term past `normal_loss_start`, and the
optional distortion, smoothness and mask-entropy terms. The rasterizer's
blend kernels (csrc/raster_blend.cu) run forward and backward. One step
backpropagates, feeds the screen-space gradient norms into the
densification statistics (the means2D-offset gradient) and takes one Adam
step with every group trained (the JAX package's stage2=False: lr_scale
1).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import surfel_raster as sr
from ..render import ir
from ..scene.cameras import CameraParams
from ..scene.gaussians import GaussianAux, GaussianParams
from . import losses as L
from .densify import add_densification_stats
from .optim import GaussianOptimizer


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    aux: GaussianAux
    optimizer: GaussianOptimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class Stage1Static:
    img_w: int
    img_h: int
    active_sh_degree: int
    white_background: bool
    dup_capacity: int = 2 ** 21
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal_render_depth: float = 0.05
    lambda_normal_smooth: float = 0.0
    lambda_depth_smooth: float = 0.0
    lambda_mask_entropy: float = 0.0
    normal_loss_start: int = 0
    dist_loss_start: int = 3000
    depth_ratio: float = 0.0


def stage1_forward_loss(params: GaussianParams, means2d_offset,
                        aux: GaussianAux, cam: CameraParams, gt_image,
                        cam_mask, iteration: int, st: Stage1Static):
    """-> (loss, (metrics, radii)), as the JAX function returns them."""
    dev = params.xyz.device
    bg = torch.full((3,), 1.0 if st.white_background else 0.0, device=dev)
    n = params.n_capacity
    raster = sr.rasterize(
        params.xyz, params.get_scaling(), params.rotation,
        params.get_opacity()[:, 0], params.get_features(),
        torch.zeros((n, 0), device=dev), means2d_offset, cam,
        torch.zeros(3, device=dev), img_w=st.img_w, img_h=st.img_h,
        active_sh_degree=st.active_sh_degree, dup_capacity=st.dup_capacity,
        alive=aux.alive)

    maps = ir.derive_geometry_maps(raster, cam, st.img_w, st.img_h,
                                   depth_ratio=st.depth_ratio)
    alpha = maps["alpha"]
    image = raster.color + bg[None, None] * (1 - alpha)

    l_l1 = L.l1_loss(image, gt_image)
    ssim_val = L.ssim(image, gt_image)
    loss = (1 - st.lambda_dssim) * l_l1 + st.lambda_dssim * (1 - ssim_val)
    metrics = {"loss_l1": l_l1, "ssim": ssim_val,
               "psnr": L.psnr(image, gt_image)}

    if st.lambda_normal_render_depth > 0:
        l_norm = L.normal_consistency_loss(maps["rend_normal"],
                                           maps["surf_normal"])
        on = float(iteration > st.normal_loss_start)
        loss = loss + st.lambda_normal_render_depth * l_norm * on
        metrics["loss_normal"] = l_norm
    if st.lambda_dist > 0:
        on = float(iteration > st.dist_loss_start)
        loss = loss + st.lambda_dist * raster.distortion.mean() * on
    if st.lambda_normal_smooth > 0:
        loss = loss + st.lambda_normal_smooth * L.first_order_edge_aware_loss(
            maps["rend_normal"], gt_image)
    if st.lambda_depth_smooth > 0:
        on = float(iteration > 3000)
        loss = loss + st.lambda_depth_smooth * L.first_order_edge_aware_loss(
            maps["surf_depth"][..., None], gt_image) * on
    if cam_mask is not None and st.lambda_mask_entropy > 0:
        loss = loss + st.lambda_mask_entropy * L.mask_entropy_loss(
            alpha[..., 0], cam_mask)

    metrics["loss"] = loss
    metrics["raster_overflow"] = raster.overflow.to(torch.float32)
    return loss, (metrics, raster.radii)


def stage1_step(state: TrainState, cam: CameraParams, gt_image, cam_mask,
                *, st: Stage1Static):
    """One geometry-training iteration (≙ stage1_step): gradients, the
    densification statistics from the gradient of a zero screen-space
    offset, and an Adam update. Updates `state` in place; returns (state,
    detached metrics)."""
    state.optimizer.zero_grad()
    m2d = torch.zeros((state.params.n_capacity, 2), dtype=torch.float32,
                      device=state.params.xyz.device, requires_grad=True)
    loss, (metrics, radii) = stage1_forward_loss(
        state.params, m2d, state.aux, cam, gt_image, cam_mask, state.step, st)
    loss.backward()
    add_densification_stats(state.aux, m2d.grad, radii)
    state.optimizer.step(state.step)
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


def init_state(params: GaussianParams, aux: GaussianAux, opt_cfg,
               spatial_lr_scale: float = 1.0) -> TrainState:
    """Leaf parameters with gradients, zeroed densification statistics and
    Adam over every group (≙ init_state with make_gaussian_optimizer(...,
    stage2=False))."""
    for t in params.tensors().values():
        t.requires_grad_(True)
    if aux.denom is None:
        aux = aux.with_zero_stats()
    opt = dataclasses.replace(opt_cfg, lr_scale=1.0)
    return TrainState(params, aux,
                      GaussianOptimizer(params, opt, spatial_lr_scale))
