"""Stage-1 (Ref-Gaussian) training step (≙ irgs_tpu/train/stage1_full.py).

Three phases, picked per iteration by the CLI: plain 2DGS (`initial`),
per-Gaussian volume shading with envmap 2 (`volume`), then pixel-space
deferred surfel shading with envmap 1 (`surfel`); with `use_indirect` and a
fused TSDF, reflection visibility by SDF ray marching. One step renders,
computes calculate_loss (loss_utils.py:90-157), backpropagates, adds the
screen-space gradient norms to the densification statistics and takes one
Adam step. `reconstruct_tsdf` fuses the training views' depths. A stage-1
checkpoint holds the parameters, the alive mask and statistics, Adam's
state and the step, with the JAX package's manifest keys.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..ops import tsdf as tsdf_ops
from ..render import ref_gaussian as rg
from ..scene.cameras import CameraParams
from ..scene.gaussians import GaussianAux
from ..scene.ref_gaussians import EnvMips, RefGaussianParams
from . import losses as L
from .densify import add_densification_stats
from .optim import RefOptimizer
from .stage2 import latest_checkpoint


@dataclasses.dataclass
class Stage1State:
    params: RefGaussianParams
    aux: GaussianAux
    optimizer: RefOptimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class Stage1FullStatic:
    img_w: int
    img_h: int
    active_sh_degree: int
    white_background: bool
    phase: str                      # "initial" | "volume" | "surfel"
    use_indirect: bool = False
    dup_capacity: int = 2 ** 21
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal_render_depth: float = 0.05
    lambda_normal_smooth: float = 0.0
    lambda_depth_smooth: float = 0.0
    lambda_mask_entropy: float = 0.0
    normal_loss_start: int = 0
    dist_loss_start: int = 3000
    normal_smooth_from_iter: int = 0
    normal_smooth_until_iter: int = 18000
    depth_ratio: float = 0.0


def init_state(params: RefGaussianParams, aux: GaussianAux, opt_cfg,
               spatial_lr_scale: float = 1.0) -> Stage1State:
    """Leaf parameters with gradients, zeroed densification statistics and
    the per-group Adam."""
    for t in params.tensors().values():
        t.requires_grad_(True)
    if aux.denom is None:
        aux = aux.with_zero_stats()
    return Stage1State(params, aux,
                       RefOptimizer(params, opt_cfg, spatial_lr_scale))


def _calc_loss(pkg, gt_image, cam_mask, iteration: int,
               st: Stage1FullStatic):
    """≙ calculate_loss (loss_utils.py:90-157) -> (loss, metrics)."""
    image = pkg["render"]
    alpha = pkg["alpha"]
    l_l1 = L.l1_loss(image, gt_image)
    loss = (1 - st.lambda_dssim) * l_l1 + st.lambda_dssim * (
        1 - L.ssim(image, gt_image))
    metrics = {"loss_l1": l_l1, "psnr": L.psnr(image, gt_image)}
    if st.lambda_normal_render_depth > 0:
        l_n = L.normal_consistency_loss(pkg["rend_normal"], pkg["surf_normal"])
        loss = loss + st.lambda_normal_render_depth * l_n * float(
            iteration > st.normal_loss_start)
        metrics["loss_normal"] = l_n
    if st.lambda_dist > 0:
        loss = loss + st.lambda_dist * pkg["raster"].distortion.mean() * float(
            iteration > st.dist_loss_start)
    if st.lambda_normal_smooth > 0:
        on = float(st.normal_smooth_from_iter < iteration
                   < st.normal_smooth_until_iter)
        loss = loss + st.lambda_normal_smooth * on * \
            L.first_order_edge_aware_loss(pkg["rend_normal"], gt_image)
    if st.lambda_depth_smooth > 0:
        loss = loss + st.lambda_depth_smooth * L.first_order_edge_aware_loss(
            pkg["surf_depth"][..., None], gt_image) * float(iteration > 3000)
    if cam_mask is not None and st.lambda_mask_entropy > 0:
        loss = loss + st.lambda_mask_entropy * L.mask_entropy_loss(
            alpha[..., 0], cam_mask)
    metrics["loss"] = loss
    return loss, metrics


def render_phase(params, aux, cam: CameraParams, fg_lut, vol, st, *,
                 means2d_offset=None):
    """The phase's renderer, with the phase's envmap prefiltered anew."""
    dev = params.xyz.device
    bg = torch.full((3,), 1.0 if st.white_background else 0.0, device=dev)
    kw = dict(img_w=st.img_w, img_h=st.img_h,
              active_sh_degree=st.active_sh_degree,
              dup_capacity=st.dup_capacity, depth_ratio=st.depth_ratio,
              means2d_offset=means2d_offset)
    if st.phase == "initial":
        return rg.render_initial(params, aux, cam, bg, **kw)
    if st.phase == "volume":
        return rg.render_volume(params, aux, cam, bg,
                                EnvMips.build(params.env2), fg_lut, vol=vol,
                                use_indirect=st.use_indirect, **kw)
    if st.phase == "surfel":
        return rg.render_surfel(params, aux, cam, bg,
                                EnvMips.build(params.env1), fg_lut, vol=vol,
                                use_indirect=st.use_indirect, **kw)
    raise ValueError(f"unknown stage-1 phase {st.phase!r}")


def stage1_forward_loss(params, aux, cam: CameraParams, gt_image, cam_mask,
                        fg_lut, vol, iteration: int, st: Stage1FullStatic,
                        means2d_offset=None):
    """Render and calculate_loss -> (loss, metrics, radii)."""
    pkg = render_phase(params, aux, cam, fg_lut, vol, st,
                       means2d_offset=means2d_offset)
    loss, metrics = _calc_loss(pkg, gt_image, cam_mask, iteration, st)
    # an overflow of the duplicate buffer drops splats from tiles
    metrics["raster_overflow"] = pkg["raster"].overflow.to(torch.float32)
    return loss, metrics, pkg["raster"].radii


def stage1_full_step(state: Stage1State, cam: CameraParams, gt_image,
                     cam_mask, fg_lut, vol, *, st: Stage1FullStatic):
    """One step (≙ irgs_tpu stage1_full_step, :142): gradients, with that of
    a zero screen-space offset feeding the densification statistics, and an
    Adam update. Updates `state` in place; returns (state, detached
    metrics)."""
    state.optimizer.zero_grad()
    m2d = torch.zeros((state.params.n_capacity, 2), dtype=torch.float32,
                      device=state.params.xyz.device, requires_grad=True)
    loss, metrics, radii = stage1_forward_loss(
        state.params, state.aux, cam, gt_image, cam_mask, fg_lut, vol,
        state.step, st, means2d_offset=m2d)
    loss.backward()
    add_densification_stats(state.aux, m2d.grad, radii)
    state.optimizer.step()
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def reconstruct_tsdf(params, aux, cams, *, img_w, img_h, active_sh_degree,
                     mesh_res: int = 128, depth_trunc: float | None = None,
                     cameras_extent: float = 3.0, dup_capacity: int = 2 ** 21):
    """Fuse the surface depth of every view (alpha > 0.5) into a TSDF over
    the alive Gaussians' box (≙ irgs_tpu reconstruct_tsdf, :182)."""
    dev = params.xyz.device
    bg = torch.zeros(3, device=dev)
    depth_trunc = depth_trunc or cameras_extent * 2.0
    voxel = depth_trunc / mesh_res
    sdf_trunc = 5.0 * voxel
    xyz = params.xyz.detach().cpu().numpy()[aux.alive.cpu().numpy()]
    bb_min = xyz.min(0) - 4 * voxel
    bb_max = xyz.max(0) + 4 * voxel
    vol = tsdf_ops.init_volume(bb_min, np.maximum(bb_max, bb_min
                                                  + mesh_res * voxel),
                               mesh_res, device=dev)
    for cam in cams:
        cp = cam.params(dev)
        pkg = rg.render_initial(params, aux, cp, bg, img_w=img_w, img_h=img_h,
                                active_sh_degree=active_sh_degree,
                                dup_capacity=dup_capacity)
        depth = pkg["surf_depth"] * (pkg["alpha"][..., 0] > 0.5)
        vol = tsdf_ops.integrate(vol, depth, cp.w2c, cp.fx, cp.fy,
                                 cam.width / 2 - 0.5, cam.height / 2 - 0.5,
                                 sdf_trunc=sdf_trunc, depth_trunc=depth_trunc)
    return vol


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def state_tensors(state: Stage1State) -> dict:
    """A copy of the full state as the nested dict a checkpoint holds."""
    a = state.aux
    return {"params": {k: v.detach().clone()
                       for k, v in state.params.tensors().items()},
            "alive": a.alive.clone(), "active_sh_degree": a.active_sh_degree,
            "max_radii2d": a.max_radii2d.clone(),
            "xyz_gradient_accum": a.xyz_gradient_accum.clone(),
            "denom": a.denom.clone(),
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def save_stage1_checkpoint(path: str, state: Stage1State, iteration: int,
                           run_state: dict | None = None):
    """chkpnt<it>.ckpt of a stage-1 run, with the JAX package's manifest
    keys (kind, n_capacity, sh_degree, env_res); `run_state` (the CLI's view
    order and generator states) is kept beside the state for a resume."""
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(path, {**state_tensors(state), **(run_state or {})},
                    iteration, extra={
        "kind": "stage1",
        "n_capacity": int(state.params.n_capacity),
        "sh_degree": int(state.params.max_sh_degree),
        "env_res": int(state.params.env1.shape[1])})


def load_stage1_checkpoint(path: str, opt_cfg=None, device=None,
                           spatial_lr_scale: float = 1.0):
    """A stage-1 checkpoint of this package -> (Stage1State, iteration).
    `path` is a chkpnt*.ckpt file or a stage-1 run's directory (latest
    taken). Without `opt_cfg` the optimizer comes from the run's cfg.json
    (≙ irgs_tpu load_stage1_checkpoint, :205); `spatial_lr_scale` (the
    scene's camera extent) scales its xyz schedule, as in the run."""
    import os

    from .. import resolve_device
    from ..config import load_config
    from ..scene.gaussians import params_from_numpy
    from ..utils.checkpoint import load_checkpoint

    device = resolve_device(device)
    ckpt = latest_checkpoint(path)
    if ckpt is None:
        raise FileNotFoundError(f"no chkpnt*.ckpt under {path}")
    with open(ckpt + ".json") as f:
        manifest = json.load(f)
    if manifest.get("kind") != "stage1":
        raise ValueError(f"{ckpt} is not a stage-1 checkpoint "
                         f"(kind={manifest.get('kind')!r})")
    if opt_cfg is None:
        opt_cfg = load_config(os.path.dirname(os.path.abspath(ckpt)),
                              stage1=True).opt
    tensors, _ = load_checkpoint(ckpt, device)
    params, aux = params_from_numpy(
        {k: v.cpu().numpy() for k, v in tensors["params"].items()},
        tensors["alive"].cpu().numpy(), device,
        max_sh_degree=int(manifest["sh_degree"]),
        active_sh_degree=int(tensors["active_sh_degree"]),
        cls=RefGaussianParams)
    aux = GaussianAux(aux.alive, aux.active_sh_degree,
                      tensors["max_radii2d"], tensors["xyz_gradient_accum"],
                      tensors["denom"])
    state = init_state(params, aux, opt_cfg, spatial_lr_scale)
    state.optimizer.load_state_dict(tensors["optimizer"])
    state.step = int(tensors["step"])
    return state, int(manifest["iteration"])
