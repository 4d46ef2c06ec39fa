"""Stage-2 material and light recovery on the toy sphere
(≙ tools/drive_stage2.py).

    python -m irgs_tpu_torch.tools.drive_stage2 [--device cuda]

Renders ground truth of the 2048-surfel toy sphere (capacity 4096, a 32²
envmap) from its true materials and envmap through the eval path (4 ring
views at 128², 64 diffuse samples), resets base colour, roughness and the
envmap to zero, then trains 161 stage-2 steps (32 diffuse samples, 32·2048
trace rays, tracer grid 24, dup 2^17; draws from a torch.Generator seeded
0). Prints loss, L1 and ray PSNR at steps 0, 20, 60 and 160 and the
recovered envmap's mean absolute error against its initial value's; the
ray PSNR should climb well above its start and the error fall below the
initial one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def render_full(params, aux, grid, tracer, cam, img: int, spp: int = 64):
    """The sRGB frame of the scene at `spp` diffuse samples (no training
    sampling), alpha-weighted."""
    from ..ops import surfel_raster as sr
    from ..render import ir
    from ..scene import envlight
    from ..utils.math3d import rgb_to_srgb
    dev = params.xyz.device
    feats = torch.cat([params.get_base_color(), params.get_roughness()], -1)
    raster = sr.rasterize(params.xyz, params.get_scaling(), params.rotation,
                          params.get_opacity()[:, 0], params.get_features(),
                          feats, None, cam, torch.zeros(3, device=dev),
                          img_w=img, img_h=img, active_sh_degree=3,
                          dup_capacity=2 ** 17, alive=aux.alive)
    maps = ir.derive_geometry_maps(raster, cam, img, img)
    flat = lambda x: x.reshape(-1, x.shape[-1])
    shade = ir.ShadeConfig(diffuse_sample_num=spp, training=False)
    tf = ir.make_trace_fn(params, aux, grid, tracer, cam.cam_pos, 3)
    pdf = envlight.build_pdf(params.env)
    re = ir.rendering_equation(flat(raster.feature[..., :3]),
                               flat(raster.feature[..., 3:4]),
                               flat(maps["normal_map"]), flat(maps["points"]),
                               -flat(maps["rays_d"]), params.env, pdf, tf,
                               shade)
    out = rgb_to_srgb(re["diffuse"] + re["specular"]).reshape(img, img, 3)
    return out * maps["alpha"]


def main(argv=None, n_surface: int = 2048, n_capacity: int = 4096,
         img: int = 128, iters: int = 161, log_at=(0, 20, 60, 160),
         gt_spp: int = 64, spp: int = 32, n_pixels: int = 2048,
         draws_fn=None):
    """The keyword arguments (scene, frame, steps, the GT's and the steps'
    diffuse samples, the pixels shaded a step) shrink the run for a test;
    `draws_fn(i, st)` -> the Stage2Draws of step i replaces the generator's
    (a test feeds the JAX tool's). Returns the logged metrics by step and
    the envmap errors."""
    from .. import resolve_device
    from ..config import Config
    from ..ops import grid_tracer as gt
    from ..scene import toy
    from ..train import stage2 as s2
    from .common import card_line, sync

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.drive_stage2",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)

    params, aux = toy.make_sphere_scene(n_surface=n_surface,
                                        n_capacity=n_capacity,
                                        env_resolution=32, device=dev)
    cams = [c.params(dev) for c in toy.make_ring_cameras(
        4, width=img, height_px=img)]
    cfg = Config()
    cfg.pipe.diffuse_sample_num = spp
    cfg.pipe.tracer_grid_res = 24
    cfg.opt.trace_num_rays = spp * n_pixels
    st = dataclasses.replace(s2.from_configs(cfg, img_w=img, img_h=img),
                             dup_capacity=2 ** 17)
    grid = gt.build_grid_from_gaussians(params, aux, st.tracer)

    t0 = time.perf_counter()
    with torch.no_grad():
        gts = [render_full(params, aux, grid, st.tracer, c, img, gt_spp)
               for c in cams]
    sync(dev)
    print(f"GT rendered in {time.perf_counter() - t0:.1f}s, mean "
          f"{float(gts[0].mean()):.4f}", flush=True)

    env_true = params.env.detach().clone()
    with torch.no_grad():
        p0 = dataclasses.replace(params, **{
            k: v.detach().clone() for k, v in params.tensors().items()})
        p0.base_color.zero_()
        p0.roughness.zero_()
        p0.env.zero_()
    state = s2.init_state(p0, aux, cfg.opt)
    gen = torch.Generator(dev).manual_seed(0)
    logged = {}
    t0 = time.perf_counter()
    for i in range(iters):
        draws = (draws_fn(i, st) if draws_fn is not None
                 else s2.draw_stage2(gen, st, dev))
        state, m = s2.stage2_step(state, grid, cams[i % 4], gts[i % 4], None,
                                  draws, st=st)
        if i in log_at:
            logged[i] = {k: float(m[k]) for k in ("loss", "loss_l1",
                                                  "ray_psnr")}
            print(f"iter {i:3d} loss {logged[i]['loss']:.4f} l1 "
                  f"{logged[i]['loss_l1']:.4f} ray_psnr "
                  f"{logged[i]['ray_psnr']:.2f}", flush=True)
    sync(dev)
    print(f"{iters} iters in {time.perf_counter() - t0:.1f}s", flush=True)
    with torch.no_grad():
        err = float((state.params.env.exp() - env_true.exp()).abs().mean())
        err0 = float((1.0 - env_true.exp()).abs().mean())
    print(f"envmap mean abs err: {err:.4f} (init {err0:.4f})", flush=True)
    return {"logged": logged, "env_err": err, "env_err_init": err0}


if __name__ == "__main__":
    main()
