"""Stage-1 training CLI (Ref-Gaussian geometry), ≙ train_refgaussian.py.

    python -m irgs_tpu_torch.train_refgaussian -s <scene_dir> -m <model_dir>
    python -m irgs_tpu_torch.train_refgaussian --toy -m <model_dir> --iterations 2000
    python -m irgs_tpu_torch.train_refgaussian ... --device cpu   (the plain CPU path)

Every option of the stage-1 configuration (config.py) and train_refgaussian.py's
own flags, plus `--device` (default cuda; without a card the run raises, it
does not fall back to the CPU), `--checkpoint_interval` and
`--start_checkpoint` (resume a stage-1 run of this package in place). The
schedule is the reference's: initial 2DGS, volume shading, surfel shading
with a material reset at the switch; densification, opacity resets and
normal-propagation events; from `indirect_from_iter` reflection visibility
through a TSDF refreshed every `--mesh_interval` iterations. Writes cfg.json,
cmd.txt, train_log.jsonl and chkpnt<it>.ckpt (+ .json), which
`python -m irgs_tpu_torch.train --start_checkpoint_refgs` takes up.

The draws come from one torch.Generator seeded with `--seed` (the reference
folds a JAX key per iteration); the view order is
np.random.RandomState(seed), as in the JAX package. `--toy` on the CPU
shrinks the scene, views and capacities so that a run takes seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def _parser(cfg) -> argparse.ArgumentParser:
    from ..config import add_config_args
    parser = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.train_refgaussian",
        description=__doc__.splitlines()[0])
    add_config_args(parser, cfg)
    parser.add_argument("--toy", action="store_true",
                        help="procedural toy scene instead of a dataset")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh_interval", type=int, default=2000,
                        help="refresh the TSDF every N iters once indirect")
    parser.add_argument("--psnr_eval_interval", type=int, default=0,
                        help="held-out PSNR every N iters (0 = six a run)")
    parser.add_argument("--psnr_eval_views", type=int, default=2)
    parser.add_argument("--checkpoint_interval", type=int, default=10000,
                        help="chkpnt<it>.ckpt every N iters, and at the end")
    parser.add_argument("--start_checkpoint", type=str, default=None,
                        help="chkpnt*.ckpt (or run dir; latest taken) of a "
                             "stage-1 run to resume in place")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, or cpu for the "
                             "plain PyTorch path)")
    return parser


def _toy_scene(cfg, dev):
    """The procedural toy: GT frames of the toy sphere rendered by
    render_initial, a uniform random cloud to start from (≙
    train_refgaussian.py --toy). On the CPU every size shrinks, the
    cubemaps (16², not 128²) and the FG table (32², not 256²) too."""
    import numpy as np
    import torch

    from ..render import ref_gaussian as rr
    from ..scene import toy

    if dev.type == "cpu":
        n_surf, n_cap, res, n_cams, n_pts = 512, 1024, 32, 4, 2000
        cfg.model.max_gaussians = min(cfg.model.max_gaussians, 4096)
        cfg.pipe.dup_capacity = min(cfg.pipe.dup_capacity or 2 ** 14, 2 ** 14)
        print("toy on CPU: shrunk scene, views and capacities for "
              "smoke-test speed", flush=True)
    else:
        n_surf, n_cap, res, n_cams, n_pts = 4096, 8192, 128, 24, 20000
        cfg.model.max_gaussians = min(cfg.model.max_gaussians, 2 ** 15)
        cfg.pipe.dup_capacity = min(cfg.pipe.dup_capacity or 2 ** 18, 2 ** 18)
    cfg.save()      # checkpoint loaders see the clamped capacities
    gt_params, gt_aux = toy.make_sphere_scene(n_surface=n_surf,
                                              n_capacity=n_cap, device=dev)
    cams = toy.make_ring_cameras(n_cams, width=res, height_px=res)
    with torch.no_grad():
        gt_images = [rr.render_initial(
            gt_params, gt_aux, c.params(dev), torch.zeros(3, device=dev),
            img_w=res, img_h=res, active_sh_degree=3,
            dup_capacity=cfg.pipe.dup_capacity)["render"].cpu().numpy()
            for c in cams]
    pts = np.random.RandomState(0).uniform(-1.3, 1.3, (n_pts, 3)).astype(
        np.float32)
    return cams, gt_images, [None] * len(cams), pts, \
        np.full((n_pts, 3), 0.5, np.float32), 3.3, []


# cubemap resolution and FG table size: the reference's, and the CPU toy's
ENV_RES, FG_LUT = 128, dict(res=256, samples=8192)
CPU_TOY_ENV_RES, CPU_TOY_FG_LUT = 16, dict(res=32, samples=64)


def _rng_state(rng) -> dict:
    import torch
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.tensor(keys.astype("int64")), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def _set_rng_state(rng, st: dict) -> None:
    import numpy as np
    rng.set_state(("MT19937", st["keys"].cpu().numpy().astype(np.uint32),
                   st["pos"], st["has_gauss"], st["cached"]))


def main(argv=None):
    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import apply_args, stage1_config
    from ..scene import cubemap as cm
    from ..scene import ref_gaussians as rgs
    from ..train import densify as D
    from ..train import losses as L
    from ..train import stage1_full as s1
    from ..utils.checkpoint import save_cmd_provenance

    cfg = stage1_config()
    args = _parser(cfg).parse_args(argv)
    dev = resolve_device(args.device)
    cfg = apply_args(cfg, args)
    if not cfg.model.model_path:
        cfg.model.model_path = os.path.join(tempfile.gettempdir(),
                                            "irgs_tpu_stage1")
    os.makedirs(cfg.model.model_path, exist_ok=True)
    cfg.save()
    save_cmd_provenance(cfg.model.model_path)
    opt = cfg.opt

    env_res, lut_size = ENV_RES, FG_LUT
    if args.toy:
        (cams, gt_images, masks, pts, colors, cameras_extent,
         test_cams) = _toy_scene(cfg, dev)
        if dev.type == "cpu":
            env_res, lut_size = CPU_TOY_ENV_RES, CPU_TOY_FG_LUT
    else:
        from ..scene.datasets import load_scene
        info = load_scene(cfg.model.source_path, cfg.model.white_background,
                          eval_split=cfg.model.eval,
                          resolution=cfg.model.resolution)
        cams = info.train_cameras
        gt_images = [c.image for c in cams]
        masks = [c.mask for c in cams]
        pts, colors = info.points, info.colors
        cameras_extent = info.radius
        test_cams = info.test_cameras or []

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(cams))
    first_iter = 0
    if args.start_checkpoint:
        from ..utils.checkpoint import load_checkpoint
        state, first_iter = s1.load_stage1_checkpoint(
            args.start_checkpoint, opt, dev, cameras_extent)
        run_state, _ = load_checkpoint(
            s1.latest_checkpoint(args.start_checkpoint), "cpu")
        _set_rng_state(rng, run_state["view_rng"])
        order = run_state["view_order"].numpy()
        gen.set_state(run_state["generator_state"])
        print(f"resumed stage-1 from {args.start_checkpoint} @ iter "
              f"{first_iter}", flush=True)
    else:
        params, aux = rgs.init_ref_from_pcd(
            pts, colors, cfg.model.max_gaussians, cfg.model.sh_degree,
            env_res=env_res, init_metallic=opt.init_metallic_value,
            init_roughness=opt.init_roughness_value, device=dev)
        state = s1.init_state(params, aux, opt, cameras_extent)
    fg_lut = cm.compute_fg_lut(device=dev, **lut_size)
    vol = None

    h, w = gt_images[0].shape[:2]
    dup = cfg.pipe.dup_capacity or 2 ** 20

    def make_static(phase, sh_deg, use_ind):
        return s1.Stage1FullStatic(
            img_w=w, img_h=h, active_sh_degree=sh_deg,
            white_background=cfg.model.white_background, phase=phase,
            use_indirect=use_ind, dup_capacity=dup,
            lambda_dssim=opt.lambda_dssim, lambda_dist=opt.lambda_dist,
            lambda_normal_render_depth=opt.lambda_normal_render_depth,
            lambda_normal_smooth=opt.lambda_normal_smooth,
            lambda_depth_smooth=opt.lambda_depth_smooth,
            lambda_mask_entropy=opt.lambda_mask_entropy,
            normal_loss_start=opt.normal_loss_start,
            dist_loss_start=opt.dist_loss_start,
            normal_smooth_from_iter=opt.normal_smooth_from_iter,
            normal_smooth_until_iter=opt.normal_smooth_until_iter)

    def refresh_tsdf(sh_deg):
        return s1.reconstruct_tsdf(
            state.params, state.aux, cams, img_w=w, img_h=h,
            active_sh_degree=sh_deg, mesh_res=min(opt.mesh_res, 256),
            cameras_extent=cameras_extent, dup_capacity=dup)

    # the schedule's state at first_iter (sh degree, indirect, TSDF)
    sh_deg = sum(1 for i in range(1, first_iter + 1)
                 if i > opt.feature_rest_from_iter and i % 1000 == 0)
    sh_deg = min(sh_deg, cfg.model.sh_degree)
    use_indirect = first_iter >= opt.indirect_from_iter + 1
    if use_indirect:
        vol = refresh_tsdf(sh_deg)

    psnr_iv = args.psnr_eval_interval or max(500, opt.iterations // 6)
    cam_params = [c.params(dev) for c in cams]
    gt_dev = [torch.tensor(np.asarray(g, np.float32), device=dev)
              for g in gt_images]
    mask_dev = [None if m is None else torch.tensor(m, device=dev)
                for m in masks]
    n = state.params.n_capacity
    t0 = time.time()
    log = open(os.path.join(cfg.model.model_path, "train_log.jsonl"), "a")

    def emit(rec):
        print(json.dumps(rec), flush=True)
        log.write(json.dumps(rec) + "\n")
        log.flush()

    for it in range(first_iter + 1, opt.iterations + 1):
        if it > opt.feature_rest_from_iter and it % 1000 == 0:
            sh_deg = min(sh_deg + 1, cfg.model.sh_degree)
        if it == opt.indirect_from_iter + 1:
            use_indirect = True
        phase = ("initial" if it <= opt.init_until_iter else
                 "volume" if it <= opt.volume_render_until_iter else "surfel")
        st = make_static(phase, sh_deg, use_indirect and vol is not None)

        # material re-init at the volume -> surfel switch
        # (≙ reset_gaussian_para, train_refgaussian.py:118-119,273-277)
        if (it == opt.volume_render_until_iter + 1
                and opt.volume_render_until_iter > opt.init_until_iter):
            rgs.reset_base_color(state.params,
                                 rgs.draw_uniform(gen, (n, 3), dev))
            rgs.reset_metallic_full(state.params, opt.init_metallic_value)
            rgs.reset_roughness(state.params, opt.init_roughness_value)
            state.optimizer.zero_moments(("base_color", "metallic",
                                          "roughness"))
            emit({"iter": it, "event": "material_reset"})

        i = int(order[it % len(cams)])
        if it % len(cams) == 0:
            order = rng.permutation(len(cams))
        state, metrics = s1.stage1_full_step(
            state, cam_params[i], gt_dev[i], mask_dev[i], fg_lut, vol, st=st)

        # held-out PSNR before the densify/reset block, with the phase's
        # renderer
        if test_cams and args.psnr_eval_views > 0 and (
                it % psnr_iv == 0 or it == opt.iterations):
            ps = []
            with torch.no_grad():
                for tc in test_cams[:args.psnr_eval_views]:
                    img = s1.render_phase(state.params, state.aux,
                                          tc.params(dev), fg_lut, vol,
                                          st)["render"]
                    ps.append(float(L.psnr(torch.clamp(img, 0, 1),
                                           torch.tensor(tc.image,
                                                        device=dev))))
            emit({"iter": it, "phase": phase,
                  "test_psnr": round(sum(ps) / len(ps), 3),
                  "test_views": len(ps)})

        # densification and resets (train_refgaussian.py:195-234)
        if it < opt.densify_until_iter and it != opt.volume_render_until_iter:
            dens_int = (opt.densification_interval
                        if it <= opt.init_until_iter
                        or it > opt.normal_prop_until_iter
                        else opt.densification_interval_when_prop)
            if it > opt.densify_from_iter and it % dens_int == 0:
                n_before = state.aux.n_alive
                state.aux, stats = D.densify_and_prune(
                    state.params, state.aux, state.optimizer,
                    grad_threshold=opt.densify_grad_threshold,
                    min_opacity=opt.prune_opacity_threshold,
                    extent=cameras_extent,
                    max_screen_size=20 if it > opt.opacity_reset_interval
                    else 0,
                    percent_dense=opt.percent_dense, generator=gen)
                emit({"iter": it, "event": "densify", "n_alive_before":
                      n_before, **stats})
            has_reset0 = False
            if it % opt.opacity_reset_interval == 0 or (
                    cfg.model.white_background
                    and it == opt.densify_from_iter):
                has_reset0 = True
                rgs.reset_opacity0(state.params, state.aux.alive)
                rgs.reset_metallic(state.params, opt.init_metallic_value)
                state.optimizer.zero_moments(("opacity", "metallic"))
                emit({"iter": it, "event": "opacity_reset"})
            if (opt.init_until_iter < it <= opt.normal_prop_until_iter
                    and it % opt.normal_prop_interval == 0
                    and not has_reset0):
                rgs.reset_opacity1(state.params)
                touched = ["opacity", "scaling"]
                if it > opt.volume_render_until_iter > opt.init_until_iter:
                    rgs.dist_color(state.params,
                                   rgs.draw_uniform(gen, (n, 1, 3), dev),
                                   metallic_thr=opt.metallic_msk_thr)
                    touched.append("features_dc")
                rgs.reset_scale(state.params, opt.metallic_msk_thr,
                                opt.enlarge_scale, opt.rough_msk_thr)
                state.optimizer.zero_moments(touched)
                emit({"iter": it, "event": "normal_prop"})

        # TSDF refresh for reflection visibility
        if use_indirect and (it % args.mesh_interval == 0
                             or it == opt.indirect_from_iter + 1):
            vol = refresh_tsdf(sh_deg)
            emit({"iter": it, "event": "tsdf_refresh",
                  "res": int(vol.tsdf.shape[0])})

        if it % 50 == 0 or it == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(iter=it, phase=phase, n_alive=state.aux.n_alive,
                     use_indirect=st.use_indirect,
                     elapsed=round(time.time() - t0, 1))
            if m.get("raster_overflow", 0) > 0:
                print(f"WARNING: capacity overflow at iter {it}: raster dup "
                      f"{m['raster_overflow']:.0f}; increase --dup_capacity",
                      flush=True)
            emit(m)
        ci = args.checkpoint_interval
        if (ci and it % ci == 0) or it == opt.iterations:
            path = os.path.join(cfg.model.model_path, f"chkpnt{it}.ckpt")
            s1.save_stage1_checkpoint(path, state, it, run_state={
                "view_rng": _rng_state(rng),
                "view_order": torch.tensor(np.asarray(order)),
                "generator_state": gen.get_state()})
    log.close()
    print("done:", cfg.model.model_path)


if __name__ == "__main__":
    main()
