"""Stage-2 training CLI (material + light decomposition), ≙ train.py.

    python -m irgs_tpu_torch.train -s <scene_dir> -m <model_dir> --start_ply <ply>
    python -m irgs_tpu_torch.train --toy -m <model_dir> --iterations 500
    python -m irgs_tpu_torch.train ... --device cpu      (the plain CPU path)

Every option of train.py's configuration (config.py) and its own flags are
accepted, plus `--device` (default cuda; without a card the run raises, it
does not fall back to the CPU). Reads Blender/TensoIR and Synthetic4Relight
folders (scene/datasets.py); starts from a Gaussian PLY or resumes a stage-2
checkpoint of this package, bridges from a stage-1 checkpoint of
`python -m irgs_tpu_torch.train_refgaussian` (--start_checkpoint_refgs, or
--start_checkpoint of a stage-1 run: from_refgs keeps the geometry and SH
and re-initialises materials and envmap), or initialises a dataset run from
its point cloud (create_from_pcd); writes cfg.json, train_log.jsonl,
visualisation PNGs, point_cloud/iteration_<it>/point_cloud.ply with its
envmap sidecars, and chkpnt<it>.ckpt.

`--n_devices N` (≙ train.py's data-parallel mesh) trains on N ranks, one
process each: on cuda one rank per card (NCCL; fewer visible cards raise),
with `--device cpu` N CPU processes (gloo). Every rank draws the same
camera choice and all N ranks' draws from the one seeded generator and
keeps its own; the gradients are averaged over the ranks each step
(parallel/dp.py), and rank 0 alone writes the log, visualisations,
checkpoints and PLY.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _parser(cfg) -> argparse.ArgumentParser:
    from ..config import add_config_args
    parser = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.train",
                                     description=__doc__.splitlines()[0])
    add_config_args(parser, cfg)
    parser.add_argument("--toy", action="store_true",
                        help="procedural toy scene instead of a dataset")
    parser.add_argument("--start_ply", type=str, default=None,
                        help="stage-1 geometry PLY to start from")
    parser.add_argument("--start_checkpoint", type=str, default=None,
                        help="chkpnt*.ckpt (or run dir; latest taken) of a "
                             "stage-2 run to resume in place")
    parser.add_argument("--start_checkpoint_refgs", type=str, default=None,
                        help="chkpnt*.ckpt (or run dir; latest taken) of a "
                             "stage-1 run to bridge from")
    parser.add_argument("--checkpoint_interval", type=int, default=5000,
                        help="save a resumable stage-2 chkpnt<it>.ckpt every "
                             "N iters (0 = only at the end)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vis_interval", type=int, default=500,
                        help="save an AOV grid every N iters (0 = off)")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="check loss finiteness EVERY iter (one host "
                             "sync per step) instead of at the log interval")
    parser.add_argument("--anomaly_continue", action="store_true",
                        help="after dumping a reproducer, keep training "
                             "instead of halting")
    parser.add_argument("--inject_nan_at", type=int, default=0,
                        help="TESTING: poison the envmap with NaN before "
                             "iter N to exercise the reproducer path")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="data-parallel ranks: one per card on cuda, CPU "
                             "processes with --device cpu")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, or cpu for the "
                             "plain PyTorch path)")
    return parser


def _resume_target(path: str) -> str | None:
    """--start_checkpoint -> the stage-2 checkpoint it names, or None when
    it is not one (≙ train.py:96-112)."""
    from .stage2 import latest_checkpoint
    cp = latest_checkpoint(path)
    if cp and os.path.exists(cp + ".json"):
        with open(cp + ".json") as f:
            if json.load(f).get("kind") == "stage2":
                return cp
    return None


def _reset_materials(params, opt, env_zero: bool):
    """Base colour and roughness to their init values, and (for the toy)
    the envmap to zeros (≙ train.py:186-193, :226-235)."""
    import torch
    from ..scene.gaussians import inverse_base_color_activation
    from ..utils.math3d import inverse_sigmoid
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    with torch.no_grad():
        params.base_color.fill_(float(inverse_base_color_activation(
            f32(opt.init_base_color_value))))
        params.roughness.fill_(float(inverse_sigmoid(
            f32(opt.init_roughness_value))))
        if env_zero:
            params.env.zero_()


def _from_stage1(path, cfg, dev):
    """The stage-2 parameters from a stage-1 checkpoint (≙ train.py:172-186,
    restore_from_refgs)."""
    from ..scene import gaussians as G
    from .stage1_full import load_stage1_checkpoint
    s1_state, s1_iter = load_stage1_checkpoint(path, device=dev)
    params, aux = G.from_refgs(
        s1_state.params, s1_state.aux,
        env_resolution=cfg.model.envmap_resolution,
        env_init_value=cfg.model.envmap_init_value,
        env_activation=cfg.model.envmap_activation,
        init_base_color=cfg.opt.init_base_color_value,
        init_metallic=cfg.opt.init_metallic_value,
        init_roughness=cfg.opt.init_roughness_value)
    print(f"restored stage-1 geometry @ iter {s1_iter} ({aux.n_alive} "
          "gaussians)", flush=True)
    return params, aux


# the CPU toy's GT frames: resolution, diffuse samples, ring views (as
# train.py shrinks them on a CPU mesh)
CPU_TOY = dict(res=64, spp=8, cams=6)
# the card's toy GT frames (train.py's own sizes)
CUDA_TOY = dict(res=256, spp=64, cams=16)


def _toy_scene(cfg, dev, s1_ckpt=None, views=None):
    """The procedural toy run: GT frames of the true sphere scene rendered by
    render_ir_eval, then materials and env reset (≙ train.py:118-194). On
    the CPU every budget shrinks as train.py's does on a CPU mesh. `views`
    (indices) renders only those cameras' frames, the others None."""
    import dataclasses

    import numpy as np

    from ..ops import grid_tracer as gt
    from ..render.eval import EvalConfig, render_ir_eval
    from ..scene import toy

    on_cpu = dev.type == "cpu"
    if on_cpu:
        toy_res, toy_spp, toy_cams = (CPU_TOY[k] for k in ("res", "spp",
                                                           "cams"))
        cfg.pipe.diffuse_sample_num = min(cfg.pipe.diffuse_sample_num, 16)
        cfg.opt.trace_num_rays = min(cfg.opt.trace_num_rays, 2 ** 12)
        cfg.pipe.tracer_grid_res = 16
        cfg.pipe.tracer_max_cells = 8
        cfg.pipe.tracer_max_hits = 16
        cfg.pipe.tracer_hit_budget = 8
        cfg.pipe.tracer_max_crossings = 12
        cfg.pipe.dup_capacity = 2 ** 16
        print("toy on CPU: shrunk sample/tracer budgets for smoke-test "
              "speed", flush=True)
        params, aux = toy.make_sphere_scene(
            n_surface=1024, n_capacity=2048,
            env_resolution=cfg.model.envmap_resolution, device=dev)
    else:
        toy_res, toy_spp, toy_cams = (CUDA_TOY[k] for k in ("res", "spp",
                                                            "cams"))
        params, aux = toy.make_sphere_scene(
            n_surface=8192, n_capacity=16384,
            env_resolution=cfg.model.envmap_resolution, device=dev)
    cams = toy.make_ring_cameras(toy_cams, width=toy_res, height_px=toy_res)
    ecfg = EvalConfig(img_w=toy_res, img_h=toy_res,
                      diffuse_sample_num=toy_spp, light_sample_num=0,
                      env_activation=cfg.model.envmap_activation,
                      dup_capacity=2 ** 16 if on_cpu else 2 ** 21,
                      tracer=dataclasses.replace(
                          gt.TracerConfig.from_pipe(cfg.pipe, eval=True),
                          pair_capacity=2 ** 16 if on_cpu else 2 ** 21))
    grid = gt.build_grid_from_gaussians(params, aux, ecfg.tracer)
    gt_images = [render_ir_eval(params, aux, grid, c.params(dev),
                                ecfg)["render"].cpu().numpy()
                 if views is None or i in views else None
                 for i, c in enumerate(cams)]
    if s1_ckpt:
        # the stage-1 toy reconstruction as the start
        params, aux = _from_stage1(s1_ckpt, cfg, dev)
    else:
        _reset_materials(params, cfg.opt, env_zero=True)
    return params, aux, cams, gt_images, [None] * len(cams)


def main(argv=None):
    from .. import resolve_device
    from ..config import Config
    from ..parallel.dp import launch_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser(Config()).parse_args(argv)
    if args.n_devices > 1:
        launch_ranks(_train_rank, args.n_devices, args.device, (argv,))
        return
    _train(args, resolve_device(args.device))


def _train_rank(mesh, device, argv):
    """One rank of `--n_devices` N; rank 0 alone prints."""
    from ..config import Config
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")
    _train(_parser(Config()).parse_args(argv), device, mesh)


def _train(args, dev, mesh=None):
    import numpy as np
    import torch

    from ..config import Config, apply_args
    from ..ops import grid_tracer as gt
    from ..render import eval as reval
    from ..scene import envlight
    from ..scene import gaussians as G
    from ..utils import vis
    from ..utils.checkpoint import save_checkpoint
    from . import stage2 as s2

    lead = mesh is None or mesh.rank == 0     # the rank that writes
    cfg = apply_args(Config(), args)
    if not cfg.model.model_path:
        cfg.model.model_path = os.path.join(tempfile.gettempdir(),
                                            "irgs_tpu_stage2")
    if lead:
        os.makedirs(cfg.model.model_path, exist_ok=True)
        cfg.save()

    # --start_checkpoint: a stage-2 checkpoint resumes in place; anything
    # else is a stage-1 bridge, as --start_checkpoint_refgs
    s2_resume = s1_ckpt = None
    if args.start_checkpoint:
        s2_resume = _resume_target(args.start_checkpoint)
        if not s2_resume:
            s1_ckpt = args.start_checkpoint
    if args.start_checkpoint_refgs:
        s1_ckpt = args.start_checkpoint_refgs

    if args.toy:
        params, aux, cams, gt_images, masks = _toy_scene(cfg, dev, s1_ckpt)
    else:
        from ..scene.datasets import LIGHT_ROTATE_TRANSFORM, load_scene
        info = load_scene(cfg.model.source_path, cfg.model.white_background,
                          eval_split=cfg.model.eval,
                          resolution=cfg.model.resolution)
        cams = info.train_cameras
        gt_images = [c.image for c in cams]
        masks = [c.mask for c in cams]
        if s1_ckpt:
            params, aux = _from_stage1(s1_ckpt, cfg, dev)
        elif args.start_ply:
            params, aux = G.load_ply(args.start_ply, cfg.model.max_gaussians,
                                     cfg.model.sh_degree,
                                     env_activation=cfg.model.envmap_activation,
                                     device=dev)
        elif not s2_resume:
            params, aux = G.create_from_pcd(
                info.points, info.colors, cfg.model.max_gaussians,
                cfg.model.sh_degree, cfg.model.envmap_resolution,
                cfg.model.envmap_init_value,
                env_activation=cfg.model.envmap_activation, device=dev)
        else:
            params = aux = None           # the checkpoint holds them
        if params is not None:
            _reset_materials(params, cfg.opt, env_zero=False)
        # computed as train.py does, which passes it to nothing (ROADMAP.md C)
        light_transform = LIGHT_ROTATE_TRANSFORM if info.light_rotate else None  # noqa: F841

    h, w = gt_images[0].shape[:2]
    st = s2.from_configs(cfg, img_w=w, img_h=h)
    first_iter = 0
    if s2_resume:
        state, first_iter = s2.load_stage2_checkpoint(s2_resume, cfg.opt, dev)
        print(f"resumed stage-2 from {s2_resume} @ iter {first_iter}",
              flush=True)
    else:
        state = s2.init_state(params, aux, cfg.opt)
    grid = gt.build_grid_from_gaussians(state.params, state.aux, st.tracer)
    n_ov = int(grid.oversize)
    if cfg.pipe.tracer_oversize_cap < 0:
        # -1 = the merge forced off: oversize Gaussians are truncated to a
        # centered window (the JAX package's sentinel)
        cfg.pipe.tracer_oversize_cap = 0
        if n_ov > 0:
            print(f"WARNING: oversize merge forced off; {n_ov} gaussians "
                  "span > span_cap cells and are window-truncated",
                  flush=True)
    elif n_ov > 0 and cfg.pipe.tracer_oversize_cap == 0:
        # surfels wider than span_cap cells would be truncated: switch the
        # exact merge on, sized to this scene, and save the cfg again so
        # that evals replay it
        cfg.pipe.tracer_oversize_cap = min(128, ((n_ov + 31) // 32) * 32)
        print(f"auto-enabled tracer_oversize_cap="
              f"{cfg.pipe.tracer_oversize_cap} ({n_ov} gaussians span > "
              f"span_cap cells)", flush=True)
        if lead:
            cfg.save()
        st = s2.from_configs(cfg, img_w=w, img_h=h)
        grid = gt.build_grid_from_gaussians(state.params, state.aux,
                                            st.tracer)
        if int(grid.oversize) > 0:
            print(f"WARNING: {int(grid.oversize)} oversize gaussians "
                  f"beyond the cap remain window-truncated", flush=True)
    cam_params = [c.params(dev) for c in cams]
    # frames and masks move to the device once, as float32 / bool
    gt_dev = [torch.tensor(np.asarray(g, np.float32), device=dev)
              for g in gt_images]
    mask_dev = [None if m is None else torch.tensor(m, device=dev)
                for m in masks]

    dp_step = None
    if mesh is not None:
        from ..parallel import broadcast_params, stage2_dp_step
        broadcast_params(mesh, state.params)
        dp_step = stage2_dp_step(mesh, st)
        if lead:
            print(f"data-parallel over {mesh.size} ranks ({dev.type}); each "
                  f"step consumes {mesh.size} cameras", flush=True)

    vcfg = None
    if args.vis_interval and lead:
        vcfg = reval.EvalConfig(img_w=w, img_h=h, diffuse_sample_num=64,
                                light_sample_num=0, tracer=st.tracer,
                                white_background=cfg.model.white_background,
                                env_activation=cfg.model.envmap_activation,
                                dup_capacity=st.dup_capacity)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(cams))
    t0 = time.time()
    log_path = os.path.join(cfg.model.model_path, "train_log.jsonl")
    with open(log_path if lead else os.devnull, "a") as logf:
        for it in range(first_iter + 1, cfg.opt.iterations + 1):
            i = int(order[it % len(cams)])
            if it % len(cams) == 0:
                order = rng.permutation(len(cams))
            if args.inject_nan_at == it:
                with torch.no_grad():
                    state.params.env.mul_(float("nan"))
            checked = args.detect_anomaly or it % 50 == 0 or it == 1
            # the step updates the state in place: the reproducer needs a
            # copy of the state before it, taken only on checked steps
            prev = s2.state_tensors(state) if checked else None
            gen_state = gen.get_state() if checked else None
            if dp_step is not None:
                # every rank makes the same choices and all ranks' draws, in
                # rank order, and keeps its own
                idxs = rng.choice(len(cams), size=mesh.size,
                                  replace=len(cams) < mesh.size)
                draws = [s2.draw_stage2(gen, st, dev)
                         for _ in range(mesh.size)][mesh.rank]
                j = int(idxs[mesh.rank])
                state, metrics = dp_step(state, grid, cam_params[j],
                                         gt_dev[j], draws)
            else:
                draws = s2.draw_stage2(gen, st, dev)
                state, metrics = s2.stage2_step(state, grid, cam_params[i],
                                                gt_dev[i], mask_dev[i], draws,
                                                st=st)
            # reproducer dump on a non-finite loss: the state before the
            # step, the camera and the generator state of its draws
            if checked:
                loss_now = float(metrics["loss"])
                if not np.isfinite(loss_now):
                    rp = os.path.join(cfg.model.model_path,
                                      f"reproducer_{it:06d}.ckpt")
                    if lead:
                        save_checkpoint(
                            rp, {**prev, "generator_state": gen_state}, it,
                            extra={"cam_index": i, "seed": args.seed,
                                   "loss": loss_now,
                                   "kind": "stage2_nonfinite_loss"})
                        print(f"ERROR iter {it}: non-finite loss "
                              f"({loss_now}); reproducer dumped to {rp}",
                              file=sys.stderr, flush=True)
                    if not args.anomaly_continue:
                        raise SystemExit(3)
            del prev
            if cfg.opt.lr_scale > 0:
                grid = gt.build_grid_from_gaussians(state.params, state.aux,
                                                    st.tracer)
            if lead and (it % 50 == 0 or it == 1):
                m = {k_: float(v) for k_, v in metrics.items()}
                m.update(iter=it, elapsed=round(time.time() - t0, 1))
                print(json.dumps(m), flush=True)
                logf.write(json.dumps(m) + "\n")
                logf.flush()
                if m.get("raster_overflow", 0) > 0 or m.get("grid_overflow", 0) > 0:
                    print(f"WARNING iter {it}: CAPACITY OVERFLOW — "
                          f"raster dup {m.get('raster_overflow', 0):.0f}, "
                          f"grid pairs {m.get('grid_overflow', 0):.0f}; "
                          "results silently degrade. Raise --dup_capacity / "
                          "tracer pair_capacity.", file=sys.stderr, flush=True)
                if m.get("grid_oversize", 0) > 0:
                    print(f"WARNING iter {it}: {m['grid_oversize']:.0f} "
                          "gaussians span > span_cap grid cells — their "
                          "insertion is TRUNCATED to a centered window and "
                          "rays far from their center miss them. Raise "
                          "tracer span_cap or lower tracer_grid_res.",
                          file=sys.stderr, flush=True)
                if m.get("trace_more_frac", 0) > 0.05:
                    print(f"WARNING iter {it}: {100*m['trace_more_frac']:.1f}% "
                          "of traced rays still truncated after all re-trace "
                          "rounds — raise tracer_n_segments/retrace_frac.",
                          file=sys.stderr, flush=True)
            if vcfg is not None and (it % args.vis_interval == 0 or it == 1):
                out = reval.render_ir_eval(state.params, state.aux, grid,
                                           cam_params[0], vcfg)
                panels = {k: out[k] for k in (
                    "render", "render_sh", "diffuse", "specular", "base_color",
                    "roughness", "rend_alpha", "rend_normal", "surf_normal",
                    "surf_depth", "rend_dist", "visibility", "light",
                    "light_indirect", "light_direct", "env_only") if k in out}
                panels["gt"] = gt_dev[0]
                vis.save_aov_grid(os.path.join(cfg.model.model_path, "vis",
                                               f"iter_{it:06d}.png"), panels)
                vis.save_envmap_png(
                    os.path.join(cfg.model.model_path, "vis",
                                 f"env_{it:06d}.png"),
                    envlight.activate(state.params.env.detach(),
                                      cfg.model.envmap_activation))
            if not lead:
                continue
            if it % 5000 == 0 or it == cfg.opt.iterations:
                out_dir = os.path.join(cfg.model.model_path, "point_cloud",
                                       f"iteration_{it}")
                os.makedirs(out_dir, exist_ok=True)
                G.save_ply(os.path.join(out_dir, "point_cloud.ply"),
                           state.params, state.aux,
                           env_activation=cfg.model.envmap_activation)
            ci = args.checkpoint_interval
            if (ci and it % ci == 0) or it == cfg.opt.iterations:
                s2.save_stage2_checkpoint(
                    os.path.join(cfg.model.model_path, f"chkpnt{it}.ckpt"),
                    state, it)
    if lead:
        print("done:", cfg.model.model_path)


if __name__ == "__main__":
    main()
