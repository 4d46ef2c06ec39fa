"""The workloads that `chip_smoke.py` and the profiles drive: the toy sphere
scene (`scene/toy.py`) with weights from a seed, ring cameras, and the
configurations of `config.py` at a chosen size.

`BENCH` is the stage-2 training workload of the JAX package's `bench.py`:
100k surfels at capacity 2^17, a 400x400 frame, 256 diffuse samples per
pixel, 2^18 trace rays (1024 shaded pixels), dup capacity 2^19, and the
training tracer of `TracerConfig.from_pipe`.

`STAGE1_BENCH` is the stage-1 workload of the JAX package's
`tools/bench_stage1.py:37-52`: 100k points drawn uniform(-1.2, 1.2) with
colours uniform(0.2, 0.8) from np.random.RandomState(0), capacity 2^17, SH
degree 3, two trainable 6x128x128x3 cubemaps, 8 ring cameras at 400x400, a
grey (0.5) target, cameras_extent 3.3. Its dup capacity is 2^21, not the
bench script's 2^20, which the JAX package's notes record as dropping 7-12 %
of the splats at this workload.

`STAGE1_SMALL` is stage 1 at test scale: the toy sphere's 2000 surfels at
capacity 4096 with random materials, indirect SH and 16² cubemaps from a
seed, 64x64 views.

`EVAL` is the NVS eval frame of the JAX package's `tools/bench_frame.py` at
`render.py`'s sample counts: the same scene, ring camera 0 at 400x400,
`EvalConfig` defaults (dup capacity 2^21, 2^20 point samples per chunk),
256 diffuse and 0 light samples, and the eval tracer of
`TracerConfig.from_pipe(..., eval=True)` (on the card its tiled select
fetches candidate rows with the row-gather kernel).
"""

from __future__ import annotations

import dataclasses

BENCH = dict(n_surface=100_000, n_capacity=2 ** 17, img=400, spp=256,
             rays=2 ** 18, dup=2 ** 19)
EVAL = dict(n_surface=100_000, n_capacity=2 ** 17, img=400, diffuse=256,
            light=0)
STAGE1_BENCH = dict(n_points=100_000, n_capacity=2 ** 17, img=400, n_cams=8,
                    env_res=128, dup=2 ** 21, cameras_extent=3.3)
STAGE1_SMALL = dict(n_surface=2000, n_capacity=4096, img=64, n_cams=3,
                    env_res=16, dup=2 ** 16, cameras_extent=3.0)


def stage2_setup(n_surface: int, n_capacity: int, img: int, spp: int,
                 rays: int, dup: int, device, tracer: dict | None = None,
                 light: int = 0):
    """-> (TrainState, Grid, ring cameras, Stage2Static) on `device`, with
    `spp` diffuse and `light` light samples per shaded pixel. `tracer`
    overrides the TracerConfig fields (default: from_pipe)."""
    from .config import Config
    from .ops import grid_tracer as gt
    from .scene import toy
    from .train import stage2 as s2

    params, aux = toy.make_sphere_scene(n_surface=n_surface,
                                        n_capacity=n_capacity,
                                        env_resolution=128 if img > 64 else 16,
                                        device=device)
    cams = toy.make_ring_cameras(8 if img > 64 else 3, width=img,
                                 height_px=img)
    cfg = Config()
    cfg.pipe.diffuse_sample_num = spp
    cfg.pipe.light_sample_num = light
    cfg.opt.trace_num_rays = rays
    st = dataclasses.replace(s2.from_configs(cfg, img_w=img, img_h=img),
                             dup_capacity=dup)
    if tracer is not None:
        st = dataclasses.replace(st, tracer=gt.TracerConfig(**tracer))
    grid = gt.build_grid_from_gaussians(params, aux, st.tracer)
    state = s2.init_state(params, aux, cfg.opt)
    return state, grid, cams, st


def eval_setup(n_surface: int, n_capacity: int, img: int, diffuse: int,
               light: int, device=None,
               tracer: dict | None = None, **eval_fields):
    """-> (params, aux, Grid, CameraParams of ring camera 0, EvalConfig) on
    `device` (default cuda). `tracer` overrides TracerConfig fields of the
    eval budgets; `eval_fields` override EvalConfig fields."""
    from . import resolve_device
    from .config import Config
    from .ops import grid_tracer as gt
    from .render.eval import EvalConfig
    from .scene import toy

    device = resolve_device(device)
    params, aux = toy.make_sphere_scene(n_surface=n_surface,
                                        n_capacity=n_capacity,
                                        env_resolution=128 if img > 64 else 16,
                                        device=device)
    cam = toy.make_ring_cameras(1, width=img, height_px=img)[0].params(device)
    tcfg = dataclasses.replace(gt.TracerConfig.from_pipe(Config().pipe,
                                                         eval=True),
                               **(tracer or {}))
    ecfg = EvalConfig(img_w=img, img_h=img, active_sh_degree=3,
                      diffuse_sample_num=diffuse, light_sample_num=light,
                      tracer=tcfg, **eval_fields)
    grid = gt.build_grid_from_gaussians(params, aux, tcfg)
    return params, aux, grid, cam, ecfg


def stage1_setup(n_points: int, n_capacity: int, img: int, n_cams: int,
                 env_res: int, dup: int, cameras_extent: float, device):
    """-> (Stage1State, ring cameras, grey target, FG table, static kwargs)
    of STAGE1_BENCH on `device`: init_ref_from_pcd of the bench's random
    cloud (the Morton-window kNN above 50k points)."""
    import numpy as np
    import torch

    from .config import stage1_config
    from .scene import cubemap as cm
    from .scene import ref_gaussians as rgs
    from .scene import toy
    from .train import stage1_full as s1

    opt = stage1_config().opt
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1.2, 1.2, (n_points, 3)).astype(np.float32)
    colors = rs.uniform(0.2, 0.8, (n_points, 3)).astype(np.float32)
    params, aux = rgs.init_ref_from_pcd(
        pts, colors, n_capacity, 3, env_res=env_res,
        init_metallic=opt.init_metallic_value,
        init_roughness=opt.init_roughness_value, device=device)
    state = s1.init_state(params, aux, opt, cameras_extent)
    cams = toy.make_ring_cameras(n_cams, width=img, height_px=img)
    gt = torch.full((img, img, 3), 0.5, device=device)
    lut = cm.compute_fg_lut(device=device)
    static = dict(img_w=img, img_h=img, active_sh_degree=3,
                  white_background=False, dup_capacity=dup,
                  lambda_dssim=opt.lambda_dssim,
                  lambda_normal_render_depth=opt.lambda_normal_render_depth,
                  lambda_normal_smooth=opt.lambda_normal_smooth)
    return state, cams, gt, lut, static


def stage1_small_fields(n_surface: int, n_capacity: int, env_res: int,
                        seed: int = 0):
    """STAGE1_SMALL's RefGaussianParams fields as numpy arrays (the toy
    sphere's geometry and SH, random materials, indirect SH and cubemaps)
    and its alive mask."""
    import numpy as np

    from .scene import toy
    params, aux = toy.make_sphere_scene(n_surface=n_surface,
                                        n_capacity=n_capacity,
                                        env_resolution=16, device="cpu")
    rng = np.random.default_rng(seed)
    n, k = n_capacity, (params.max_sh_degree + 1) ** 2
    f32 = lambda a: np.asarray(a, np.float32)
    g = {f: t.detach().numpy() for f, t in params.tensors().items()}
    fields = dict(
        xyz=f32(g["xyz"] + 0.01 * rng.standard_normal((n, 3))),
        base_color=f32(rng.standard_normal((n, 3))),
        metallic=f32(rng.standard_normal((n, 1))),
        roughness=f32(rng.standard_normal((n, 1))),
        features_dc=g["features_dc"],
        features_rest=f32(0.05 * rng.standard_normal((n, k - 1, 3))),
        indirect_dc=f32(0.3 * rng.standard_normal((n, 1, 3))),
        indirect_rest=f32(0.05 * rng.standard_normal((n, k - 1, 3))),
        scaling=g["scaling"], rotation=g["rotation"], opacity=g["opacity"],
        env1=f32(0.5 * rng.standard_normal((6, env_res, env_res, 3))),
        env2=f32(0.5 * rng.standard_normal((6, env_res, env_res, 3))))
    return fields, aux.alive.numpy()
