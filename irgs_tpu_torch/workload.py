"""The workloads that `chip_smoke.py` and the profiles drive: the toy sphere
scene (`scene/toy.py`) with weights from a seed, ring cameras, and the
configurations of `config.py` at a chosen size.

`BENCH` is the stage-2 training workload of the JAX package's `bench.py`:
100k surfels at capacity 2^17, a 400x400 frame, 256 diffuse samples per
pixel, 2^18 trace rays (1024 shaded pixels), dup capacity 2^19, and the
training tracer of `TracerConfig.from_pipe`.

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
