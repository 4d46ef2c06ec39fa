"""The stage-2 workload that `chip_smoke.py` and `profile_stage2` drive: the
toy sphere scene (`scene/toy.py`) with random weights from a seed, ring
cameras, and the training configuration of `config.py` at a chosen size.

`BENCH` is the workload of the JAX package's `bench.py`: 100k surfels at
capacity 2^17, a 400x400 frame, 256 diffuse samples per pixel, 2^18 trace
rays (1024 shaded pixels), dup capacity 2^19, and the training tracer of
`TracerConfig.from_pipe`.
"""

from __future__ import annotations

import dataclasses

BENCH = dict(n_surface=100_000, n_capacity=2 ** 17, img=400, spp=256,
             rays=2 ** 18, dup=2 ** 19)


def stage2_setup(n_surface: int, n_capacity: int, img: int, spp: int,
                 rays: int, dup: int, device, tracer: dict | None = None):
    """-> (TrainState, Grid, ring cameras, Stage2Static) on `device`.
    `tracer` overrides the TracerConfig fields (default: from_pipe)."""
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
    cfg.opt.trace_num_rays = rays
    st = dataclasses.replace(s2.from_configs(cfg, img_w=img, img_h=img),
                             dup_capacity=dup)
    if tracer is not None:
        st = dataclasses.replace(st, tracer=gt.TracerConfig(**tracer))
    grid = gt.build_grid_from_gaussians(params, aux, st.tracer)
    state = s2.init_state(params, aux, cfg.opt)
    return state, grid, cams, st
