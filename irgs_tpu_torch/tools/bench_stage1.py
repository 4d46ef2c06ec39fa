"""Stage-1 step throughput per phase at the bench workload
(≙ tools/bench_stage1.py).

    python -m irgs_tpu_torch.tools.bench_stage1 [--img 400] [--n 100000]
        [--iters 10] [--device cuda]

The workload is `workload.STAGE1_BENCH` at the JAX script's sizes: `--n`
points uniform in ±1.2 with colours from np.random.RandomState(0), capacity
2^17, two 128² cubemaps, 8 ring cameras at `--img`², a grey target,
cameras_extent 3.3, and the script's dup capacity 2^20. Each phase
(initial / volume / surfel, no indirect path) starts from the initial state
and runs one warm-up step and `--iters` chained steps; then
densify_and_prune twice on the surfel phase's state (the second timed), then
reconstruct_tsdf of the 8 views at 128³.

Prints one line per part, the card's name and power limit, and last one
JSON line with the JAX script's keys: `stage1_<phase>_iters_per_sec`,
`stage1_densify_ms`, `stage1_tsdf_refresh_s`.
"""

from __future__ import annotations

import argparse
import json
import time

DUP = 2 ** 20            # the JAX script's dup capacity (steps and TSDF)


def main(argv=None, n_capacity: int | None = None, n_cams: int | None = None,
         env_res: int | None = None, fg_lut: dict | None = None):
    """`n_capacity`, `n_cams`, `env_res` and `fg_lut` (default
    STAGE1_BENCH's 2^17, 8 views, 128² cubemaps and the 256 x 8192-sample
    FG table) shrink the run for a test."""
    import torch

    from .. import resolve_device
    from .. import workload as W
    from ..config import stage1_config
    from ..train import densify as D
    from ..train import stage1_full as s1
    from .common import card_line, sync

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.bench_stage1",
        description=__doc__.splitlines()[0])
    ap.add_argument("--img", type=int, default=400)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = W.STAGE1_BENCH
    wl = dict(b, n_points=args.n, img=args.img, dup=DUP,
              n_capacity=n_capacity or b["n_capacity"],
              n_cams=n_cams or b["n_cams"], env_res=env_res or b["env_res"])
    opt = stage1_config().opt
    extent = wl["cameras_extent"]

    state, cams, gt, lut, static = W.stage1_setup(**wl, device=dev,
                                                  fg_lut=fg_lut)
    cam_params = [c.params(dev) for c in cams]
    results = {}
    for phase in ("initial", "volume", "surfel"):
        if phase != "initial":
            # each phase from the initial state, as the JAX script
            state = W.stage1_state(wl["n_points"], wl["n_capacity"],
                                   wl["env_res"], extent, dev)
        st = s1.Stage1FullStatic(phase=phase, use_indirect=False, **static)
        state, _ = s1.stage1_full_step(state, cam_params[0], gt, None, lut,
                                       None, st=st)
        sync(dev)
        t0 = time.perf_counter()
        for i in range(1, args.iters + 1):
            state, m = s1.stage1_full_step(state, cam_params[i % len(cams)],
                                           gt, None, lut, None, st=st)
        sync(dev)
        dt = (time.perf_counter() - t0) / args.iters
        results[f"stage1_{phase}_iters_per_sec"] = round(1.0 / dt, 3)
        print(f"{phase}: {dt * 1e3:.0f} ms/step ({1 / dt:.2f} iter/s), "
              f"raster overflow {float(m['raster_overflow']):.0f}",
              flush=True)

    # densify (between steps, every 100 iterations in the schedule)
    gen = torch.Generator(dev).manual_seed(1)
    kw = dict(grad_threshold=opt.densify_grad_threshold,
              min_opacity=opt.prune_opacity_threshold, extent=extent,
              max_screen_size=20, percent_dense=opt.percent_dense,
              generator=gen)
    t0 = time.perf_counter()
    state.aux, _ = D.densify_and_prune(state.params, state.aux,
                                       state.optimizer, **kw)
    sync(dev)
    print(f"densify_and_prune: {(time.perf_counter() - t0) * 1e3:.0f} ms "
          "(first)", flush=True)
    t0 = time.perf_counter()
    state.aux, _ = D.densify_and_prune(state.params, state.aux,
                                       state.optimizer, **kw)
    sync(dev)
    dt_d = time.perf_counter() - t0
    results["stage1_densify_ms"] = round(dt_d * 1e3, 1)
    print(f"densify_and_prune warm: {dt_d * 1e3:.0f} ms", flush=True)

    # TSDF refresh (every mesh_interval iterations in the schedule): render
    # every training view and fuse, no extraction
    t0 = time.perf_counter()
    with torch.no_grad():
        s1.reconstruct_tsdf(state.params, state.aux, cams, img_w=args.img,
                            img_h=args.img, active_sh_degree=3, mesh_res=128,
                            cameras_extent=extent, dup_capacity=DUP)
    sync(dev)
    dt_t = time.perf_counter() - t0
    results["stage1_tsdf_refresh_s"] = round(dt_t, 2)
    print(f"tsdf refresh ({len(cams)} views, 128^3): {dt_t:.1f} s",
          flush=True)
    print(card_line(dev), flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
