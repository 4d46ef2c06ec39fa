"""Stage-2 training throughput at the bench workload (≙ bench.py).

    python -m irgs_tpu_torch.bench [--device cuda]

The workload is `workload.BENCH` (the JAX script's): the 100k-surfel toy
sphere at capacity 2^17, a 400x400 frame, 256 diffuse samples per pixel,
2^18 trace rays (1024 shaded pixels), dup capacity 2^19, the training tracer
of `TracerConfig.from_pipe`, grey targets, weights and draws from seed 0.
A probe rasterization at the dup capacity must drop no splat, or the run
raises. One warm-up step, then 4 rounds of 10 chained steps (each consumes
the state the one before left), each round closed by a synchronisation;
the best round counts.

Prints the card's name and power limit on stderr, then ONE JSON line with
the JAX script's keys: `metric`, `value` (iter/s), `unit`, `vs_baseline`,
`mfu`, `hbm_util`, `flops_per_step`, `bytes_per_step`. `vs_baseline` is
null: the JAX script's baseline of 1 iter/s is a target for another device.
The cost fields are null: PyTorch has no per-program cost model like XLA's
`cost_analysis`, and this system runs no model whose FLOPs would define an
MFU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None, workload=None, n_rounds: int = 4, n_iters: int = 10):
    """`workload` (a dict of workload.stage2_setup's arguments, default
    BENCH) and the round counts shrink the run for a test."""
    import torch

    from . import resolve_device
    from . import workload as W
    from .ops import surfel_raster as sr
    from .tools.common import card_line, sync
    from .train import stage2 as s2

    ap = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    wl = dict(W.BENCH if workload is None else workload)
    img = wl["img"]

    state, grid, cams, st = W.stage2_setup(**wl, device=dev)
    cam_params = [c.params(dev) for c in cams]
    gts = [torch.full((img, img, 3), 0.5, device=dev) for _ in cams]
    gen = torch.Generator(dev).manual_seed(0)

    # honesty check: the static duplicate capacity must cover this workload
    p = state.params
    with torch.no_grad():
        probe = sr.rasterize(
            p.xyz, p.get_scaling(), p.rotation, p.get_opacity()[:, 0],
            p.get_features(), torch.zeros((p.n_capacity, 1), device=dev),
            torch.zeros((p.n_capacity, 2), device=dev), cam_params[0],
            torch.zeros(3, device=dev), img_w=img, img_h=img,
            active_sh_degree=3, dup_capacity=st.dup_capacity,
            alive=state.aux.alive)
    if int(probe.overflow) != 0:
        raise RuntimeError(f"dup overflow {int(probe.overflow)}: the bench's "
                           f"dup capacity {st.dup_capacity} does not cover "
                           "its workload")
    del probe

    def step(i):
        nonlocal state
        draws = s2.draw_stage2(gen, st, dev)
        state, m = s2.stage2_step(state, grid, cam_params[i % len(cams)],
                                  gts[i % len(cams)], None, draws, st=st)
        return m

    step(0)                                  # warm-up
    sync(dev)
    best_dt, i = float("inf"), 0
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            i += 1
            step(i)
        sync(dev)
        best_dt = min(best_dt, time.perf_counter() - t0)
    iters_per_sec = n_iters / best_dt

    print(card_line(dev), file=sys.stderr, flush=True)
    print("# mfu, hbm_util, flops_per_step, bytes_per_step: null (PyTorch has "
          "no per-program cost model like XLA's cost_analysis, and no model "
          "FLOPs define an MFU here)", file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "stage2_train_iters_per_sec",
        "value": round(iters_per_sec, 4),
        "unit": (f"iter/s ({img}x{img}, {wl['n_surface'] // 1000}k "
                 f"gaussians, {wl['spp']}spp x "
                 f"{wl['rays'] // wl['spp']} rays)"),
        "vs_baseline": None,
        "mfu": None,
        "hbm_util": None,
        "flops_per_step": None,
        "bytes_per_step": None,
    }), flush=True)


if __name__ == "__main__":
    main()
