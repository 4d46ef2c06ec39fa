"""The tracer's truncation bias across scene densities
(≙ tools/trace_fidelity.py).

    python -m irgs_tpu_torch.tools.trace_fidelity [--device cuda]

For each density (the toy sphere at 100k surfels, capacity 2^17, "bench",
and at 200k, capacity 2^18, "dense"), 16384 rays from near surface points
in random directions (a torch.Generator seeded 3) are traced by a
high-budget reference config (16 cells, 96 hits, budget 32, no crossing
cap, 3 segments, every ray re-traced) and by the training budgets with and
without the segmented re-trace (VARIANTS). Prints per variant mean |dalpha|
and |dcolor| against the reference and the trace's time: each config runs
once untimed, then once timed, synchronised.
"""

from __future__ import annotations

import argparse
import time

import torch

# production budget sets; n_segments=1 is the single-pass behaviour
VARIANTS = [
    ("train(40h,16kb) seg1", dict(max_cells=12, max_hits=40, hit_budget=16,
                                  max_crossings=24, n_segments=1)),
    ("train(40h,16kb) seg2", dict(max_cells=12, max_hits=40, hit_budget=16,
                                  max_crossings=24, n_segments=2,
                                  retrace_frac=0.25)),
]
REFERENCE = dict(max_cells=16, max_hits=96, hit_budget=32, max_crossings=0,
                 n_segments=3, retrace_frac=1.0)
DENSITIES = [(100_000, 2 ** 17, "bench"), (200_000, 2 ** 18, "dense")]


@torch.no_grad()
def run(params, aux, ro, rd, grid_res: int = 48, **kw):
    """Trace (ro, rd) with TracerConfig(grid_res, pair_capacity 2^21, **kw):
    once untimed, once timed -> (TraceOut, seconds)."""
    from ..ops import grid_tracer as gt
    from ..render import ir
    from .common import sync
    cfg = gt.TracerConfig(grid_res=grid_res, pair_capacity=2 ** 21, **kw)
    grid = gt.build_grid_from_gaussians(params, aux, cfg)
    tf = ir.make_trace_fn(params, aux, grid, cfg, torch.zeros(3,
                                                              device=ro.device),
                          3)
    tf(ro, rd)
    sync(ro.device)
    t0 = time.perf_counter()
    out = tf(ro, rd)
    sync(ro.device)
    return out, time.perf_counter() - t0


def compare(out, ref) -> dict:
    return {"dalpha": float((out.alpha - ref.alpha).abs().mean()),
            "dcolor": float((out.color - ref.color).abs().mean())}


def main(argv=None, densities=None, n_rays: int = 16384,
         grid_res: int = 48):
    """`densities` [(n_surface, n_capacity, tag)], `n_rays` and `grid_res`
    shrink the run for a test."""
    from .. import resolve_device
    from ..scene import toy
    from .audit_train_budget import audit_rays
    from .common import card_line

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.trace_fidelity",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    rows = {}
    for n_gauss, cap, tag in densities or DENSITIES:
        params, aux = toy.make_sphere_scene(n_surface=n_gauss, n_capacity=cap,
                                            env_resolution=64, device=dev)
        ro, rd = audit_rays(params, n_gauss, n_rays,
                            torch.Generator(dev).manual_seed(3))
        ref, t_ref = run(params, aux, ro, rd, grid_res, **REFERENCE)
        print(f"--- density={tag} ({n_gauss} gaussians), oracle "
              f"{t_ref * 1e3:.0f} ms", flush=True)
        rows[tag] = {"oracle_ms": t_ref * 1e3}
        for name, kw in VARIANTS:
            o, t = run(params, aux, ro, rd, grid_res, **kw)
            c = compare(o, ref)
            rows[tag][name] = {**c, "ms": t * 1e3}
            print(f"{name}: |dalpha|={c['dalpha']:.5f} "
                  f"|dcolor|={c['dcolor']:.5f} {t * 1e3:.0f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
