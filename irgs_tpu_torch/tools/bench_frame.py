"""The time of one full-resolution NVS eval frame (≙ tools/bench_frame.py).

    python -m irgs_tpu_torch.tools.bench_frame [--img 800] [--n 100000]
        [--spp 512 256] [--device cuda]

Renders ring camera 0 of the `--n`-surfel toy sphere (capacity 2^17, a 128²
envmap) at `--img`² through the production eval path (render_ir_eval:
foreground-compacted chunks, the eval tracer of
`TracerConfig.from_pipe(pipe, eval=True)`, `--spp` diffuse + light
samples), once cold and once warm. Prints the grid's pair overflow, the
card's name and power limit, and last one JSON line with the JAX script's
keys: `frame_img`, `fg_pixels`, `rays_per_frame`, `cold_s`, `warm_s`,
`mrays_per_sec` (foreground pixels x samples over the warm frame's time).
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None, n_capacity: int = 2 ** 17, tracer: dict | None = None,
         **eval_fields):
    """`n_capacity`, `tracer` (TracerConfig overrides) and `eval_fields`
    (EvalConfig overrides) shrink the run for a test."""
    from .. import resolve_device
    from .. import workload as W
    from ..render.eval import render_ir_eval
    from .common import card_line, sync

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.bench_frame",
        description=__doc__.splitlines()[0])
    ap.add_argument("--img", type=int, default=800)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--spp", type=int, nargs=2, default=(512, 256),
                    metavar=("DIFFUSE", "LIGHT"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)

    params, aux, grid, cam, ecfg = W.eval_setup(
        n_surface=args.n, n_capacity=n_capacity, img=args.img,
        diffuse=args.spp[0], light=args.spp[1], device=dev, tracer=tracer,
        **eval_fields)
    print("grid built, overflow:", int(grid.overflow), flush=True)

    # cold frame (the first launches, the allocator's first blocks)
    t0 = time.perf_counter()
    out = render_ir_eval(params, aux, grid, cam, ecfg)
    sync(dev)
    cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = render_ir_eval(params, aux, grid, cam, ecfg)
    sync(dev)
    warm = time.perf_counter() - t0

    fg = int((out["rend_alpha"][..., 0] > 0).sum())
    rays = fg * sum(args.spp)
    print(json.dumps({
        "frame_img": args.img,
        "fg_pixels": fg,
        "rays_per_frame": rays,
        "cold_s": round(cold, 1),
        "warm_s": round(warm, 1),
        "mrays_per_sec": round(rays / warm / 1e6, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
