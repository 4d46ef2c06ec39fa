"""The bench workload with a named tracer variant, one variant per
process (≙ tools/bench_variant.py).

    python -m irgs_tpu_torch.tools.bench_variant <name> [--device cuda]

Names (the JAX script's table): base | topk | t16x48 | t128x8 | seg3 |
seg2 | st16, each a set of TracerConfig fields over the bench's training
tracer (`workload.BENCH`: 100k surfels, 400x400, 256 spp, 2^18 rays, dup
2^19); all of them have the same fields in the port's TracerConfig. The
JAX script's usage line also names selchunk2x, which its table lacks; the
port raises for it, as for any other name. One warm-up step, then 3 rounds
of 8 chained steps; prints the card line on stderr and ONE JSON line
{"variant", "iters_per_sec"} with the best round.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

VARIANTS = {
    "base": {},
    "topk": {"select_topk": True},
    "t16x48": {"tile": 16, "select_tiles": 48, "retrace_select_tiles": 48},
    "t128x8": {"tile": 128, "select_tiles": 8, "retrace_select_tiles": 8},
    "seg3": {"n_segments": 3},
    "seg2": {"n_segments": 2},
    "st16": {"select_tiles": 16, "retrace_select_tiles": 16,
             "n_segments": 5},
}


def tracer_fields(name: str) -> dict:
    """The variant's TracerConfig fields; an unknown name raises."""
    if name not in VARIANTS:
        raise KeyError(f"no tracer variant {name!r}: the JAX script's table "
                       f"has {sorted(VARIANTS)}")
    return VARIANTS[name]


def main(argv=None, workload=None, n_rounds: int = 3, n_iters: int = 8):
    """`workload` (workload.stage2_setup's arguments, default BENCH) and
    the round counts shrink the run for a test."""
    import torch

    from .. import resolve_device
    from .. import workload as W
    from ..ops import grid_tracer as gt
    from ..train import stage2 as s2
    from .common import card_line, sync

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.bench_variant",
        description=__doc__.splitlines()[0])
    ap.add_argument("name", nargs="?", default="base")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mods = tracer_fields(args.name)
    dev = resolve_device(args.device)
    wl = dict(W.BENCH if workload is None else workload)
    img = wl["img"]
    state, _, cams, st = W.stage2_setup(**wl, device=dev)
    st = dataclasses.replace(st, tracer=dataclasses.replace(st.tracer, **mods))
    grid = gt.build_grid_from_gaussians(state.params, state.aux, st.tracer)
    cam_params = [c.params(dev) for c in cams]
    gts = [torch.full((img, img, 3), 0.5, device=dev) for _ in cams]
    gen = torch.Generator(dev).manual_seed(0)

    def step(i):
        nonlocal state
        draws = s2.draw_stage2(gen, st, dev)
        state, _ = s2.stage2_step(state, grid, cam_params[i % len(cams)],
                                  gts[i % len(cams)], None, draws, st=st)

    step(0)
    sync(dev)
    best_dt, i = float("inf"), 0
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            i += 1
            step(i)
        sync(dev)
        best_dt = min(best_dt, time.perf_counter() - t0)
    print(card_line(dev), file=sys.stderr, flush=True)
    out = {"variant": args.name,
           "iters_per_sec": round(n_iters / best_dt, 4)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
