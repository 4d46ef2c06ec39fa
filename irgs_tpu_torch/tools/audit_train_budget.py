"""The default tracer configs' bias against the exact brute-force oracle
(≙ tools/audit_train_budget.py).

    python -m irgs_tpu_torch.tools.audit_train_budget [--n_rays 512]
        [--full] [--tile64] [--bf16] [--t32] [--only SUBSTR] [--device cuda]

Runs the training tracer config (`TracerConfig.from_pipe(Config().pipe)`,
what `python -m irgs_tpu_torch.train` uses) and the eval config against
grid_tracer.trace_reference on the dense stress scene: the 100k-surfel toy
sphere, rays from near surface points in random directions, occluded ones
included (the shadow and interreflection regime). Prints one row per
variant: mean |dcolor|, mean |dalpha|, the 50/90/99th percentiles of each
ray's largest channel error and the share of rays above 0.05. `--full`,
`--t32`, `--tile64` and `--bf16` add the JAX tool's tuning ladders (each a
set of TracerConfig overrides), `--only` keeps the variants whose name holds
the substring. The JAX tool's `--cpu` is `--device cpu` here. Rays come from
a torch.Generator seeded 3.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

ORACLE_CHUNK = 64


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.audit_train_budget",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu: the bias is the "
                         "budgets', so the rows do not depend on the device)")
    ap.add_argument("--n_rays", type=int, default=512)
    ap.add_argument("--full", action="store_true",
                    help="also run the tuning-ladder variants")
    ap.add_argument("--tile64", action="store_true",
                    help="run the 64-candidate-tile ladder")
    ap.add_argument("--only", type=str, default="",
                    help="run only variants whose name contains this "
                         "substring")
    ap.add_argument("--bf16", action="store_true",
                    help="audit the bf16 pair table and top-k extraction "
                         "ladder")
    ap.add_argument("--t32", action="store_true",
                    help="repair ladder for the tile-32 direct defaults: "
                         "more tiles or segments")
    return ap


def audit_rays(params, n_surface: int, n_rays: int, generator):
    """Rays from near the first n_surface surfels, in uniform directions."""
    dev = params.xyz.device
    kw = dict(generator=generator, device=dev)
    idx = torch.randint(0, n_surface, (n_rays,), **kw)
    ro = params.xyz.detach()[idx] + 0.05 * torch.randn(n_rays, 3, **kw)
    rd = torch.randn(n_rays, 3, **kw)
    return ro, rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)


def variants(args, train_tc, eval_tc):
    """[(name, TracerConfig)] as the JAX tool lists them."""
    r = dataclasses.replace
    out = [("shipping TRAIN config", train_tc),
           ("shipping EVAL config", eval_tc)]
    if args.full:
        out += [
            ("train +prefilter256", r(train_tc, prefilter_width=256)),
            ("train +prefilter256 seg2/f0.25", r(
                train_tc, prefilter_width=256, retrace_frac=0.25)),
            ("train +prefilter512 seg3/f0.25", r(
                train_tc, prefilter_width=512, n_segments=3,
                retrace_frac=0.25)),
            ("eval +prefilter256/r1024", r(
                eval_tc, prefilter_width=256, retrace_prefilter_width=1024)),
            ("eval +prefilter512/r2048 seg8", r(
                eval_tc, prefilter_width=512, retrace_prefilter_width=2048,
                n_segments=8))]
    if args.t32:
        out += [
            ("train t32x24 seg5", r(train_tc, n_segments=5)),
            ("train t32x28 seg4", r(train_tc, select_tiles=28,
                                    retrace_select_tiles=28)),
            ("train t32x24 seg4/f0.375", r(train_tc, retrace_frac=0.375)),
            ("eval t32x24/r48 seg5", r(eval_tc, n_segments=5)),
            ("eval t32x28/r48 seg4", r(eval_tc, select_tiles=28)),
            ("train t16x48 direct", r(train_tc, tile=16, select_tiles=48,
                                      retrace_select_tiles=48)),
            ("train t32x24 packed", r(train_tc, tiled_direct=False)),
            ("train seg3", r(train_tc, n_segments=3)),
            ("train seg2", r(train_tc, n_segments=2)),
            ("train st16 seg5", r(train_tc, select_tiles=16,
                                  retrace_select_tiles=16, n_segments=5)),
            ("eval seg3", r(eval_tc, n_segments=3)),
            ("train decay0.5", r(train_tc, retrace_decay=0.5)),
            ("train cr16", r(train_tc, max_crossings=16)),
            ("train cr16 decay0.5", r(train_tc, max_crossings=16,
                                      retrace_decay=0.5))]
    if args.tile64:
        out += [(f"train tile64 x{st}", r(train_tc, tile=64, select_tiles=st,
                                          retrace_select_tiles=st))
                for st in (10, 12, 16)]
        out += [(f"eval tile64 x{st}/r{rt}", r(eval_tc, tile=64,
                                               select_tiles=st,
                                               retrace_select_tiles=rt))
                for st, rt in ((12, 24), (16, 24), (16, 32))]
    if args.bf16:
        out += [("train bf16", r(train_tc, table_bf16=True)),
                ("eval bf16", r(eval_tc, table_bf16=True)),
                ("eval topk", r(eval_tc, select_topk=True)),
                ("eval bf16 topk", r(eval_tc, table_bf16=True,
                                     select_topk=True))]
    if args.only:
        out = [(n, tc) for n, tc in out if args.only in n]
    return out


def row_stats(out, ref) -> dict:
    """The row's numbers: mean |dcolor| and |dalpha|, the percentiles of
    each ray's largest channel error and the share of rays above 0.05."""
    d = (out.color - ref.color).abs().amax(-1)
    q = np.percentile(d.cpu().numpy(), [50, 90, 99])
    return {"dcolor": float((out.color - ref.color).abs().mean()),
            "dalpha": float((out.alpha - ref.alpha).abs().mean()),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "frac_gt_0.05": float((d > 0.05).float().mean())}


def row_text(name, tc, s) -> str:
    return (f"{name} ({tc.max_cells}c,{tc.max_hits}h,{tc.hit_budget}kb,"
            f"{tc.max_crossings}cr,seg{tc.n_segments}/f{tc.retrace_frac}"
            f"d{tc.retrace_decay}): mean|dcolor|={s['dcolor']:.5f} "
            f"mean|dalpha|={s['dalpha']:.5f} dcolor p50/p90/p99="
            f"{s['p50']:.4f}/{s['p90']:.4f}/{s['p99']:.4f} "
            f"frac(>0.05)={s['frac_gt_0.05']:.3f}")


@torch.no_grad()
def audit(params, aux, ro, rd, named_configs, print_fn=print):
    """Each config's trace of (ro, rd) against the oracle -> [(name, row
    stats)], each row printed as it comes."""
    from ..ops import grid_tracer as gt
    from ..render import ir
    from .common import oracle_trace
    cam_pos = torch.zeros(3, device=ro.device)
    ref = oracle_trace(ir.trace_inputs(params, aux, cam_pos), aux.alive, ro, rd,
                       0.03, ORACLE_CHUNK)
    print_fn("oracle done")
    rows = []
    for name, tc in named_configs:
        grid = gt.build_grid_from_gaussians(params, aux, tc)
        out = ir.make_trace_fn(params, aux, grid, tc, cam_pos, 3)(ro, rd)
        s = row_stats(out, ref)
        print_fn(row_text(name, tc, s))
        rows.append((name, s))
    return rows


def main(argv=None, n_surface: int = 100_000, n_capacity: int = 2 ** 17):
    """`n_surface` and `n_capacity` shrink the stress scene for a test."""
    from .. import resolve_device
    from ..config import Config
    from ..ops import grid_tracer as gt
    from ..scene import toy
    from .common import card_line

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    params, aux = toy.make_sphere_scene(n_surface=n_surface,
                                        n_capacity=n_capacity,
                                        env_resolution=64, device=dev)
    ro, rd = audit_rays(params, n_surface, args.n_rays,
                        torch.Generator(dev).manual_seed(3))
    pipe = Config().pipe
    named = variants(args, gt.TracerConfig.from_pipe(pipe),
                     gt.TracerConfig.from_pipe(pipe, eval=True))
    return audit(params, aux, ro, rd, named,
                 print_fn=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
