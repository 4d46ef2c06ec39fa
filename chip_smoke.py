"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

    python3 chip_smoke.py --phases build,kernels,eval_small

Phases (JSON lines; any failure exits non-zero):
  build         compile the CUDA kernels from irgs_tpu_torch/csrc for sm_90a,
                one nvcc per source, all started together;
  kernels       hold each kernel against its plain PyTorch version on the
                card: the blend at two slabs (with how its work spreads over
                the tiles, and the heaviest tile's time alone), the row
                gather (bit for bit) at the JAX package's test shapes and the
                TPU probe kernels';
  stage2_small  one test-scale stage-2 step on the card and on the CPU;
  stage2        stage2_step at the bench workload (100k-surfel toy sphere,
                400x400, 256 diffuse samples, 2^18 trace rays); both blend
                kernels must run on every step;
  eval_small    one test-scale NVS eval frame on the card and on the CPU;
  eval          the NVS eval frame at the bench scene (workload.EVAL): one
                untimed frame, which also records the real inputs of the
                forward blend and of the row gather (held against their
                plain versions as `kernels` lines), then one timed frame with
                the gather kernel and one without; the two must be equal bit
                for bit.
Then a `kernels` summary line, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(ROOT, "irgs_tpu_torch")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and fp32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per pixel x splat pair, counted from the first version of
# the kernel source and kept as the yardstick, so that shares of the bound
# compare across versions (each add, mul, compare, select, exp, log1p or
# division counts one):
# alpha_depth 55; the forward blend 30 + 2·NA (transmittance, cut, median
# test, NA attribute FMAs, depth/distortion moments); the backward's pass A
# replays alpha_depth and the weight and forms w·dL/dw (81 + 2·NA), pass B
# adds dalpha/ddepth/dm, the hand-derived chain rule (~60) and the
# per-splat sums over the tile's pixels (173 + 4·NA)
FWD_OPS_PER_PAIR = lambda na: 55 + 30 + 2 * na
BWD_OPS_PER_PAIR = lambda na: (81 + 2 * na) + (173 + 4 * na)

# tolerances of kernel vs plain version. Forward: the kernel runs the
# transmittance as a sequential sum of log1p where the plain version takes
# torch.cumsum, so the two round differently (≈1e-6 relative); a pixel whose
# T sits exactly at a threshold (the 1e-4 cut or the 0.5 median test) can
# flip, so the check bounds the share of elements outside the tolerance, and
# the share of pixels whose med_ord (an index) differs.
FWD_ATOL, FWD_RTOL = 5e-5, 1e-4
BWD_REL = 5e-4          # x max|g| per slab row, as the JAX parity tests
MAX_OUTLIER_SHARE = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=1):
    """Median ms of fn() over reps, each timed with CUDA events and
    synchronised."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_queued(fn, n=20):
    """Mean ms of fn() over n calls enqueued back to back between two CUDA
    events: the host's launch overhead hides behind the device's work, so
    this reads device time where cuda_ms (one synchronised call per event
    pair, the yardstick of the kernel table) also counts the launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def compare_fwd(a, b, S):
    """Kernel output `a` against the plain version's `b`. The values are
    every channel but med_ord; med_ord, an index, is counted as flips."""
    import torch
    from irgs_tpu_torch.ops import raster_blend as rb
    i_ord = rb.c_out(S) - 2
    vals = [j for j in range(rb.c_out(S)) if j != i_ord]
    d = (a[..., vals] - b[..., vals]).abs()
    bad = d > (FWD_ATOL + FWD_RTOL * b[..., vals].abs())
    return {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
            "outlier_share": float(bad.float().mean()),
            "med_ord_flip_share": float((a[..., i_ord] != b[..., i_ord])
                                        .float().mean()),
            "finite": bool(torch.isfinite(a).all())}


# ---------------------------------------------------------------------------

def phase_build():
    """Build every csrc/*.cu at once, one nvcc each (wall time is the
    slowest build, not the sum)."""
    from concurrent.futures import ThreadPoolExecutor
    from irgs_tpu_torch.ops import _cuda_build
    names = sorted(p[:-3] for p in os.listdir(_cuda_build.CSRC)
                   if p.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: _cuda_build.build(n, verbose=True),
                            names))
    libs = [{"source": f"irgs_tpu_torch/csrc/{n}.cu",
             "library": os.path.relpath(path, ROOT), "seconds": round(secs, 3),
             "ptxas": [l.strip() for l in log.splitlines()
                       if "Used" in l or "spill" in l]}
            for n, (path, secs, log) in zip(names, built)]
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3), "libraries": libs})


def _slab_for(n_surface, n_capacity, img, dup_capacity, dev, cam_index=0):
    """The blend's real inputs: the toy sphere's slab as rasterize builds it."""
    import torch
    from irgs_tpu_torch.ops import surfel_raster as sr
    from irgs_tpu_torch.scene import toy

    params, aux = toy.make_sphere_scene(n_surface=n_surface,
                                        n_capacity=n_capacity,
                                        env_resolution=128, device=dev)
    cam = toy.make_ring_cameras(8, width=img, height_px=img)[cam_index].params(dev)
    grid_x = (img + 15) // 16
    n_tiles = grid_x * grid_x
    with torch.no_grad():
        feats = torch.cat([params.get_base_color(), params.get_roughness()], -1)
        prep = sr.preprocess(params.xyz, params.get_scaling(), params.rotation,
                             params.get_opacity()[:, 0], params.get_features(),
                             cam, img, img, 3, alive=aux.alive)
        binning = sr.bin_and_sort(prep, grid_x, grid_x, dup_capacity)
        splat, starts, counts = sr.build_slab(prep, binning, feats, grid_x,
                                              n_tiles, dup_capacity)
    if int(binning.overflow) != 0:
        raise RuntimeError(f"dup overflow {int(binning.overflow)}")
    return splat, starts, counts, grid_x, n_tiles, feats.shape[-1]


def _bounds(chunks_run, S, fwd_out_bytes, backward):
    """Least time for the blend's work at these inputs: the larger of bytes
    moved over HBM rate and fp32 operations over the fp32 peak. Slab columns
    and pixel x splat pairs count only the chunks these inputs need: each
    tile's chunks up to the one at which no pixel stays transmissive
    (`chunks_run`, from the plain version)."""
    from irgs_tpu_torch.ops import raster_blend as rb
    na = rb.n_attr(S)
    n_cols = int(chunks_run.sum()) * rb.K
    pairs = n_cols * rb.TILE_PIX
    slab_bytes = 4 * rb.slab_width(S) * n_cols
    if backward:
        # reads slab + fwd_out + cot, writes dslab
        nbytes = 2 * slab_bytes + 2 * fwd_out_bytes
        ops = pairs * BWD_OPS_PER_PAIR(na)
    else:
        nbytes = slab_bytes + fwd_out_bytes
        ops = pairs * FWD_OPS_PER_PAIR(na)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "fp32_ops": ops, "pairs": pairs})


def _tile_work(chunks_run):
    """How the blend's work spreads over the tiles: the chunks of K splats
    each tile blended before it stopped (`chunks_run`), over the tiles that
    blended any. The heaviest tile bounds the kernel from below: one block
    walks its chunks in order."""
    busy = chunks_run[chunks_run > 0]
    return {"tiles_with_work": int(busy.numel()),
            "tile_chunks_max": int(busy.max()) if busy.numel() else 0,
            "tile_chunks_p50": float(busy.float().median())
            if busy.numel() else 0.0}


def _heaviest_alone(counts, chunks_run):
    """`counts` with every tile but the one that blends the most chunks
    emptied: the kernels' time on it is the heaviest tile's critical path,
    with the card otherwise idle."""
    import torch
    keep = torch.zeros_like(counts)
    t = int(torch.argmax(chunks_run))
    keep[t] = counts[t]
    return keep


def check_blend_fwd(results, name, args):
    """The forward blend kernel against its plain version on `args`
    (splat, starts, counts, grid_x, n_tiles, S), with its time, the plain
    version's and its bound. Returns (ok, kernel output, plain output, the
    plain version's chunks run per tile, output bytes)."""
    import torch
    from irgs_tpu_torch.ops import raster_blend as rb
    counts, S = args[2], args[5]
    with torch.no_grad():
        out_k = rb.blend_fwd_cuda(*args)
        torch.cuda.synchronize()
        out_p, chunks_run = rb.blend_tiles_plain(*args, return_chunks=True)
        torch.cuda.synchronize()
    c = compare_fwd(out_k, out_p, S)
    c_ok = (c["finite"] and c["outlier_share"] <= MAX_OUTLIER_SHARE
            and c["med_ord_flip_share"] <= MAX_OUTLIER_SHARE)
    ms = cuda_ms(lambda: rb.blend_fwd_cuda(*args))
    ms_queued = cuda_ms_queued(lambda: rb.blend_fwd_cuda(*args))
    alone = (*args[:2], _heaviest_alone(counts, chunks_run), *args[3:])
    ms_alone = cuda_ms_queued(lambda: rb.blend_fwd_cuda(*alone))
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: rb.blend_tiles_plain(*args), reps=3)
    fwd_bytes = 4 * out_k.numel()
    bound_ms, bound_by, work = _bounds(chunks_run, S, fwd_bytes,
                                       backward=False)
    work["chunks_run"] = int(chunks_run.sum())
    work["chunks_total"] = int(counts.sum()) // rb.K
    work.update(_tile_work(chunks_run))
    line = {"phase": "kernels", "kernel": "blend_fwd", "case": name,
            "ok": c_ok, **c, "atol": FWD_ATOL, "rtol": FWD_RTOL,
            "max_outlier_share": MAX_OUTLIER_SHARE, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_queued": ms_queued,
            "ms_heaviest_tile_alone": ms_alone,
            "slab_columns": int(args[0].shape[1]),
            **work}
    emit(line)
    results.setdefault("blend_fwd", {})[name] = line
    return c_ok, out_k, out_p, chunks_run, fwd_bytes


def phase_kernels(results):
    import numpy as np
    import torch
    from irgs_tpu_torch.ops import raster_blend as rb

    dev = torch.device("cuda")
    cases = [("mid_128px_8k", 8192, 16384, 128, 2 ** 17),
             ("bench_400px_100k", 100_000, 2 ** 17, 400, 2 ** 19)]
    ok = True
    for name, n_s, n_cap, img, dup in cases:
        splat, starts, counts, grid_x, n_tiles, S = _slab_for(n_s, n_cap, img,
                                                              dup, dev)
        args = (splat, starts, counts, grid_x, n_tiles, S)
        c_ok, out_k, out_p, chunks_run, fwd_bytes = check_blend_fwd(
            results, name, args)
        ok &= c_ok

        rng = np.random.default_rng(7)
        cot = torch.tensor(rng.standard_normal(tuple(out_k.shape)),
                           dtype=torch.float32, device=dev)
        cot[..., rb.c_out(S) - 2] = 0.0   # med_ord is an index
        # the backward kernel replays the plain forward's totals and median
        # order, so that both sides route the median gradient to one splat
        d_k = rb.blend_bwd_cuda(splat, starts, counts, out_p, cot, grid_x,
                                n_tiles, S)
        torch.cuda.synchronize()
        d_k2 = rb.blend_bwd_cuda(splat, starts, counts, out_p, cot, grid_x,
                                 n_tiles, S)
        torch.cuda.synchronize()
        sp = splat.clone().requires_grad_(True)
        out_sp = rb.blend_tiles_plain(sp, starts, counts, grid_x, n_tiles, S)
        (d_p,) = torch.autograd.grad(out_sp, sp, cot, retain_graph=True)
        torch.cuda.synchronize()
        rows = []
        r_ok = bool(torch.equal(d_k, d_k2)) and bool(torch.isfinite(d_k).all())
        for j in range(12 + rb.n_attr(S)):
            scale = float(d_p[j].abs().max().clamp_min(1e-8))
            dd = (d_k[j] - d_p[j]).abs()
            share = float((dd > BWD_REL * scale).float().mean())
            rows.append(share)
            r_ok &= share <= MAX_OUTLIER_SHARE
        ms = cuda_ms(lambda: rb.blend_bwd_cuda(splat, starts, counts, out_k,
                                               cot, grid_x, n_tiles, S))
        ms_queued = cuda_ms_queued(lambda: rb.blend_bwd_cuda(
            splat, starts, counts, out_k, cot, grid_x, n_tiles, S))
        alone = _heaviest_alone(counts, chunks_run)
        ms_alone = cuda_ms_queued(lambda: rb.blend_bwd_cuda(
            splat, starts, alone, out_k, cot, grid_x, n_tiles, S))
        # the plain version's backward alone: autograd through its graph
        plain_ms = cuda_ms(lambda: torch.autograd.grad(out_sp, sp, cot,
                                                       retain_graph=True),
                           reps=3)
        del out_sp
        bound_ms, bound_by, work = _bounds(chunks_run, S, fwd_bytes,
                                           backward=True)
        work.update(_tile_work(chunks_run))
        d = (d_k - d_p).abs()
        line = {"phase": "kernels", "kernel": "blend_bwd", "case": name,
                "ok": r_ok, "deterministic": bool(torch.equal(d_k, d_k2)),
                "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                "max_row_outlier_share": max(rows), "rel_tol": BWD_REL,
                "max_outlier_share": MAX_OUTLIER_SHARE, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "ms_queued": ms_queued,
                "ms_heaviest_tile_alone": ms_alone, **work}
        emit(line)
        results.setdefault("blend_bwd", {})[name] = line
        ok &= r_ok
    if not ok:
        fail("kernels", "a kernel disagrees with its plain version")


# the row gather's cases apart from the eval frame's own: the shapes of
# tests/test_gather_pallas.py (M = 3T + 7, and its 5-row small batch) and
# the two probe kernels of tools/_prof_collect_parts.py (`kern`, a row gather
# of [1024, 128] by 128 rows; `kern2`, a flat gather of 8 x 128 elements
# from 110592, i.e. rows of one word)
GATHER_CASES = [("test_513x224", 513, 224, 3 * 513 + 7),
                ("test_64x896", 64, 896, 3 * 64 + 7),
                ("test_2048x56", 2048, 56, 3 * 2048 + 7),
                ("test_small_batch", 10, 4, 5),
                ("probe_kern_1024x128", 1024, 128, 128),
                ("probe_kern2_flat", 110592, 1, 8 * 128)]


def check_gather(results, name, table, idx):
    """The gather kernel against table[idx] on the card, bit for bit, with
    its time, the plain version's, index_select's, and its bound: the
    distinct rows this idx reads, idx itself and the output, over the HBM
    rate."""
    import torch
    from irgs_tpu_torch.ops import gather_rows as gr
    out = gr.gather_rows_cuda(table, idx)
    want = gr.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    same = bool(torch.equal(out.view(torch.int32), want.view(torch.int32)))
    M, W = idx.shape[0], table.shape[1]
    rows_read = int(torch.unique(idx).numel())
    nbytes = 4 * W * rows_read + 8 * M + 4 * W * M
    line = {"phase": "kernels", "kernel": "gather_rows", "case": name,
            "ok": same, "bitwise_equal": same,
            "max_abs_err": float((out - want).abs().max()) if M else 0.0,
            "table": list(table.shape), "rows": M, "distinct_rows": rows_read,
            "ms": cuda_ms(lambda: gr.gather_rows_cuda(table, idx)),
            "plain_ms": cuda_ms(lambda: gr.gather_rows_plain(table, idx)),
            "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}
    emit(line)
    results.setdefault("gather_rows", {})[name] = line
    return same


def phase_kernels_gather(results):
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    for name, T, W, M in GATHER_CASES:
        table = torch.randn((T, W), device=dev, generator=g)
        idx = torch.randint(0, T, (M,), device=dev, generator=g)
        ok &= check_gather(results, name, table, idx)
    if not ok:
        fail("kernels", "gather_rows differs from table[idx]")


def phase_stage2_small():
    """One stage-2 step at the CPU tests' scale on the card and with the
    plain CPU path, from the same draws: the whole step, kernels included,
    against the port's plain version."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.train import stage2 as s2

    tracer = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8,
                  max_hits=24, hit_budget=16, max_crossings=10,
                  select_tiles=4, tile=32, tiled_direct=True, n_segments=4,
                  retrace_frac=0.25)
    res = {}
    gen = torch.Generator().manual_seed(0)
    for dev in ("cpu", "cuda"):
        state, grid, cams, st = workload.stage2_setup(
            512, 1024, 64, 8, 8 * 128, 2 ** 14, dev, tracer)
        if dev == "cpu":
            draws = s2.draw_stage2(gen, st, "cpu")
        gt_img = torch.full((64, 64, 3), 0.4, device=dev)
        state.step = 1001
        state, m = s2.stage2_step(state, grid, cams[0].params(dev), gt_img,
                                  None, s2.Stage2Draws(*(d.to(dev) for d in draws)),
                                  st=st)
        res[dev] = (m, {k: v.detach().cpu() for k, v in
                        state.params.tensors().items()})
    loss_rel = abs(float(res["cuda"][0]["loss"]) - float(res["cpu"][0]["loss"])) \
        / abs(float(res["cpu"][0]["loss"]))
    p_err = max(float((res["cuda"][1][k] - res["cpu"][1][k]).abs().max())
                for k in res["cpu"][1])
    ok = loss_rel <= 1e-4 and p_err <= 1e-5
    emit({"phase": "stage2_small", "ok": ok, "loss_cuda": float(res["cuda"][0]["loss"]),
          "loss_cpu": float(res["cpu"][0]["loss"]), "loss_rel_err": loss_rel,
          "loss_rel_tol": 1e-4, "param_max_abs_err": p_err, "param_tol": 1e-5})
    if not ok:
        fail("stage2_small", "the step on the card disagrees with the CPU path")


def phase_stage2(results, n_warm=1, n_timed=5):
    """stage2_step at the bench workload, on the card."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.train import stage2 as s2

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state, grid, cams, st = workload.stage2_setup(**workload.BENCH,
                                                  device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cam_params = [c.params(dev) for c in cams]
    gt_img = torch.full((400, 400, 3), 0.5, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    xyz0 = state.params.xyz.detach().clone()
    mat0 = state.params.base_color.detach().clone()

    def step(i):
        nonlocal state
        draws = s2.draw_stage2(gen, st, dev)
        state, m = s2.stage2_step(state, grid, cam_params[i % len(cams)],
                                  gt_img, None, draws, st=st)
        return m

    for i in range(n_warm):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rb.reset_launches()                      # count the main path only
    times, metrics = [], []
    for i in range(n_warm, n_warm + n_timed):
        a = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - a) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(rb.LAUNCHES)
    last = metrics[-1]
    results.setdefault("launches", {})["stage2"] = launches
    line = {"phase": "stage2", "steps_timed": n_timed,
            "setup_s": round(setup_s, 3),
            "ms_per_step": statistics.median(times), "ms_steps": times,
            "loss": last["loss"], "ray_psnr": last["ray_psnr"],
            "raster_overflow": max(m["raster_overflow"] for m in metrics),
            "grid_overflow": last["grid_overflow"],
            "grid_oversize": last["grid_oversize"],
            "trace_trunc_frac": last.get("trace_trunc_frac"),
            "trace_more_frac": last.get("trace_more_frac"),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches,
            "launches_per_step": {k: v / n_timed for k, v in launches.items()}}
    checks = {
        "loss_finite": all(math.isfinite(m["loss"]) for m in metrics),
        "raster_overflow_zero": line["raster_overflow"] == 0.0,
        "kernels_every_step": all(v >= n_timed for v in launches.values()),
        "xyz_frozen": bool(torch.equal(state.params.xyz.detach(), xyz0)),
        "materials_moved": not bool(torch.equal(
            state.params.base_color.detach(), mat0)),
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("stage2", f"checks failed: {checks}")


# eval frame agreement, card against CPU or JAX: rtol 2e-4 / atol 2e-5 per
# element (the JAX package's compact-vs-full eval test), except for a share
# of outliers. The card and the CPU round the sample directions (sin, cos,
# the batched matrix product) differently in the last bit, and the tracer's
# discrete tests (alpha_min, the transmittance cut, the hit-cell dedup) can
# then take or drop a hit on such a ray; a flipped hit moves one of a pixel's
# S samples, so an outlier is bounded by 1/S.
EVAL_RTOL, EVAL_ATOL = 2e-4, 2e-5
EVAL_MAX_OUTLIER_SHARE = 0.01

# the test-scale eval frame: 2k surfels, 64x64, 32 diffuse samples (one
# chunk of 4096 pixels x 32 = 2^17 rays, so the chunked trace path runs), a
# grid-16 eval tracer with adaptive, select_topk and the gather kernel
EVAL_SMALL = dict(n_surface=2000, n_capacity=2048, img=64, diffuse=32,
                  light=0, pallas_gather=8,
                  tracer=dict(grid_res=16, pair_capacity=2 ** 15,
                              max_cells=8, max_hits=24, select_tiles=4,
                              retrace_select_tiles=8, hit_budget=8,
                              retrace_hit_budget=12, max_crossings=12,
                              retrace_max_crossings=16, retrace_max_cells=12,
                              retrace_max_hits=48),
                  dup_capacity=2 ** 16)


def phase_eval_small():
    """One test-scale eval frame on the card and on the CPU (plain versions
    of every kernel), from the same scene."""
    import numpy as np
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.render.eval import render_ir_eval
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import raster_blend as rb

    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        params, aux, grid, cam, ecfg = workload.eval_setup(**EVAL_SMALL,
                                                           device=dev)
        rb.reset_launches()
        gr.reset_launches()
        stats[dev] = {}
        out = render_ir_eval(params, aux, grid, cam, ecfg,
                             stats_out=stats[dev])
        outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
        stats[dev]["launches"] = {**rb.LAUNCHES, **gr.LAUNCHES}
    spp = EVAL_SMALL["diffuse"]
    aovs, ok = {}, True
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        d = np.abs(got - want)
        share = float((d > EVAL_ATOL + EVAL_RTOL * np.abs(want)).mean())
        aovs[k] = {"max_abs_err": float(d.max()), "outlier_share": share}
        ok &= (bool(np.isfinite(got).all()) and share <= EVAL_MAX_OUTLIER_SHARE
               and float(d.max()) <= 1.0 / spp)
    lc = stats["cuda"]["launches"]
    ok &= lc["blend_fwd"] == 1 and lc["gather_rows"] > 0
    ok &= stats["cpu"]["launches"]["gather_rows"] == 0
    ok &= stats["cuda"]["raster_overflow"] == 0
    emit({"phase": "eval_small", "ok": bool(ok), "rtol": EVAL_RTOL,
          "atol": EVAL_ATOL, "max_outlier_share": EVAL_MAX_OUTLIER_SHARE,
          "max_abs_bound": 1.0 / spp, "stats": stats, "aovs": aovs})
    if not ok:
        fail("eval_small", "the eval frame on the card disagrees with the "
             "CPU path")


def check_eval_inputs(results, blend_args, seen, first_pass_tiles):
    """The kernels against their plain versions on the eval frame's recorded
    inputs: the blend's one call, and the gather's first call of the first
    pass and of the re-trace rounds."""
    ok = len(blend_args) == 1 and len(seen) == 2
    for args in blend_args:
        ok &= check_blend_fwd(results, "eval_400px_100k", args)[0]
    for tiles, (table, idx) in sorted(seen.items()):
        where = "first_pass" if tiles == first_pass_tiles else "retrace"
        ok &= check_gather(results, f"eval_{where}_{idx.shape[0]}x"
                           f"{table.shape[1]}", table, idx)
    if not ok:
        fail("kernels", "a kernel differs from its plain version on the eval "
             f"frame's inputs (blend calls recorded: {len(blend_args)}, "
             f"gather stages: {len(seen)})")


def phase_eval(results):
    """The NVS eval frame at the bench scene, on the card."""
    import dataclasses
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.render.eval import render_ir_eval

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params, aux, grid, cam, ecfg = workload.eval_setup(**workload.EVAL,
                                                       device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the untimed frame records the kernels' real inputs: the G-buffer
    # blend's, and the gather's first ones of the first pass and of the
    # re-trace rounds, told apart by the select's tile budget
    seen, current, blend_args = {}, {}, []
    kernel, select, blend = (gt.gather_rows_kernel, gt.select_hits_tiled,
                             rb.blend_tiles)

    def select_rec(*args, **kw):
        current["tiles"] = args[5].select_tiles     # its TracerConfig
        return select(*args, **kw)

    def gather_rec(table, idx, **kw):
        seen.setdefault(current["tiles"], (table, idx.clone()))
        return kernel(table, idx, **kw)

    def blend_rec(*args):
        blend_args.append(args)
        return blend(*args)

    gt.gather_rows_kernel, gt.select_hits_tiled = gather_rec, select_rec
    rb.blend_tiles = blend_rec
    try:
        a = time.perf_counter()
        render_ir_eval(params, aux, grid, cam, ecfg)
        torch.cuda.synchronize()
        untimed_s = time.perf_counter() - a
    finally:
        gt.gather_rows_kernel, gt.select_hits_tiled = kernel, select
        rb.blend_tiles = blend

    # hold both kernels against their plain versions on those inputs, and
    # drop the inputs before the timed frames measure peak memory
    check_eval_inputs(results, blend_args, seen, ecfg.tracer.select_tiles)
    del blend_args, seen

    def frame(cfg):
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rb.reset_launches()                  # count the main path only
        gr.reset_launches()
        a = time.perf_counter()
        out = render_ir_eval(params, aux, grid, cam, cfg, stats_out=stats)
        torch.cuda.synchronize()
        stats["seconds"] = time.perf_counter() - a
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        stats["launches"] = {**rb.LAUNCHES, **gr.LAUNCHES}
        return out, stats

    out_k, st_k = frame(ecfg)
    plain_cfg = dataclasses.replace(
        ecfg, tracer=dataclasses.replace(ecfg.tracer, pallas_gather=0))
    out_p, st_p = frame(plain_cfg)
    results.setdefault("launches", {})["eval"] = st_k["launches"]

    equal = {k: bool(torch.equal(out_k[k], out_p[k])) for k in out_k}
    line = {"phase": "eval", "setup_s": round(setup_s, 3),
            "untimed_frame_s": untimed_s,
            "s_per_frame": st_k["seconds"],
            "s_per_frame_gather_off": st_p["seconds"],
            "fg_pixels": st_k["shaded_pixels"],
            # the headline rate counts the shaded pixels' rays; the traced
            # rays also count the last chunk's padding, which retraces
            # pixel 0
            "shaded_rays": st_k["shaded_rays"],
            "traced_rays": st_k["traced_rays"],
            "mrays_per_s": st_k["shaded_rays"] / st_k["seconds"] / 1e6,
            "mrays_per_s_incl_padding":
                st_k["traced_rays"] / st_k["seconds"] / 1e6,
            "max_memory_allocated": st_k["max_memory_allocated"],
            "max_memory_allocated_gather_off": st_p["max_memory_allocated"],
            "trace_trunc_frac": st_k.get("trace_trunc_frac"),
            "trace_more_frac": st_k.get("trace_more_frac"),
            "raster_overflow": st_k["raster_overflow"],
            "launches_per_frame": st_k["launches"],
            "launches_per_frame_gather_off": st_p["launches"],
            "tracer": dataclasses.asdict(ecfg.tracer)}
    checks = {
        "aovs_finite": all(bool(torch.isfinite(v).all())
                           for v in out_k.values()),
        "aov_count_18": len(out_k) == 18,
        "raster_overflow_zero": st_k["raster_overflow"] == 0,
        "blend_fwd_once": st_k["launches"]["blend_fwd"] == 1,
        "gather_launched": st_k["launches"]["gather_rows"] > 0,
        "gather_off_not_launched": st_p["launches"]["gather_rows"] == 0,
        "gather_on_off_bitwise_equal": all(equal.values()),
    }
    line["unequal_aovs"] = [k for k, v in equal.items() if not v]
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("eval", f"checks failed: {checks}")


# each kernel: its source, the Pallas functions it replaces, and for each
# main path it runs on, the case held at the shape that path gives it (the
# summary's top-level numbers are those of the first path's case)
KERNELS = {
    "blend_fwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:141",
        cases={"stage2": "bench_400px_100k", "eval": "eval_400px_100k"}),
    "blend_bwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:222",
        cases={"stage2": "bench_400px_100k"}),
    "gather_rows": dict(
        route="cuda", source="irgs_tpu_torch/csrc/gather_rows.cu",
        replaces=("irgs_tpu/ops/gather_pallas.py:28; "
                  "tools/_prof_collect_parts.py:121; "
                  "tools/_prof_collect_parts.py:144"),
        cases={"eval": "eval_first_pass"}),
}
_CASE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def kernels_line(results):
    """The summary: one entry per kernel, with the numbers of the case of its
    first main path, its launches on each main path run, and per path the
    case held at that path's shape."""
    out = []
    launches = results.get("launches", {})
    for name, meta in KERNELS.items():
        cases = results.get(name, {})
        by_path = {}
        for path, prefix in meta["cases"].items():
            case = next((k for k in cases if k.startswith(prefix)), None)
            by_path[path] = {
                "launches": launches.get(path, {}).get(name), "case": case,
                **{k: cases.get(case, {}).get(k) for k in _CASE_KEYS}}
        top = next(iter(by_path.values()))
        ran = [p["launches"] for p in by_path.values()
               if p["launches"] is not None]
        out.append({"name": name, "route": meta["route"],
                    "source": meta["source"], "replaces": meta["replaces"],
                    "launches": sum(ran) if ran else None,
                    # no single PyTorch call computes the per-tile blend
                    # (library_ms null); the gather's is index_select
                    **{k: top[k] for k in _CASE_KEYS}, "case": top["case"],
                    "by_path": by_path,
                    "matches_plain": all(c["ok"] for c in cases.values())})
    return {"kernels": out}


PHASES = ("build", "kernels", "stage2_small", "stage2", "eval_small", "eval")


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return res.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not os.path.isdir(PKG):
        print("chip_smoke.py must run from a checkout of the repository "
              "(irgs_tpu_torch/ not found)", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        sys.exit(3)
    import irgs_tpu_torch  # noqa: F401  (precision flags)

    results = {}
    t0 = time.perf_counter()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(results)
        phase_kernels_gather(results)
    if "stage2_small" in phases:
        phase_stage2_small()
    if "stage2" in phases:
        phase_stage2(results)
    if "eval_small" in phases:
        phase_eval_small()
    if "eval" in phases:
        phase_eval(results)
    summary = kernels_line(results)
    print(json.dumps(summary), flush=True)
    if set(phases) == set(PHASES):
        # every kernel must have run on each of its main paths
        idle = [(k["name"], p) for k in summary["kernels"]
                for p, c in k["by_path"].items() if not c["launches"]]
        if idle:
            fail("done", f"kernels not launched on their main path: {idle}")
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
