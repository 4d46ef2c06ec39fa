"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

    python3 chip_smoke.py --phases build,kernels,eval_small

Phases (JSON lines; any failure exits non-zero):
  build         compile the CUDA kernels from irgs_tpu_torch/csrc for sm_90a,
                one nvcc per source, all started together;
  kernels       hold each kernel against its plain PyTorch version on the
                card: the blend at two stage-2 slabs and at stage 1's widths
                11 and 18 (with how its work spreads over the tiles, and the
                heaviest tile's time alone), the row gather (bit for bit) at
                the JAX package's test shapes and the TPU probe kernels';
  stage2_small  one test-scale stage-2 step on the card and on the CPU, and
                two backward passes on the card bit for bit;
  stage2        stage2_step at the bench workload (100k-surfel toy sphere,
                400x400, 256 diffuse samples, 2^18 trace rays); both blend
                kernels and the gather must run on every step (the gather
                held at its first real inputs, the segment-sum scatter-add
                at its largest and at blend_hits' seven column blocks
                (65 wide), each with no host sync and n_levels(M) launches
                a call);
                one untimed step counted (scatter-add calls, segment-sum
                launches, host syncs) and one with index_add_ in the
                scatter-add's place; then the timed steps, and as many with
                index_add_;
  eval_small    one test-scale NVS eval frame on the card and on the CPU;
  mis_small     the MIS branch at test scale, card against CPU: one eval
                frame at 32 diffuse + 32 light samples, one stage-2 step with
                8 light samples from the same draws, and the light sampler
                (2^22 draws bit for bit, a chi-square test against the pdf);
  eval          the NVS eval frame at the bench scene (workload.EVAL): one
                untimed frame, which also records the real inputs of the
                forward blend and of the row gather (held against their
                plain versions as `kernels` lines), then one timed frame with
                the gather kernel and one with its plain version patched in;
                the two must be equal bit for bit;
  train_cli     python -m irgs_tpu_torch.train, in-process, at the bench
                workload: a Blender folder of 8 ring views at 400x400
                rendered from the 100k-surfel sphere, its PLY as start, 100
                iterations (checkpoints and visualisations every 50), then 5
                more resumed from chkpnt50; ms/step beside the stage2
                phase's, launches per step, peak memory;
  train_cli_oversize
                the CLI on the shadow scene (4 views, white background) for
                3 iterations: the oversize merge switched on by itself, the
                grid counts before and after, the step's peak memory, the
                kernels held at its inputs, and one merged trace_segments of
                a small shadow scene on the card against the CPU;
  eval_cli      the three eval CLIs in-process on the run train_cli leaves:
                python -m irgs_tpu_torch.render (one view, 256 + 256
                samples), .eval.material (--compute_scale, then the eval
                pass) and .eval.relighting (one view, 512 + 256 samples, a
                sun-and-sky EXR with relit GT rendered by the port at 64 + 64
                samples and the toy blob env without); per CLI its seconds
                per view and of setup, rays and Mrays/s, peak memory,
                launches per view and result JSON, the kernels held at the
                relighting path's inputs. Needs train_cli;
  stage1_small  stage 1 at test scale (2000 surfels, 64x64, 16² cubemaps),
                card against CPU: the loss and gradients of one step of each
                phase (initial, volume, surfel, and volume and surfel with
                the indirect path on a TSDF fused on the CPU), two backward
                passes on the card bit for bit, densify_and_prune from the
                same state and draws;
  stage1        stage1_full_step at STAGE1_BENCH (the JAX package's
                tools/bench_stage1.py: 100k points, 400x400, 128² cubemaps,
                dup 2^21): per phase 1 warm-up and 10 timed steps, the 128³
                TSDF of 8 views, a warm densify_and_prune, peak memory,
                overflow, launches and the blend's width per phase;
  train_stage1_cli
                python -m irgs_tpu_torch.train_refgaussian in-process on
                train_cli's folder with a 60-iteration schedule through
                every phase, densify, resets, normal propagation and TSDF
                refreshes; then python -m irgs_tpu_torch.train for 3
                iterations from its checkpoint (--start_checkpoint_refgs).
Then a `kernels` summary line, a `done` line with each phase's wall time,
the card's name and power limit, and the last line {"ok": true, "device":
{...}}.

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


def launch_counts():
    """Every kernel wrapper's launch count since the last reset."""
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.ops import segment_sum as ss
    return {**rb.LAUNCHES, **gr.LAUNCHES, **ss.LAUNCHES}


def reset_launch_counts():
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.ops import segment_sum as ss
    rb.reset_launches()
    gr.reset_launches()
    ss.reset_launches()


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


def _stage1_slabs(dev, widths=(11, 18)):
    """The blend's inputs at STAGE1_BENCH, camera 0: the bench's geometry
    (init_ref_from_pcd of its 100k-point cloud) with features of each width
    in `widths` drawn from a seed -> {S: args}."""
    import numpy as np
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import surfel_raster as sr
    from irgs_tpu_torch.scene import ref_gaussians as rgs
    from irgs_tpu_torch.scene import toy

    b = workload.STAGE1_BENCH
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1.2, 1.2, (b["n_points"], 3)).astype(np.float32)
    colors = rs.uniform(0.2, 0.8, (b["n_points"], 3)).astype(np.float32)
    params, aux = rgs.init_ref_from_pcd(pts, colors, b["n_capacity"], 3,
                                        env_res=16, device=dev)
    img = b["img"]
    cam = toy.make_ring_cameras(b["n_cams"], width=img,
                                height_px=img)[0].params(dev)
    grid_x = (img + 15) // 16
    g = torch.Generator(dev).manual_seed(1)
    out = {}
    with torch.no_grad():
        prep = sr.preprocess(params.xyz, params.get_scaling(), params.rotation,
                             params.get_opacity()[:, 0], params.get_features(),
                             cam, img, img, 3, alive=aux.alive)
        binning = sr.bin_and_sort(prep, grid_x, grid_x, b["dup"])
        if int(binning.overflow) != 0:
            raise RuntimeError(f"dup overflow {int(binning.overflow)}")
        for S in widths:
            feats = torch.rand((params.n_capacity, S), device=dev, generator=g)
            out[S] = (*sr.build_slab(prep, binning, feats, grid_x,
                                     grid_x * grid_x, b["dup"]),
                      grid_x, grid_x * grid_x, S)
    return out


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


def check_blend_bwd(results, name, args, out_k, out_p, chunks_run,
                    fwd_bytes):
    """The backward blend kernel against autograd through the plain version
    on `args`, with a random cotangent, its time, the plain version's and
    its bound. Returns ok."""
    import numpy as np
    import torch
    from irgs_tpu_torch.ops import raster_blend as rb
    splat, starts, counts, grid_x, n_tiles, S = args
    rng = np.random.default_rng(7)
    cot = torch.tensor(rng.standard_normal(tuple(out_k.shape)),
                       dtype=torch.float32, device=splat.device)
    cot[..., rb.c_out(S) - 2] = 0.0   # med_ord is an index
    # the backward kernel replays the plain forward's totals and median
    # order, so that both sides route the median gradient to one splat
    d_k = rb.blend_bwd_cuda(splat, starts, counts, out_p, cot, grid_x,
                            n_tiles, S)
    torch.cuda.synchronize()
    d_k2 = rb.blend_bwd_cuda(splat, starts, counts, out_p, cot, grid_x,
                             n_tiles, S)
    torch.cuda.synchronize()
    sp = splat.detach().clone().requires_grad_(True)
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
    return r_ok


def check_blend(results, name, args):
    """Both blend kernels against their plain version on `args`."""
    c_ok, out_k, out_p, chunks_run, fwd_bytes = check_blend_fwd(
        results, name, args)
    return c_ok & check_blend_bwd(results, name, args, out_k, out_p,
                                  chunks_run, fwd_bytes)


def phase_kernels(results):
    import torch

    dev = torch.device("cuda")
    cases = [("mid_128px_8k", 8192, 16384, 128, 2 ** 17),
             ("bench_400px_100k", 100_000, 2 ** 17, 400, 2 ** 19)]
    ok = True
    for name, n_s, n_cap, img, dup in cases:
        ok &= check_blend(results, name, _slab_for(n_s, n_cap, img, dup, dev))
    # stage 1's widths: render_volume's 11 features, 18 with indirect
    for S, args in _stage1_slabs(dev).items():
        ok &= check_blend(results, f"stage1_400px_100k_S{S}", args)
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


# the test-scale stage-2 step: tests/test_torch_stage2.py's scene and tracer
STAGE2_SMALL_TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8,
                           max_hits=24, hit_budget=16, max_crossings=10,
                           select_tiles=4, tile=32, tiled_direct=True,
                           n_segments=4, retrace_frac=0.25)
STEP_LOSS_REL_TOL, STEP_PARAM_TOL = 1e-4, 1e-5


def stage2_card_vs_cpu(light=0):
    """One stage-2 step at the CPU tests' scale (512 surfels, 64x64, 8
    diffuse and `light` light samples on 128 pixels) on the card and with
    the plain CPU path, from the same draws -> its JSON fields and ok."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.train import stage2 as s2

    res = {}
    gen = torch.Generator().manual_seed(0)
    for dev in ("cpu", "cuda"):
        state, grid, cams, st = workload.stage2_setup(
            512, 1024, 64, 8, (8 + light) * 128, 2 ** 14, dev,
            STAGE2_SMALL_TRACER, light=light)
        if dev == "cpu":
            draws = s2.draw_stage2(gen, st, "cpu")
        gt_img = torch.full((64, 64, 3), 0.4, device=dev)
        state.step = 1001
        state, m = s2.stage2_step(state, grid, cams[0].params(dev), gt_img,
                                  None, draws.to(dev), st=st)
        res[dev] = (m, {k: v.detach().cpu() for k, v in
                        state.params.tensors().items()})
    loss_rel = abs(float(res["cuda"][0]["loss"]) - float(res["cpu"][0]["loss"])) \
        / abs(float(res["cpu"][0]["loss"]))
    p_err = max(float((res["cuda"][1][k] - res["cpu"][1][k]).abs().max())
                for k in res["cpu"][1])
    ok = loss_rel <= STEP_LOSS_REL_TOL and p_err <= STEP_PARAM_TOL
    return {"light_sample_num": light,
            "loss_cuda": float(res["cuda"][0]["loss"]),
            "loss_cpu": float(res["cpu"][0]["loss"]), "loss_rel_err": loss_rel,
            "loss_rel_tol": STEP_LOSS_REL_TOL, "param_max_abs_err": p_err,
            "param_tol": STEP_PARAM_TOL}, ok


def grads_twice(make_loss, tensors):
    """Run make_loss().backward() twice from the same state -> whether
    every gradient in `tensors` (a dict of leaves) came out the same bits
    both times, and the fields that did not."""
    import torch
    runs = []
    for _ in range(2):
        for t in tensors.values():
            t.grad = None
        make_loss().backward()
        torch.cuda.synchronize()
        runs.append({k: None if t.grad is None else t.grad.clone()
                     for k, t in tensors.items()})
    differ = [k for k in tensors
              if (runs[0][k] is None) != (runs[1][k] is None)
              or (runs[0][k] is not None
                  and not torch.equal(runs[0][k], runs[1][k]))]
    return not differ, differ


def stage2_grads_deterministic():
    """Two backward passes of the test-scale stage-2 step on the card from
    the same inputs -> (bitwise equal, fields that differ)."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.train import stage2 as s2
    dev = torch.device("cuda")
    state, grid, cams, st = workload.stage2_setup(
        512, 1024, 64, 8, 8 * 128, 2 ** 14, dev, STAGE2_SMALL_TRACER)
    draws = s2.draw_stage2(torch.Generator().manual_seed(0), st, "cpu").to(dev)
    gt_img = torch.full((64, 64, 3), 0.4, device=dev)
    cam = cams[0].params(dev)
    return grads_twice(lambda: s2.stage2_forward_loss(
        state.params, state.aux, grid, cam, gt_img, None, draws, 1001,
        st)[0], state.params.tensors())


def phase_stage2_small():
    """One stage-2 step at the CPU tests' scale on the card and with the
    plain CPU path, from the same draws: the whole step, kernels included,
    against the port's plain version; and two backward passes on the card,
    bit for bit."""
    line, ok = stage2_card_vs_cpu()
    det, differ = stage2_grads_deterministic()
    emit({"phase": "stage2_small", "ok": ok and det, **line,
          "grads_bitwise_deterministic": det, "grads_differ": differ})
    if not ok:
        fail("stage2_small", "the step on the card disagrees with the CPU path")
    if not det:
        fail("stage2_small", f"two backward passes differ in {differ}")


class FirstCalls:
    """Patch functions of modules to keep the arguments of their first call
    (tensors as given; `clone` names the argument positions to copy, for
    inputs the caller overwrites or frees), and undo it on exit."""

    def __init__(self, targets, clone=()):
        self.targets, self.clone, self.args = targets, set(clone), {}
        self.orig = {}

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            fn = self.orig[name] = getattr(mod, attr)

            def rec(*a, _name=name, _fn=fn, **kw):
                if _name not in self.args:
                    self.args[_name] = tuple(
                        x.clone() if i in self.clone and hasattr(x, "clone")
                        else x for i, x in enumerate(a))
                return _fn(*a, **kw)
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.orig[name])


def check_recorded(results, rec, name):
    """The kernels against their plain versions on the inputs a main path
    gave them (FirstCalls of rb.blend_tiles and gt.gather_rows_kernel)."""
    ok = True
    if "blend" in rec.args:
        ok &= check_blend(results, name, tuple(
            x.detach() if hasattr(x, "detach") else x
            for x in rec.args["blend"]))
    if "gather" in rec.args:
        table, idx = rec.args["gather"]
        ok &= check_gather(results, f"{name}_first_pass_{idx.shape[0]}x"
                           f"{table.shape[1]}", table, idx)
    if not ok or len(rec.args) != len(rec.targets):
        fail("kernels", f"a kernel differs from its plain version on the "
             f"inputs of {name} (recorded: {sorted(rec.args)})")


class LargestScatter:
    """Patch ops/segment_sum.scatter_add_rows (the deterministic scatter-add
    of a gathered tensor's gradient) to keep the arguments of its largest
    call, and undo it on exit."""

    def __enter__(self):
        import torch
        from irgs_tpu_torch.ops import segment_sum as ss
        self.mod, self.orig, self.args = ss, ss.scatter_add_rows, None

        def rec(grad, idx, n_rows):
            blocks = [grad] if torch.is_tensor(grad) else list(grad)
            size = sum(b.numel() for b in blocks)
            if self.args is None or size > sum(b.numel()
                                               for b in self.args[0]):
                self.args = ([b.detach().clone() for b in blocks],
                             idx.clone(), n_rows)
            return self.orig(grad, idx, n_rows)
        ss.scatter_add_rows = rec
        return self

    def __exit__(self, *exc):
        self.mod.scatter_add_rows = self.orig


SCATTER_REL = 1e-4   # x max|out|: fp32 sums of another order than index_add_'s
SCATTER_TILES = (64, 128, 256, 512, 1024)   # tiles C timed beside TILE
# blend_hits' tables with the materials, the column blocks of its gradient:
# means3d 3, opacity 1, ru 3, rv 3, normals 3, SH 48, base colour and
# roughness 4 (65 columns)
CONCAT_BLOCKS = (3, 1, 3, 3, 3, 48, 4)


def check_scatter(results, rec, name, blocks_case=False):
    """The deterministic scatter-add (one sort and the reduce-by-key kernel's
    levels) on the largest gradient a main path gave it (its column blocks,
    read in place), and with `blocks_case` on the same indices with rows of
    CONCAT_BLOCKS uniform in [0, 1) from a seed: twice bit for bit, bit for
    bit with its plain version (the same sums in the same order) and with the
    blocks concatenated first, within SCATTER_REL of index_add_, n_levels(M)
    launches a call, no host sync (sync debug mode "error"), with its time,
    the sort's, the plain version's, index_add_'s, its bound (the gradient,
    the indices and the output each moved once), its device time (calls
    queued back to back) at TILE, at each tile C of SCATTER_TILES and with
    the blocks concatenated first, and the device time of its parts (the
    gradient's layout copy, the sort, level 0 of the kernel)."""
    import torch
    from irgs_tpu_torch.ops import segment_sum as ss
    from irgs_tpu_torch.profile_stage2 import index_add_rows
    if rec.args is None:
        fail("kernels", f"no scatter-add of gathered rows ran on {name}")
    blocks0, idx, n = rec.args
    dev = idx.device
    gen = torch.Generator(dev).manual_seed(0)
    cases = [(name, blocks0)]
    if blocks_case:
        cases.append((f"{name}_w{sum(CONCAT_BLOCKS)}", [
            torch.rand((idx.numel(), w), generator=gen, device=dev)
            for w in CONCAT_BLOCKS]))
    for case, blocks in cases:
        cat = torch.cat(blocks, 1) if len(blocks) > 1 else blocks[0]
        torch.cuda.synchronize()
        ss.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = ss.scatter_add_rows(blocks, idx, n)
            out2 = ss.scatter_add_rows(blocks, idx, n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = ss.LAUNCHES["segment_sum"] / 2
        plain = ss.scatter_sorted(blocks, idx, n, ss.segment_sum_plain)
        concat = ss.scatter_add_rows(cat, idx, n)
        ref = index_add_rows(cat, idx, n)
        torch.cuda.synchronize()
        scale = float(ref.abs().max().clamp_min(1e-30))
        err_ia = float((out - ref).abs().max())
        same = (bool(torch.equal(out, out2)) and bool(torch.equal(out, plain))
                and bool(torch.equal(out, concat)))
        m, w = idx.numel(), cat.shape[1]
        ok = (same and err_ia <= SCATTER_REL * scale
              and launches == ss.n_levels(m))
        nbytes = 4 * m * w + 8 * m + 4 * n * w
        idx32 = idx.to(torch.int32)
        line = {"phase": "kernels", "kernel": "segment_sum", "case": case,
                "ok": ok, "deterministic": bool(torch.equal(out, out2)),
                "bitwise_equal_plain": bool(torch.equal(out, plain)),
                "bitwise_equal_concatenated": bool(torch.equal(out, concat)),
                "max_abs_err": float((out - plain).abs().max()),
                "max_abs_err_index_add": err_ia, "max_abs_index_add": scale,
                "rel_tol_index_add": SCATTER_REL,
                "rows": m, "width": int(w),
                "blocks": [b.shape[1] for b in blocks], "out_rows": int(n),
                "distinct_rows": int(torch.unique(idx).numel()),
                "tile": ss.TILE, "launches_per_call": launches,
                "n_levels": ss.n_levels(m), "host_syncs": 0,
                "ms": cuda_ms(lambda: ss.scatter_add_rows(blocks, idx, n)),
                "sort_ms": cuda_ms(lambda: torch.sort(idx32, stable=True)),
                "plain_ms": cuda_ms(lambda: ss.scatter_sorted(
                    blocks, idx, n, ss.segment_sum_plain), reps=3),
                "library_ms": cuda_ms(lambda: index_add_rows(cat, idx, n)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": nbytes,
                "ms_queued": cuda_ms_queued(
                    lambda: ss.scatter_add_rows(blocks, idx, n)),
                "tile_ms_queued": {c: cuda_ms_queued(
                    lambda c=c: ss.scatter_sorted(blocks, idx, n, tile=c))
                    for c in SCATTER_TILES}}
        if len(blocks) > 1:
            # the alternative: the blocks concatenated first, then one block
            line["ms_queued_concatenated_first"] = cuda_ms_queued(
                lambda: ss.scatter_add_rows(torch.cat(blocks, 1), idx, n))
        # where a call's device time goes: the layout copy of a gradient
        # that is not contiguous (the slab's, transposed), the sort, level 0
        src = [b.contiguous() for b in blocks]
        keys, perm = torch.sort(idx32, stable=True)
        t = ss.n_tiles(m)
        ck, cv = ((torch.empty(2 * t, dtype=torch.int32, device=dev),
                   torch.empty((2 * t, w), device=dev)) if t > 1
                  else (None, None))
        o = torch.zeros((n, w), device=dev)
        line.update({
            "grad_contiguous": all(b.is_contiguous() for b in blocks),
            "contiguous_ms_queued": cuda_ms_queued(
                lambda: [b.contiguous() for b in blocks]),
            "sort_ms_queued": cuda_ms_queued(
                lambda: torch.sort(idx32, stable=True)),
            "level0_ms_queued": cuda_ms_queued(lambda: ss.segment_sum_cuda(
                src, perm, keys, ss.TILE, o, ck, cv)),
            "level0_bytes": 4 * m * w + 12 * m + 4 * n * w})
        emit(line)
        results.setdefault("segment_sum", {})[case] = line
        if not ok:
            fail("kernels", f"segment_sum disagrees on {case}")


def phase_stage2(results, n_warm=1, n_timed=5):
    """stage2_step at the bench workload, on the card."""
    import torch
    from irgs_tpu_torch import profile_stage2 as prof
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import grid_tracer as gt
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

    # the warm step records the gather's first real inputs and the largest
    # scatter-add of gathered rows' gradients, held against their plain
    # versions before the timed steps measure peak memory
    with FirstCalls({"gather": (gt, "gather_rows_kernel")}, clone=(1,)) as rec, \
            LargestScatter() as scat:
        step(0)
    check_recorded(results, rec, "stage2")
    check_scatter(results, scat, "stage2_largest", blocks_case=True)
    del rec, scat
    for i in range(1, n_warm):
        step(i)
    # one untimed step counted: the scatter-adds (a host sync inside one
    # raises), their launches and the step's host syncs; then one with
    # index_add_ in the scatter-add's place
    blend_calls, blend_hits = [0], gt.blend_hits

    def counted_blend(*a, **kw):
        blend_calls[0] += 1
        return blend_hits(*a, **kw)
    gt.blend_hits = counted_blend
    try:
        counts = prof.count_step(lambda: step(n_warm),
                                 scatter_sync_error=True)
    finally:
        gt.blend_hits = blend_hits
    with prof.scatter_swapped(prof.index_add_rows):
        counts_ia = prof.count_step(lambda: step(n_warm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                    # count the main path only
    times, metrics = [], []
    for i in range(n_warm, n_warm + n_timed):
        a = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - a) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the same steps with the gathers' gradients summed by index_add_ (the
    # atomic scatter-add the deterministic one replaces), in the same call
    with prof.scatter_swapped(prof.index_add_rows):
        times_ia = []
        for i in range(n_warm + n_timed, n_warm + 2 * n_timed):
            a = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            times_ia.append((time.perf_counter() - a) * 1e3)
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
            "max_memory_allocated": peak,
            "ms_per_step_index_add": statistics.median(times_ia),
            "ms_steps_index_add": times_ia,
            "scatter_calls_per_step": counts["scatter_calls"],
            "blend_hits_calls_per_step": blend_calls[0],
            "scatter_shapes": counts["scatter_shapes"],
            "segment_sum_launches_per_step": counts["segment_sum_launches"],
            "host_syncs_per_step": counts["host_syncs"],
            "host_syncs_per_step_index_add": counts_ia["host_syncs"],
            "scatter_stream_ms_per_step": counts["scatter_stream_ms"],
            "scatter_stream_ms_per_step_index_add":
                counts_ia["scatter_stream_ms"],
            "launches": launches,
            "launches_per_step": {k: v / n_timed for k, v in launches.items()}}
    checks = {
        "loss_finite": all(math.isfinite(m["loss"]) for m in metrics),
        "raster_overflow_zero": line["raster_overflow"] == 0.0,
        "kernels_every_step": all(v >= n_timed for v in launches.values()),
        # one scatter-add per blend_hits call, one for the raster slab
        "one_scatter_per_blend": counts["scatter_calls"] <= blend_calls[0] + 1,
        "xyz_frozen": bool(torch.equal(state.params.xyz.detach(), xyz0)),
        "materials_moved": not bool(torch.equal(
            state.params.base_color.detach(), mat0)),
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    results["stage2"] = line
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
                  light=0,
                  tracer=dict(grid_res=16, pair_capacity=2 ** 15,
                              max_cells=8, max_hits=24, select_tiles=4,
                              retrace_select_tiles=8, hit_budget=8,
                              retrace_hit_budget=12, max_crossings=12,
                              retrace_max_crossings=16, retrace_max_cells=12,
                              retrace_max_hits=48),
                  dup_capacity=2 ** 16)
# the merged trace on the card against the CPU is held to eval_small's
# bounds: the same outlier share, and its bound on max |Δ|
MERGED_TRACE_MAX_ABS = 1.0 / EVAL_SMALL["diffuse"]


def eval_card_vs_cpu(setup, flat_first_row=False):
    """One test-scale eval frame (workload.eval_setup(**setup)) on the card
    and on the CPU (plain versions of every kernel), from the same scene
    -> its JSON fields and ok. `flat_first_row` sets the env's first row to
    its second (see phase_mis_small)."""
    import numpy as np
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.render.eval import render_ir_eval
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import raster_blend as rb

    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        params, aux, grid, cam, ecfg = workload.eval_setup(**setup, device=dev)
        if flat_first_row:
            with torch.no_grad():
                params.env[0] = params.env[1]
        rb.reset_launches()
        gr.reset_launches()
        stats[dev] = {}
        out = render_ir_eval(params, aux, grid, cam, ecfg,
                             stats_out=stats[dev])
        outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
        stats[dev]["launches"] = {**rb.LAUNCHES, **gr.LAUNCHES}
    spp = setup["diffuse"] + setup["light"]
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
    return {"rtol": EVAL_RTOL, "atol": EVAL_ATOL,
            "max_outlier_share": EVAL_MAX_OUTLIER_SHARE,
            "max_abs_bound": 1.0 / spp, "stats": stats, "aovs": aovs}, bool(ok)


def phase_eval_small():
    """One test-scale eval frame on the card and on the CPU (plain versions
    of every kernel), from the same scene."""
    line, ok = eval_card_vs_cpu(EVAL_SMALL)
    emit({"phase": "eval_small", "ok": ok, **line})
    if not ok:
        fail("eval_small", "the eval frame on the card disagrees with the "
             "CPU path")


# the light sampler on the card: 2^14 pixels x 256 draws from the pdf of a
# 64 x 128 blob env, against the CPU's bit for bit, and a chi-square test of
# the texel counts against the pdf (|z| bound)
SAMPLER_PIXELS, SAMPLER_S, CHI2_Z_MAX = 2 ** 14, 256, 4.0


def phase_mis_small():
    """The MIS branch at test scale, on the card against the CPU: one eval
    frame at 32 diffuse + 32 light samples (eval_small's scene), one stage-2
    step with 8 light samples from the same draws, and the light sampler
    (2^22 draws bit for bit, and a chi-square test against the pdf).

    The frame's env has its first row set to its second: at eval the light
    samples sit on texel centres, and at a first-row centre the bilinear
    lookup (the reference's: row y0 + 1 after clamping y0 = -1 to 0) jumps
    from row 0 to row 1 when v·H - 0.5 rounds an ulp below 0, which the
    card's and the CPU's acos do for different samples (3.3 % of the
    light_direct elements apart on the 8x16 env otherwise)."""
    import torch
    from irgs_tpu_torch.scene import envlight
    from irgs_tpu_torch.scene.toy import make_blob_env
    from irgs_tpu_torch.utils.rng import chi_square_z

    frame, frame_ok = eval_card_vs_cpu(dict(EVAL_SMALL, light=32),
                                       flat_first_row=True)
    step, step_ok = stage2_card_vs_cpu(light=8)
    pdf = envlight.build_pdf(torch.tensor(make_blob_env(64, 128)))
    ids = torch.arange(SAMPLER_PIXELS)
    cpu = envlight.draw_light(pdf, ids, SAMPLER_S, seed=1, training=True)
    pdf_c, ids_c = pdf.cuda(), ids.cuda()
    card = envlight.draw_light(pdf_c, ids_c, SAMPLER_S, seed=1, training=True)
    same = bool(torch.equal(card.idx.cpu(), cpu.idx)
                and torch.equal(card.jitter.cpu(), cpu.jitter))
    z, dof = chi_square_z(card.idx, pdf)
    ms = cuda_ms(lambda: envlight.draw_light(pdf_c, ids_c, SAMPLER_S, seed=1,
                                             training=True), reps=5)
    sampler = {"draws": SAMPLER_PIXELS * SAMPLER_S, "texels": pdf.numel(),
               "card_equals_cpu": same, "chi2_z": z, "chi2_dof": dof,
               "chi2_z_max": CHI2_Z_MAX, "ms_on_card": ms}
    ok = frame_ok and step_ok and same and abs(z) < CHI2_Z_MAX
    emit({"phase": "mis_small", "ok": ok, "frame_ok": frame_ok,
          "step_ok": step_ok, "sampler": sampler, "step": step,
          "frame": frame})
    if not ok:
        fail("mis_small", "the MIS frame, step or sampler on the card "
             "disagrees with the CPU path or the pdf")


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
    gt.gather_rows_kernel = gr.gather_rows_plain     # the "off" frame
    try:
        out_p, st_p = frame(ecfg)
    finally:
        gt.gather_rows_kernel = kernel
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


def write_blender_dataset(root, params, aux, cams, spp, white):
    """A Blender-layout folder of `cams`: ground truth rendered from the
    scene by render_ir_eval at `spp` diffuse samples, stored as RGBA PNG
    (straight colour, alpha from the render) through utils/png.py."""
    import numpy as np
    import torch
    from irgs_tpu_torch.config import Config
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.render.eval import EvalConfig, render_ir_eval
    from irgs_tpu_torch.utils import png

    dev = params.xyz.device
    w, h = cams[0].width, cams[0].height
    ecfg = EvalConfig(img_w=w, img_h=h, diffuse_sample_num=spp,
                      light_sample_num=0, white_background=white,
                      tracer=gt.TracerConfig.from_pipe(Config().pipe, eval=True))
    grid = gt.build_grid_from_gaussians(params, aux, ecfg.tracer)
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for i, cam in enumerate(cams):
        out = render_ir_eval(params, aux, grid, cam.params(dev), ecfg)
        a = out["rend_alpha"]
        bg = 1.0 if white else 0.0
        rgb = torch.where(a > 0, (out["render"] - bg * (1 - a))
                          / torch.clamp(a, min=1e-6), torch.zeros_like(a))
        rgba = torch.cat([rgb, a], -1).clamp(0, 1).cpu().numpy()
        png.write_png(os.path.join(root, "train", f"r_{i}.png"),
                      (rgba * 255 + 0.5).astype(np.uint8))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = cam.R, cam.cam_pos
        c2w[:3, 1:3] *= -1                  # COLMAP -> Blender axes
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": cams[0].fovx, "frames": frames}, f)


class StepMeter:
    """Wraps stage2_step (the CLI looks it up on its module at each step):
    each step's wall time, synchronised on both sides, its peak memory, and
    the kernel launches inside it; the run's peak memory is kept across
    the per-step resets."""

    def __init__(self):
        from irgs_tpu_torch.train import stage2 as s2
        self.mod, self.orig, self.steps, self.run_peak = s2, s2.stage2_step, [], 0

    def _launches(self):
        return launch_counts()

    def __call__(self, *a, **kw):
        import torch
        torch.cuda.synchronize()
        self.run_peak = max(self.run_peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        before, t = self._launches(), time.perf_counter()
        out = self.orig(*a, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated()
        self.run_peak = max(self.run_peak, peak)
        self.steps.append({"ms": ms, "peak": peak, "launches": {
            k: v - before[k] for k, v in self._launches().items()}})
        return out

    def __enter__(self):
        self.mod.stage2_step = self
        return self

    def __exit__(self, *exc):
        import torch
        self.mod.stage2_step = self.orig
        self.run_peak = max(self.run_peak, torch.cuda.max_memory_allocated())


class Timed:
    """Patch functions of modules to record the synchronised wall time of
    each call (seconds, by name), and undo it on exit."""

    def __init__(self, targets):
        self.targets, self.seconds, self.orig = targets, {}, {}

    def __enter__(self):
        import torch
        for name, (mod, attr) in self.targets.items():
            fn = self.orig[name] = getattr(mod, attr)

            def timed(*a, _name=name, _fn=fn, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds.setdefault(_name, []).append(
                    time.perf_counter() - t)
                return out
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.orig[name])


def run_cli(argv):
    """python -m irgs_tpu_torch.train, in-process, from the main path's
    launch counts at 0; -> (launches, seconds)."""
    import torch
    from irgs_tpu_torch.train.__main__ import main as train_main
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    train_main(argv)
    torch.cuda.synchronize()
    return launch_counts(), time.perf_counter() - t


def read_log(run):
    with open(os.path.join(run, "train_log.jsonl")) as f:
        return {m["iter"]: m for m in map(json.loads, f)}


# the CLI at the BENCH budgets (workload.BENCH: 2^18 trace rays at 256
# diffuse samples, dup capacity 2^19, capacity 2^17)
CLI_BENCH = ["--dup_capacity", "524288", "--trace_num_rays", "262144",
             "--diffuse_sample_num", "256", "--max_gaussians", "131072"]


def phase_train_cli(results, tmp):
    """python -m irgs_tpu_torch.train at full width: the BENCH sphere
    (100k surfels) as start.ply, 8 ring views at 400x400 as a Blender
    folder, 100 iterations with checkpoints and visualisations every 50;
    then a resume from chkpnt50 for 5 iterations."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.render import eval as reval
    from irgs_tpu_torch.scene import gaussians as G
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.train import stage2 as s2
    from irgs_tpu_torch.utils import png

    dev = torch.device("cuda")
    b = workload.BENCH
    t0 = time.perf_counter()
    params, aux = toy.make_sphere_scene(n_surface=b["n_surface"],
                                        n_capacity=b["n_capacity"],
                                        env_resolution=128, device=dev)
    scene, run = os.path.join(tmp, "sphere"), os.path.join(tmp, "run")
    ply = os.path.join(tmp, "start.ply")
    G.save_ply(ply, params, aux)
    cams = toy.make_ring_cameras(8, width=b["img"], height_px=b["img"])
    write_blender_dataset(scene, params, aux, cams, spp=32, white=False)
    del params, aux
    data_s = time.perf_counter() - t0

    n_it = 100
    extras = {"vis_frame": (reval, "render_ir_eval"),
              "checkpoint": (s2, "save_stage2_checkpoint"),
              "ply": (G, "save_ply")}
    with StepMeter() as meter, Timed(extras) as timed:
        launches, cli_s = run_cli(
            ["-s", scene, "-m", run, "--start_ply", ply, "--iterations",
             str(n_it), "--checkpoint_interval", "50", "--vis_interval", "50",
             *CLI_BENCH])
    log = read_log(run)
    window = meter.steps[50:100]                 # iterations 51..100
    per_step = {k: [st["launches"][k] for st in meter.steps]
                for k in launches}
    files = sorted(os.path.relpath(os.path.join(d, f), run)
                   for d, _, fs in os.walk(run) for f in fs)
    vis_shapes = {f: list(png.read_png(os.path.join(run, f)).shape)
                  for f in files if f.endswith(".png")}
    stage2 = results.get("stage2", {})

    # resume from chkpnt50 into a second model dir for 5 iterations
    run2 = os.path.join(tmp, "resumed")
    _, resume_s = run_cli(["-s", scene, "-m", run2, "--start_checkpoint",
                           os.path.join(run, "chkpnt50.ckpt"), "--iterations",
                           "55", "--vis_interval", "0", *CLI_BENCH])
    ck55 = os.path.join(run2, "chkpnt55.ckpt")
    ck = torch.load(ck55, weights_only=True) if os.path.exists(ck55) else None
    results.setdefault("launches", {})["train_cli"] = launches
    line = {
        "phase": "train_cli", "data_s": data_s, "cli_s": cli_s,
        "resume_s": resume_s,
        # the CLI's own clock: logged elapsed between iterations 50 and
        # 100 (rounded to 0.1 s; includes the visualisation frame and the
        # checkpoint of iteration 50)
        "ms_per_step_log_50_100": (log[100]["elapsed"] - log[50]["elapsed"])
        / 50 * 1e3,
        "ms_per_step_median_51_100": statistics.median(st["ms"]
                                                       for st in window),
        "ms_per_step_mean_51_100": statistics.fmean(st["ms"] for st in window),
        "stage2_phase_ms_per_step": stage2.get("ms_per_step"),
        "stage2_phase_max_memory_allocated": stage2.get(
            "max_memory_allocated"),
        "step_max_memory_allocated": max(st["peak"] for st in meter.steps),
        # the steps whose loss is checked (1, 50, 100) also hold a copy of
        # the state from before them, for the reproducer
        "step_max_memory_allocated_unchecked": max(
            st["peak"] for i, st in enumerate(meter.steps, 1)
            if i % 50 and i != 1),
        "extra_s": timed.seconds,
        "run_max_memory_allocated": meter.run_peak,
        "launches": launches,
        "launches_per_step": {k: sorted(set(v)) for k, v in per_step.items()},
        "ray_psnr_final": log[n_it]["ray_psnr"], "loss_final": log[n_it]["loss"],
        "ray_psnr_first": log[1]["ray_psnr"],
        "raster_overflow": max(m["raster_overflow"] for m in log.values()),
        "grid_oversize": log[n_it]["grid_oversize"],
        "trace_more_frac": log[n_it].get("trace_more_frac"),
        "files": files, "png_shapes": vis_shapes,
    }
    checks = {
        "logged_1_50_100": sorted(log) == [1, 50, 100],
        "loss_finite": all(math.isfinite(m["loss"]) for m in log.values()),
        "raster_overflow_zero": line["raster_overflow"] == 0.0,
        "blend_once_per_step": all(set(per_step[k]) == {1}
                                   for k in ("blend_fwd", "blend_bwd")),
        "gather_every_step": min(per_step["gather_rows"]) > 0,
        "vis_pngs_decode": len(vis_shapes) == 6 and all(
            len(v) == 3 and v[2] == 3 for v in vis_shapes.values()),
        "ply_and_sidecars": all(f"point_cloud/iteration_100/point_cloud{x}"
                                in files for x in (".ply", "_env.npy",
                                                   "1.exr", "1.map")),
        "checkpoints": {"chkpnt50.ckpt", "chkpnt100.ckpt"} <= set(files),
        "resumed_chkpnt55": ck is not None and ck["step"] == 55 and all(
            bool(torch.isfinite(v).all()) for v in ck["params"].values()),
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("train_cli", f"checks failed: {checks}")


def _shadow_trace_case(dev):
    """The oversize test's small shadow scene (tests/test_torch_oversize.py:
    200 ground + 300 sphere surfels, grid 16, oversize cap 64) as tracer
    inputs, grid and rays on `dev`, built on the CPU and moved."""
    import numpy as np
    import torch
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.utils import math3d

    params, aux = toy.make_shadow_scene(n_ground=200, n_sphere=300,
                                        n_capacity=512, env_resolution=16,
                                        device="cpu")
    cfg = gt.TracerConfig(grid_res=16, pair_capacity=2 ** 16, max_cells=8,
                          max_hits=24, hit_budget=16, max_crossings=12,
                          select_tiles=8, tile=32, tiled_direct=True,
                          n_segments=4, retrace_frac=0.5, oversize_cap=64)
    with torch.no_grad():
        s = params.get_scaling()
        R = math3d.quat_to_rotmat(params.rotation)
        inputs = gt.TraceInputs(
            means3d=params.xyz,
            opacity=torch.where(aux.alive, params.get_opacity()[:, 0], 0.0),
            ru=R[:, :, 0] / s[:, 0:1], rv=R[:, :, 1] / s[:, 1:2],
            normals=params.world_normals(
                cam_pos=torch.tensor([3.0, 0.8, 0.0])),
            shs=params.get_features(),
            features=torch.cat([params.get_base_color(),
                                params.get_roughness()], -1))
        radius = gt.bounding_radius(inputs.opacity, s, cfg.alpha_min)
    rng = np.random.default_rng(1)
    ang = rng.uniform(0, 2 * np.pi, 256)
    ro = np.stack([3 * np.cos(ang), 0.8 + 0.5 * rng.uniform(size=256),
                   3 * np.sin(ang)], -1)
    target = params.xyz.numpy()[rng.integers(0, 500, 256)]
    rd = target - ro + 0.05 * rng.standard_normal((256, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    inputs = gt.TraceInputs(*[x.to(dev) for x in inputs])
    grid = gt.build_grid(inputs.means3d, radius.to(dev), aux.alive.to(dev),
                         grid_res=cfg.grid_res, pair_capacity=cfg.pair_capacity,
                         span_cap=cfg.span_cap, normals=inputs.normals,
                         oversize_cap=cfg.oversize_cap)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return inputs, grid, cfg, f32(ro), f32(rd)


def phase_train_cli_oversize(results, tmp):
    """The CLI on the shadow scene (make_shadow_scene at its default size,
    4 ring views at 400x400, white background) for 3 iterations: the merge
    switched on by itself, its grid counts and the step's peak memory; then
    one merged trace_segments of the test's small shadow scene on the card
    against the CPU."""
    import numpy as np
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.config import Config
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.scene import gaussians as G
    from irgs_tpu_torch.scene import toy

    dev = torch.device("cuda")
    img = workload.BENCH["img"]
    t0 = time.perf_counter()
    params, aux = toy.make_shadow_scene(device=dev)
    scene, run = os.path.join(tmp, "shadow"), os.path.join(tmp, "shadow_run")
    ply = os.path.join(tmp, "shadow.ply")
    G.save_ply(ply, params, aux)
    write_blender_dataset(scene, params, aux,
                          toy.make_ring_cameras(4, width=img, height_px=img),
                          spp=32, white=True)
    n_cap = params.n_capacity
    # the oversize count the CLI finds before it switches the merge on
    lp, la = G.load_ply(ply, n_cap, device=dev)
    n_ov_before = int(gt.build_grid_from_gaussians(
        lp, la, gt.TracerConfig.from_pipe(Config().pipe)).oversize)
    del params, aux, lp, la
    data_s = time.perf_counter() - t0

    with StepMeter() as meter, FirstCalls(
            {"blend": (rb, "blend_tiles"),
             "gather": (gt, "gather_rows_kernel")}, clone=(1,)) as rec:
        launches, cli_s = run_cli(
            ["-s", scene, "-m", run, "--start_ply", ply, "-w",
             "--iterations", "3", "--checkpoint_interval", "0",
             "--vis_interval", "0", *CLI_BENCH, "--max_gaussians",
             str(n_cap)])
    results.setdefault("launches", {})["train_cli_oversize"] = launches
    log = read_log(run)
    with open(os.path.join(run, "cfg.json")) as f:
        cap = json.load(f)["pipe"]["tracer_oversize_cap"]
    check_recorded(results, rec, "shadow_400px_12k")
    del rec

    # one merged trace_segments at the test's scale, card against CPU
    outs, n_ids = {}, {}
    for d in ("cpu", "cuda"):
        inputs, grid, cfg, ro, rd = _shadow_trace_case(torch.device(d))
        with torch.no_grad():
            outs[d] = gt.trace_segments(ro, rd, grid, inputs, cfg=cfg,
                                        sh_deg=3)
        n_ids[d] = grid.oversize_ids.cpu()
    fields = {}
    tr_ok = bool(torch.equal(n_ids["cpu"], n_ids["cuda"]))
    for name in gt.TraceOut._fields:
        want = getattr(outs["cpu"], name).numpy()
        got = getattr(outs["cuda"], name).cpu().numpy()
        d = np.abs(got - want)
        share = float((d > EVAL_ATOL + EVAL_RTOL * np.abs(want)).mean())
        fields[name] = {"max_abs_err": float(d.max()), "outlier_share": share}
        tr_ok &= (bool(np.isfinite(got).all()) and share <= EVAL_MAX_OUTLIER_SHARE
                  and float(d.max()) <= MERGED_TRACE_MAX_ABS)
    line = {
        "phase": "train_cli_oversize", "data_s": data_s, "cli_s": cli_s,
        "grid_oversize_before_cap": n_ov_before,
        "tracer_oversize_cap": cap,
        "grid_oversize_logged": log[1]["grid_oversize"],
        "step_ms": [st["ms"] for st in meter.steps],
        "step_max_memory_allocated": [st["peak"] for st in meter.steps],
        "run_max_memory_allocated": meter.run_peak,
        "launches": launches, "loss": log[1]["loss"],
        "ray_psnr": log[1]["ray_psnr"],
        "trace_more_frac": log[1].get("trace_more_frac"),
        "merged_trace_card_vs_cpu": {
            "oversize_ids": int((n_ids["cpu"] >= 0).sum()),
            "rtol": EVAL_RTOL, "atol": EVAL_ATOL,
            "max_outlier_share": EVAL_MAX_OUTLIER_SHARE,
            "max_abs_bound": MERGED_TRACE_MAX_ABS, "fields": fields},
    }
    checks = {
        "merge_auto_enabled": cap == min(128, ((n_ov_before + 31) // 32) * 32)
        and n_ov_before > 0,
        "fewer_truncated": log[1]["grid_oversize"] < n_ov_before,
        "loss_finite": math.isfinite(log[1]["loss"]),
        "three_steps": len(meter.steps) == 3,
        "blend_every_step": all(st["launches"]["blend_fwd"] == 1
                                and st["launches"]["blend_bwd"] == 1
                                for st in meter.steps),
        "merged_trace_matches_cpu": tr_ok,
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("train_cli_oversize", f"checks failed: {checks}")


def sun_sky(h, w):
    """A linear-radiance lat-long envmap: a sky gradient over a dim ground
    and a small sun (peak 200) at u = 0.35, v = 0.25."""
    import numpy as np
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    sky = np.where(v[..., None] < 0.5,
                   0.3 + 0.9 * (0.5 - v)[..., None] * np.array([0.5, 0.7, 1.0]),
                   np.array([0.12, 0.1, 0.08]))
    sun = 200.0 * np.exp(-((u - 0.35) ** 2 + (v - 0.25) ** 2) / (2 * 0.01 ** 2))
    return (sky + sun[..., None] * np.array([1.0, 0.95, 0.85])).astype(np.float32)


class PerView:
    """Patch a CLI's per-view function (looked up on its module at each
    call): each call's synchronised seconds and kernel launches, and what
    `info(output)` reports of it; undo on exit."""

    def __init__(self, mod, attr, info=None, stats_kw=False):
        self.mod, self.attr, self.info, self.stats_kw = mod, attr, info, stats_kw
        self.orig, self.calls = getattr(mod, attr), []

    def __call__(self, *a, **kw):
        import torch
        from irgs_tpu_torch.ops import gather_rows as gr
        from irgs_tpu_torch.ops import raster_blend as rb
        stats = {}
        if self.stats_kw:
            kw["stats_out"] = stats
        torch.cuda.synchronize()
        before, t = {**rb.LAUNCHES, **gr.LAUNCHES}, time.perf_counter()
        out = self.orig(*a, **kw)
        torch.cuda.synchronize()
        after = {**rb.LAUNCHES, **gr.LAUNCHES}
        if self.info is not None:
            stats.update(self.info(out))
        self.calls.append({"seconds": time.perf_counter() - t, **stats,
                           "launches": {k: v - before[k]
                                        for k, v in after.items()}})
        return out

    def __enter__(self):
        setattr(self.mod, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.orig)


def run_eval_cli(main, argv):
    """One eval CLI's main(argv) in-process, from launch counts at 0 ->
    (seconds, peak device memory, launches)."""
    import torch
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import raster_blend as rb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rb.reset_launches()
    gr.reset_launches()
    t = time.perf_counter()
    main(argv)
    torch.cuda.synchronize()
    return (time.perf_counter() - t, torch.cuda.max_memory_allocated(),
            {**rb.LAUNCHES, **gr.LAUNCHES})


def _finite_metrics(res):
    """Every number of a results JSON is finite (a null lpips is allowed)."""
    vals = [v for r in ([res] + [x for x in res.values() if isinstance(x, dict)])
            for k, v in r.items() if not isinstance(v, (dict, list))]
    return all(v is None or math.isfinite(v) for v in vals)


def phase_eval_cli(results, tmp):
    """The three eval CLIs, in-process, on the run that train_cli leaves
    (the 100k-surfel sphere at 400x400, iteration 100): first the dataset
    gets GT albedo/roughness maps of view r_0 (the model's own G-buffer), two
    256x512 EXR envmaps (a sun and sky, the toy blob env) and relit GT of
    r_0 under the first, rendered by the port at 64 + 64 samples; then
    render (one view, 256 + 256 samples), eval.material (--compute_scale,
    then the eval pass) and eval.relighting (one view, both envmaps, its
    default 512 + 256 samples)."""
    import numpy as np
    import torch
    from irgs_tpu_torch.config import load_config
    from irgs_tpu_torch.eval import material, relighting
    from irgs_tpu_torch.eval.common import load_trained
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.render import __main__ as render_cli
    from irgs_tpu_torch.render import eval as reval
    from irgs_tpu_torch.render import ir, relight
    from irgs_tpu_torch.scene import cubemap as cm
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.scene.datasets import load_scene
    from irgs_tpu_torch.utils import exr, png
    from irgs_tpu_torch.utils.math3d import rgb_to_srgb

    run, scene = os.path.join(tmp, "run"), os.path.join(tmp, "sphere")
    if not os.path.isdir(os.path.join(run, "point_cloud")):
        fail("eval_cli", "needs the run that the train_cli phase leaves")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = load_config(run)
    params, aux, it = load_trained(run, -1, cfg, dev)
    cam = load_scene(scene, cfg.model.white_background, True).test_cameras[0]
    w, h = cam.width, cam.height
    u8 = lambda x: (x.clamp(0, 1).cpu().numpy() * 255 + 0.5).astype(np.uint8)
    base, rough, _ = material.material_maps(params, aux, cam.params(dev), w, h,
                                            cfg.model.sh_degree)
    for sub, img in (("albedo", rgb_to_srgb(base)),
                     ("roughness", rough.expand(-1, -1, 3))):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
        png.write_png(os.path.join(scene, sub, f"{cam.image_name}.png"), u8(img))
    envs = [os.path.join(tmp, "sunsky.exr"), os.path.join(tmp, "blob.exr")]
    exr.write_exr(envs[0], sun_sky(256, 512))
    exr.write_exr(envs[1], np.exp(toy.make_blob_env(256, 512)))
    # relit GT of the first envmap; this untimed pass also records the
    # kernels' first inputs on the relighting path
    tracer = gt.TracerConfig.from_pipe(cfg.pipe, eval=True)
    grid = gt.build_grid_from_gaussians(params, aux, tracer)
    env0 = relight.build_relight_env(
        torch.tensor(exr.read_exr_rgb(envs[0]), device=dev))
    gt_cfg = ir.ShadeConfig(diffuse_sample_num=64, light_sample_num=64,
                            light_t_min=cfg.pipe.light_t_min, training=False)
    with FirstCalls({"blend": (rb, "blend_tiles"),
                     "gather": (gt, "gather_rows_kernel")}, clone=(1,)) as rec:
        imgs, alpha, _ = relighting.relight_view(
            params, aux, grid, cam.params(dev), [env0], tracer, gt_cfg,
            cm.compute_fg_lut(device=dev), torch.ones(3, device=dev), w, h,
            cfg.model.sh_degree)
    os.makedirs(os.path.join(scene, "sunsky"), exist_ok=True)
    png.write_png(os.path.join(scene, "sunsky", f"{cam.image_name}.png"),
                  u8(torch.cat([imgs[0], alpha], -1)))
    check_recorded(results, rec, "relight_400px_100k")
    del rec, params, aux, grid, env0, imgs, base, rough
    torch.cuda.empty_cache()
    data_s = time.perf_counter() - t0

    line = {"phase": "eval_cli", "data_s": data_s, "iteration": it}
    launches_all = {}

    def record(name, seconds, peak, launches, views, extra):
        view_s = sum(v["seconds"] for v in views)
        per_view = {k: sorted({v["launches"][k] for v in views})
                    for k in launches}
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        entry = {"phase": "eval_cli", "cli": name, "seconds": seconds,
                 "views": len(views), "s_per_view": [v["seconds"] for v in views],
                 "setup_s": seconds - view_s, "max_memory_allocated": peak,
                 "launches": launches, "launches_per_view": per_view, **extra}
        emit(entry)
        line[name] = entry
        return entry

    # 1. render, the MIS branch: 256 + 256 samples on view r_0
    with PerView(reval, "render_ir_eval", stats_kw=True) as pv:
        sec, peak, lc = run_eval_cli(render_cli.main, [
            "-m", run, "--max_images", "1", "--light_sample_num", "256"])
    with open(os.path.join(run, "test", "nvs_results.json")) as f:
        nvs = json.load(f)
    v = pv.calls
    record("render", sec, peak, lc, v, {
        "samples": [cfg.pipe.diffuse_sample_num, 256],
        "fg_pixels": v[0]["shaded_pixels"], "shaded_rays": v[0]["shaded_rays"],
        "traced_rays": v[0]["traced_rays"],
        "mrays_per_s": v[0]["shaded_rays"] / v[0]["seconds"] / 1e6,
        "trace_more_frac": v[0].get("trace_more_frac"),
        "raster_overflow": v[0]["raster_overflow"], "result": nvs})

    # 2. material: the albedo scale over the train views, then the eval pass
    mat = {}
    for name, extra in (("material_scale", ["--compute_scale"]),
                        ("material_eval", [])):
        with PerView(material, "material_maps") as pv:
            sec, peak, lc = run_eval_cli(material.main, ["-m", run, *extra])
        fname = "albedo_scale.json" if extra else "material_results.json"
        with open(os.path.join(run, fname)) as f:
            mat[name] = json.load(f)
        record(name, sec, peak, lc, pv.calls, {"result": mat[name]})

    # 3. relighting at its defaults (512 + 256), one view, both envmaps
    n_env, s_d, s_l = len(envs), 512, 256
    info = lambda out: dict(out[2])
    with PerView(relighting, "relight_view", info=info) as pv, \
            Timed({"fg_lut": (cm, "compute_fg_lut"),
                   "relight_env": (relight, "build_relight_env")}) as timed:
        sec, peak, lc = run_eval_cli(relighting.main, [
            "-m", run, "--envmaps", *envs, "--max_images", "1"])
    with open(os.path.join(run, "relighting_results.json")) as f:
        rel = json.load(f)
    v = pv.calls[0]
    shaded = v["fg_pixels"] * (s_d + n_env * s_l)
    record("relighting", sec, peak, lc, pv.calls, {
        "samples": [s_d, s_l], "envmaps": n_env,
        "setup_parts_s": timed.seconds, "fg_pixels": v["fg_pixels"],
        "pixel_chunk": v["pixel_chunk"], "chunks": v["chunks"],
        "shaded_rays": shaded,
        "traced_rays": v["chunks"] * v["pixel_chunk"] * (s_d + n_env * s_l),
        "mrays_per_s": shaded / v["seconds"] / 1e6, "result": rel})
    results.setdefault("launches", {})["eval_cli"] = launches_all

    scale = mat["material_scale"]["2"]
    per_view = [line[k] for k in ("render", "material_scale", "material_eval",
                                  "relighting")]
    checks = {
        "metrics_finite": all(_finite_metrics(r) for r in
                              (nvs, mat["material_eval"], rel)),
        "albedo_scale_within_2pct": all(abs(x - 1.0) <= 0.02 for x in scale),
        "psnr_albedo_35db": (mat["material_eval"]["psnr_albedo"] or 0) >= 35.0,
        "psnr_pbr_first_env": rel.get("sunsky", {}).get("psnr_pbr") is not None,
        "psnr_trainlight_second_env":
            rel.get("blob", {}).get("psnr_trainlight") is not None,
        "blend_fwd_once_per_view": all(e["launches_per_view"]["blend_fwd"] == [1]
                                       for e in per_view),
        "gather_every_traced_view": all(
            min(line[k]["launches_per_view"]["gather_rows"]) > 0
            for k in ("render", "relighting")),
        "raster_overflow_zero": line["render"]["raster_overflow"] == 0,
    }
    emit({"phase": "eval_cli", "ok": all(checks.values()), "checks": checks,
          "data_s": data_s, "launches": launches_all})
    if not all(checks.values()):
        fail("eval_cli", f"checks failed: {checks}")


# ---------------------------------------------------------------------------
# stage 1

# the stage-1 phases of one step: (renderer, with the indirect TSDF path);
# the blend's feature width S of each
STAGE1_PHASES = (("initial", False), ("volume", False), ("surfel", False),
                 ("volume", True), ("surfel", True))
STAGE1_S = {"initial": 0, "volume": 11, "surfel": 8, "volume_indirect": 18,
            "surfel_indirect": 8}
# card against CPU at test scale: the loss within rtol 1e-4, each gradient
# within 1e-4·max|g| (the CPU tests' bound against JAX) except a share of
# MAX_OUTLIER_SHARE of its elements, each within BWD_REL·max|g| (the blend
# kernels' own bounds against their plain version, through which the card
# and the CPU differ); with the indirect path the TSDF march's marginal
# crossings (its CPU test allows 0.5 % of the rays to flip) may move a few
# elements further, so there a share of S1_OUTLIER_SHARE may lie outside
S1_LOSS_RTOL, S1_GRAD_REL, S1_OUTLIER_SHARE = 1e-4, 1e-4, 0.005
S1_PARAM_TOL = 1e-6  # densify on the card against the CPU: the split's 3x3


def _phase_name(phase, indirect):
    return phase + ("_indirect" if indirect else "")


def _stage1_static(phase, indirect, **kw):
    from irgs_tpu_torch.train import stage1_full as s1
    return s1.Stage1FullStatic(phase=phase, use_indirect=indirect, **kw)


def stage1_small_state(dev):
    """STAGE1_SMALL on `dev`: the state, cameras, target, FG table and the
    static kwargs."""
    import numpy as np
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.config import stage1_config
    from irgs_tpu_torch.scene import cubemap as cm
    from irgs_tpu_torch.scene import gaussians as G
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.scene.ref_gaussians import RefGaussianParams
    from irgs_tpu_torch.train import stage1_full as s1
    w = workload.STAGE1_SMALL
    fields, alive = workload.stage1_small_fields(w["n_surface"],
                                                 w["n_capacity"], w["env_res"])
    params, aux = G.params_from_numpy(fields, alive, dev,
                                      cls=RefGaussianParams)
    state = s1.init_state(params, aux, stage1_config().opt,
                          w["cameras_extent"])
    cams = toy.make_ring_cameras(w["n_cams"], width=w["img"],
                                 height_px=w["img"])
    yy, xx = np.mgrid[:w["img"], :w["img"]] / w["img"]
    gt = torch.tensor(np.stack([0.3 + 0.2 * np.sin(6 * xx), 0.4 + 0.1 * yy,
                                0.5 - 0.2 * xx * yy], -1).astype(np.float32),
                      device=dev)
    lut = cm.compute_fg_lut(res=32, samples=64, device=dev)
    static = dict(img_w=w["img"], img_h=w["img"], active_sh_degree=3,
                  white_background=False, dup_capacity=w["dup"])
    return state, cams, gt, lut, static


def _grad_tensors(state, m2d):
    return {**state.params.tensors(), "means2d": m2d}


def stage1_small_grads(dev, phase, indirect, vol):
    """Loss and gradients of the test-scale stage-1 step (iteration 10)."""
    import torch
    from irgs_tpu_torch.train import stage1_full as s1
    state, cams, gt, lut, static = stage1_small_state(dev)
    st = _stage1_static(phase, indirect, **static)
    m2d = torch.zeros((state.params.n_capacity, 2), device=dev,
                      requires_grad=True)
    cam = cams[0].params(dev)
    vol = None if vol is None else type(vol)(*(x.to(dev) for x in vol))

    def make_loss():
        return s1.stage1_forward_loss(state.params, state.aux, cam, gt, None,
                                      lut, vol, 10, st, means2d_offset=m2d)[0]
    loss = make_loss()
    loss.backward()
    grads = {k: None if t.grad is None else t.grad.detach().cpu()
             for k, t in _grad_tensors(state, m2d).items()}
    det = None
    if dev == "cuda":
        det = grads_twice(make_loss, _grad_tensors(state, m2d))
    return float(loss.detach()), grads, det


def stage1_densify_card_vs_cpu():
    """densify_and_prune on the card and on the CPU from the same state,
    statistics, Adam moments and split draws -> (fields, ok)."""
    import numpy as np
    import torch
    from irgs_tpu_torch.train import densify as D
    rng = np.random.default_rng(5)
    res = {}
    for dev in ("cpu", "cuda"):
        state = stage1_small_state(dev)[0]
        n = state.params.n_capacity
        r = np.random.default_rng(5)
        moments = {g["name"]: {
            "exp_avg": torch.tensor(r.standard_normal(
                tuple(g["params"][0].shape)).astype(np.float32)),
            "exp_avg_sq": torch.tensor(r.uniform(0, 1, tuple(
                g["params"][0].shape)).astype(np.float32)),
            "step": torch.tensor(3.0)}
            for g in state.optimizer.adam.param_groups}
        state.optimizer.load_state_dict(moments)
        aux = state.aux
        aux.xyz_gradient_accum.copy_(torch.tensor(
            r.uniform(0, 2e-3, n).astype(np.float32)))
        aux.denom.copy_(torch.tensor(r.integers(1, 5, n).astype(np.float32)))
        aux.max_radii2d.copy_(torch.tensor(r.uniform(0, 40, n).astype(
            np.float32)))
        draws = (torch.tensor(rng.standard_normal((2, 512, 3)).astype(
            np.float32)) if dev == "cpu" else res["cpu"][3]).to(dev)
        new_aux, stats = D.densify_and_prune(
            state.params, aux, state.optimizer, grad_threshold=2e-4,
            min_opacity=0.05, extent=3.0, max_screen_size=20, max_new=512,
            split_normals=draws)
        res[dev] = (new_aux.alive.cpu(), {k: v.detach().cpu() for k, v in
                                          state.params.tensors().items()},
                    state.optimizer.state_dict(), draws.cpu(), stats)
    alive_eq = bool(torch.equal(res["cpu"][0], res["cuda"][0]))
    p_err = max(float((res["cuda"][1][k] - res["cpu"][1][k]).abs().max())
                for k in res["cpu"][1])
    m_eq = all(torch.equal(res["cuda"][2][g][k].cpu().float(),
                           res["cpu"][2][g][k].cpu().float())
               for g in res["cpu"][2] for k in res["cpu"][2][g])
    stats = res["cuda"][4]
    ok = (alive_eq and p_err <= S1_PARAM_TOL and m_eq
          and stats == res["cpu"][4] and stats["n_cloned"] + stats["n_split"]
          > 0)
    return {"alive_equal": alive_eq, "param_max_abs_err": p_err,
            "param_tol": S1_PARAM_TOL, "moments_equal": m_eq,
            "stats": stats}, ok


def phase_stage1_small():
    """Stage 1 at test scale (STAGE1_SMALL), card against CPU: the loss and
    gradients of one step of each phase (the indirect ones on a TSDF fused
    on the CPU), two backward passes on the card bit for bit, and a
    densify_and_prune from the same state and draws."""
    import numpy as np
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.train import stage1_full as s1
    state, cams, _, _, static = stage1_small_state("cpu")
    w = workload.STAGE1_SMALL
    vol = s1.reconstruct_tsdf(state.params, state.aux, cams, img_w=w["img"],
                              img_h=w["img"], active_sh_degree=3, mesh_res=32,
                              cameras_extent=w["cameras_extent"],
                              dup_capacity=w["dup"])
    phases, ok = {}, True
    for phase, ind in STAGE1_PHASES:
        name = _phase_name(phase, ind)
        v = vol if ind else None
        l_cpu, g_cpu, _ = stage1_small_grads("cpu", phase, ind, v)
        l_card, g_card, (det, differ) = stage1_small_grads("cuda", phase,
                                                           ind, v)
        worst, shares = 0.0, {}
        for k, gc in g_cpu.items():
            gk = g_card[k]
            if gc is None or gk is None:
                if (gc is None) != (gk is None):
                    shares[k] = 1.0
                continue
            scale = float(gc.abs().max().clamp_min(1e-12))
            d = (gk - gc).abs()
            worst = max(worst, float(d.max()) / scale)
            shares[k] = float((d > S1_GRAD_REL * scale).float().mean())
        allowed = S1_OUTLIER_SHARE if ind else MAX_OUTLIER_SHARE
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        p_ok = (loss_rel <= S1_LOSS_RTOL and det
                and max(shares.values()) <= allowed
                and (ind or worst <= BWD_REL)
                and bool(np.isfinite(l_card)))
        phases[name] = {"loss_cuda": l_card, "loss_cpu": l_cpu,
                        "loss_rel_err": loss_rel,
                        "grad_max_rel_err": worst,
                        "grad_max_outlier_share": max(shares.values()),
                        "allowed_outlier_share": allowed,
                        "outlier_bound_rel": None if ind else BWD_REL,
                        "grads_bitwise_deterministic": det,
                        "grads_differ": differ, "ok": p_ok}
        ok &= p_ok
    dens, d_ok = stage1_densify_card_vs_cpu()
    line = {"phase": "stage1_small", "ok": ok and d_ok,
            "loss_rtol": S1_LOSS_RTOL, "grad_rel": S1_GRAD_REL,
            "phases": phases, "densify": dens}
    emit(line)
    if not line["ok"]:
        fail("stage1_small", "stage 1 on the card disagrees with the CPU "
             "path, or two backward passes differ")


class BlendWidths:
    """Patch raster_blend.blend_tiles to record the feature width S of
    each call, and undo it on exit."""

    def __enter__(self):
        from irgs_tpu_torch.ops import raster_blend as rb
        self.mod, self.orig, self.widths = rb, rb.blend_tiles, []

        def rec(*a):
            self.widths.append(a[5])
            return self.orig(*a)
        rb.blend_tiles = rec
        return self

    def __exit__(self, *exc):
        self.mod.blend_tiles = self.orig


def phase_stage1(results, n_warm=1, n_timed=10):
    """stage1_full_step at STAGE1_BENCH, per phase: 1 warm-up and 10 timed
    steps, the TSDF (128³, fused from the 8 views) for the indirect phases,
    a warm densify_and_prune, peak memory, overflow, launches and S."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.train import densify as D
    from irgs_tpu_torch.train import stage1_full as s1

    dev = torch.device("cuda")
    b = workload.STAGE1_BENCH
    t0 = time.perf_counter()
    state, cams, gt, lut, static = workload.stage1_setup(**b, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cam_params = [c.params(dev) for c in cams]
    vol, tsdf_s, per, ok = None, None, {}, True
    for phase, ind in STAGE1_PHASES:
        name = _phase_name(phase, ind)
        if ind and vol is None:
            torch.cuda.synchronize()
            a = time.perf_counter()
            vol = s1.reconstruct_tsdf(
                state.params, state.aux, cams, img_w=b["img"], img_h=b["img"],
                active_sh_degree=3, mesh_res=128,
                cameras_extent=b["cameras_extent"], dup_capacity=b["dup"])
            torch.cuda.synchronize()
            tsdf_s = time.perf_counter() - a
        st = _stage1_static(phase, ind, **static)

        def step(i):
            nonlocal state
            state, m = s1.stage1_full_step(state, cam_params[i % len(cams)],
                                           gt, None, lut, vol, st=st)
            return m
        with LargestScatter() as scat:
            for i in range(n_warm):
                step(i)
        if name == "volume":
            check_scatter(results, scat, "stage1_largest")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, metrics = [], []
        with BlendWidths() as bw:
            for i in range(n_warm, n_warm + n_timed):
                a = time.perf_counter()
                m = step(i)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - a) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
        launches = launch_counts()
        if name in ("volume", "volume_indirect"):
            results.setdefault("launches", {})[
                "stage1" if name == "volume" else "stage1_indirect"] = launches
        per[name] = {
            "ms_per_step": statistics.median(times), "ms_steps": times,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "loss": metrics[-1]["loss"],
            "raster_overflow": max(m["raster_overflow"] for m in metrics),
            "blend_S": sorted(set(bw.widths)),
            "launches_per_step": {k: v / n_timed for k, v in
                                  launches.items()}}
        ok &= (per[name]["raster_overflow"] == 0.0
               and all(math.isfinite(m["loss"]) for m in metrics)
               and per[name]["blend_S"] == [STAGE1_S[name]]
               and launches["blend_fwd"] == launches["blend_bwd"] == n_timed
               and launches["segment_sum"] > 0)
    parts = stage1_parts(state, cam_params[0], vol, static)
    opt = state.optimizer
    dens = []
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(2):                       # the first warms up
        torch.cuda.synchronize()
        a = time.perf_counter()
        n_before = state.aux.n_alive
        state.aux, stats = D.densify_and_prune(
            state.params, state.aux, opt, grad_threshold=2e-4,
            min_opacity=0.05, extent=b["cameras_extent"], max_screen_size=20,
            generator=gen)
        torch.cuda.synchronize()
        dens.append({"ms": (time.perf_counter() - a) * 1e3,
                     "n_alive_before": n_before, **stats})
    line = {"phase": "stage1", "ok": ok, "setup_s": setup_s,
            "steps_timed": n_timed, "tsdf_res": 128, "tsdf_views": len(cams),
            "tsdf_s": tsdf_s, "phases": per, "parts_ms": parts,
            "densify_warm": dens[-1],
            "densify_first": dens[0],
            "max_memory_allocated": max(p["max_memory_allocated"]
                                        for p in per.values())}
    emit(line)
    results["stage1"] = line
    if not ok:
        fail("stage1", "a stage-1 phase overflowed, lost its loss or did not "
             "run its kernels once a step at its width")


def stage1_parts(state, cam, vol, static):
    """Where a stage-1 step's time goes, part by part, at STAGE1_BENCH
    (synchronised, median of 5): the cubemap prefilter forward and backward
    (EnvMips.build of one 128² cubemap), the TSDF march of every
    Gaussian's reflected ray (the volume phase's visibility), and the
    rasterizer forward and backward at S = 0 (the initial phase)."""
    import torch
    from irgs_tpu_torch.render import ref_gaussian as rg
    from irgs_tpu_torch.ops import tsdf as tsdf_ops
    from irgs_tpu_torch.scene.ref_gaussians import EnvMips
    p = state.params

    def envmips():
        mips = EnvMips.build(p.env2)
        (sum(m.sum() for m in mips.specular) + mips.diffuse.sum()).backward()

    def march():
        _, _, refl = rg._per_gaussian_view(p, cam)
        tsdf_ops.ray_march_visibility(vol, p.xyz.detach(), refl.detach())

    def raster():
        out = rg.render_initial(p, state.aux, cam, torch.zeros(3,
                                device=cam.w2c.device),
                                img_w=static["img_w"], img_h=static["img_h"],
                                active_sh_degree=3,
                                dup_capacity=static["dup_capacity"])
        out["render"].sum().backward()

    res = {}
    for name, fn in (("envmips_fwd_bwd", envmips), ("march_100k", march),
                     ("raster_s0_fwd_bwd", raster)):
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            a = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - a) * 1e3)
        res[name] = statistics.median(ts[1:])
    state.optimizer.zero_grad()
    return res


class Stage1StepMeter:
    """Wraps stage1_full_step (the stage-1 CLI looks it up on its module
    at each step): each step's phase, synchronised wall time and kernel
    launches."""

    def __enter__(self):
        from irgs_tpu_torch.train import stage1_full as s1
        self.mod, self.orig, self.steps = s1, s1.stage1_full_step, []
        s1.stage1_full_step = self
        return self

    def __call__(self, *a, st, **kw):
        import torch
        torch.cuda.synchronize()
        before, t = launch_counts(), time.perf_counter()
        out = self.orig(*a, st=st, **kw)
        torch.cuda.synchronize()
        self.steps.append({
            "phase": _phase_name(st.phase, st.use_indirect),
            "ms": (time.perf_counter() - t) * 1e3,
            "launches": {k: v - before[k] for k, v in launch_counts().items()}})
        return out

    def __exit__(self, *exc):
        self.mod.stage1_full_step = self.orig


# the stage-1 CLI's compressed schedule: 60 iterations through every phase
# (initial to 10, volume to 30, surfel after), a densification at 10,
# opacity resets at 25 and 50, normal propagation at 20, 40 and 60, the
# material reset at 31, indirect steps from 42 on TSDFs refreshed at 41,
# 50 and 60 (128³, as STAGE1_BENCH's)
STAGE1_CLI = ["--iterations", "60", "--init_until_iter", "10",
              "--volume_render_until_iter", "30", "--indirect_from_iter", "40",
              "--densify_from_iter", "5", "--densification_interval", "10",
              "--opacity_reset_interval", "25", "--normal_prop_interval", "20",
              "--mesh_interval", "10", "--mesh_res", "128",
              "--dup_capacity", str(2 ** 21), "--max_gaussians", str(2 ** 17)]


def phase_train_stage1_cli(results, tmp):
    """python -m irgs_tpu_torch.train_refgaussian in-process on train_cli's
    folder (8 ring views at 400x400; the Blender reader's 100k random
    points) with STAGE1_CLI, then python -m irgs_tpu_torch.train for 3
    iterations from its last checkpoint (--start_checkpoint_refgs)."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.train import densify as D
    from irgs_tpu_torch.train import stage1_full as s1
    from irgs_tpu_torch.train_refgaussian.__main__ import main as s1_main

    dev = torch.device("cuda")
    b = workload.BENCH
    scene = os.path.join(tmp, "sphere")
    if not os.path.isdir(scene):            # train_cli made it when it ran
        params, aux = toy.make_sphere_scene(n_surface=b["n_surface"],
                                            n_capacity=b["n_capacity"],
                                            env_resolution=128, device=dev)
        write_blender_dataset(scene, params, aux, toy.make_ring_cameras(
            8, width=b["img"], height_px=b["img"]), spp=32, white=False)
        del params, aux
    run = os.path.join(tmp, "stage1_run")
    timed = {"tsdf_refresh": (s1, "reconstruct_tsdf"),
             "densify": (D, "densify_and_prune"),
             "checkpoint": (s1, "save_stage1_checkpoint")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    with Stage1StepMeter() as meter, Timed(timed) as tm:
        s1_main(["-s", scene, "-m", run, *STAGE1_CLI])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    results.setdefault("launches", {})["train_stage1_cli"] = launches
    with open(os.path.join(run, "train_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    events = {}
    for m in log:
        if "event" in m:
            events.setdefault(m["event"], []).append(m)
    by_phase = {}
    for stp in meter.steps[1:]:              # the first step warms up
        by_phase.setdefault(stp["phase"], []).append(stp["ms"])
    run2 = os.path.join(tmp, "stage2_from_stage1")
    # the raster's dup capacity of STAGE1_BENCH: 60 steps from a random
    # cloud leave large surfels that touch many tiles
    s2_launches, s2_s = run_cli(["-s", scene, "-m", run2,
                                 "--start_checkpoint_refgs", run,
                                 "--iterations", "3", "--vis_interval", "0",
                                 *CLI_BENCH, "--dup_capacity", str(2 ** 21)])
    with open(os.path.join(run2, "train_log.jsonl")) as f:
        log2 = [json.loads(x) for x in f]
    files = sorted(os.listdir(run))
    files2 = sorted(os.listdir(run2))
    dens = events.get("densify", [{}])[0]
    line = {"phase": "train_stage1_cli", "cli_s": cli_s,
            "ms_per_step_by_phase": {k: statistics.median(v)
                                     for k, v in by_phase.items()},
            "steps_by_phase": {k: len(v) for k, v in by_phase.items()},
            "tsdf_refresh_s": tm.seconds.get("tsdf_refresh"),
            "densify_s": tm.seconds.get("densify"),
            "checkpoint_s": tm.seconds.get("checkpoint"),
            "n_alive_before_densify": dens.get("n_alive_before"),
            "n_alive_after_densify": dens.get("n_alive"),
            "densify": dens, "events": {k: [m["iter"] for m in v]
                                        for k, v in events.items()},
            "max_memory_allocated": peak, "launches": launches,
            "log_final": log[-1], "files": files,
            "stage2_s": s2_s, "stage2_launches": s2_launches,
            "stage2_log": log2, "stage2_files": files2}
    checks = {
        "every_phase": set(by_phase) == {"initial", "volume", "surfel",
                                         "surfel_indirect"},
        "events": all(k in events for k in (
            "densify", "opacity_reset", "normal_prop", "material_reset",
            "tsdf_refresh")),
        "loss_finite": all(math.isfinite(m["loss"]) for m in log
                           if "loss" in m),
        "raster_overflow_zero": all(m.get("raster_overflow", 0) == 0
                                    for m in log),
        "blend_once_per_step": all(
            stp["launches"]["blend_fwd"] == stp["launches"]["blend_bwd"] == 1
            for stp in meter.steps),
        "checkpoint": "chkpnt60.ckpt" in files,
        "stage2_bridged": "chkpnt3.ckpt" in files2 and all(
            math.isfinite(m["loss"]) for m in log2),
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("train_stage1_cli", f"checks failed: {checks}")


# each kernel: its source, the Pallas functions it replaces, and for each
# main path it runs on, the case held at the shape that path gives it (the
# summary's top-level numbers are those of the first path's case)
KERNELS = {
    "blend_fwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:141",
        cases={"stage2": "bench_400px_100k", "eval": "eval_400px_100k",
               "train_cli": "bench_400px_100k",
               "train_cli_oversize": "shadow_400px_12k",
               "eval_cli": "relight_400px_100k",
               "stage1": "stage1_400px_100k_S11",
               "stage1_indirect": "stage1_400px_100k_S18",
               "train_stage1_cli": "stage1_400px_100k_S11"}),
    "blend_bwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:222",
        cases={"stage2": "bench_400px_100k", "train_cli": "bench_400px_100k",
               "train_cli_oversize": "shadow_400px_12k",
               "stage1": "stage1_400px_100k_S11",
               "stage1_indirect": "stage1_400px_100k_S18",
               "train_stage1_cli": "stage1_400px_100k_S11"}),
    "gather_rows": dict(
        route="cuda", source="irgs_tpu_torch/csrc/gather_rows.cu",
        replaces=("irgs_tpu/ops/gather_pallas.py:28; "
                  "tools/_prof_collect_parts.py:121; "
                  "tools/_prof_collect_parts.py:144"),
        # the CLI trains at the stage2 phase's shapes
        cases={"eval": "eval_first_pass", "stage2": "stage2_first_pass",
               "train_cli": "stage2_first_pass",
               "train_cli_oversize": "shadow_400px_12k_first_pass",
               "eval_cli": "relight_400px_100k_first_pass"}),
    # no Pallas kernel: the deterministic scatter-add of the gathers'
    # gradients (XLA's scatter-add in the JAX package, the VJP of its slab
    # gather and of blend_hits' gathers); index_add_ is its library call
    "segment_sum": dict(
        route="cuda", source="irgs_tpu_torch/csrc/segment_sum.cu",
        replaces=("irgs_tpu/ops/surfel_raster.py:547 and "
                  "irgs_tpu/ops/grid_tracer.py:1440 (XLA scatter-add, the "
                  "VJP of the slab gather and of blend_hits' gathers; no "
                  "Pallas kernel)"),
        cases={"stage2": "stage2_largest", "train_cli": "stage2_largest",
               "stage1": "stage1_largest",
               "train_stage1_cli": "stage1_largest"}),
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


PHASES = ("build", "kernels", "stage2_small", "stage2", "eval_small",
          "mis_small", "eval", "train_cli", "train_cli_oversize", "eval_cli",
          "stage1_small", "stage1", "train_stage1_cli")


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

    import tempfile
    results, wall = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="irgs_chip_smoke_") as tmp:
        runs = {
            "build": phase_build,
            "kernels": lambda: (phase_kernels(results),
                                phase_kernels_gather(results)),
            "stage2_small": phase_stage2_small,
            "stage2": lambda: phase_stage2(results),
            "eval_small": phase_eval_small,
            "mis_small": phase_mis_small,
            "eval": lambda: phase_eval(results),
            "train_cli": lambda: phase_train_cli(results, tmp),
            "train_cli_oversize": lambda: phase_train_cli_oversize(results,
                                                                   tmp),
            "eval_cli": lambda: phase_eval_cli(results, tmp),
            "stage1_small": phase_stage1_small,
            "stage1": lambda: phase_stage1(results),
            "train_stage1_cli": lambda: phase_train_stage1_cli(results, tmp),
        }
        for name in PHASES:
            if name in phases:
                a = time.perf_counter()
                runs[name]()
                wall[name] = round(time.perf_counter() - a, 1)
    summary = kernels_line(results)
    print(json.dumps(summary), flush=True)
    if set(phases) == set(PHASES):
        # every kernel must have run on each of its main paths
        idle = [(k["name"], p) for k in summary["kernels"]
                for p, c in k["by_path"].items() if not c["launches"]]
        if idle:
            fail("done", f"kernels not launched on their main path: {idle}")
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1),
          "phase_wall_s": wall})
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
