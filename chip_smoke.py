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
                heaviest tile's time alone), the row gather (bit for bit)
                at the JAX package's test shapes, the TPU probe kernels'
                and synthetic audit and eval first passes, beside
                index_select in blocks and in turns, with its queued time
                and both host costs a call;
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
  stage2_full   the full-image branch (train_ray off): the test-scale step
                on the card against the CPU and two of its backward passes
                bit for bit, then one step at the bench workload (400x400,
                157 chunks of 1024 pixels, each recomputed in the backward
                pass) with its forward and backward timed apart, peak
                memory and launches; the gather and the scatter-add held at
                its inputs; and the CLI with --no-train_ray at the test
                scale (2 iterations, visualisations, a resume);
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
                same state and draws; then SH degree 4: SH4_STAGE1_STEPS
                surfel-phase steps of the test-scale state with 25
                coefficients per channel at active degree 4 (the first
                step's loss and gradients card against CPU, the later
                losses reported), one stage-2 step of the test-scale
                sphere with 25 coefficients at active degree 3 (as
                stage2_small) and one eval frame of it at active degree 4
                (as eval_small, 8 diffuse samples), each a path of its own
                (sh4_stage1, sh4_stage2, sh4_eval) with every kernel it
                launches held at its first inputs and the scatter-add at
                its largest call;
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
                iterations from its checkpoint (--start_checkpoint_refgs);
  extract_mesh  python -m irgs_tpu_torch.extract_mesh in-process on the
                run train_stage1_cli leaves, at --mesh_res 256, bounded and
                --unbounded: the seconds of fusion, marching tetrahedra,
                weld, clean-up and writes, the meshes' counts, peak memory,
                the forward blend held at the depth render's inputs; then
                --toy at the defaults (the unit sphere) and the analytic
                spheres' meshes card against CPU. Needs train_stage1_cli;
  tracer_options
                the tracer's options: at test scale (96 surfels, 256 rays)
                the per-candidate select single- and two-tier, the packed
                cell collection, the bf16 pair table and iterative
                deepening, card against CPU (forward, and gradients but for
                the forward-only retrace_while); one warm and two timed
                BENCH stage-2 steps with select_tiles 0, with the two-tier
                prefilter at 192, with tiled_direct off and with table_bf16
                (the gather held at the bf16 table's first inputs); one EVAL
                frame with retrace_while off and on (s/frame, rounds run,
                Mrays/s);
  parallel      multi-device on torch.distributed: a one-rank NCCL world's
                BENCH DP step against the plain step, bit for bit; then two
                gloo ranks sharing the card (NCCL refuses two ranks on one
                device): the test-scale DP step against one process's mean
                step bit for bit, equal parameters on both ranks, the
                sample-sharded test-scale eval frame against the one-rank
                frame, and three BENCH DP steps with their all_reduce timed;
  datasets      the readers on the card's machine (no PIL, no cv2): the
                committed JPEG fixtures of tests/data/jpeg decoded bit for
                bit (ms per 1297x840 frame); a COLMAP folder of the BENCH
                sphere (8 views at 600², saved as JPEG by the port's
                encoder, PINHOLE with the principal point 7 px off centre,
                points3D.bin of its 100k surfel centres)
                through python -m irgs_tpu_torch.train at --resolution 400
                (a fractional INTER_AREA) for 20 iterations; a Stanford-ORB
                folder (8 views of 2048² PNG frames and masks, read at 512,
                the surfel centres as its cloud) through the stage-1 CLI
                for 20 iterations (every phase) and 3 stage-2 iterations
                from its checkpoint; each run's losses
                finite, no overflow, the kernels launched and held at its
                inputs, ms/step and peak memory beside train_cli's;
  e2e           tools/run_e2e (E2E_SMOKE: the analytic dataset at 400²,
                stage 1, stage 2, the NVS, material and relighting evals,
                each stage's CLI main(argv) in this process): every
                stage's rc, seconds and peak memory, finite eval PSNR,
                stage 2's ray_psnr rising, each stage's kernel launches,
                and the training stages' first blend and gather inputs and
                largest scatter-add held against the plain versions;
  bench         python -m irgs_tpu_torch.bench at its defaults (BENCH): its
                JSON line with bench.py's keys (the cost fields null),
                ms/step beside the stage2 phase's;
  bench_stage1  python -m irgs_tpu_torch.tools.bench_stage1 at full width,
                --iters 3: its JSON line with the JAX script's keys;
  bench_frame   python -m irgs_tpu_torch.tools.bench_frame at 800², its
                samples cut to 16 + 8: the grid's overflow, a cold and a
                warm frame, its JSON line;
  raster_oracle the whole rasterizer (binning, the per-tile sort, both blend
                kernels) on tests/test_raster.py's tiny scene against the
                brute-force oracle, values and gradients, and preprocess
                against the independent preprocess_reference;
  drives        drive_parity at its defaults but one view, on 1024 of its
                foreground pixels (gated at 40 dB), audit_train_budget's
                rows, trace_fidelity's two densities, 41 of drive_stage2's
                161 steps (ray PSNR rising, the envmap error below its
                initial value); each tool's launches counted apart;
  load_reproducer
                the stage-2 CLI's toy with a NaN injected at step 2 (exit 3
                and a reproducer), then its replay, which must raise;
  run_grid      python -m irgs_tpu_torch.tools.run_grid (its in-process
                runner) on e2e's dataset (made here when e2e did not run):
                every step done, collect_results' output, and a second
                invocation that skips every step by its markers;
  overfit       python -m irgs_tpu_torch.tools.drive_overfit at the JAX
                script's size (2048 surfels, 128², 200 steps + 50 timed):
                PSNR from ~7 dB to above 45 dB, no overflow, its probes;
                then 5 stage-1-lite steps (train/stage1.py) on the BENCH
                sphere at 400²; each a path of its own, the blends held at
                its first inputs and the scatter-add at its largest;
  images        the image codecs without PIL: every committed JPEG and PNG
                fixture (tests/data/jpeg, tests/data/png) decoded bit for
                bit with its mode and palette, every PIL-refused stream
                refused; ms per 1297x840 frame (baseline, progressive and
                arithmetic re-saves), Lanczos 1600² -> 400² and JPEG encode
                of that frame; python -m irgs_tpu_torch.process_images on the
                committed inputs against the root script's committed
                outputs (JPEG bytes equal, PNG arrays, modes and palettes
                equal), split-grid on train_cli's vis/iter_000001.png and
                crop --downscale 4 on eval_cli's render folder (sizes);
                every committed TIFF, BMP and GIF fixture (tests/data/tiff,
                bmp, gif) bit for bit with its mode and palette through the
                content-sniffing reader, their refused streams refused,
                three files whose extension lies read by content, the .hdr
                headers cv2 takes or refuses, and ms per 1297x840 RGB TIFF
                at each compression, 24-bit BMP and GIF frame; the WebP
                fixtures (tests/data/webp) among the containers,
                and the median ms of 5 decodes of the three committed
                1297x840 WebP frames (lossless, lossy q90, lossy with
                alpha) and of the four committed TIFF frames (YCbCr
                JPEG-in-TIFF 4:2:0, Zstandard and LZMA with predictor 2,
                1297x840; a 1728-wide T.6 page), each held against the
                SHA-256 of PIL's array. Needs train_cli and eval_cli.
  webp_colmap   python -m irgs_tpu_torch.train for 5 iterations at the
                BENCH budgets on the committed COLMAP capture of WebP frames
                (tests/data/webp/colmap: 4 views at 400², two lossy, one
                lossless, one lossy with alpha; 4,096 points), a main path
                of its own: the blends and the gather held at their first
                inputs, the scatter-add at its largest; load time, ms per
                step and peak memory.
  tiff_colmap   the same on the committed COLMAP capture of TIFF frames
                (tests/data/tiff/colmap: the same 4 views as YCbCr
                JPEG-in-TIFF 4:2:0 with JPEGTables, RGB JPEG-in-TIFF, YCbCr
                LZW at 2x2, RGBA Zstandard tiles with predictor 2), a main
                path of its own.
Each of the tool phases from bench on runs its tool's main in this process
and holds the kernels at the path's first inputs (the scatter-add at its
largest).
Then a `kernels` summary line, a `done` line with each phase's wall time,
the card's name and power limit, and the last line {"ok": true, "device":
{...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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


def cuda_ms_paired(fn_a, fn_b, reps=20):
    """Median ms of fn_a() and of fn_b(), each call timed as cuda_ms times
    one, the two taken in turns (a first on even turns, b first on odd) so
    that both see the same host and card: the pair's comparison where a
    call is short enough for the host's jitter to matter."""
    import torch
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for r in range(reps):
        for k in ((0, 1) if r % 2 == 0 else (1, 0)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            (fn_a, fn_b)[k]()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


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
# tests/test_gather_pallas.py (M = 3T + 7, and its 5-row small batch), the
# two probe kernels of tools/_prof_collect_parts.py (`kern`, a row gather
# of [1024, 128] by 128 rows; `kern2`, a flat gather of 8 x 128 elements
# from 110592, i.e. rows of one word), and synthetic stand-ins for the
# audit's first pass (12,288 x 352) and the eval frame's (393,216 x 352):
# from a table as large as the eval frame's pair table, indices drawn from
# as many distinct rows as its first pass reads (both as the eval phase
# records them on the H100); and the eval shape from a table small enough
# to stay in L2 (8.8 MB), where only the write stream is left.
# (name, T, W, M, distinct rows or None: any)
EVAL_TABLE_ROWS, EVAL_FIRST_PASS_ROWS = 65536, 12887
GATHER_CASES = [("test_513x224", 513, 224, 3 * 513 + 7, None),
                ("test_64x896", 64, 896, 3 * 64 + 7, None),
                ("test_2048x56", 2048, 56, 3 * 2048 + 7, None),
                ("test_small_batch", 10, 4, 5, None),
                ("probe_kern_1024x128", 1024, 128, 128, None),
                ("probe_kern2_flat", 110592, 1, 8 * 128, None),
                ("synthetic_audit_12288x352", EVAL_TABLE_ROWS, 352, 12288,
                 EVAL_FIRST_PASS_ROWS),
                ("synthetic_eval_first_pass_393216x352", EVAL_TABLE_ROWS, 352,
                 393216, EVAL_FIRST_PASS_ROWS),
                ("synthetic_l2_table_393216x352", 6250, 352, 393216, None)]

def host_us_per_call(fn, n=50):
    """The host's enqueue time of fn() by the host clock, no synchronise
    inside the n calls: the wrapper's own cost where the device keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def check_gather(results, name, table, idx):
    """The gather kernel against table[idx] on the card, bit for bit, with
    its time (synchronised: ms, plain_ms and library_ms each a block of 20
    calls, as every kernel line times them; then the kernel and index_select
    again in turns, *_paired; and queued back to back), the host cost a call
    of the kernel and of index_select, and its bound: the distinct rows this
    idx reads, idx itself and the output, over the HBM rate."""
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
            "table": list(table.shape), "table_bytes": 4 * table.numel(),
            "rows": M, "distinct_rows": rows_read,
            "ms": cuda_ms(lambda: gr.gather_rows_cuda(table, idx)),
            "plain_ms": cuda_ms(lambda: gr.gather_rows_plain(table, idx)),
            "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx))}
    line["ms_paired"], line["library_ms_paired"] = cuda_ms_paired(
        lambda: gr.gather_rows_cuda(table, idx),
        lambda: torch.index_select(table, 0, idx))
    line.update(
        vs_library=line["ms"] / line["library_ms"],
        vs_library_paired=line["ms_paired"] / line["library_ms_paired"],
        ms_queued=cuda_ms_queued(lambda: gr.gather_rows_cuda(table, idx)),
        host_us_per_call=host_us_per_call(
            lambda: gr.gather_rows_cuda(table, idx)),
        library_host_us_per_call=host_us_per_call(
            lambda: torch.index_select(table, 0, idx)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)
    emit(line)
    results.setdefault("gather_rows", {})[name] = line
    return same


def phase_kernels_gather(results):
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    ok = True
    for name, T, W, M, distinct in GATHER_CASES:
        table = torch.randn((T, W), device=dev, generator=g)
        idx = torch.randint(0, distinct or T, (M,), device=dev, generator=g)
        if distinct:
            idx = torch.randperm(T, device=dev, generator=g)[:distinct][idx]
        ok &= check_gather(results, name, table, idx)
    if not ok:
        fail("kernels", "gather_rows differs from table[idx]")


# the test-scale stage-2 step: tests/test_torch_stage2.py's scene and tracer
STAGE2_SMALL_TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8,
                           max_hits=24, hit_budget=16, max_crossings=10,
                           select_tiles=4, tile=32, tiled_direct=True,
                           n_segments=4, retrace_frac=0.25)
STEP_LOSS_REL_TOL, STEP_PARAM_TOL = 1e-4, 1e-5


def stage2_small_setup(dev, light=0, train_ray=True, sh_degree=3):
    """The CPU tests' stage-2 scale (512 surfels, 64x64, 8 diffuse and
    `light` light samples on 128 pixels, or with train_ray off on every
    pixel in 32 chunks of 128; a model of SH degree `sh_degree`) ->
    stage2_setup's tuple."""
    import dataclasses
    from irgs_tpu_torch import workload
    state, grid, cams, st = workload.stage2_setup(
        512, 1024, 64, 8, (8 + light) * 128, 2 ** 14, dev,
        STAGE2_SMALL_TRACER, light=light, sh_degree=sh_degree)
    return state, grid, cams, dataclasses.replace(st, train_ray=train_ray)


@contextlib.contextmanager
def main_path(results, path, kernels=("blend", "gather"), scatter=True,
              case=None):
    """Run the block as the main path `path` on the card: every launch count
    set to 0 before it and read after it into results["launches"][path],
    the `kernels` (_held) held at their first inputs as case `case`
    (default f"{path}_64px"), and with `scatter` the scatter-add at its
    largest call as f"{path}_largest"."""
    import torch
    reset_launch_counts()
    with _held(kernels) as rec, LargestScatter() as scat:
        yield
    torch.cuda.synchronize()
    results.setdefault("launches", {})[path] = launch_counts()
    check_recorded(results, rec, case or f"{path}_64px")
    if scatter:
        check_scatter(results, scat, f"{path}_largest")


def _on_card(dev, results, path, **kw):
    """main_path(results, path, **kw) for the card's run of a card-vs-CPU
    case that is a main path of its own, else no context."""
    if dev == "cuda" and path:
        return main_path(results, path, **kw)
    return contextlib.nullcontext()


def stage2_card_vs_cpu(light=0, train_ray=True, sh_degree=3, results=None,
                       path=None):
    """One stage-2 step at the CPU tests' scale on the card and with the
    plain CPU path, from the same draws -> its JSON fields and ok. With
    `path`, the card's step is that main path (main_path)."""
    import torch
    from irgs_tpu_torch.train import stage2 as s2

    res = {}
    gen = torch.Generator().manual_seed(0)
    for dev in ("cpu", "cuda"):
        state, grid, cams, st = stage2_small_setup(dev, light, train_ray,
                                                   sh_degree)
        if dev == "cpu":
            draws = s2.draw_stage2(gen, st, "cpu")
        gt_img = torch.full((64, 64, 3), 0.4, device=dev)
        state.step = 1001
        with _on_card(dev, results, path):
            state, m = s2.stage2_step(state, grid, cams[0].params(dev),
                                      gt_img, None, draws.to(dev), st=st)
        res[dev] = (m, {k: v.detach().cpu() for k, v in
                        state.params.tensors().items()})
    loss_rel = abs(float(res["cuda"][0]["loss"]) - float(res["cpu"][0]["loss"])) \
        / abs(float(res["cpu"][0]["loss"]))
    p_err = max(float((res["cuda"][1][k] - res["cpu"][1][k]).abs().max())
                for k in res["cpu"][1])
    ok = loss_rel <= STEP_LOSS_REL_TOL and p_err <= STEP_PARAM_TOL
    return {"light_sample_num": light, "train_ray": train_ray,
            "sh_coefficients": res["cuda"][1]["features_rest"].shape[1] + 1,
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


def stage2_grads_deterministic(train_ray=True):
    """Two backward passes of the test-scale stage-2 step on the card from
    the same inputs -> (bitwise equal, fields that differ)."""
    import torch
    from irgs_tpu_torch.train import stage2 as s2
    dev = torch.device("cuda")
    state, grid, cams, st = stage2_small_setup(dev, train_ray=train_ray)
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


def stage2_full_cli(tmp):
    """python -m irgs_tpu_torch.train --no-train_ray at the test scale on the
    card: a Blender folder of 4 ring views at 64x64 rendered from the
    512-surfel sphere, 2 iterations with a visualisation frame and a
    checkpoint each, then iteration 2 again resumed from chkpnt1 ->
    (JSON fields, ok)."""
    from irgs_tpu_torch.scene import gaussians as G
    from irgs_tpu_torch.scene import toy
    import torch
    dev = torch.device("cuda")
    scene, run, run2 = (os.path.join(tmp, d) for d in
                        ("fi_scene", "fi_run", "fi_resumed"))
    params, aux = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                        env_resolution=16, device=dev)
    write_blender_dataset(scene, params, aux, toy.make_ring_cameras(
        4, width=64, height_px=64), spp=16, white=False)
    G.save_ply(os.path.join(tmp, "fi_start.ply"), params, aux)
    small = ["-s", scene, "--no-train_ray", "--diffuse_sample_num", "8",
             "--trace_num_rays", "1024", "--dup_capacity", "65536",
             "--max_gaussians", "1024", "--envmap_resolution", "16",
             "--iterations", "2"]
    launches, cli_s = run_cli([*small, "-m", run, "--start_ply",
                               os.path.join(tmp, "fi_start.ply"),
                               "--vis_interval", "1",
                               "--checkpoint_interval", "1"])
    _, resume_s = run_cli([*small, "-m", run2, "--vis_interval", "0",
                           "--start_checkpoint",
                           os.path.join(run, "chkpnt1.ckpt")])
    log = read_log(run)
    vis = sorted(os.listdir(os.path.join(run, "vis")))
    line = {"cli_s": cli_s, "resume_s": resume_s, "log": log[1],
            "vis": vis, "launches": launches}
    ok = (math.isfinite(log[1]["loss"]) and "psnr" in log[1]
          and {"iter_000001.png", "iter_000002.png"} <= set(vis)
          and os.path.exists(os.path.join(run2, "chkpnt2.ckpt"))
          and all(v > 0 for v in launches.values()))
    return line, ok


# the full-image step's frame: the bench scene and budgets, cut in depth
# from 400² (157 chunks, ~100 s on an H100 80GB HBM3 at 700 W) to 160² (25
# chunks)
STAGE2_FULL_IMG = 160


def phase_stage2_full(results, tmp):
    """One stage-2 step with train_ray off at the bench workload's scene
    and budgets on a STAGE2_FULL_IMG² frame: every pixel shaded in chunks
    of 1024 (2^18 rays a chunk, as a train_ray step traces), each chunk
    recomputed in the backward pass; the forward and the backward timed
    apart. The step also records the gather's first inputs and the largest
    scatter-add, held against their plain versions after it. Before it, the
    test-scale full-image step on the card against the CPU, two of its
    backward passes on the card bit for bit, and the CLI with
    --no-train_ray at that scale (stage2_full_cli)."""
    import dataclasses

    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.train import stage2 as s2

    small, small_ok = stage2_card_vs_cpu(train_ray=False)
    det, differ = stage2_grads_deterministic(train_ray=False)
    cli, cli_ok = stage2_full_cli(tmp)
    dev = torch.device("cuda")
    state, grid, cams, st = workload.stage2_setup(
        **{**workload.BENCH, "img": STAGE2_FULL_IMG}, device=dev)
    st = dataclasses.replace(st, train_ray=False)
    cam = cams[0].params(dev)
    gt_img = torch.full((st.img_h, st.img_w, 3), 0.5, device=dev)
    draws = s2.draw_stage2(torch.Generator(dev).manual_seed(0), st, dev)
    mat0 = state.params.base_color.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with FirstCalls({"blend": (rb, "blend_tiles"),
                     "gather": (gt, "gather_rows_kernel")},
                    clone=(1,)) as rec, LargestScatter() as scat:
        t0 = time.perf_counter()
        state.optimizer.zero_grad()
        loss, m = s2.stage2_forward_loss(state.params, state.aux, grid, cam,
                                         gt_img, None, draws, state.step, st)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.optimizer.step(state.step)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    results.setdefault("launches", {})["stage2_full"] = launches
    check_recorded(results, rec, f"stage2_full_{STAGE2_FULL_IMG}px")
    check_scatter(results, scat, "stage2_full_largest")
    m = {k: float(v.detach()) for k, v in m.items()}
    n = st.n_chunks
    line = {"phase": "stage2_full", "img": st.img_w, "n_chunks": n,
            "chunk_pixels": st.chunk_pixels,
            "rays_per_chunk": st.chunk_pixels * st.diffuse_sample_num,
            "ms_step": (t3 - t0) * 1e3, "ms_forward": (t1 - t0) * 1e3,
            "ms_backward": (t2 - t1) * 1e3, "ms_adam": (t3 - t2) * 1e3,
            "ms_forward_per_chunk": (t1 - t0) * 1e3 / n,
            "ms_backward_per_chunk": (t2 - t1) * 1e3 / n,
            "max_memory_allocated": peak, "loss": m["loss"],
            "psnr": m["psnr"], "raster_overflow": m["raster_overflow"],
            "grid_overflow": m["grid_overflow"], "launches": launches,
            "launches_per_chunk": {k: v / n for k, v in launches.items()},
            "small": small, "small_grads_bitwise_deterministic": det,
            "small_grads_differ": differ, "cli": cli}
    checks = {
        "small_card_vs_cpu": small_ok, "small_bitwise": det,
        "cli_trains_visualises_resumes": cli_ok,
        "loss_finite": math.isfinite(m["loss"]),
        "raster_overflow_zero": m["raster_overflow"] == 0.0,
        # the forward and the recomputation each blend and gather a chunk
        "every_kernel_ran": all(v > 0 for v in launches.values()),
        "materials_moved": not bool(torch.equal(
            state.params.base_color.detach(), mat0)),
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    results["stage2_full"] = line
    if not line["ok"]:
        fail("stage2_full", f"checks failed: {checks}")


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


def eval_card_vs_cpu(setup, flat_first_row=False, results=None, path=None):
    """One test-scale eval frame (workload.eval_setup(**setup)) on the card
    and on the CPU (plain versions of every kernel), from the same scene
    -> its JSON fields and ok. `flat_first_row` sets the env's first row to
    its second (see phase_mis_small). With `path`, the card's frame is that
    main path (main_path; no backward, so no scatter-add)."""
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
        with _on_card(dev, results, path, scatter=False):
            out = render_ir_eval(params, aux, grid, cam, ecfg,
                                 stats_out=stats[dev])
            # read before main_path's checks launch the kernels again
            stats[dev]["launches"] = {**rb.LAUNCHES, **gr.LAUNCHES}
        outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
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
    results["train_cli_line"] = line
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


# the eval CLIs' samples (diffuse, light), cut in depth from render's 256 +
# 256 and relighting's default 512 + 256; the relit GT's
EVAL_CLI_RENDER_SPP = (64, 64)
EVAL_CLI_RELIGHT_SPP = (128, 64)
EVAL_CLI_GT_SPP = (32, 32)


def phase_eval_cli(results, tmp):
    """The three eval CLIs, in-process, on the run that train_cli leaves
    (the 100k-surfel sphere at 400x400, iteration 100): first the dataset
    gets GT albedo/roughness maps of view r_0 (the model's own G-buffer), two
    256x512 EXR envmaps (a sun and sky, the toy blob env) and relit GT of
    r_0 under the first, rendered by the port at EVAL_CLI_GT_SPP; then
    render (one view, EVAL_CLI_RENDER_SPP), eval.material (--compute_scale,
    then the eval pass) and eval.relighting (one view, both envmaps,
    EVAL_CLI_RELIGHT_SPP)."""
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
    gt_cfg = ir.ShadeConfig(diffuse_sample_num=EVAL_CLI_GT_SPP[0],
                            light_sample_num=EVAL_CLI_GT_SPP[1],
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

    # 1. render, the MIS branch, on view r_0
    with PerView(reval, "render_ir_eval", stats_kw=True) as pv:
        sec, peak, lc = run_eval_cli(render_cli.main, [
            "-m", run, "--max_images", "1",
            "--diffuse_sample_num", str(EVAL_CLI_RENDER_SPP[0]),
            "--light_sample_num", str(EVAL_CLI_RENDER_SPP[1])])
    with open(os.path.join(run, "test", "nvs_results.json")) as f:
        nvs = json.load(f)
    v = pv.calls
    record("render", sec, peak, lc, v, {
        "samples": list(EVAL_CLI_RENDER_SPP),
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

    # 3. relighting, one view, both envmaps
    n_env, (s_d, s_l) = len(envs), EVAL_CLI_RELIGHT_SPP
    info = lambda out: dict(out[2])
    with PerView(relighting, "relight_view", info=info) as pv, \
            Timed({"fg_lut": (cm, "compute_fg_lut"),
                   "relight_env": (relight, "build_relight_env")}) as timed:
        sec, peak, lc = run_eval_cli(relighting.main, [
            "-m", run, "--envmaps", *envs, "--max_images", "1",
            "--diffuse_sample_num", str(s_d), "--light_sample_num", str(s_l)])
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


def stage1_small_state(dev, sh_degree=3):
    """STAGE1_SMALL on `dev` at SH degree `sh_degree` (active and max): the
    state, cameras, target, FG table and the static kwargs."""
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
    fields, alive = workload.stage1_small_fields(
        w["n_surface"], w["n_capacity"], w["env_res"], sh_degree=sh_degree)
    params, aux = G.params_from_numpy(fields, alive, dev,
                                      cls=RefGaussianParams,
                                      max_sh_degree=sh_degree)
    state = s1.init_state(params, aux, stage1_config().opt,
                          w["cameras_extent"])
    cams = toy.make_ring_cameras(w["n_cams"], width=w["img"],
                                 height_px=w["img"])
    yy, xx = np.mgrid[:w["img"], :w["img"]] / w["img"]
    gt = torch.tensor(np.stack([0.3 + 0.2 * np.sin(6 * xx), 0.4 + 0.1 * yy,
                                0.5 - 0.2 * xx * yy], -1).astype(np.float32),
                      device=dev)
    lut = cm.compute_fg_lut(res=32, samples=64, device=dev)
    static = dict(img_w=w["img"], img_h=w["img"], active_sh_degree=sh_degree,
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


def _grads_agree(g_cpu, g_card):
    """Worst |card - CPU| / max|g_cpu| over the gradients, and the largest
    share of a gradient's elements beyond S1_GRAD_REL·max|g_cpu|."""
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
    return worst, max(shares.values())


SH4_STAGE1_STEPS = 3
# the degree-4 eval frame: EVAL_SMALL's scene and tracer at 8 diffuse samples
SH4_EVAL = dict(EVAL_SMALL, diffuse=8, sh_degree=4)
# each SH-degree-4 path and the kernels it must launch
SH4_PATHS = {"sh4_stage1": ("blend_fwd", "blend_bwd", "segment_sum"),
             "sh4_stage2": ("blend_fwd", "blend_bwd", "gather_rows",
                            "segment_sum"),
             "sh4_eval": ("blend_fwd", "gather_rows")}


def stage1_small_steps(dev, n, sh_degree=3, results=None, path=None):
    """n surfel-phase steps of STAGE1_SMALL at SH degree `sh_degree` from
    iteration 10 -> their losses and the first step's gradients. With
    `path`, the card's steps are that main path (main_path; no gather)."""
    from irgs_tpu_torch.train import stage1_full as s1
    state, cams, gt, lut, static = stage1_small_state(dev, sh_degree)
    st = _stage1_static("surfel", False, **static)
    state.step = 10
    losses, grads = [], None
    with _on_card(dev, results, path, kernels=("blend",)):
        for i in range(n):
            state, m = s1.stage1_full_step(state, cams[i % len(cams)]
                                           .params(dev), gt, None, lut, None,
                                           st=st)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = {k: None if t.grad is None else
                         t.grad.detach().cpu().clone()
                         for k, t in state.params.tensors().items()}
    return losses, grads


def sh_degree4_case(results):
    """SH degree 4 at test scale, card against CPU, each card run a main
    path of its own (main_path): SH4_STAGE1_STEPS surfel-phase stage-1 steps
    of STAGE1_SMALL with 25 coefficients per channel at active degree 4
    (sh4_stage1: the first step's loss and gradients compared, the later
    losses reported); one stage-2 step of the test-scale sphere with 25
    coefficients, at active degree 3 as the trainer runs it (sh4_stage2:
    as stage2_small); and one eval frame of that sphere at active degree 4,
    the tracer's blend evaluating the degree-4 terms (sh4_eval: as
    eval_small, at SH4_EVAL's 8 diffuse samples)."""
    l_cpu, g_cpu = stage1_small_steps("cpu", SH4_STAGE1_STEPS, 4)
    l_card, g_card = stage1_small_steps("cuda", SH4_STAGE1_STEPS, 4,
                                        results, "sh4_stage1")
    worst, share = _grads_agree(g_cpu, g_card)
    rel = [abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu)]
    s1_ok = (rel[0] <= S1_LOSS_RTOL and share <= MAX_OUTLIER_SHARE
             and worst <= BWD_REL and all(map(math.isfinite, l_card))
             and g_cpu["features_rest"][:, 15:].abs().max() > 0)
    s2, s2_ok = stage2_card_vs_cpu(sh_degree=4, results=results,
                                   path="sh4_stage2")
    ev, ev_ok = eval_card_vs_cpu(SH4_EVAL, results=results, path="sh4_eval")
    launches = {p: results["launches"][p] for p in SH4_PATHS}
    launched = all(launches[p].get(k, 0) > 0 for p, ks in SH4_PATHS.items()
                   for k in ks)
    s2_ok = s2_ok and s2["sh_coefficients"] == 25
    return {"stage1_steps": SH4_STAGE1_STEPS, "stage1_loss_cuda": l_card,
            "stage1_loss_cpu": l_cpu, "stage1_loss_rel_err": rel,
            "stage1_grad_max_rel_err": worst,
            "stage1_grad_max_outlier_share": share, "stage1_ok": bool(s1_ok),
            "stage2": s2, "stage2_ok": bool(s2_ok),
            "eval_diffuse": SH4_EVAL["diffuse"], "eval": ev,
            "eval_ok": bool(ev_ok), "launches": launches}, \
        bool(s1_ok and s2_ok and ev_ok and launched)


def phase_stage1_small(results):
    """Stage 1 at test scale (STAGE1_SMALL), card against CPU: the loss and
    gradients of one step of each phase (the indirect ones on a TSDF fused
    on the CPU), two backward passes on the card bit for bit, and a
    densify_and_prune from the same state and draws; then the SH-degree-4
    case (sh_degree4_case)."""
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
        worst, share = _grads_agree(g_cpu, g_card)
        allowed = S1_OUTLIER_SHARE if ind else MAX_OUTLIER_SHARE
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        p_ok = (loss_rel <= S1_LOSS_RTOL and det
                and share <= allowed
                and (ind or worst <= BWD_REL)
                and bool(np.isfinite(l_card)))
        phases[name] = {"loss_cuda": l_card, "loss_cpu": l_cpu,
                        "loss_rel_err": loss_rel,
                        "grad_max_rel_err": worst,
                        "grad_max_outlier_share": share,
                        "allowed_outlier_share": allowed,
                        "outlier_bound_rel": None if ind else BWD_REL,
                        "grads_bitwise_deterministic": det,
                        "grads_differ": differ, "ok": p_ok}
        ok &= p_ok
    dens, d_ok = stage1_densify_card_vs_cpu()
    sh4, sh4_ok = sh_degree4_case(results)
    line = {"phase": "stage1_small", "ok": ok and d_ok and sh4_ok,
            "loss_rtol": S1_LOSS_RTOL, "grad_rel": S1_GRAD_REL,
            "phases": phases, "densify": dens, "sh_degree4": sh4}
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
            # the pairs the tracer's table drops in the stage-2 steps, as
            # the JAX package drops them (C3_SHARED_CAP): reported, not a
            # check
            "stage2_grid_overflow": max(
                (m.get("grid_overflow", 0) for m in log2), default=None),
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


def _mesh_stats(out_dir):
    """Vertex and triangle counts of the CLI's two PLYs, and the median
    vertex radius of fuse_post.ply."""
    import numpy as np
    from irgs_tpu_torch.utils import ply
    res = {}
    for name in ("fuse", "fuse_post"):
        el = ply.read_ply(os.path.join(out_dir, f"{name}.ply"))
        v = np.stack([el["vertex"].data[k] for k in "xyz"], -1)
        res[name] = {"verts": len(v), "tris": el["face"].count}
    res["median_radius"] = float(np.median(np.linalg.norm(v, axis=-1)))
    return res


def _analytic_mesh_card_vs_cpu():
    """extract_mesh on an analytic sphere volume (128³, tests/test_mesh.py's
    construction) and extract_mesh_unbounded on a sphere's analytic depth
    maps (12 views at 96², 64³), each on the card and on the CPU: the same
    triangles, and the vertices' largest difference."""
    import numpy as np
    import torch
    from irgs_tpu_torch.ops import tsdf as T
    from irgs_tpu_torch.scene import toy

    res, r = 128, 0.6
    voxel = 2.0 / res
    idx = (np.arange(res) + 0.5) * voxel - 1.0
    zz, yy, xx = np.meshgrid(idx, idx, idx, indexing="ij")
    d = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - r
    vol = [torch.tensor(np.clip(d / (5 * voxel), -1, 1).astype(np.float32)),
           torch.full((res,) * 3, 2.0), torch.full((3,), -1.0),
           torch.tensor(voxel, dtype=torch.float32)]
    depths, projs, centers = [], [], []
    for cam in toy.make_ring_cameras(12, radius=3.0, height=0.5, width=96,
                                     height_px=96):
        cp = cam.params("cpu")
        dirs = cp.ray_dirs(96, 96, normalize=True).numpy()
        o = cam.cam_pos.astype(np.float64)
        b = dirs @ o
        disc = b ** 2 - (o @ o - r ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0))
        depths.append(np.where(disc > 0, t * (dirs @ cam.w2c[2, :3]),
                               0.0).astype(np.float32))
        projs.append(cam.full_proj)
        centers.append(cam.cam_pos)
    centers = np.stack(centers)
    center = centers.mean(0)
    radius = float(np.linalg.norm(centers - center, axis=-1).min())
    xyz = np.random.RandomState(0).normal(size=(512, 3)).astype(np.float32)
    xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True) * r
    out, ok = {}, True
    for name, fn in (
            ("bounded_128", lambda dev: T.extract_mesh(T.TSDFVolume(
                *(x.to(dev) for x in vol)))),
            ("unbounded_64", lambda dev: T.extract_mesh_unbounded(
                torch.tensor(np.stack(depths), device=dev),
                torch.tensor(np.stack(projs), device=dev), xyz, center,
                radius, resolution=64))):
        (vc, fc), (vp, fp) = fn("cuda"), fn("cpu")
        same = fc.shape == fp.shape and bool(torch.equal(fc.cpu(), fp))
        err = float((vc.cpu() - vp).abs().max()) if same else None
        out[name] = {"tris": int(fp.shape[0]), "same_faces": same,
                     "max_abs_err": err}
        ok &= same and err <= 1e-6
    return out, ok


def phase_extract_mesh(results, tmp):
    """python -m irgs_tpu_torch.extract_mesh in-process on the run that
    train_stage1_cli leaves (8 views at 400x400, iteration 60), at
    --mesh_res 256, bounded and --unbounded: the seconds of its parts
    (fusion: the depth renders and the TSDF; marching tetrahedra; the weld;
    the clean-up; the two PLY writes), vertex and triangle counts, peak
    memory, launches; the forward blend held at the first depth render's
    inputs. Then --toy at the defaults (the unit sphere: median vertex
    radius within 0.05 of 1), and the analytic spheres card vs CPU."""
    import torch
    from irgs_tpu_torch.extract_mesh.__main__ import main as mesh_main
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.ops import tsdf as T
    from irgs_tpu_torch.render import ref_gaussian as rg
    from irgs_tpu_torch.train import stage1_full as s1
    from irgs_tpu_torch.utils import ply

    run = os.path.join(tmp, "stage1_run")
    if not os.path.isfile(os.path.join(run, "chkpnt60.ckpt")):
        fail("extract_mesh", "needs the run that train_stage1_cli leaves")
    parts = {"tsdf_fusion": (s1, "reconstruct_tsdf"),
             "depth_renders": (rg, "render_initial"),
             "unbounded_fusion": (T, "fuse_unbounded_tsdf"),
             "marching_tets": (T, "extract_mesh"),
             "weld": (T, "merge_vertices"),
             "post_process": (T, "post_process_mesh"),
             "write": (ply, "write_ply")}
    line, peaks = {"phase": "extract_mesh", "mesh_res": 256}, []
    reset_launch_counts()
    for mode in ("bounded", "unbounded"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = FirstCalls({"blend": (rb, "blend_tiles")})
        with rec, Timed(parts) as tm:
            t = time.perf_counter()
            mesh_main(["-m", run, "--mesh_res", "256",
                       *(["--unbounded"] if mode == "unbounded" else [])])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t
        peaks.append(torch.cuda.max_memory_allocated())
        sec = {k: sum(v) for k, v in tm.seconds.items()}
        # post_process_mesh welds again inside: the weld's first call is
        # fuse.ply's
        sec["weld"] = tm.seconds["weld"][0]
        line[mode] = {"cli_s": cli_s, "part_s": sec,
                      "calls": {k: len(v) for k, v in tm.seconds.items()},
                      "max_memory_allocated": peaks[-1],
                      **_mesh_stats(os.path.join(run, "mesh"))}
        if mode == "bounded":
            launches = dict(launch_counts())
            check_recorded(results, rec, "extract_mesh_400px")
            reset_launch_counts()
    launches = {k: v + launch_counts()[k] for k, v in launches.items()}
    results.setdefault("launches", {})["extract_mesh"] = launches
    toy_dir = os.path.join(tmp, "mesh_toy")
    torch.cuda.synchronize()
    t = time.perf_counter()
    mesh_main(["--toy", "-m", toy_dir])
    torch.cuda.synchronize()
    line["toy"] = {"cli_s": time.perf_counter() - t,
                   **_mesh_stats(os.path.join(toy_dir, "mesh"))}
    line["analytic_card_vs_cpu"], analytic_ok = _analytic_mesh_card_vs_cpu()
    line["launches"] = launches
    checks = {
        "meshes": all(line[m]["fuse_post"]["tris"] > 0
                      for m in ("bounded", "unbounded")),
        "toy_unit_sphere": abs(line["toy"]["median_radius"] - 1.0) < 0.05,
        "analytic_card_vs_cpu": analytic_ok,
        # one depth render a view, each one forward blend
        "blend_per_render": launches["blend_fwd"] == sum(
            line[m]["calls"]["depth_renders"] for m in ("bounded",
                                                        "unbounded")),
    }
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("extract_mesh", f"checks failed: {checks}")


# ---------------------------------------------------------------------------
# the tracer's options: test scale card against CPU, BENCH steps and
# EVAL frames

# tests/test_torch_tracer_options.py's scale: 96 surfels on a jittered unit
# sphere, 256 rays shot inward, a grid of 12 and 4 segments
OPTIONS_BASE = dict(grid_res=12, pair_capacity=2 ** 15, max_cells=8,
                    max_hits=24, hit_budget=16, max_crossings=10, span_cap=6,
                    n_segments=4, retrace_frac=0.25)
OPTIONS = {
    "candidates": dict(),
    "two_tier": dict(prefilter_width=96),
    "packed_tiled": dict(select_tiles=4, tile=32, tiled_direct=False),
    "bf16": dict(select_tiles=4, tile=32, tiled_direct=True, table_bf16=True),
    # forward only, as the reference's while_loop
    "retrace_while": dict(retrace_while=True, n_segments=8, retrace_bulk=1),
}
# card against CPU: the forward elementwise (a ray whose hit sits at a
# threshold may flip, so the share of elements outside the tolerance is
# bounded, as eval_small's), the gradients per field in units of max|g|
OPT_ATOL, OPT_RTOL, OPT_MAX_OUTLIER_SHARE, OPT_GRAD_REL = 1e-5, 1e-4, 0.01, 1e-3
# the training tracer's options at BENCH (from_pipe: 24 tiles of 32, max_hits
# 40), and the eval frame's iterative deepening
BENCH_OPTIONS = {
    "default": dict(),                   # the training tracer, as a baseline
    "select_tiles_0": dict(select_tiles=0),
    "select_tiles_0_prefilter_192": dict(select_tiles=0, prefilter_width=192),
    "tiled_direct_off": dict(tiled_direct=False),
    "table_bf16": dict(table_bf16=True),
}


def _option_inputs(seed=0, n=96, s=4, r=256):
    """tests/test_torch_tracer_options.py's make_inputs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    nrm = d / np.linalg.norm(d, axis=-1, keepdims=True)
    means = nrm * (1.0 + 0.15 * rng.standard_normal((n, 1)))
    tu = np.cross(nrm, rng.standard_normal((n, 3)))
    tu /= np.linalg.norm(tu, axis=-1, keepdims=True)
    tv = np.cross(nrm, tu)
    scales = np.exp(rng.uniform(-2.0, -1.2, (n, 2)))
    opac = 1.0 / (1.0 + np.exp(-(rng.standard_normal(n) + 1.5)))
    arrs = dict(means3d=means, opacity=opac, ru=tu / scales[:, :1],
                rv=tv / scales[:, 1:], normals=nrm,
                shs=0.3 * rng.standard_normal((n, 16, 3)),
                features=rng.uniform(size=(n, s)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    dirs = rng.standard_normal((r, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rd = dirs + 0.1 * rng.standard_normal((r, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return (arrs, scales.astype(np.float32), (-2.5 * dirs).astype(np.float32),
            rd.astype(np.float32))


def option_card_vs_cpu(over):
    """tests/test_torch_tracer_options.py's segmented trace with one option
    on the card and on the CPU: the forward, and (unless retrace_while) the
    gradients of a random linear functional -> its JSON fields and ok."""
    import numpy as np
    import torch
    from irgs_tpu_torch.ops import gather_rows as gr
    from irgs_tpu_torch.ops import grid_tracer as gt

    arrs, scales, ro, rd = _option_inputs()
    cfg = gt.TracerConfig(**dict(OPTIONS_BASE, **over))
    grad = not cfg.retrace_while
    fields = list(gt.TraceInputs._fields)
    rng = np.random.default_rng(3)
    r, s = ro.shape[0], arrs["features"].shape[1]
    cot = [rng.standard_normal(sh).astype(np.float32)
           for sh in [(r, 3), (r, 3), (r, s), (r,), (r,), (r,)]]
    res = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.tensor(arrs[k], device=dev, requires_grad=grad)
                  for k in fields]
        inp = gt.TraceInputs(*leaves)
        radius = gt.bounding_radius(inp.opacity.detach(),
                                    torch.tensor(scales, device=dev),
                                    cfg.alpha_min)
        grid = gt.build_grid(inp.means3d.detach(), radius,
                             torch.ones(len(scales), dtype=torch.bool,
                                        device=dev),
                             grid_res=cfg.grid_res,
                             pair_capacity=cfg.pair_capacity,
                             span_cap=cfg.span_cap,
                             normals=inp.normals.detach())
        gr.reset_launches()
        with torch.set_grad_enabled(grad):
            out = gt.trace_segments(torch.tensor(ro, device=dev),
                                    torch.tensor(rd, device=dev), grid, inp,
                                    cfg=cfg, sh_deg=3)
        grads = []
        if grad:
            loss = sum((a * torch.tensor(b, device=dev)).sum()
                       for a, b in zip(out, cot))
            grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        res[dev] = ([x.detach().cpu() for x in out], grads,
                    gr.LAUNCHES["gather_rows"])
    fwd, ok = {}, True
    for name, got, want in zip(gt.TraceOut._fields, res["cuda"][0],
                               res["cpu"][0]):
        d = (got - want).abs()
        share = float((d > OPT_ATOL + OPT_RTOL * want.abs()).float().mean())
        fwd[name] = {"max_abs_err": float(d.max()), "outlier_share": share}
        ok &= bool(torch.isfinite(got).all()) and share <= OPT_MAX_OUTLIER_SHARE
    grad_err = {}
    for name, got, want in zip(fields, res["cuda"][1], res["cpu"][1]):
        grad_err[name] = float((got - want).abs().max()
                               / max(float(want.abs().max()), 1e-12))
        ok &= grad_err[name] <= OPT_GRAD_REL
    tiled = cfg.select_tiles > 0
    ok &= (res["cuda"][2] > 0) == tiled and res["cpu"][2] == 0
    ok &= float(res["cpu"][0][4].max()) > 0.5          # rays hit surfels
    return {"forward": fwd, "grad_rel_err": grad_err,
            "gather_launches_cuda": res["cuda"][2]}, bool(ok)


def phase_tracer_options(results, n_timed=2):
    """Every tracer option at test scale, card against CPU (forward, and
    gradients where the option trains); one BENCH stage-2 step per training
    option, timed, the first one's gather held against its plain version at
    the bf16 table's shape; and one EVAL frame with retrace_while on against
    off (s/frame, rounds run, Mrays/s)."""
    import dataclasses
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.render.eval import render_ir_eval
    from irgs_tpu_torch.train import stage2 as s2

    small, ok = {}, True
    for name, over in OPTIONS.items():
        small[name], ok_i = option_card_vs_cpu(over)
        small[name]["ok"] = ok_i
        ok &= ok_i
    emit({"phase": "tracer_options", "part": "test_scale", "ok": ok,
          "atol": OPT_ATOL, "rtol": OPT_RTOL,
          "max_outlier_share": OPT_MAX_OUTLIER_SHARE,
          "grad_rel": OPT_GRAD_REL, "options": small})
    if not ok:
        fail("tracer_options", "an option on the card disagrees with the CPU")

    dev = torch.device("cuda")
    state, grid, cams, st = workload.stage2_setup(**workload.BENCH,
                                                  device=dev)
    cam_params = [c.params(dev) for c in cams]
    gt_img = torch.full((st.img_h, st.img_w, 3), 0.5, device=dev)
    gen = torch.Generator(dev).manual_seed(0)

    def step(st_v, i):
        nonlocal state
        draws = s2.draw_stage2(gen, st_v, dev)
        state, m = s2.stage2_step(state, grid, cam_params[i % len(cams)],
                                  gt_img, None, draws, st=st_v)
        return m

    bench = {}
    for name, over in BENCH_OPTIONS.items():
        st_v = dataclasses.replace(st, tracer=dataclasses.replace(st.tracer,
                                                                  **over))
        if name == "table_bf16":
            # the gather's first inputs: the bf16 table viewed as int32
            with FirstCalls({"gather": (gt, "gather_rows_kernel")},
                            clone=(1,)) as rec:
                step(st_v, 0)
            check_recorded(results, rec, "tracer_options_bf16")
            del rec
        else:
            step(st_v, 0)
        torch.cuda.synchronize()
        reset_launch_counts()                # count the main path only
        times, metrics = [], []
        for i in range(1, 1 + n_timed):
            a = time.perf_counter()
            m = step(st_v, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - a) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = launch_counts()
        for k, v in launches.items():
            results.setdefault("launches", {}).setdefault(
                "tracer_options", {}).setdefault(k, 0)
            results["launches"]["tracer_options"][k] += v
        bench[name] = {"tracer": over, "ms_per_step": statistics.median(times),
                       "ms_steps": times, "loss": metrics[-1]["loss"],
                       "trace_trunc_frac": metrics[-1].get("trace_trunc_frac"),
                       "trace_more_frac": metrics[-1].get("trace_more_frac"),
                       "launches_per_step": {k: v / n_timed
                                             for k, v in launches.items()},
                       "loss_finite": all(math.isfinite(m["loss"])
                                          for m in metrics)}
    del state, grid
    torch.cuda.empty_cache()

    params, aux, egrid, cam, ecfg = workload.eval_setup(**workload.EVAL,
                                                        device=dev)
    frames = {}
    body = gt._retrace_body
    for on in (False, True):
        cfg = dataclasses.replace(ecfg, tracer=dataclasses.replace(
            ecfg.tracer, retrace_while=on))
        caps = []
        gt._retrace_body = lambda *a, **k: (caps.append(a[9]),
                                            body(*a, **k))[1]
        try:
            stats = {}
            torch.cuda.synchronize()
            a = time.perf_counter()
            out = render_ir_eval(params, aux, egrid, cam, cfg,
                                 stats_out=stats)
            torch.cuda.synchronize()
            sec = time.perf_counter() - a
        finally:
            gt._retrace_body = body
        frames["on" if on else "off"] = {
            "s_per_frame": sec, "rounds_run": len(caps),
            # rounds by capacity: with retrace_while the tail's are the
            # smallest (retrace_tail_frac of a chunk's rays)
            "rounds_by_capacity": {str(c): caps.count(c)
                                   for c in sorted(set(caps))},
            "mrays_per_s": stats["shaded_rays"] / sec / 1e6,
            "trace_more_frac": stats.get("trace_more_frac"),
            "finite": all(bool(torch.isfinite(v).all()) for v in out.values()),
            "render": out["render"]}
    d = (frames["on"].pop("render") - frames["off"].pop("render")).abs()
    line = {"phase": "tracer_options", "part": "bench", "bench": bench,
            "eval_retrace_while": frames,
            "eval_render_max_abs_diff_on_off": float(d.max()),
            "eval_render_mean_abs_diff_on_off": float(d.mean()),
            "launches": results["launches"]["tracer_options"]}
    checks = {"bench_loss_finite": all(b["loss_finite"]
                                       for b in bench.values()),
              "eval_finite": all(f["finite"] for f in frames.values()),
              "retrace_rounds_ran": frames["on"]["rounds_run"] > 0}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("tracer_options", f"checks failed: {checks}")


# ---------------------------------------------------------------------------
# multi-device: one rank on the card over NCCL, and two ranks that
# share the card over gloo

# tests/test_parallel.py's scale: the toy sphere's 256 surfels, 32x32, the
# default (per-candidate) tracer at grid 16 and one segment
PAR_TRACER = dict(grid_res=16, pair_capacity=2 ** 14, max_cells=8,
                  max_hits=16, hit_budget=8)
PAR_RTOL, PAR_ATOL = 2e-4, 2e-5


def _par_small_frames(params, aux, cam, mesh):
    """The sample-sharded test-scale eval frame (16 diffuse + 8 light
    samples, all pixels) with `mesh`, as a dict of CPU arrays."""
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.render.eval import EvalConfig, render_ir_eval
    ecfg = EvalConfig(img_w=32, img_h=32, active_sh_degree=1,
                      diffuse_sample_num=16, light_sample_num=8,
                      dup_capacity=2 ** 12, tracer=gt.TracerConfig(**PAR_TRACER))
    grid = gt.build_grid_from_gaussians(params, aux, ecfg.tracer)
    out = render_ir_eval(params, aux, grid, cam, ecfg, mesh=mesh,
                         compact_fg=False)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _parallel_rank(mesh, device, out_dir):
    """One of the two ranks that share the card (gloo): the test-scale DP
    step (rank 0 also takes one process's mean of the two ranks' gradients),
    the test-scale sample-sharded eval frame (rank 0 also the one-rank
    frame), then one BENCH DP step, timed with its all_reduce."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import irgs_tpu_torch  # noqa: F401  (precision flags)
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.parallel import broadcast_params, stage2_dp_step
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.train import stage2 as s2

    r, out = mesh.rank, {}
    gen = torch.Generator().manual_seed(0)
    state, grid, cams, st = stage2_small_setup(device)
    draws = [s2.draw_stage2(gen, st, "cpu").to(device)
             for _ in range(mesh.size)]
    gts = [torch.full((64, 64, 3), 0.3 + 0.1 * q, device=device)
           for q in range(mesh.size)]
    state.step = 1001
    broadcast_params(mesh, state.params)
    state, m = stage2_dp_step(mesh, st)(state, grid, cams[r].params(device),
                                         gts[r], draws[r])
    out.update({f"dp_{k}": v.detach().cpu().numpy()
                for k, v in state.params.tensors().items()})
    out["dp_loss"] = float(m["loss"])
    if r == 0:
        ref = stage2_small_setup(device)[0]
        ref.step = 1001
        sums = {}
        for q in range(mesh.size):
            ref.optimizer.zero_grad()
            loss, _ = s2.stage2_forward_loss(
                ref.params, ref.aux, grid, cams[q].params(device), gts[q],
                None, draws[q], ref.step, st)
            loss.backward()
            for f, t in ref.params.tensors().items():
                if t.grad is not None:
                    sums[f] = t.grad.clone() if f not in sums else sums[f] + t.grad
        for f, t in ref.params.tensors().items():
            t.grad = sums[f] / mesh.size if f in sums else None
        ref.optimizer.step(ref.step)
        out.update({f"mean_{k}": v.detach().cpu().numpy()
                    for k, v in ref.params.tensors().items()})
    del state, grid

    params, aux = toy.make_sphere_scene(n_surface=256, n_capacity=512,
                                        env_resolution=16, device=device)
    cam = toy.make_ring_cameras(1, width=32, height_px=32)[0].params(device)
    out.update({f"sharded_{k}": v for k, v in
                _par_small_frames(params, aux, cam, mesh).items()})
    if r == 0:
        out.update({f"single_{k}": v for k, v in
                    _par_small_frames(params, aux, cam, None).items()})

    state, grid, cams, st = workload.stage2_setup(**workload.BENCH,
                                                  device=device)
    broadcast_params(mesh, state.params)
    step = stage2_dp_step(mesh, st)
    gen = torch.Generator(device).manual_seed(0)
    gt_img = torch.full((st.img_h, st.img_w, 3), 0.5, device=device)
    reduce_ms, all_reduce = [], dist.all_reduce

    def timed_all_reduce(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = all_reduce(t, *a, **kw)
        torch.cuda.synchronize()
        reduce_ms.append(((time.perf_counter() - t0) * 1e3, t.numel()))
        return res

    times = []
    dist.all_reduce = timed_all_reduce
    try:
        for i in range(3):
            d = [s2.draw_stage2(gen, st, device)
                 for _ in range(mesh.size)][r]
            torch.cuda.synchronize()
            a = time.perf_counter()
            state, m = step(state, grid, cams[r].params(device), gt_img, d)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - a) * 1e3)
    finally:
        dist.all_reduce = all_reduce
    out["bench_ms_steps"] = np.array(times)
    out["bench_all_reduce_ms"] = np.array([t for t, _ in reduce_ms])
    out["bench_all_reduce_numel"] = reduce_ms[-1][1]
    out["bench_loss"] = float(m["loss"])
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def phase_parallel(results, tmp):
    """(a) A one-rank NCCL world on the card: stage2_dp_step at BENCH
    equals the plain stage2_step bit for bit (the mean over one rank is the
    identity); three steps timed each way; the first DP step's launches are
    the path's. (b) Two ranks sharing the card
    over gloo (NCCL refuses two ranks on one device): the test-scale DP
    step equals one process's mean of the same two gradients, bit for bit,
    both ranks end with equal parameters, and the sample-sharded test-scale
    eval frame equals the one-rank frame within tests/test_parallel.py's
    tolerance. (c) The same world's BENCH DP step timed, with its
    all_reduce: two ranks sharing one card, not a scaling figure."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.parallel import Mesh, spawn_ranks, stage2_dp_step
    from irgs_tpu_torch.train import stage2 as s2

    dev = torch.device("cuda")
    runs, step_ms = {}, {}
    for name in ("plain", "dp"):
        state, grid, cams, st = workload.stage2_setup(**workload.BENCH,
                                                      device=dev)
        gen = torch.Generator(dev).manual_seed(0)
        gt_img = torch.full((st.img_h, st.img_w, 3), 0.5, device=dev)
        cam = cams[0].params(dev)
        if name == "plain":
            step = lambda state, d: s2.stage2_step(state, grid, cam, gt_img,
                                                   None, d, st=st)
        else:
            store = os.path.join(tmp, "nccl_store")
            dist.init_process_group("nccl", init_method="file://" + store,
                                    world_size=1, rank=0)
            # NCCL sets its communicator up at the first collective
            dist.all_reduce(torch.zeros(1, device=dev))
            dp = stage2_dp_step(Mesh(rank=0, size=1), st)
            step = lambda state, d: dp(state, grid, cam, gt_img, d)
        try:
            # three steps each way from the same state and draws; the
            # first's parameters are compared, the DP ones' launches kept
            times = []
            for i in range(3):
                draws = s2.draw_stage2(gen, st, dev)
                if name == "dp" and i == 0:
                    reset_launch_counts()    # count the main path only
                torch.cuda.synchronize()
                a = time.perf_counter()
                state, m = step(state, draws)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - a) * 1e3)
                if i == 0:
                    runs[name] = ({k: v.detach().clone()
                                   for k, v in state.params.tensors().items()},
                                  float(m["loss"]))
                    if name == "dp":
                        launches = launch_counts()
        finally:
            if name == "dp":
                dist.destroy_process_group()
        step_ms[name] = times
        del state, grid, step
    results.setdefault("launches", {})["parallel"] = launches
    one_rank_equal = {k: bool(torch.equal(v, runs["dp"][0][k]))
                      for k, v in runs["plain"][0].items()}
    losses = {k: v[1] for k, v in runs.items()}
    del runs
    torch.cuda.empty_cache()

    out_dir = os.path.join(tmp, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    a = time.perf_counter()
    spawn_ranks(_parallel_rank, ["cuda:0", "cuda:0"], "gloo",
                args=(out_dir,))
    world_s = time.perf_counter() - a
    w = [dict(np.load(os.path.join(out_dir, f"rank{q}.npz")))
         for q in range(2)]
    fields = [k[3:] for k in w[0] if k.startswith("dp_") and k != "dp_loss"]
    mean_equal = {f: bool(np.array_equal(w[0]["dp_" + f], w[0]["mean_" + f]))
                  for f in fields}
    ranks_equal = {f: bool(np.array_equal(w[0]["dp_" + f], w[1]["dp_" + f]))
                   for f in fields}
    frame_err, frame_ok = {}, True
    for k in (k[7:] for k in w[0] if k.startswith("single_")):
        want = w[0]["single_" + k]
        for q in range(2):
            got = w[q]["sharded_" + k]
            frame_ok &= bool(np.allclose(got, want, rtol=PAR_RTOL,
                                         atol=PAR_ATOL))
        frame_err[k] = float(np.abs(w[0]["sharded_" + k] - want).max())
    line = {"phase": "parallel",
            "one_rank_nccl": {"dp_step_ms": step_ms["dp"],
                              "plain_step_ms": step_ms["plain"],
                              "launches": launches,
                              "loss_plain": losses["plain"],
                              "loss_dp": losses["dp"]},
            "two_ranks_sharing_one_card": {
                "backend": "gloo", "world_s": world_s,
                "bench_dp_step_ms": w[0]["bench_ms_steps"].tolist(),
                "bench_all_reduce_ms": w[0]["bench_all_reduce_ms"].tolist(),
                "bench_all_reduce_numel": int(w[0]["bench_all_reduce_numel"]),
                "bench_loss": float(w[0]["bench_loss"]),
                "small_dp_loss": float(w[0]["dp_loss"]),
                "sharded_frame_max_abs_err": frame_err,
                "rtol": PAR_RTOL, "atol": PAR_ATOL}}
    checks = {"one_rank_nccl_equals_plain_bitwise": all(one_rank_equal.values()),
              "two_rank_step_equals_mean_bitwise": all(mean_equal.values()),
              "ranks_end_equal": all(ranks_equal.values()),
              "sharded_frame_matches_one_rank": frame_ok,
              "kernels_launched": all(v > 0 for v in launches.values())}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("parallel", f"checks failed: {checks} (one rank: "
             f"{one_rank_equal}, mean: {mean_equal}, ranks: {ranks_equal})")


JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
PNG_FIXTURES = os.path.join(ROOT, "tests", "data", "png")
PI_FIXTURES = os.path.join(ROOT, "tests", "data", "process_images")
# the TIFF, BMP, GIF and WebP fixtures: format -> extension
CONTAINER_FIXTURES = {"tiff": ".tif", "bmp": ".bmp", "gif": ".gif",
                      "webp": ".webp"}
# re-saves that carry another fixture's coefficients, and so its array
# (tests/make_jpeg_fixtures.py ARRAY_OF)
JPEG_ARRAY_OF = {"large_1297x840_q95_progressive": "large_1297x840_q95",
                 "large_1297x840_q95_arith": "large_1297x840_q95"}
# the root process_images.py crop arguments of the committed outputs
# (tests/make_png_fixtures.py CROP_ARGS)
PI_CROP_ARGS = ["--downscale", "2", "--crop", "-2", "1", "3", "-2"]


def jpeg_fixtures_exact():
    """name -> (decoded bit for bit with its .npy, mode) for every committed
    JPEG fixture; the mode must agree with the array's channels."""
    import glob

    import numpy as np
    from irgs_tpu_torch.utils import jpeg
    out = {}
    for path in sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg"))):
        name = os.path.basename(path)[:-4]
        want = np.load(os.path.join(JPEG_FIXTURES, JPEG_ARRAY_OF.get(
            name, name) + ".npy"))
        got, mode, _ = jpeg.read_jpeg_like_pil(path)
        chans = {"L": 2, "RGB": 3, "CMYK": 4}[mode]
        out[name] = (got.shape == want.shape
                     and bool(np.array_equal(got, want))
                     and (got.ndim if mode == "L" else got.shape[-1])
                     == chans, mode)
    return out


def container_fixtures_exact():
    """Every committed TIFF, BMP, GIF and WebP fixture through the
    content-sniffing reader (utils/image.read_image_like_pil) -> ({"fmt/name":
    array, mode, palette and transparency equal to PIL's}, {"fmt/name" of a
    refused stream: the format's reader raised its own error, naming what
    is not ported where PIL reads the stream})."""
    import numpy as np
    from irgs_tpu_torch.utils import bmp, gif, image, tiff, webp
    readers = {"tiff": (tiff.read_tiff_like_pil, tiff.TiffError),
               "bmp": (bmp.read_bmp_like_pil, bmp.BmpError),
               "gif": (gif.read_gif_like_pil, gif.GifError),
               "webp": (webp.read_webp_like_pil, webp.WebpError)}
    exact, refused = {}, {}
    for fmt, ext in CONTAINER_FIXTURES.items():
        folder = os.path.join(ROOT, "tests", "data", fmt)
        with open(os.path.join(folder, "modes.json")) as f:
            modes = json.load(f)
        for name, want in modes.items():
            arr, mode, info = image.read_image_like_pil(
                os.path.join(folder, name + ext))
            npy = np.load(os.path.join(folder, name + ".npy"))
            ok = (mode == want["mode"] and arr.dtype == npy.dtype
                  and arr.shape == npy.shape
                  and bool(np.array_equal(arr, npy,
                                          equal_nan=arr.dtype.kind == "f"))
                  and info.get("transparency") == want["transparency"])
            if want["palette"] is not None and mode in ("P", "PA"):
                pal = np.asarray(want["palette"]).reshape(-1, 3)
                got = np.asarray(info["palette"])
                ok = ok and bool(np.array_equal(got, pal[:len(got)]))
            exact[f"{fmt}/{name}"] = ok
        with open(os.path.join(folder, "refused", "refused.json")) as f:
            notes = json.load(f)
        read, error = readers[fmt]
        for name, why in notes.items():
            try:
                read(os.path.join(folder, "refused", name + ext))
                refused[f"{fmt}/{name}"] = False
            except error as e:
                refused[f"{fmt}/{name}"] = why is None or "not ported" in str(e)
    return exact, refused


def mislabelled_read_by_content(tmp):
    """A JPEG named .png and .jfif and a PNG named .jpg through
    datasets._load_image_any -> {case: equal to the fixture's array / 255}."""
    import shutil

    import numpy as np
    from irgs_tpu_torch.scene.datasets import _load_image_any
    out = {}
    for case, (src, dst) in {
            "jpeg_as_png": ("jpeg/adobe_rgb_q90_17x9.jpg", "a.png"),
            "jpeg_as_jfif": ("jpeg/adobe_rgb_q90_17x9.jpg", "a.jfif"),
            "png_as_jpg": ("png/ct2_d8.png", "b.jpg")}.items():
        path = os.path.join(tmp, dst)
        shutil.copy(os.path.join(ROOT, "tests", "data", src), path)
        want = np.load(os.path.join(ROOT, "tests", "data",
                                    src.rsplit(".", 1)[0] + ".npy"))
        got = _load_image_any(path)
        out[case] = bool(np.array_equal(got, np.asarray(want, np.float32)
                                        / 255.0))
    return out


# .hdr headers and what cv2.imread does with them (checked against cv2
# where the tests run): True reads, False refuses
HDR_HEADERS_CV2 = {
    "radiance": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n", True),
    "rgbe": (b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n", True),
    "other_magic": (b"#?FOO\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n", False),
    "no_format": (b"#?RADIANCE\nEXPOSURE=1\n\n-Y 5 +X 12\n", False),
    "crlf": (b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 5 +X 12\r\n",
             False),
    "resolution_junk": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                        b"-Y 5 +X 12 junk\n", True),
}


def hdr_headers_as_cv2(tmp):
    """Each HDR_HEADERS_CV2 header before 5x12 flat RGBE pixels -> {case:
    taken or refused as cv2 does, and what is taken decoded as rgbe.c
    decodes it}."""
    import numpy as np
    from irgs_tpu_torch.utils import hdr
    rgbe = np.random.default_rng(3).integers(1, 256, (5, 12, 4), np.uint8)
    rgbe[..., 0] = 1
    e = rgbe[..., 3].astype(np.int32)
    want = rgbe[..., :3].astype(np.float32) * np.ldexp(
        np.float32(1.0), e - 136).astype(np.float32)[..., None]
    out = {}
    for case, (head, reads) in HDR_HEADERS_CV2.items():
        path = os.path.join(tmp, case + ".hdr")
        with open(path, "wb") as f:
            f.write(head + rgbe.tobytes())
        try:
            got = hdr.read_hdr(path)
            out[case] = reads and bool(np.array_equal(got, want))
        except hdr.HdrError:
            out[case] = not reads
    return out


def container_decode_ms(frame, tmp):
    """An 840x1297 RGB frame written as TIFF at each compression (strips of
    8 rows, predictor 2 where the codec takes one), as 24-bit BMP and, its
    red channel as indices, as an interlaced GIF, by tests/image_streams.py
    -> ({file: median ms of the port's reader}, {file: all ms}, {file:
    decoded equal to the source}, {file: bytes})."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import image_streams as ims
    from irgs_tpu_torch.utils import image
    frame = np.ascontiguousarray(frame[:840, :1297])
    files = {}
    for comp, pred in (("none", 1), ("packbits", 1), ("lzw", 1), ("lzw", 2),
                       ("adobe_deflate", 2), ("deflate", 2)):
        files[f"tiff_{comp}_p{pred}"] = (ims.write_tiff(
            frame, photometric=2, bits=8, compression=comp, predictor=pred,
            layout=("strips", 8)), frame)
    files["bmp_24"] = (ims.write_bmp(frame, bits=24), frame)
    pal = np.random.default_rng(1).integers(0, 256, (256, 3))
    files["gif_interlaced"] = (ims.write_gif(frame[..., 0],
                                             global_palette=pal,
                                             interlace=True), frame[..., 0])
    ms, ms_all, equal, sizes = {}, {}, {}, {}
    for name, (data, src) in files.items():
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        ms[name], ms_all[name] = _median_ms(
            lambda: image.read_image_like_pil(path))
        equal[name] = bool(np.array_equal(image.read_image_like_pil(path)[0],
                                          src))
        sizes[name] = len(data)
    return ms, ms_all, equal, sizes


WEBP_FIXTURES = os.path.join(ROOT, "tests", "data", "webp")


def large_frames_ms(fmt="webp", ext=".webp"):
    """The committed large frames of tests/data/<fmt>/large/ (three
    1297x840 WebP; four TIFF) -> ({name: median ms of 5 decodes}, {name: all
    ms}, {name: mode, shape and SHA-256 of the array equal to PIL's (bool
    as 0/1 bytes)}, {name: bytes})."""
    import hashlib

    import numpy as np
    folder = os.path.join(ROOT, "tests", "data", fmt, "large")
    from irgs_tpu_torch.utils import image
    with open(os.path.join(folder, "large.json")) as f:
        want = json.load(f)
    ms, ms_all, equal, sizes = {}, {}, {}, {}
    for name, w in want.items():
        path = os.path.join(folder, name + ext)
        arr, mode, _ = image.read_image_like_pil(path)
        vals = arr.astype(np.uint8) if arr.dtype == bool else arr
        equal[name] = (mode == w["mode"] and list(arr.shape) == w["shape"]
                       and hashlib.sha256(np.ascontiguousarray(
                           vals).tobytes()).hexdigest() == w["sha256"])
        ms[name], ms_all[name] = _median_ms(
            lambda: image.read_image_like_pil(path))
        sizes[name] = os.path.getsize(path)
    return ms, ms_all, equal, sizes


def _render_frames(params, aux, cams, spp):
    """Each camera's render_ir_eval frame at `spp` diffuse samples on a
    black background -> [(rgb, alpha) uint8 numpy] (alpha [H, W])."""
    import numpy as np
    import torch
    from irgs_tpu_torch.config import Config
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.render.eval import EvalConfig, render_ir_eval

    dev = params.xyz.device
    ecfg = EvalConfig(img_w=cams[0].width, img_h=cams[0].height,
                      diffuse_sample_num=spp, light_sample_num=0,
                      white_background=False,
                      tracer=gt.TracerConfig.from_pipe(Config().pipe,
                                                       eval=True))
    grid = gt.build_grid_from_gaussians(params, aux, ecfg.tracer)
    out = []
    for cam in cams:
        o = render_ir_eval(params, aux, grid, cam.params(dev), ecfg)
        to8 = lambda x: (x.clamp(0, 1).cpu().numpy() * 255 + 0.5).astype(
            np.uint8)
        out.append((to8(o["render"]), to8(o["rend_alpha"][..., 0])))
    return out


def write_colmap_dataset(root, params, aux, n_views, res, offset):
    """A COLMAP folder of the sphere: `n_views` ring views rendered at
    res² and saved as captures are, JPEG at PIL's defaults (the port's
    encoder, utils/jpeg_encode.py), through a PINHOLE camera whose principal
    point sits
    `offset` pixels right of and below the centre; points3D.bin holds the
    live surfels' centres."""
    import numpy as np
    from irgs_tpu_torch.scene import colmap
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.scene.cameras import Camera
    from irgs_tpu_torch.utils import jpeg_encode

    ring = toy.make_ring_cameras(n_views, width=res, height_px=res)
    f = res / (2 * math.tan(ring[0].fovx / 2))
    K = np.array([[f, 0, res / 2 + offset], [0, f, res / 2 + offset],
                  [0, 0, 1]], np.float32)
    cams = [Camera(c.uid, c.R, c.T, fovx=c.fovx, fovy=c.fovy, width=res,
                   height=res, K=K) for c in ring]
    os.makedirs(os.path.join(root, "images"))
    images = []
    for i, (cam, (rgb, _)) in enumerate(zip(cams, _render_frames(
            params, aux, cams, spp=8))):
        name = f"view_{i:03d}.jpg"
        jpeg_encode.write_jpeg(os.path.join(root, "images", name), rgb)
        images.append(dict(id=i + 1, qvec=colmap.rotmat2qvec(cam.R.T),
                           tvec=cam.T, camera_id=1, name=name))
    alive = aux.alive.cpu().numpy()
    xyz = params.xyz.detach().cpu().numpy()[alive]
    colmap.write_model(os.path.join(root, "sparse", "0"),
                       [dict(id=1, model="PINHOLE", width=res, height=res,
                             params=[f, f, res / 2 + offset,
                                     res / 2 + offset])],
                       images, xyz, np.full((len(xyz), 3), 128, np.uint8))


def write_orb_dataset(root, params, aux, n_views, res, up):
    """A Stanford-ORB folder of the sphere: `n_views` ring views rendered at
    res² and stored at (up·res)² (each pixel repeated up x up) as RGB PNG
    frames, with their alpha as separate grey PNG masks; the same views as
    the test split; the live surfels' centres as points3d.ply."""
    import numpy as np
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.utils import png
    from irgs_tpu_torch.utils.ply import write_ply

    cams = toy.make_ring_cameras(n_views, width=res, height_px=res)
    for split in ("train", "test", "train_mask", "test_mask"):
        os.makedirs(os.path.join(root, split))
    frames = []
    for i, (cam, (rgb, a)) in enumerate(zip(cams, _render_frames(
            params, aux, cams, spp=8))):
        big = lambda x: np.repeat(np.repeat(x, up, 0), up, 1)
        for split in ("train", "test"):
            png.write_png(os.path.join(root, split, f"{i:04d}.png"), big(rgb))
            png.write_png(os.path.join(root, f"{split}_mask", f"{i:04d}.png"),
                          big(a))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = cam.R, cam.cam_pos
        c2w[:3, 1:3] *= -1                  # COLMAP -> Blender axes
        frames.append(c2w)
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": cams[0].fovx, "frames": [
                {"file_path": f"./{split}/{i:04d}",
                 "transform_matrix": m.tolist()}
                for i, m in enumerate(frames)]}, f)
    xyz = params.xyz.detach().cpu().numpy()[aux.alive.cpu().numpy()]
    v = np.zeros(len(xyz), [("x", "f4"), ("y", "f4"), ("z", "f4")])
    v["x"], v["y"], v["z"] = xyz.T
    write_ply(os.path.join(root, "points3d.ply"), v)


def _run_checks(log, launches, need=("blend_fwd", "blend_bwd", "gather_rows",
                                     "segment_sum")):
    return {"loss_finite": all(math.isfinite(m["loss"]) for m in log
                               if "loss" in m),
            "raster_overflow_zero": all(m.get("raster_overflow", 0) == 0
                                        for m in log),
            "grid_overflow_zero": all(m.get("grid_overflow", 0) == 0
                                      for m in log),
            "kernels_launched": all(launches.get(k, 0) > 0 for k in need)}


# the stage-1 CLI's 20-iteration schedule on the Stanford-ORB folder:
# initial to 4, volume to 10, surfel after, indirect from 15 on a 128³ TSDF
# refreshed every 7 iterations, densifications at 5 and 10
ORB_STAGE1 = ["--iterations", "20", "--init_until_iter", "4",
              "--volume_render_until_iter", "10", "--indirect_from_iter", "14",
              "--densify_from_iter", "3", "--densification_interval", "5",
              "--opacity_reset_interval", "15", "--normal_prop_interval", "8",
              "--mesh_interval", "7", "--mesh_res", "128",
              "--dup_capacity", str(2 ** 21), "--max_gaussians", str(2 ** 17)]


# the ring views of the datasets phase's COLMAP and Stanford-ORB folders
# (cut in depth from 8)
DATASET_VIEWS = 4


def phase_datasets(results, tmp):
    """The dataset readers on the card's machine (no PIL, no cv2): the
    committed JPEG fixtures bit for bit; a COLMAP folder (DATASET_VIEWS ring
    views of the BENCH sphere at 600², PINHOLE with the principal point 7 px
    off centre, its 100k surfel centres as points3D.bin) through python -m
    irgs_tpu_torch.train at --resolution 400 (a fractional INTER_AREA) for
    20 iterations at BENCH's budgets; a Stanford-ORB folder (DATASET_VIEWS
    views of 2048² PNG frames and masks, resized to 512, the surfel centres
    as points3d.ply: from the reader's random init, 20 stage-1 steps leave
    surfels that overflow the tracer's pair table in stage 2, an open
    fault, ROADMAP.md C) through python -m irgs_tpu_torch.train_refgaussian
    for 20 iterations and 3 stage-2 iterations from its checkpoint."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.scene import datasets as ds
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.train_refgaussian.__main__ import main as s1_main
    from irgs_tpu_torch.utils import jpeg

    dev = torch.device("cuda")
    # 1. the JPEG fixtures, bit for bit (the first decode builds the
    # entropy decoder with g++)
    a = time.perf_counter()
    jpeg.read_jpeg(os.path.join(JPEG_FIXTURES, "s420_q95_opt_1x1.jpg"))
    build_s = time.perf_counter() - a
    exact = {name: ok for name, (ok, _) in jpeg_fixtures_exact().items()}
    large = os.path.join(JPEG_FIXTURES, "large_1297x840_q95.jpg")
    decode_ms = []
    for _ in range(5):
        a = time.perf_counter()
        jpeg.read_jpeg(large)
        decode_ms.append((time.perf_counter() - a) * 1e3)

    # 2-3. COLMAP at 600², trained at 400²
    b = workload.BENCH
    params, aux = toy.make_sphere_scene(n_surface=b["n_surface"],
                                        n_capacity=b["n_capacity"],
                                        env_resolution=128, device=dev)
    a = time.perf_counter()
    colmap_dir = os.path.join(tmp, "colmap_sphere")
    write_colmap_dataset(colmap_dir, params, aux, DATASET_VIEWS, 600, 7.0)
    colmap_data_s = time.perf_counter() - a
    a = time.perf_counter()
    info = ds.load_scene(colmap_dir, eval_split=False, resolution=400)
    colmap_load_s = time.perf_counter() - a
    cam0 = info.train_cameras[0]
    colmap_cam = {"width": cam0.width, "height": cam0.height,
                  "cx": cam0.cx, "cy": cam0.cy, "fx": cam0.fx,
                  "n_points": int(len(info.points))}
    del info
    run = os.path.join(tmp, "colmap_run")
    with StepMeter() as meter, FirstCalls(
            {"blend": (rb, "blend_tiles"),
             "gather": (gt, "gather_rows_kernel")}, clone=(1,)) as rec, \
            LargestScatter() as scat:
        launches, colmap_s = run_cli(
            ["-s", colmap_dir, "-m", run, "--resolution", "400",
             "--iterations", "20", "--checkpoint_interval", "0",
             "--vis_interval", "0", *CLI_BENCH])
    log = list(read_log(run).values())
    colmap_steps = [st["ms"] for st in meter.steps[1:]]
    colmap_line = {
        "cli_s": colmap_s, "data_s": colmap_data_s, "load_s": colmap_load_s,
        "camera": colmap_cam, "ms_per_step_median": statistics.median(
            colmap_steps),
        "step_max_memory_allocated": max(st["peak"] for st in meter.steps),
        "run_max_memory_allocated": meter.run_peak, "launches": launches,
        "log": log}
    colmap_checks = _run_checks(log, launches)
    colmap_checks["fractional_400"] = (colmap_cam["width"],
                                       colmap_cam["height"]) == (400, 400)
    colmap_checks["k_off_centre"] = abs(colmap_cam["cx"] - 200 - 7 / 1.5) \
        < 1e-3
    colmap_checks["frames_port_jpeg"] = sorted(os.listdir(os.path.join(
        colmap_dir, "images"))) == [f"view_{i:03d}.jpg"
                                    for i in range(DATASET_VIEWS)]
    check_recorded(results, rec, "colmap_400px_100k")
    check_scatter(results, scat, "colmap_largest")
    del rec, scat, params, aux

    # 4. Stanford-ORB at 2048², read at 512
    params, aux = toy.make_sphere_scene(n_surface=b["n_surface"],
                                        n_capacity=b["n_capacity"],
                                        env_resolution=128, device=dev)
    a = time.perf_counter()
    orb_dir = os.path.join(tmp, "StanfordORB", "sphere")
    write_orb_dataset(orb_dir, params, aux, DATASET_VIEWS, 512, 4)
    orb_data_s = time.perf_counter() - a
    del params, aux
    a = time.perf_counter()
    info = ds.load_scene(orb_dir, eval_split=True)
    orb_load_s = time.perf_counter() - a
    orb_shape = list(info.train_cameras[0].image.shape)
    orb_mask = float(info.train_cameras[0].mask.mean())
    del info
    run1 = os.path.join(tmp, "orb_stage1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    a = time.perf_counter()
    with Stage1StepMeter() as s1meter, FirstCalls(
            {"blend": (rb, "blend_tiles")}) as rec1, \
            LargestScatter() as scat1:
        s1_main(["-s", orb_dir, "-m", run1, "--eval", *ORB_STAGE1])
    torch.cuda.synchronize()
    orb_s1_s = time.perf_counter() - a
    s1_launches = launch_counts()
    s1_peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(run1, "train_log.jsonl")) as f:
        log1 = [json.loads(x) for x in f]
    check_recorded(results, rec1, "orb_512px_100k")
    check_scatter(results, scat1, "orb_stage1_largest")
    del rec1, scat1
    run2 = os.path.join(tmp, "orb_stage2")
    with StepMeter() as meter2, FirstCalls(
            {"gather": (gt, "gather_rows_kernel")}, clone=(1,)) as rec2:
        s2_launches, orb_s2_s = run_cli(
            ["-s", orb_dir, "-m", run2, "--start_checkpoint_refgs", run1,
             "--iterations", "3", "--vis_interval", "0", "--eval",
             *CLI_BENCH, "--dup_capacity", str(2 ** 21)])
    log2 = list(read_log(run2).values())
    check_recorded(results, rec2, "orb_stage2_512px")
    del rec2
    orb_launches = {k: s1_launches.get(k, 0) + s2_launches.get(k, 0)
                    for k in set(s1_launches) | set(s2_launches)}
    by_phase = {}
    for stp in s1meter.steps[1:]:
        by_phase.setdefault(stp["phase"], []).append(stp["ms"])
    orb_line = {
        "stage1_s": orb_s1_s, "stage2_s": orb_s2_s, "data_s": orb_data_s,
        "load_s": orb_load_s, "image_shape": orb_shape,
        "mask_mean": orb_mask,
        "stage1_ms_per_step_by_phase": {k: statistics.median(v)
                                        for k, v in by_phase.items()},
        "stage1_max_memory_allocated": s1_peak,
        "stage2_ms_per_step": [st["ms"] for st in meter2.steps],
        "stage2_max_memory_allocated": meter2.run_peak,
        "stage1_launches": s1_launches, "stage2_launches": s2_launches,
        "stage1_log_final": log1[-1], "stage2_log": log2}
    orb_checks = _run_checks(log1 + log2, orb_launches)
    orb_checks["resized_512"] = orb_shape == [512, 512, 3]
    orb_checks["every_phase"] = set(by_phase) == {
        "initial", "volume", "surfel", "surfel_indirect"}
    orb_checks["stage2_bridged"] = os.path.exists(
        os.path.join(run2, "chkpnt3.ckpt"))

    launches_all = {k: launches.get(k, 0) + orb_launches.get(k, 0)
                    for k in set(launches) | set(orb_launches)}
    results.setdefault("launches", {})["datasets"] = launches_all
    train_cli = results.get("train_cli_line", {})
    line = {"phase": "datasets", "c3_shared_cap": C3_SHARED_CAP,
            "jpeg": {"fixtures": len(exact), "build_and_first_s": build_s,
                     "large_1297x840_ms": decode_ms,
                     "large_ms_median": statistics.median(decode_ms)},
            "colmap": colmap_line, "stanford_orb": orb_line,
            "launches": launches_all,
            "train_cli_ms_per_step_median_51_100": train_cli.get(
                "ms_per_step_median_51_100"),
            "train_cli_step_max_memory_allocated": train_cli.get(
                "step_max_memory_allocated")}
    checks = {"jpeg_bit_for_bit": bool(exact) and all(exact.values()),
              **{f"colmap_{k}": v for k, v in colmap_checks.items()},
              **{f"orb_{k}": v for k, v in orb_checks.items()}}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("datasets", f"checks failed: {checks} "
             f"(jpeg: {[k for k, v in exact.items() if not v]})")


# run_e2e at the dataset's full width (400², 256 + 128 GT samples), cut in
# depth to stay near 100 s on the card: 8 + 2 views, radiosity textures
# 128² / 64 x 128 at 128 + 64 samples, a 20k-point cloud on the analytic
# surfaces as the init (C3_SHARED_CAP), 50 stage-1 iterations (the
# indirect phase for the last 20, its TSDF at 128³), 50 stage-2 iterations
# at dup 2^21 (the first and the last are logged: the CLI logs iteration 1
# and every 50th), the evals at 32 + 16 samples on one view each.
#
# Why the datasets and e2e phases start from surface clouds: a short stage 1
# from the readers' 100k random points leaves surfels whose cell pairs
# overflow the tracer's 2^21 pair table in stage 2, in the JAX package as in
# the port (the same 21-bit CSR start in cell_meta, the same pair_capacity,
# the same dropped pairs and grid_overflow count): ROADMAP.md C3, shared,
# with the counts of earlier chip runs
C3_SHARED_CAP = {
    "shared_with_jax_package": True,
    "pair_capacity": 2 ** 21,
    "overflow_from_random_100k_init": {
        "C1_datasets_stanford_orb_stage2": 1_935_831,
        "C2_e2e_stage2_200_stage1_steps": 283_095,
        "R2_train_stage1_cli_stage2_60_stage1_steps": 1_923_179},
    "source": "PERF.md section 6 (chip runs C1, C2, R2)"}
E2E_SMOKE = ["--img", "400", "--ds_spp", "256", "128", "--n_train", "8",
             "--n_test", "2", "--ds_grid", "128", "64", "--ds_rad_spp", "128",
             "64", "--s1_iters", "50", "--s1_indirect_tail", "20",
             "--s2_iters", "50", "--eval_spp", "32", "16",
             "--max_eval_images", "1", "--relight_images", "1",
             "--stage_args", "dataset=--points 20000",
             "--stage_args", "stage1=--mesh_res 128",
             "--stage_args", f"stage2=--dup_capacity {2 ** 21}"]
# the kernels whose first inputs each training stage records (FirstCalls)
# and holds against their plain versions
E2E_HELD = {"stage1": ("blend",), "stage2": ("blend", "gather")}


def phase_e2e(results, tmp):
    """tools/run_e2e on the card (E2E_SMOKE): the analytic dataset, stage 1,
    stage 2 from its checkpoint and the NVS, material and relighting evals,
    each stage's CLI main(argv) run in this process (run_e2e.run_in_process)
    from launch counts at 0. After each training stage, its first blend and
    gather inputs and its largest scatter-add are held against the plain
    versions (cases e2e_stage1_400px, e2e_stage2_400px)."""
    import torch
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    from irgs_tpu_torch.tools import run_e2e

    targets = {"blend": (rb, "blend_tiles"),
               "gather": (gt, "gather_rows_kernel")}
    by_stage, peak = {}, {}

    def run_stage(tag, module, argv, timeout):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        held = E2E_HELD.get(tag, ())
        with FirstCalls({k: targets[k] for k in held}, clone=(1,)) as rec, \
                LargestScatter() as scat:
            rc = run_e2e.run_in_process(tag, module, argv, timeout)
        torch.cuda.synchronize()
        by_stage[tag] = launch_counts()
        peak[tag] = torch.cuda.max_memory_allocated()
        if held and rc == 0:
            check_recorded(results, rec, f"e2e_{tag}_400px")
            check_scatter(results, scat, f"e2e_{tag}_largest")
        return rc

    root = os.path.join(tmp, "e2e")
    res = os.path.join(tmp, "e2e_results")
    a = time.perf_counter()
    try:
        run_e2e.main(["--root", root, "--results", res, "--device", "cuda",
                      *E2E_SMOKE], run_stage=run_stage)
        stopped = None
    except SystemExit as e:
        stopped = str(e)
    wall = time.perf_counter() - a
    sp = os.path.join(res, "summary.json")
    summary = json.load(open(sp)) if os.path.exists(sp) else {}
    launches = {}
    for counts in by_stage.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    results.setdefault("launches", {})["e2e"] = launches
    log = summary.get("stage2_log", [])
    psnr = {}
    for name in ("nvs_results", "material_results", "relighting_results"):
        psnr[name] = {k: v for k, v in summary.get(name, {}).items()
                      if "psnr" in k and isinstance(v, (int, float))}
    meta = summary.get("dataset_meta", {})
    line = {"phase": "e2e", "c3_shared_cap": C3_SHARED_CAP,
            "wall_s": wall, "stopped": stopped,
            "stage_s": summary.get("timings_s"),
            "stage_rc": summary.get("rc"), "psnr": psnr,
            "stage2_ray_psnr": {m["iter"]: m.get("ray_psnr") for m in log},
            "stage2_loss": {m["iter"]: m.get("loss") for m in log},
            "dataset_timings_s": meta.get("timings_s"),
            "dataset_peak_mem_bytes": meta.get("peak_mem_bytes"),
            "stage_max_memory_allocated": peak,
            "launches": launches, "launches_by_stage": by_stage}
    checks = {
        "every_stage_rc_0": stopped is None and summary.get("rc") == {
            k: 0 for k in run_e2e.STAGES},
        "eval_psnr_finite": all(v and all(math.isfinite(x)
                                          for x in v.values())
                                for v in psnr.values()),
        "ray_psnr_rises": len(log) >= 2 and log[-1]["ray_psnr"]
        > log[0]["ray_psnr"],
        "loss_finite": bool(log) and all(math.isfinite(m["loss"])
                                         for m in log),
        "raster_overflow_zero": bool(log) and all(
            m.get("raster_overflow", 0) == 0 for m in log),
        "grid_overflow_zero": bool(log) and all(
            m.get("grid_overflow", 0) == 0 for m in log),
        "kernels_launched": all(launches.get(k, 0) > 0 for k in (
            "blend_fwd", "blend_bwd", "gather_rows", "segment_sum"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("e2e", f"checks failed: {checks}")


# ---------------------------------------------------------------------------
# the bench, oracle and drive tools (each run in this process through its
# main, so that the launch counters and the kernels' first inputs are read)

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "hbm_util",
              "flops_per_step", "bytes_per_step"}
BENCH_STAGE1_KEYS = {"stage1_initial_iters_per_sec",
                     "stage1_volume_iters_per_sec",
                     "stage1_surfel_iters_per_sec", "stage1_densify_ms",
                     "stage1_tsdf_refresh_s"}
BENCH_FRAME_KEYS = {"frame_img", "fg_pixels", "rays_per_frame", "cold_s",
                    "warm_s", "mrays_per_sec"}
# bench_frame at its full width, its samples cut (a cut of depth): the
# defaults' 512 + 256 take ~290 s a frame (PERF.md records one such run),
# 64 + 32 ~35 s and 32 + 16 ~20 s: the cold and the warm frame at 16 + 8
# keep the whole smoke within its time
BENCH_FRAME_SMOKE = ["--img", "800", "--spp", "16", "8"]
PARITY_MIN_PSNR = 40.0     # the JAX drive's figure is 54.5-55.5 dB
# drive_parity at its defaults but one view compared on 1024 of its
# foreground pixels (the JAX tool's --subsample; cuts of depth: its oracle
# trace takes ~40-55 s for a whole 64² view), drive_stage2 for 41 of its
# 161 steps
DRIVE_PARITY_SMOKE = ["--views", "1", "--subsample", "1024"]
DRIVE_STAGE2_STEPS = dict(iters=41, log_at=(0, 20, 40))


def run_tool(main, argv, **kw):
    """A tool's main(argv, **kw) in this process, its standard output
    captured -> (its return value, its output lines, seconds)."""
    import contextlib
    import io

    import torch
    buf = io.StringIO()
    torch.cuda.synchronize()
    a = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = main(argv, **kw)
    torch.cuda.synchronize()
    return ret, buf.getvalue().splitlines(), time.perf_counter() - a


def _held(kernels=("blend", "gather")):
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.ops import raster_blend as rb
    targets = {"blend": (rb, "blend_tiles"),
               "gather": (gt, "gather_rows_kernel")}
    return FirstCalls({k: targets[k] for k in kernels}, clone=(1,))


def _finite_json(line, keys, nullable=()):
    """The tool's JSON line has exactly `keys`, numbers finite (the
    `nullable` keys null)."""
    return (set(line) == keys
            and all(line[k] is None for k in nullable)
            and all(isinstance(v, str) or (isinstance(v, (int, float))
                                           and math.isfinite(v))
                    for k, v in line.items() if k not in nullable))


def phase_bench(results):
    """python -m irgs_tpu_torch.bench at its defaults (workload.BENCH): its
    JSON line with bench.py's keys, the cost fields null, ms/step beside the
    stage2 phase's; the kernels held at the path's first inputs and the
    scatter-add at its largest."""
    from irgs_tpu_torch import bench

    reset_launch_counts()
    with _held() as rec, LargestScatter() as scat:
        _, lines, wall = run_tool(bench.main, ["--device", "cuda"])
    launches = launch_counts()
    results.setdefault("launches", {})["bench"] = launches
    check_recorded(results, rec, "bench_tool_400px")
    check_scatter(results, scat, "bench_tool_largest")
    out = json.loads(lines[-1])
    stage2 = results.get("stage2", {})
    line = {"phase": "bench", "wall_s": wall, "json": out,
            "ms_per_step": 1e3 / out["value"] if out.get("value") else None,
            "stage2_phase_ms_per_step": stage2.get("ms_per_step"),
            "launches": launches}
    checks = {
        "keys_and_values": _finite_json(out, BENCH_KEYS, nullable=(
            "vs_baseline", "mfu", "hbm_util", "flops_per_step",
            "bytes_per_step")) and out["value"] > 0,
        "kernels_launched": all(launches.get(k, 0) > 0 for k in (
            "blend_fwd", "blend_bwd", "gather_rows", "segment_sum"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("bench", f"checks failed: {checks}")


def phase_bench_stage1(results):
    """python -m irgs_tpu_torch.tools.bench_stage1 at full width with
    --iters 3: its JSON line with the JAX script's keys, beside the stage1
    phase's ms/step (the same workload at dup 2^21, 10 timed steps)."""
    from irgs_tpu_torch.tools import bench_stage1

    reset_launch_counts()
    with _held(("blend",)) as rec, LargestScatter() as scat:
        _, lines, wall = run_tool(bench_stage1.main,
                                  ["--device", "cuda", "--iters", "3"])
    launches = launch_counts()
    results.setdefault("launches", {})["bench_stage1"] = launches
    check_recorded(results, rec, "bench_stage1_tool_400px")
    check_scatter(results, scat, "bench_stage1_tool_largest")
    out = json.loads(lines[-1])
    phases = results.get("stage1", {}).get("phases", {})
    line = {"phase": "bench_stage1", "wall_s": wall, "json": out,
            "ms_per_step": {p: 1e3 / out[f"stage1_{p}_iters_per_sec"]
                            for p in ("initial", "volume", "surfel")
                            if out.get(f"stage1_{p}_iters_per_sec")},
            "stage1_phase_ms_per_step": {p: phases[p]["ms_per_step"]
                                         for p in ("initial", "volume",
                                                   "surfel") if p in phases},
            "lines": lines[:-1], "launches": launches}
    checks = {"keys_and_values": _finite_json(out, BENCH_STAGE1_KEYS),
              "kernels_launched": all(launches.get(k, 0) > 0 for k in (
                  "blend_fwd", "blend_bwd", "segment_sum"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("bench_stage1", f"checks failed: {checks}")


def phase_bench_frame(results):
    """python -m irgs_tpu_torch.tools.bench_frame at 800² with its samples
    cut (BENCH_FRAME_SMOKE): the grid's overflow, a cold and a warm frame,
    its JSON line with the JAX script's keys."""
    from irgs_tpu_torch.tools import bench_frame

    reset_launch_counts()
    with _held() as rec:
        _, lines, wall = run_tool(bench_frame.main,
                                  ["--device", "cuda", *BENCH_FRAME_SMOKE])
    launches = launch_counts()
    results.setdefault("launches", {})["bench_frame"] = launches
    check_recorded(results, rec, "bench_frame_800px")
    out = json.loads(lines[-1])
    line = {"phase": "bench_frame",
            "cut": {"spp": [int(x) for x in BENCH_FRAME_SMOKE[3:5]],
                    "defaults": [512, 256]},
            "wall_s": wall, "json": out,
            "grid_line": next((x for x in lines if x.startswith("grid")),
                              None),
            "launches": launches}
    checks = {"keys_and_values": _finite_json(out, BENCH_FRAME_KEYS),
              "frame_800": out.get("frame_img") == 800,
              "grid_overflow_zero": "grid built, overflow: 0" in lines,
              "kernels_launched": all(launches.get(k, 0) > 0 for k in (
                  "blend_fwd", "gather_rows"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("bench_frame", f"checks failed: {checks}")


# tests/test_raster.py's tiny scene (64 surfels uniform in ±1, log-scales
# uniform in [-3, -1.5], sigmoid(N(0,1) + 1) opacities, 0.3·N(0,1) SH, 4
# uniform features; a 64x64 camera at z = -4), here from a numpy seed, and
# its tolerances against the oracle. The card's values are held within
# those plus the forward kernel's own bound against its plain version
# (FWD_ATOL + FWD_RTOL·|x|: its transmittance is a sequential sum of log1p,
# the plain version's a cumsum), since the CPU tests hold the plain version
# within test_raster.py's; the line also says which fields stay within
# test_raster.py's alone
RASTER_ORACLE_TOL = {"color": (2e-5, 0), "feature": (2e-5, 0),
                     "alpha": (2e-5, 0), "depth": (1e-4, 0),
                     "depth2": (5e-4, 0), "depth_median": (1e-5, 0),
                     "normal": (2e-5, 0), "distortion": (1e-4, 1e-3)}
RASTER_ORACLE_GRAD = (2e-4, 1e-3)   # x max|g| absolute, relative


def _oracle_scene(dev, n=64, s=4, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1.0, 1.0, (n, 3)),
            np.exp(rng.uniform(-3.0, -1.5, (n, 2))),
            rng.standard_normal((n, 4)),
            1.0 / (1.0 + np.exp(-(rng.standard_normal((n, 1)) + 1.0))),
            0.3 * rng.standard_normal((n, 16, 3)), rng.uniform(size=(n, s)))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def phase_raster_oracle(results):
    """The whole rasterizer on the card (preprocess, binning, the per-tile
    sort, both blend kernels) against the brute-force oracle
    (ops/surfel_raster_ref.rasterize_reference, every surfel at every pixel
    in global depth order, plain PyTorch on the card), values and
    gradients; and preprocess against the independent preprocess_reference,
    with tests/test_raster.py's tolerances."""
    import numpy as np
    import torch
    from irgs_tpu_torch.ops import surfel_raster as sr
    from irgs_tpu_torch.ops import surfel_raster_ref as ref
    from irgs_tpu_torch.scene.cameras import Camera

    dev = torch.device("cuda")
    W = H = 64
    cam = Camera(0, np.eye(3), np.array([0.0, 0.0, 4.0]), fovx=0.8,
                 fovy=0.8, width=W, height=H).params(dev)
    scene = _oracle_scene(dev)
    n = scene[0].shape[0]
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    tgt = torch.tensor(np.random.default_rng(7).uniform(
        size=(H, W, 3)).astype(np.float32), device=dev)
    kw = dict(img_w=W, img_h=H, active_sh_degree=3)
    reset_launch_counts()
    with _held(("blend",)) as rec, LargestScatter() as scat:
        leaves = [x.clone().requires_grad_(True) for x in scene] + [
            torch.zeros((n, 2), device=dev, requires_grad=True)]
        out = sr.rasterize(*leaves[:6], leaves[6], cam, bg,
                           dup_capacity=2 ** 14, **kw)
        loss = lambda o: ((o.color - tgt).abs().mean() + o.feature.mean()
                          + 0.1 * o.distortion.mean() + o.normal.mean()
                          + 0.01 * o.depth.mean())
        g_k = torch.autograd.grad(loss(out), leaves)
        torch.cuda.synchronize()
    launches = launch_counts()
    results.setdefault("launches", {})["raster_oracle"] = launches
    leaves_r = [x.clone().requires_grad_(True) for x in scene] + [
        torch.zeros((n, 2), device=dev, requires_grad=True)]
    out_r = ref.rasterize_reference(*leaves_r[:6], cam, bg,
                                    means2d_offset=leaves_r[6], **kw)
    g_r = torch.autograd.grad(loss(out_r), leaves_r)
    errs, strict, ok_v = {}, {}, True
    for name, (atol, rtol) in RASTER_ORACLE_TOL.items():
        a, b = getattr(out, name).detach(), getattr(out_r, name).detach()
        d = (a - b).abs()
        errs[name] = float(d.max())
        strict[name] = bool((d <= atol + rtol * b.abs()).all())
        ok_v &= bool((d <= atol + FWD_ATOL
                      + (rtol + FWD_RTOL) * b.abs()).all())
    g_errs, ok_g = {}, True
    for nm, a, b in zip(("means", "scales", "quats", "opacity", "shs",
                         "features", "means2d"), g_k, g_r):
        scale = float(b.abs().max().clamp_min(1e-8))
        d = (a - b).abs()
        g_errs[nm] = float(d.max()) / scale
        ok_g &= bool((d <= RASTER_ORACLE_GRAD[0] * scale
                      + RASTER_ORACLE_GRAD[1] * b.abs()).all())
    with torch.no_grad():
        prep = sr.preprocess(*scene[:5], cam, W, H, 3)
    orc = ref.preprocess_reference(*scene[:5], cam, W, H, 3)
    valid = prep.valid.cpu().numpy()
    p_errs = {k: float(np.abs(getattr(prep, k).cpu().numpy()[valid]
                              - orc[k][valid]).max())
              for k in ("M", "depth", "normal", "rgb")}
    c_err = float(np.abs(prep.center.cpu().numpy()[valid]
                         - orc["center"][valid]).max())
    ext = orc["extent"][valid].max(axis=1)
    rad = prep.radius.cpu().numpy()[valid]
    check_recorded(results, rec, "raster_oracle_64px")
    check_scatter(results, scat, "raster_oracle_largest")
    line = {"phase": "raster_oracle", "surfels": n, "img": W,
            "max_abs_err": errs, "within_test_raster_tol": strict,
            "kernel_tol": [FWD_ATOL, FWD_RTOL],
            "grad_max_err_over_max": g_errs,
            "preprocess_max_abs_err": p_errs, "center_err": c_err,
            "tolerances": RASTER_ORACLE_TOL,
            "grad_tolerance": RASTER_ORACLE_GRAD, "launches": launches}
    checks = {
        "values": ok_v, "gradients": ok_g,
        "overflow_zero": int(out.overflow) == 0,
        "renders": float(out.alpha.detach().max()) > 0.3
        and float(out_r.depth_median.detach().abs().max()) > 0.1,
        "preprocess": int(valid.sum()) > 10
        and p_errs["M"] <= 2e-4 * (1 + np.abs(orc["M"][valid]).max())
        and p_errs["depth"] <= 1e-5 * (1 + np.abs(orc["depth"]).max())
        and p_errs["normal"] <= 2e-4 and p_errs["rgb"] <= 2e-4
        and c_err < 1.0 and bool(np.all(rad >= ext - 1e-3))
        and bool(np.all(rad <= np.ceil(ext) + 1.0)),
        "kernels_launched": launches.get("blend_fwd", 0) > 0
        and launches.get("blend_bwd", 0) > 0}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("raster_oracle", f"checks failed: {checks}")


def phase_drives(results):
    """The tracer-bias drives, each a path of its own (its launches counted
    from 0 and its kernels held at its first inputs): drive_parity
    (DRIVE_PARITY_SMOKE: the shadow scene at 64², 512 + 256 samples, the
    production shading against the oracle trace's; gated at
    PARITY_MIN_PSNR), audit_train_budget at its defaults (its rows on the
    100k dense stress scene), trace_fidelity (both densities; its variants
    select per candidate, so no pair table and no kernel of ours) and
    drive_stage2 (DRIVE_STAGE2_STEPS: the ray PSNR rises, the envmap error
    falls below its initial value)."""
    from irgs_tpu_torch.tools import (audit_train_budget, drive_parity,
                                      drive_stage2, trace_fidelity)

    def run(path, main, argv, kernels, case, scatter=False, **kw):
        reset_launch_counts()
        with _held(kernels) as rec, LargestScatter() as scat:
            out = run_tool(main, argv, **kw)
        launches = results.setdefault("launches", {})[path] = launch_counts()
        if kernels:
            check_recorded(results, rec, case)
        if scatter:
            check_scatter(results, scat, f"{path}_largest")
        return (*out, launches)

    parity, p_lines, p_s, p_n = run(
        "drive_parity", drive_parity.main,
        ["--device", "cuda", *DRIVE_PARITY_SMOKE], ("blend", "gather"),
        "drive_parity_64px")
    rows, a_lines, a_s, a_n = run(
        "audit_train_budget", audit_train_budget.main, ["--device", "cuda"],
        ("gather",), "audit_train_budget_100k")
    fid, f_lines, f_s, f_n = run(
        "trace_fidelity", trace_fidelity.main, ["--device", "cuda"], (),
        None)
    s2, s_lines, s_s, s_n = run(
        "drive_stage2", drive_stage2.main, ["--device", "cuda"],
        ("blend", "gather"), "drive_stage2_128px", scatter=True,
        **DRIVE_STAGE2_STEPS)
    logged = s2["logged"]
    steps = sorted(logged)
    launches = {"drive_parity": p_n, "audit_train_budget": a_n,
                "trace_fidelity": f_n, "drive_stage2": s_n}
    line = {"phase": "drives", "parity_cut": DRIVE_PARITY_SMOKE,
            "drive_stage2_cut": DRIVE_STAGE2_STEPS,
            "parity_psnr": parity,
            "parity_s": p_s, "parity_lines": p_lines,
            "audit_rows": dict(rows), "audit_s": a_s, "audit_lines": a_lines,
            "trace_fidelity": fid, "trace_fidelity_s": f_s,
            "drive_stage2": s2, "drive_stage2_s": s_s,
            "drive_stage2_lines": s_lines, "launches": launches}
    checks = {
        "parity_psnr_gate": bool(parity) and all(
            v >= PARITY_MIN_PSNR for v in parity.values()),
        "audit_rows": len(rows) == 2 and all(
            all(math.isfinite(v) for v in r.values()) for _, r in rows),
        "trace_fidelity_rows": set(fid) == {"bench", "dense"} and all(
            math.isfinite(v["dalpha"]) and math.isfinite(v["dcolor"])
            for r in fid.values() for k, v in r.items()
            if k != "oracle_ms"),
        "stage2_ray_psnr_rises": logged[steps[-1]]["ray_psnr"]
        > logged[steps[0]]["ray_psnr"],
        "stage2_envmap_recovers": s2["env_err"] < s2["env_err_init"],
        "kernels_launched": all(p_n.get(k, 0) > 0 for k in (
            "blend_fwd", "gather_rows")) and a_n.get("gather_rows", 0) > 0
        and all(s_n.get(k, 0) > 0 for k in (
            "blend_fwd", "blend_bwd", "gather_rows", "segment_sum"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("drives", f"checks failed: {checks}")


# the toy's GT frames in load_reproducer, cut in depth from the card's
# 16 views of 256² at 64 samples (train/__main__.py:CUDA_TOY)
REPRODUCER_TOY = dict(res=128, spp=16, cams=4)


def phase_load_reproducer(results, tmp):
    """python -m irgs_tpu_torch.train --toy with --inject_nan_at 2 under
    --detect_anomaly: exit 3 and a reproducer of step 2; then
    python -m irgs_tpu_torch.tools.load_reproducer replays that step under
    anomaly detection, which must raise on the NaN. Both render the toy's
    GT frames at REPRODUCER_TOY."""
    from irgs_tpu_torch.tools import load_reproducer
    from irgs_tpu_torch.train import __main__ as train_cli

    saved = dict(train_cli.CUDA_TOY)
    train_cli.CUDA_TOY.update(REPRODUCER_TOY)
    try:
        _load_reproducer(results, tmp, load_reproducer, train_cli.main)
    finally:
        train_cli.CUDA_TOY.update(saved)


def _load_reproducer(results, tmp, load_reproducer, train_main):
    run = os.path.join(tmp, "nan_toy")
    reset_launch_counts()
    a = time.perf_counter()
    with _held() as rec, LargestScatter() as scat:
        try:
            train_main(["--toy", "-m", run, "--iterations", "3",
                        "--inject_nan_at", "2", "--detect_anomaly",
                        "--vis_interval", "0"])
            code = 0
        except SystemExit as e:
            code = e.code
    train_s = time.perf_counter() - a
    rp = os.path.join(run, "reproducer_000002.ckpt")
    raised, lines = None, []
    a = time.perf_counter()
    try:
        _, lines, _ = run_tool(load_reproducer.main, [rp, "--toy"])
    except RuntimeError as e:
        raised = str(e).splitlines()[0]
    replay_s = time.perf_counter() - a
    launches = launch_counts()
    results.setdefault("launches", {})["load_reproducer"] = launches
    check_recorded(results, rec, "reproducer_toy_128px")
    check_scatter(results, scat, "reproducer_largest")
    line = {"phase": "load_reproducer", "toy": REPRODUCER_TOY,
            "train_exit_code": code, "train_s": train_s,
            "replay_s": replay_s, "raised": raised, "replay_lines": lines,
            "launches": launches}
    checks = {"train_exit_3": code == 3, "reproducer": os.path.exists(rp),
              "replay_raises_on_nan": raised is not None
              and "nan" in raised.lower(),
              "kernels_launched": all(launches.get(k, 0) > 0 for k in (
                  "blend_fwd", "blend_bwd", "gather_rows", "segment_sum"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("load_reproducer", f"checks failed: {checks}")


# run_grid on the e2e phase's analytic dataset, one scene, cut in depth: 20
# stage-1 and 10 stage-2 iterations, 16 diffuse samples in stage 2 and the
# NVS eval; its frames at -r 8 (50²: the relighting eval's samples, 512 +
# 256, have no run_grid flag), 2048 pixels a stage-2 step
RUN_GRID_SMOKE = ["--scenes", "dataset", "--s1_iterations", "20",
                  "--s2_iterations", "10", "--resolution", "8",
                  "--diffuse_sample_num", "16",
                  "--nvs_diffuse_sample_num", "16",
                  "--s2_args=--trace_num_rays 32768 --vis_interval 0"]


def phase_run_grid(results, tmp):
    """python -m irgs_tpu_torch.tools.run_grid through its in-process
    runner on the e2e phase's dataset (made here with E2E_SMOKE's dataset
    arguments when e2e did not run): every step's .done marker and log,
    collect_results' output for the three kinds, and a second invocation
    that skips every step by its marker."""
    import contextlib
    import io

    from irgs_tpu_torch.tools import collect_results, run_grid

    root = os.path.join(tmp, "e2e")
    ds = os.path.join(root, "dataset")
    if not os.path.exists(os.path.join(ds, "transforms_train.json")):
        from irgs_tpu_torch.tools import run_e2e
        run_e2e.main(["--root", root, "--results",
                      os.path.join(tmp, "e2e_results"), "--device", "cuda",
                      *E2E_SMOKE, "--skip_stage1", "--skip_stage2",
                      "--skip_eval"], run_stage=run_e2e.run_in_process)
    out = os.path.join(tmp, "grid")
    argv = ["--data_root", root, "--out", out, *RUN_GRID_SMOKE,
            "--relight_envmaps", os.path.join(ds, "sunset.exr"),
            "--device", "cuda"]
    reset_launch_counts()
    with _held() as rec, LargestScatter() as scat:
        _, lines, wall = run_tool(run_grid.main, argv,
                                  run_cmd=run_grid.run_in_process)
    launches = launch_counts()
    results.setdefault("launches", {})["run_grid"] = launches
    check_recorded(results, rec, "run_grid_50px")
    check_scatter(results, scat, "run_grid_largest")
    _, lines2, wall2 = run_tool(run_grid.main, argv,
                                run_cmd=run_grid.run_in_process)
    logs = os.path.join(out, "dataset", "logs")
    model = os.path.join(out, "dataset", "irgs")
    collected = {}
    for kind in ("nvs", "material", "relight"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            collect_results.main([model, "--kind", kind])
        collected[kind] = buf.getvalue().splitlines()
    line = {"phase": "run_grid", "wall_s": wall, "second_wall_s": wall2,
            "lines": lines, "second_lines": lines2,
            "logs": sorted(os.listdir(logs)) if os.path.isdir(logs) else [],
            "collect_results": collected, "launches": launches}
    checks = {
        "every_step_done": all(os.path.exists(os.path.join(
            logs, f"{s}.done")) for s in run_grid.ALL_STEPS),
        "grid_ok": json.loads(lines[-1]) == {"grid": "ok", "cells": 1},
        "second_run_skips_every_step": sum(
            "[skip]" in x for x in lines2) == len(run_grid.ALL_STEPS)
        and not any("[run ]" in x for x in lines2),
        # the grid's material step is the --compute_scale pass alone (as
        # in run_grid.py), which writes no material_results.json
        "collect_results": all(any("(n=1)" in x for x in collected[k])
                               for k in ("nvs", "relight")),
        "kernels_launched": all(launches.get(k, 0) > 0 for k in (
            "blend_fwd", "blend_bwd", "gather_rows", "segment_sum"))}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("run_grid", f"checks failed: {checks}")


OVERFIT_MIN_PSNR = 45.0     # the JAX drive's expected figure
STAGE1_LITE_STEPS = 5


def phase_overfit(results):
    """tools/drive_overfit at the JAX script's size (its own path), then
    STAGE1_LITE_STEPS stage-1-lite steps (train/stage1.py: render_initial's
    losses, the densification statistics, Adam) on the BENCH sphere at 400²
    against a grey target (a path of its own); the blends held at each
    path's first inputs and the scatter-add at its largest."""
    import torch
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.config import Config
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.tools import drive_overfit
    from irgs_tpu_torch.train import stage1

    dev = torch.device("cuda")
    reset_launch_counts()
    with _held(("blend",)) as rec, LargestScatter() as scat:
        drive, d_lines, d_s = run_tool(drive_overfit.main,
                                       ["--device", "cuda"])
    d_n = results.setdefault("launches", {})["drive_overfit"] = \
        launch_counts()
    check_recorded(results, rec, "drive_overfit_128px")
    check_scatter(results, scat, "drive_overfit_largest")
    del rec, scat

    b = workload.BENCH
    params, aux = toy.make_sphere_scene(n_surface=b["n_surface"],
                                        n_capacity=b["n_capacity"],
                                        env_resolution=128, device=dev)
    cams = toy.make_ring_cameras(8, width=b["img"], height_px=b["img"])
    st = stage1.Stage1Static(img_w=b["img"], img_h=b["img"],
                             active_sh_degree=3, white_background=False,
                             dup_capacity=b["dup"])
    state = stage1.init_state(params, aux, Config().opt, 3.3)
    target = torch.full((b["img"], b["img"], 3), 0.5, device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    a = time.perf_counter()
    logs = []
    with _held(("blend",)) as rec, LargestScatter() as scat:
        for i in range(STAGE1_LITE_STEPS):
            state, m = stage1.stage1_step(state, cams[i % 8].params(dev),
                                          target, None, st=st)
            logs.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    lite_s = time.perf_counter() - a
    l_n = results["launches"]["stage1_lite"] = launch_counts()
    check_recorded(results, rec, "stage1_lite_400px_100k")
    check_scatter(results, scat, "stage1_lite_largest")
    del rec, scat, state, params, aux

    rows = drive["rows"]
    line = {"phase": "overfit", "drive_overfit": drive, "drive_s": d_s,
            "drive_lines": d_lines, "stage1_lite_steps": logs,
            "stage1_lite_s": lite_s,
            "launches": {"drive_overfit": d_n, "stage1_lite": l_n}}
    checks = {
        "psnr_starts_low": rows[0]["psnr"] < 12.0,
        "psnr_above_45": rows[-1]["psnr"] > OVERFIT_MIN_PSNR,
        "overflow_zero": all(r["overflow"] == 0 for r in rows),
        "probes": drive["probe_overflow"] > 0 and drive["probe_finite"]
        and drive["probe_dead_err"] == 0.0,
        "stage1_lite_finite": all(math.isfinite(m["loss"]) for m in logs),
        "stage1_lite_no_overflow": all(m["raster_overflow"] == 0
                                       for m in logs),
        "stage1_lite_loss_falls": logs[-1]["loss_l1"] < logs[0]["loss_l1"],
        "kernels_launched": all(n.get(k, 0) > 0 for n in (d_n, l_n)
                                for k in ("blend_fwd", "blend_bwd",
                                          "segment_sum"))}
    line["checks"] = checks = {k: bool(v) for k, v in checks.items()}
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("overfit", f"checks failed: {checks}")


def _median_ms(fn, reps=5):
    out = []
    for _ in range(reps):
        a = time.perf_counter()
        fn()
        out.append((time.perf_counter() - a) * 1e3)
    return statistics.median(out), out


def _png_same(a, b):
    """Two PNG files decode (the port's reader) to the same array, mode,
    palette, transparency and ICC profile."""
    import numpy as np
    from irgs_tpu_torch.utils import png
    (x, mx, ix), (y, my, iy) = png.read_png_like_pil(a), \
        png.read_png_like_pil(b)
    pal = lambda i: None if i.get("palette") is None else i[
        "palette"].tolist()
    return (mx == my and x.dtype == y.dtype and x.shape == y.shape
            and bool(np.array_equal(x, y)) and pal(ix) == pal(iy)
            and ix.get("transparency") == iy.get("transparency")
            and ix.get("icc_profile") == iy.get("icc_profile"))


def phase_images(results, tmp):
    """The image codecs on the card's machine (no PIL): the committed JPEG
    and PNG fixtures bit for bit (with mode, palette, transparency), the
    PIL-refused streams refused, the decode, Lanczos and encode times, and
    python -m irgs_tpu_torch.process_images on committed inputs (against
    the root script's committed outputs) and on the outputs of the
    train_cli and eval_cli phases (sizes)."""
    import contextlib
    import glob
    import io
    import shutil

    import numpy as np
    from irgs_tpu_torch import process_images
    from irgs_tpu_torch.utils import jpeg, jpeg_encode, png
    from irgs_tpu_torch.utils.resize import resize_lanczos_like_pil

    run = os.path.join(tmp, "run")
    renders = sorted(glob.glob(os.path.join(run, "test", "ours_*")))
    vis = os.path.join(run, "vis", "iter_000001.png")
    if not (os.path.exists(vis) and renders):
        fail("images", "needs the runs that train_cli and eval_cli leave")

    a = time.perf_counter()
    jpeg_exact = jpeg_fixtures_exact()
    with open(os.path.join(PNG_FIXTURES, "modes.json")) as f:
        modes = json.load(f)
    png_exact = {}
    for name, want_info in modes.items():
        arr, mode, info = png.read_png_like_pil(
            os.path.join(PNG_FIXTURES, name + ".png"))
        want = np.load(os.path.join(PNG_FIXTURES, name + ".npy"))
        t = info.get("transparency")
        got_info = {"mode": mode, "palette": None if info.get("palette")
                    is None else info["palette"].tolist(),
                    "transparency": list(t) if isinstance(t, (bytes, tuple))
                    else t}
        png_exact[name] = (arr.dtype == want.dtype and arr.shape == want.shape
                           and bool(np.array_equal(arr, want))
                           and got_info == want_info)
    refused = {}
    for path in sorted(glob.glob(os.path.join(JPEG_FIXTURES, "refused",
                                              "*.jpg"))):
        try:
            jpeg.read_jpeg(path)
            refused[os.path.basename(path)] = False
        except jpeg.JpegError:
            refused[os.path.basename(path)] = True
    fixtures_s = time.perf_counter() - a

    decode_ms = {}
    for kind in ("", "_progressive", "_arith"):
        path = os.path.join(JPEG_FIXTURES, f"large_1297x840_q95{kind}.jpg")
        decode_ms[kind.strip("_") or "baseline"] = _median_ms(
            lambda: jpeg.read_jpeg(path))
    # a photo-like 1600² frame: gradients, rings and a little noise
    y, x = np.mgrid[0:1600, 0:1600].astype(np.float64)
    frame = np.stack([128 + 100 * np.sin(x / 53.0 + y / 91.0),
                      128 + 90 * np.cos(np.hypot(x - 700, y - 800) / 37.0),
                      128 + 110 * np.sin(x * y / 90000.0)], -1)
    frame += np.random.default_rng(0).normal(0, 4, frame.shape)
    frame = np.clip(frame, 0, 255).astype(np.uint8)
    lanczos_ms = _median_ms(lambda: resize_lanczos_like_pil(frame, "RGB",
                                                            (400, 400)))
    encode_ms = _median_ms(lambda: jpeg_encode.encode_jpeg(frame, "RGB"))
    data = jpeg_encode.encode_jpeg(frame, "RGB")
    back = jpeg.decode_jpeg(data).astype(np.float64)
    psnr = 10 * math.log10(255.0 ** 2 / float(((back - frame) ** 2).mean()))

    # process_images on the committed inputs: the root script's outputs
    out_dir = os.path.join(tmp, "pi_out")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        process_images.main(["crop", os.path.join(PI_FIXTURES, "in"),
                             out_dir, *PI_CROP_ARGS])
        shutil.copy(os.path.join(PI_FIXTURES, "in", "grid.png"),
                    os.path.join(tmp, "grid.png"))
        process_images.main(["split-grid", os.path.join(tmp, "grid.png")])
    committed = {}
    for name in sorted(os.listdir(os.path.join(PI_FIXTURES, "out"))):
        want, got = (os.path.join(PI_FIXTURES, "out", name),
                     os.path.join(out_dir, name))
        if name.lower().endswith((".jpg", ".jpeg")):
            committed[name] = (os.path.exists(got) and open(got, "rb").read()
                               == open(want, "rb").read())
        else:
            committed[name] = os.path.exists(got) and _png_same(want, got)
    for r in range(2):
        committed[f"grid_panel{r}.png"] = _png_same(
            os.path.join(PI_FIXTURES, f"grid_panel{r}.png"),
            os.path.join(tmp, f"grid_panel{r}.png"))

    # ... and on this run's outputs
    a = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        process_images.main(["split-grid", vis])
        process_images.main(["crop", renders[-1], os.path.join(tmp, "crop4"),
                             "--downscale", "4"])
    pi_s = time.perf_counter() - a
    grid_shape = list(png.read_png(vis).shape)
    h_each = (grid_shape[0] - 3 * 10) // 2
    panels = [list(png.read_png(os.path.join(
        run, "vis", f"iter_000001_panel{r}.png")).shape) for r in range(2)]
    srcs = sorted(f for f in os.listdir(renders[-1]) if f.endswith(".png"))
    crops = {f: list(png.read_png(os.path.join(tmp, "crop4", f)).shape)
             for f in sorted(os.listdir(os.path.join(tmp, "crop4")))}
    want_crop = {f: [s // 4 for s in png.read_png(
        os.path.join(renders[-1], f)).shape[:2]] for f in srcs}

    # TIFF, BMP and GIF, content sniffing and the .hdr headers
    a = time.perf_counter()
    containers, container_refused = container_fixtures_exact()
    mislabelled = mislabelled_read_by_content(tmp)
    hdr_cases = hdr_headers_as_cv2(tmp)
    containers_s = time.perf_counter() - a
    c_ms, c_ms_all, c_equal, c_bytes = container_decode_ms(frame, tmp)
    w_ms, w_ms_all, w_equal, w_bytes = large_frames_ms()
    t_ms, t_ms_all, t_equal, t_bytes = large_frames_ms("tiff", ".tif")

    line = {"phase": "images", "jpeg_fixtures": len(jpeg_exact),
            "jpeg_modes": sorted({m for _, m in jpeg_exact.values()}),
            "png_fixtures": len(png_exact), "refused": refused,
            "fixtures_s": fixtures_s,
            "decode_1297x840_ms": {k: v[0] for k, v in decode_ms.items()},
            "decode_1297x840_ms_all": {k: v[1] for k, v in decode_ms.items()},
            "lanczos_1600_to_400_ms": lanczos_ms[0],
            "encode_1600_ms": encode_ms[0], "encode_bytes": len(data),
            "encode_psnr_db": psnr, "process_images_committed": committed,
            "process_images_run_s": pi_s, "vis_grid_shape": grid_shape,
            "panels": panels, "crops": crops,
            "container_fixtures": {f: sum(k.startswith(f + "/")
                                          for k in containers)
                                   for f in CONTAINER_FIXTURES},
            "container_refused": container_refused,
            "mislabelled": mislabelled, "hdr_headers": hdr_cases,
            "containers_s": containers_s,
            "decode_1297x840_container_ms": c_ms,
            "decode_1297x840_container_ms_all": c_ms_all,
            "container_bytes": c_bytes, "decode_1297x840_webp_ms": w_ms,
            "decode_1297x840_webp_ms_all": w_ms_all, "webp_bytes": w_bytes,
            "decode_large_tiff_ms": t_ms, "decode_large_tiff_ms_all": t_ms_all,
            "large_tiff_bytes": t_bytes}
    checks = {
        "jpeg_bit_for_bit": bool(jpeg_exact) and all(
            ok for ok, _ in jpeg_exact.values()),
        "png_bit_for_bit": bool(png_exact) and all(png_exact.values()),
        "refused_raise": bool(refused) and all(refused.values()),
        "encode_decodes": psnr > 30.0,
        "process_images_equals_root_script": len(committed) >= 9 and all(
            committed.values()),
        "split_grid_sizes": all(p == [h_each, grid_shape[1] - 20, 3]
                                for p in panels),
        "crop_sizes": sorted(crops) == srcs and all(
            crops[f][:2] == want_crop[f] for f in srcs),
        "containers_bit_for_bit": len(containers) >= 424 and all(
            containers.values()),
        "containers_refused_raise": bool(container_refused) and all(
            container_refused.values()),
        "mislabelled_read_by_content": all(mislabelled.values()),
        "hdr_headers_as_cv2": all(hdr_cases.values()),
        "container_frames_decode": all(c_equal.values()),
        "webp_large_frames_equal": len(w_equal) == 3 and all(
            w_equal.values()),
        "tiff_large_frames_equal": len(t_equal) == 4 and all(
            t_equal.values())}
    line["checks"] = checks
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("images", f"checks failed: {checks} (jpeg: "
             f"{[k for k, v in jpeg_exact.items() if not v[0]]}, png: "
             f"{[k for k, v in png_exact.items() if not v]}, process_images: "
             f"{[k for k, v in committed.items() if not v]}, containers: "
             f"{[k for k, v in containers.items() if not v]})")


WEBP_CAPTURE = os.path.join(WEBP_FIXTURES, "colmap")
TIFF_CAPTURE = os.path.join(ROOT, "tests", "data", "tiff", "colmap")
CAPTURE_ITERS = 5


def phase_webp_colmap(results, tmp):
    _capture_phase(results, tmp, "webp_colmap", WEBP_CAPTURE)


def phase_tiff_colmap(results, tmp):
    _capture_phase(results, tmp, "tiff_colmap", TIFF_CAPTURE)


def _capture_phase(results, tmp, phase, capture):
    """python -m irgs_tpu_torch.train on a committed COLMAP capture (four
    400² frames, 4,096 points) for CAPTURE_ITERS iterations at CLI_BENCH's
    budgets, as the main path `phase` (main_path: the blends and the gather
    held at their first inputs, the scatter-add at its largest)."""
    import numpy as np
    import torch
    from irgs_tpu_torch.scene import datasets as ds

    a = time.perf_counter()
    info = ds.load_scene(capture, eval_split=False)
    load_s = time.perf_counter() - a
    images = [c.image for c in info.train_cameras]
    n_points = int(len(info.points))
    del info
    run = os.path.join(tmp, phase + "_run")
    with main_path(results, phase, case=phase + "_400px"), \
            StepMeter() as meter:
        launches, cli_s = run_cli(
            ["-s", capture, "-m", run, "--iterations",
             str(CAPTURE_ITERS), "--checkpoint_interval", "0",
             "--vis_interval", "0", *CLI_BENCH])
    log = list(read_log(run).values())
    steps = [st["ms"] for st in meter.steps[1:]]
    checks = _run_checks(log, launches)
    checks["frames_400"] = [list(im.shape) for im in images] == \
        [[400, 400, 3]] * 4
    checks["frames_finite"] = all(bool(np.isfinite(im).all())
                                  for im in images)
    checks["points_4096"] = n_points == 4096
    checks["steps"] = len(meter.steps) == CAPTURE_ITERS
    line = {"phase": phase, "load_s": load_s, "cli_s": cli_s,
            "ms_per_step": [st["ms"] for st in meter.steps],
            "ms_per_step_median_after_first": statistics.median(steps)
            if steps else None,
            "step_max_memory_allocated": max(st["peak"]
                                             for st in meter.steps),
            "run_max_memory_allocated": meter.run_peak,
            "launches": launches, "log": log, "n_points": n_points,
            "frames": sorted(os.listdir(os.path.join(capture, "images"))),
            "checks": checks}
    line["ok"] = all(checks.values())
    emit(line)
    if not line["ok"]:
        fail(phase, f"checks failed: {checks}")
    torch.cuda.synchronize()


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
               "train_stage1_cli": "stage1_400px_100k_S11",
               "stage2_full": "stage2_full_160px",
               "extract_mesh": "extract_mesh_400px",
               "tracer_options": "bench_400px_100k",
               "parallel": "bench_400px_100k",
               "datasets": "colmap_400px_100k",
               "e2e": "e2e_stage1_400px",
               "bench": "bench_tool_400px",
               "bench_stage1": "bench_stage1_tool_400px",
               "bench_frame": "bench_frame_800px",
               "raster_oracle": "raster_oracle_64px",
               "drive_parity": "drive_parity_64px",
               "drive_stage2": "drive_stage2_128px",
               "load_reproducer": "reproducer_toy_128px",
               "run_grid": "run_grid_50px",
               "drive_overfit": "drive_overfit_128px",
               "stage1_lite": "stage1_lite_400px_100k",
               "sh4_stage1": "sh4_stage1_64px",
               "sh4_stage2": "sh4_stage2_64px",
               "sh4_eval": "sh4_eval_64px",
               "webp_colmap": "webp_colmap_400px",
               "tiff_colmap": "tiff_colmap_400px"}),
    "blend_bwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:222",
        cases={"stage2": "bench_400px_100k", "train_cli": "bench_400px_100k",
               "train_cli_oversize": "shadow_400px_12k",
               "stage1": "stage1_400px_100k_S11",
               "stage1_indirect": "stage1_400px_100k_S18",
               "train_stage1_cli": "stage1_400px_100k_S11",
               "stage2_full": "stage2_full_160px",
               "tracer_options": "bench_400px_100k",
               "parallel": "bench_400px_100k",
               "datasets": "colmap_400px_100k",
               "e2e": "e2e_stage1_400px",
               "bench": "bench_tool_400px",
               "bench_stage1": "bench_stage1_tool_400px",
               "raster_oracle": "raster_oracle_64px",
               "drive_stage2": "drive_stage2_128px",
               "load_reproducer": "reproducer_toy_128px",
               "run_grid": "run_grid_50px",
               "drive_overfit": "drive_overfit_128px",
               "stage1_lite": "stage1_lite_400px_100k",
               "sh4_stage1": "sh4_stage1_64px",
               "sh4_stage2": "sh4_stage2_64px",
               "webp_colmap": "webp_colmap_400px",
               "tiff_colmap": "tiff_colmap_400px"}),
    "gather_rows": dict(
        route="cuda", source="irgs_tpu_torch/csrc/gather_rows.cu",
        replaces=("irgs_tpu/ops/gather_pallas.py:28; "
                  "tools/_prof_collect_parts.py:121; "
                  "tools/_prof_collect_parts.py:144"),
        # the CLI trains at the stage2 phase's shapes
        cases={"eval": "eval_first_pass", "stage2": "stage2_first_pass",
               "train_cli": "stage2_first_pass",
               "train_cli_oversize": "shadow_400px_12k_first_pass",
               "eval_cli": "relight_400px_100k_first_pass",
               "stage2_full": "stage2_full_160px_first_pass",
               # the bf16 pair table's rows, viewed as int32 words
               "tracer_options": "tracer_options_bf16_first_pass",
               "parallel": "stage2_first_pass",
               "datasets": "colmap_400px_100k_first_pass",
               "e2e": "e2e_stage2_400px_first_pass",
               "bench": "bench_tool_400px_first_pass",
               "bench_frame": "bench_frame_800px_first_pass",
               "drive_parity": "drive_parity_64px_first_pass",
               "audit_train_budget": "audit_train_budget_100k_first_pass",
               "drive_stage2": "drive_stage2_128px_first_pass",
               "load_reproducer": "reproducer_toy_128px_first_pass",
               "run_grid": "run_grid_50px_first_pass",
               "sh4_stage2": "sh4_stage2_64px_first_pass",
               "sh4_eval": "sh4_eval_64px_first_pass",
               "webp_colmap": "webp_colmap_400px_first_pass",
               "tiff_colmap": "tiff_colmap_400px_first_pass"}),
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
               "train_stage1_cli": "stage1_largest",
               "stage2_full": "stage2_full_largest",
               "tracer_options": "stage2_largest",
               "parallel": "stage2_largest",
               "datasets": "colmap_largest", "e2e": "e2e_stage2_largest",
               "bench": "bench_tool_largest",
               "bench_stage1": "bench_stage1_tool_largest",
               "raster_oracle": "raster_oracle_largest",
               "drive_stage2": "drive_stage2_largest",
               "load_reproducer": "reproducer_largest",
               "run_grid": "run_grid_largest",
               "drive_overfit": "drive_overfit_largest",
               "stage1_lite": "stage1_lite_largest",
               "sh4_stage1": "sh4_stage1_largest",
               "sh4_stage2": "sh4_stage2_largest",
               "webp_colmap": "webp_colmap_largest",
               "tiff_colmap": "tiff_colmap_largest"}),
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


PHASES = ("build", "kernels", "stage2_small", "stage2", "stage2_full",
          "eval_small", "mis_small", "eval", "train_cli", "train_cli_oversize",
          "eval_cli", "stage1_small", "stage1", "train_stage1_cli",
          "extract_mesh", "tracer_options", "parallel", "datasets", "e2e",
          "bench", "bench_stage1", "bench_frame", "raster_oracle", "drives",
          "load_reproducer", "run_grid", "overfit", "images", "webp_colmap",
          "tiff_colmap")


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
            "stage2_full": lambda: phase_stage2_full(results, tmp),
            "eval_small": phase_eval_small,
            "mis_small": phase_mis_small,
            "eval": lambda: phase_eval(results),
            "train_cli": lambda: phase_train_cli(results, tmp),
            "train_cli_oversize": lambda: phase_train_cli_oversize(results,
                                                                   tmp),
            "eval_cli": lambda: phase_eval_cli(results, tmp),
            "stage1_small": lambda: phase_stage1_small(results),
            "stage1": lambda: phase_stage1(results),
            "train_stage1_cli": lambda: phase_train_stage1_cli(results, tmp),
            "extract_mesh": lambda: phase_extract_mesh(results, tmp),
            "tracer_options": lambda: phase_tracer_options(results),
            "parallel": lambda: phase_parallel(results, tmp),
            "datasets": lambda: phase_datasets(results, tmp),
            "e2e": lambda: phase_e2e(results, tmp),
            "bench": lambda: phase_bench(results),
            "bench_stage1": lambda: phase_bench_stage1(results),
            "bench_frame": lambda: phase_bench_frame(results),
            "raster_oracle": lambda: phase_raster_oracle(results),
            "drives": lambda: phase_drives(results),
            "load_reproducer": lambda: phase_load_reproducer(results, tmp),
            "run_grid": lambda: phase_run_grid(results, tmp),
            "overfit": lambda: phase_overfit(results),
            "images": lambda: phase_images(results, tmp),
            "webp_colmap": lambda: phase_webp_colmap(results, tmp),
            "tiff_colmap": lambda: phase_tiff_colmap(results, tmp),
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
