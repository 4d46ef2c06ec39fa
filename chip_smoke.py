"""Smoke run of the PyTorch port on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero):
  build    compile the CUDA kernels from irgs_tpu_torch/csrc for sm_90a;
  kernels  hold each kernel against its plain PyTorch version on the card;
  stage2   run stage2_step at the bench workload (100k-surfel toy sphere,
           400x400, 256 diffuse samples, 2^18 trace rays) and check that
           both blend kernels ran on every step.
Then a `kernels` summary line, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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
# fp32 operations per pixel x splat pair, counted from the kernel source
# (each add, mul, compare, select, exp, log1p or division counts one):
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
    from irgs_tpu_torch.ops import raster_blend as rb
    path, secs, log = rb.build(verbose=True)
    emit({"phase": "build", "ok": True, "seconds": round(secs, 3),
          "library": os.path.relpath(path, ROOT),
          "ptxas": [l for l in log.splitlines() if "Used" in l or "spill" in l]})


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
        with torch.no_grad():
            out_k = rb.blend_fwd_cuda(*args)
            torch.cuda.synchronize()
            out_p, chunks_run = rb.blend_tiles_plain(*args, return_chunks=True)
            torch.cuda.synchronize()
        c = compare_fwd(out_k, out_p, S)
        c_ok = (c["finite"] and c["outlier_share"] <= MAX_OUTLIER_SHARE
                and c["med_ord_flip_share"] <= MAX_OUTLIER_SHARE)
        ms = cuda_ms(lambda: rb.blend_fwd_cuda(*args))
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: rb.blend_tiles_plain(*args), reps=3)
        fwd_bytes = 4 * out_k.numel()
        bound_ms, bound_by, work = _bounds(chunks_run, S, fwd_bytes,
                                           backward=False)
        work["chunks_run"] = int(chunks_run.sum())
        work["chunks_total"] = int(counts.sum()) // rb.K
        line = {"phase": "kernels", "kernel": "blend_fwd", "case": name,
                "ok": c_ok, **c, "atol": FWD_ATOL, "rtol": FWD_RTOL,
                "max_outlier_share": MAX_OUTLIER_SHARE, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, **work}
        emit(line)
        results.setdefault("blend_fwd", {})[name] = line
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
        # the plain version's backward alone: autograd through its graph
        plain_ms = cuda_ms(lambda: torch.autograd.grad(out_sp, sp, cot,
                                                       retain_graph=True),
                           reps=3)
        del out_sp
        bound_ms, bound_by, work = _bounds(chunks_run, S, fwd_bytes,
                                           backward=True)
        d = (d_k - d_p).abs()
        line = {"phase": "kernels", "kernel": "blend_bwd", "case": name,
                "ok": r_ok, "deterministic": bool(torch.equal(d_k, d_k2)),
                "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                "max_row_outlier_share": max(rows), "rel_tol": BWD_REL,
                "max_outlier_share": MAX_OUTLIER_SHARE, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, **work}
        emit(line)
        results.setdefault("blend_bwd", {})[name] = line
        ok &= r_ok
    if not ok:
        fail("kernels", "a kernel disagrees with its plain version")


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
    results["launches"] = launches
    if not line["ok"]:
        fail("stage2", f"checks failed: {checks}")


KERNELS = {
    "blend_fwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:141"),
    "blend_bwd": dict(
        route="cuda", source="irgs_tpu_torch/csrc/raster_blend.cu",
        replaces="irgs_tpu/ops/raster_pallas.py:222"),
}


def kernels_line(results):
    out = []
    for name, meta in KERNELS.items():
        bench = results[name]["bench_400px_100k"]
        out.append({"name": name, **meta,
                    "launches": results["launches"][name],
                    "max_abs_err": bench["max_abs_err"], "ms": bench["ms"],
                    "plain_ms": bench["plain_ms"],
                    "bound_ms": bench["bound_ms"],
                    "bound_by": bench["bound_by"],
                    "matches_plain": all(c["ok"] for c in
                                         results[name].values()),
                    # no single PyTorch call computes the per-tile blend
                    "library_ms": None})
    return {"kernels": out}


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return res.stdout.strip().splitlines()[0]


def main():
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
    phase_build()
    phase_kernels(results)
    phase_stage2_small()
    phase_stage2(results)
    print(json.dumps(kernels_line(results)), flush=True)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1)})
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
