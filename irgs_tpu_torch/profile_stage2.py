"""Profile one stage-2 step of the port at the bench workload on the card.

    python3 -m irgs_tpu_torch.profile_stage2 [--out FILE]

Runs one warm-up step; two counted steps (`count_step`: the scatter-adds
of gathered rows' gradients, their launches, the stream time they span and
the host syncs of the step), the second with the scatter-add swapped for
`index_add_`, so that the difference is the scatter-add's own; one step
split at its stage boundaries, each stage timed on the host clock with
synchronisation, then one whole step ("full_step"); three more whole steps,
each synchronised; then one step under torch.profiler (CPU + CUDA
activities). Prints the counts, the stage times,
the device's busy time in the profiled step and its share of that step and
of the unprofiled steps' median, the kernels it launched, and the ops
ranked by self CUDA time and by self CPU time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch


class _Stages:
    """Wall time per named stage, synchronised at each boundary."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def index_add_rows(grad, idx, n_rows):
    """The atomic scatter-add that ops/segment_sum.scatter_add_rows replaces
    (index_add_, index_select's own backward), of the same arguments (grad a
    tensor or a list of column blocks): the yardstick a step is timed
    against."""
    if not torch.is_tensor(grad):
        grad = torch.cat(list(grad), 1)
    out = torch.zeros((n_rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    return out.index_add_(0, idx, grad)


@contextlib.contextmanager
def scatter_swapped(fn):
    """ops/segment_sum.scatter_add_rows replaced by `fn` inside the block."""
    from .ops import segment_sum as ss
    orig = ss.scatter_add_rows
    ss.scatter_add_rows = fn
    try:
        yield
    finally:
        ss.scatter_add_rows = orig


def count_step(step, scatter_sync_error=False):
    """Run `step()` once and count what it does: each call of
    scatter_add_rows (rows, width, output rows), the stream time the calls
    span (CUDA events around each, no synchronisation), the host time inside
    them, the segment-sum kernel's launches, and the host syncs of the step
    (torch.cuda.set_sync_debug_mode("warn"): one warning each). With
    `scatter_sync_error`, a host sync inside a scatter-add call raises (sync
    debug mode "error" for the call)."""
    from .ops import segment_sum as ss
    calls, events, host_ms = [], [], 0.0
    orig = ss.scatter_add_rows

    def counted(grad, idx, n_rows):
        nonlocal host_ms
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        if scatter_sync_error:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(grad, idx, n_rows)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        b.record()
        host_ms += (time.perf_counter() - t0) * 1e3
        width = sum(b.shape[1] for b in
                    ([grad] if torch.is_tensor(grad) else grad))
        calls.append([int(idx.numel()), int(width), int(n_rows)])
        events.append((a, b))
        return out

    torch.cuda.synchronize()
    launches0 = ss.LAUNCHES["segment_sum"]
    with warnings.catch_warnings(record=True) as caught, \
            scatter_swapped(counted):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    return {"scatter_calls": len(calls), "scatter_shapes": calls,
            "scatter_stream_ms": sum(a.elapsed_time(b) for a, b in events),
            "scatter_host_ms": host_ms,
            "segment_sum_launches": ss.LAUNCHES["segment_sum"] - launches0,
            "host_syncs": syncs}


def _staged_step(state, grid, cam, gt_img, draws, st):
    """stage2_step split at its stage boundaries (same ops, same order)."""
    from .ops import surfel_raster as sr
    from .render import ir
    from .train import stage2 as s2

    T = _Stages()
    p = state.params
    with T("raster_fwd"):
        feats = torch.cat([p.get_base_color(), p.get_roughness()], -1)
        raster = sr.rasterize(p.xyz, p.get_scaling(), p.rotation,
                              p.get_opacity()[:, 0], p.get_features(), feats,
                              None, cam, torch.zeros(3, device=gt_img.device),
                              img_w=st.img_w, img_h=st.img_h,
                              active_sh_degree=st.active_sh_degree,
                              dup_capacity=st.dup_capacity,
                              alive=state.aux.alive)
    with T("gbuffer+select"):
        maps = ir.derive_geometry_maps(raster, cam, st.img_w, st.img_h)
        idx, valid = ir.select_train_pixels(draws.pixel_u,
                                            maps["alpha"][..., 0] > 0.9,
                                            st.num_shaded_pixels)
    with T("trace_fwd"):
        fn = ir.make_trace_fn(p, state.aux, grid, st.tracer, cam.cam_pos, 3)
        flat = lambda x: x.reshape(-1, x.shape[-1])
        normals = flat(maps["normal_map"])[idx]
        dirs, _ = ir.fibonacci_sphere_sampling(normals, st.diffuse_sample_num,
                                               u=draws.theta_u)
        ro = flat(maps["points"])[idx][:, None] + dirs * st.light_t_min
        out = fn(ro, dirs)
    with T("trace_bwd+raster_bwd"):
        (out.color.sum() + out.alpha.sum()).backward()
    state.optimizer.zero_grad()
    with T("full_step"):
        s2.stage2_step(state, grid, cam, gt_img, None, draws, st=st)
    return T.ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the summary and both tables to this file")
    ap.add_argument("--rows", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_stage2 runs on a CUDA card only")
    from torch.profiler import ProfilerActivity, profile
    from . import workload
    from .train import stage2 as s2

    dev = torch.device("cuda")
    state, grid, cams, st = workload.stage2_setup(**workload.BENCH,
                                                  device=dev)
    cam = cams[0].params(dev)
    gt_img = torch.full((400, 400, 3), 0.5, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    s2.stage2_step(state, grid, cam, gt_img, None, s2.draw_stage2(gen, st, dev),
                   st=st)
    torch.cuda.synchronize()

    def step():
        s2.stage2_step(state, grid, cam, gt_img, None,
                       s2.draw_stage2(gen, st, dev), st=st)
    counts = count_step(step)
    with scatter_swapped(index_add_rows):
        counts_index_add = count_step(step)

    stages = _staged_step(state, grid, cam, gt_img,
                          s2.draw_stage2(gen, st, dev), st)
    steps_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    draws = s2.draw_stage2(gen, st, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s2.stage2_step(state, grid, cam, gt_img, None, draws, st=st)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # device kernels only: an operator's own row repeats its kernels' time
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    by_cuda = ka.table(sort_by="self_cuda_time_total", row_limit=args.rows)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=args.rows)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    # the profiler slows the host, so the busy share is also given against
    # the median of three synchronised unprofiled steps
    summary = {"wall_ms_profiled_step": wall_ms,
               "device_busy_ms": dev_us / 1e3,
               "device_busy_share_profiled": dev_us / 1e3 / wall_ms,
               "device_busy_share_unprofiled": (dev_us / 1e3
                                                / statistics.median(steps_ms)),
               "steps_ms": steps_ms,
               "device_kernels": sum(e.count for e in kern),
               "segment_sum_device_ms": sum(
                   e.self_device_time_total for e in kern
                   if "segment_sum" in e.key) / 1e3,
               "stage_ms": stages, "counted_step": counts,
               "counted_step_index_add": counts_index_add,
               "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(summary) + "\n\n" + by_cuda + "\n\n" + by_cpu)
    print(json.dumps(summary))
    print(by_cuda)
    print(by_cpu[:6000])


if __name__ == "__main__":
    main()
