"""Profile one NVS eval frame of the port at the bench scene on the card.

    python3 -m irgs_tpu_torch.profile_eval [--out FILE] [--relight]

Renders one warm-up frame of `workload.EVAL` (with `--relight`, one view of
the relighting CLI instead: the same scene and camera at 512 + 256 samples
under two 256x512 envmaps, the toy blob env and a dimmed copy, with the
G-buffer, the hemisphere half, the relit shading and its environment
queries as stages of their own, and no profiled view); then one frame with
its stages timed on the host clock, synchronised at each boundary: the
G-buffer, the first pass's cell collection, hit selection and blends
(`trace`), and the re-trace rounds (with their own collection, selection
and blends nested under them, as "retrace_rounds/select_hits"); what is
left is sampling, environment lookups and shading ("rest"). Then one whole
frame, and one frame under torch.profiler (CPU + CUDA activities). Prints
the stage times, the device's busy time in the profiled frame and its
share of that frame and of the unprofiled one, and the ops ranked by self
CUDA time and by self CPU time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch


class _NestedStages:
    """Synchronised wall time per call of the wrapped functions, keyed by
    the chain of enclosing wrapped calls ("retrace_rounds/select_hits")."""

    def __init__(self):
        self.ms, self.calls, self._stack = {}, {}, []

    def wrap(self, mod, name):
        """-> (mod, name, the function, its timed wrapper)."""
        fn = getattr(mod, name)

        def timed(*args, **kw):
            self._stack.append(name)
            key = "/".join(self._stack)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms[key] = (self.ms.get(key, 0.0)
                                + (time.perf_counter() - t0) * 1e3)
                self.calls[key] = self.calls.get(key, 0) + 1
                self._stack.pop()

        return mod, name, fn, timed


@contextlib.contextmanager
def _staged(stages: _NestedStages):
    """Wrap the eval frame's and the relighting view's stage functions for
    the duration."""
    from .eval import relighting
    from .ops import grid_tracer as gt
    from .render import eval as ev
    from .render import relight
    patches = [stages.wrap(ev, "_gbuffer"),
               stages.wrap(relighting, "relight_gbuffer")] + [
        stages.wrap(relight, n) for n in ("trace_diffuse_cache",
                                          "rendering_equation_relight",
                                          "env_query")] + [
        stages.wrap(gt, n) for n in ("collect_cells", "select_hits", "trace",
                                     "blend_hits", "retrace_rounds")]
    for mod, name, _, timed in patches:
        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, fn, _ in patches:
            setattr(mod, name, fn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the summary and both tables to this file")
    ap.add_argument("--rows", type=int, default=30)
    ap.add_argument("--relight", action="store_true",
                    help="profile one view of the relighting CLI instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_eval runs on a CUDA card only")
    from torch.profiler import ProfilerActivity, profile
    from . import workload
    from .render.eval import render_ir_eval

    dev = torch.device("cuda")
    params, aux, grid, cam, ecfg = workload.eval_setup(**workload.EVAL,
                                                       device=dev)
    render = lambda: render_ir_eval(params, aux, grid, cam, ecfg)
    if args.relight:
        import numpy as np
        from .eval import relighting
        from .render import ir, relight
        from .scene import cubemap as cm
        from .scene import toy
        hdr = torch.tensor(np.exp(toy.make_blob_env(256, 512)), device=dev)
        envs = [relight.build_relight_env(hdr),
                relight.build_relight_env(0.3 * hdr + 0.1)]
        lut = cm.compute_fg_lut(device=dev)
        shade = ir.ShadeConfig(diffuse_sample_num=512, light_sample_num=256,
                               training=False)
        ones = torch.ones(3, device=dev)
        render = lambda: relighting.relight_view(
            params, aux, grid, cam, envs, ecfg.tracer, shade, lut, ones,
            ecfg.img_w, ecfg.img_h, ecfg.active_sh_degree)
    render()
    torch.cuda.synchronize()

    stages = _NestedStages()
    t0 = time.perf_counter()
    with _staged(stages):
        render()
    staged_ms = (time.perf_counter() - t0) * 1e3
    top = {k: v for k, v in stages.ms.items() if "/" not in k}
    stage_ms = dict(stages.ms, rest=staged_ms - sum(top.values()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    summary = {"path": "relight" if args.relight else "eval",
               "frame_ms": frame_ms, "staged_frame_ms": staged_ms,
               "stage_ms": stage_ms, "stage_calls": stages.calls,
               "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    tables = ""
    # a relighting view is not profiled: on the H100, torch.profiler had not
    # finished with one (106 s unprofiled) 25 minutes after it began
    if not args.relight:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        # device kernels only: an operator's own row repeats its kernels' time
        dev_events = [e for e in ka
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in dev_events)
        gather = [e for e in dev_events if "gather_rows_kernel" in e.key]
        summary.update(
            wall_ms_profiled_frame=wall_ms, device_busy_ms=dev_us / 1e3,
            device_busy_share_profiled=dev_us / 1e3 / wall_ms,
            device_busy_share_unprofiled=dev_us / 1e3 / frame_ms,
            gather_kernel_ms=sum(e.self_device_time_total
                                 for e in gather) / 1e3,
            gather_kernel_launches=sum(e.count for e in gather))
        by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=args.rows)
        tables = (ka.table(sort_by="self_cuda_time_total",
                           row_limit=args.rows) + "\n\n" + by_cpu[:6000])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(summary) + "\n\n" + tables)
    print(json.dumps(summary))
    print(tables)


if __name__ == "__main__":
    main()
