"""Profile one NVS eval frame of the port at the bench scene on the card.

    python3 -m irgs_tpu_torch.profile_eval [--out FILE]

Renders one warm-up frame of `workload.EVAL`; then one frame with its stages
timed on the host clock, synchronised at each boundary: the G-buffer, the
first pass's cell collection, hit selection and blends (`trace`), and the
re-trace rounds (with their own collection, selection and blends nested
under them, as "retrace_rounds/select_hits");
what is left is sampling, environment lookups and shading ("rest"). Then
one whole frame, and one frame under torch.profiler (CPU + CUDA
activities). Prints the stage times, the device's busy time in the profiled
frame and its share of that frame and of the unprofiled one, and the ops
ranked by self CUDA time and by self CPU time.
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
    """Wrap the eval frame's stage functions for the duration."""
    from .ops import grid_tracer as gt
    from .render import eval as ev
    patches = [stages.wrap(ev, "_gbuffer")] + [
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
    gather_us = sum(e.self_device_time_total for e in dev_events
                    if "gather_rows_kernel" in e.key)
    gather_n = sum(e.count for e in dev_events
                   if "gather_rows_kernel" in e.key)
    by_cuda = ka.table(sort_by="self_cuda_time_total", row_limit=args.rows)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=args.rows)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    summary = {"frame_ms": frame_ms, "staged_frame_ms": staged_ms,
               "stage_ms": stage_ms, "stage_calls": stages.calls,
               "wall_ms_profiled_frame": wall_ms,
               "device_busy_ms": dev_us / 1e3,
               "device_busy_share_profiled": dev_us / 1e3 / wall_ms,
               "device_busy_share_unprofiled": dev_us / 1e3 / frame_ms,
               "gather_kernel_ms": gather_us / 1e3,
               "gather_kernel_launches": gather_n,
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
