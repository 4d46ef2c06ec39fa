"""Experiment grid: scene x envmap sweeps through the two-stage pipeline,
resumable per step, aggregated by collect_results (≙ run_grid.py).

    python -m irgs_tpu_torch.tools.run_grid --data_root <root> \\
        --scenes <scene>... --out <out> [--envmaps <subdir>...] \\
        [--steps stage1 stage2 nvs material relight] [--redo] \\
        [--keep_going] [--relight_envmaps <exr>...] [--device cuda]

Each cell runs, as the JAX script's does, the stage-1 CLI, the stage-2 CLI
from its checkpoint, the NVS render, the material eval and (with
`--relight_envmaps`) the relighting eval, each as `python -m` of this
package's module:

  stage1    irgs_tpu_torch.train_refgaussian
  stage2    irgs_tpu_torch.train
  nvs       irgs_tpu_torch.render
  material  irgs_tpu_torch.eval.material
  relight   irgs_tpu_torch.eval.relighting

with the JAX script's arguments and `--device` added. Each step logs to
<out>/<scene>[/<envmap>]/logs/<step>.log and writes a `.done` marker on
success, so a stopped grid resumes where it stopped (`--redo` ignores the
markers). An `--envmaps` entry is set as DATA_SUBDIR in the children's
environment only. Then the port's copy of collect_results.py aggregates
each kind over the cells, run as a script (it needs numpy only, and a
`python -m` of the package would import torch first). From Python,
``main(argv, run_cmd=...)`` takes another runner ``run_cmd(module, argv,
log_file, env) -> exit code``, such as `run_in_process`, which calls the
module's ``main(argv)`` in the calling process.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ALL_STEPS = ("stage1", "stage2", "nvs", "material", "relight")
COLLECT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "collect_results.py")
MODULES = {"stage1": "train_refgaussian", "stage2": "train", "nvs": "render",
           "material": "eval.material", "relight": "eval.relighting"}


def run_subprocess(module, argv, log_file, env):
    """`python -m irgs_tpu_torch.<module> argv` with its output appended to
    the open `log_file` -> its exit code."""
    cmd = [sys.executable, "-m", f"irgs_tpu_torch.{module}", *argv]
    return subprocess.run(cmd, cwd=REPO, stdout=log_file, stderr=log_file,
                          env=env).returncode


def run_in_process(module, argv, log_file, env):
    """The module's main(argv) in this process, its output appended to the
    open `log_file` and `env`'s DATA_SUBDIR set while it runs -> its exit
    code (common.run_module_main)."""
    from .common import run_module_main
    return run_module_main(module, argv, log_file, env)


def run_step(name: str, module: str, argv: list[str], log_dir: str,
             redo: bool, env: dict | None = None,
             run_cmd=run_subprocess) -> bool:
    os.makedirs(log_dir, exist_ok=True)
    done = os.path.join(log_dir, f"{name}.done")
    log = os.path.join(log_dir, f"{name}.log")
    if os.path.exists(done) and not redo:
        print(f"  [skip] {name} (marker exists)", flush=True)
        return True
    shown = " ".join(shlex.quote(c) for c in argv)
    print(f"  [run ] {name}: python -m irgs_tpu_torch.{module} {shown}",
          flush=True)
    t0 = time.time()
    with open(log, "a") as lf:
        lf.write(f"\n=== {time.strftime('%F %T')} python -m "
                 f"irgs_tpu_torch.{module} {' '.join(argv)}\n")
        lf.flush()
        rc = run_cmd(module, argv, lf, env)
    dt = time.time() - t0
    if rc != 0:
        print(f"  [FAIL] {name} rc={rc} after {dt:.0f}s (see {log})",
              flush=True)
        return False
    with open(done, "w") as f:
        f.write(f"{time.strftime('%F %T')} {dt:.0f}s\n")
    print(f"  [done] {name} in {dt:.0f}s", flush=True)
    return True


def _parser():
    ap = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.tools.run_grid",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", required=True,
                    help="dataset root; scenes are subdirectories")
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--envmaps", nargs="*", default=[None],
                    help="optional DATA_SUBDIR grid axis (one image set per "
                         "envmap subdir)")
    ap.add_argument("--out", required=True, help="output root")
    ap.add_argument("--steps", nargs="+", default=list(ALL_STEPS),
                    choices=ALL_STEPS)
    ap.add_argument("--redo", action="store_true",
                    help="ignore .done markers and re-run")
    ap.add_argument("--keep_going", action="store_true",
                    help="continue the grid past a failed cell")
    # workload knobs (defaults: the reference launch scripts)
    ap.add_argument("--s1_iterations", type=int, default=50_000)
    ap.add_argument("--s2_iterations", type=int, default=20_000)
    ap.add_argument("--resolution", type=int, default=-1)
    ap.add_argument("--diffuse_sample_num", type=int, default=256)
    ap.add_argument("--nvs_diffuse_sample_num", type=int, default=512)
    ap.add_argument("--relight_envmaps", nargs="*", default=[],
                    help="HDR .exr paths for the relighting eval")
    ap.add_argument("--s1_args", default="",
                    help="extra stage-1 CLI args")
    ap.add_argument("--s2_args", default="",
                    help="extra stage-2 CLI args (lambdas etc.; the "
                         "reference spec_v5 defaults apply unless "
                         "overridden)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (cuda, or cpu)")
    return ap


def main(argv=None, run_cmd=run_subprocess):
    args = _parser().parse_args(argv)
    dev = ["--device", args.device]
    failures = []
    for scene in args.scenes:
        for env in args.envmaps:
            tag = scene if env is None else f"{scene}/{env}"
            src = os.path.join(args.data_root, scene)
            out = os.path.join(args.out, scene if env is None
                               else os.path.join(scene, env))
            s1_dir = os.path.join(out, "refgs")
            s2_dir = os.path.join(out, "irgs")
            logs = os.path.join(out, "logs")
            print(f"[grid] {tag}", flush=True)
            # the children's environment only: a DATA_SUBDIR left in this
            # process's would leak into later grid cells
            child_env = {k: v for k, v in os.environ.items()
                         if k != "DATA_SUBDIR"}
            if env is not None:
                child_env["DATA_SUBDIR"] = env

            def step(name, argv_):
                if name not in args.steps:
                    return True
                return run_step(name, MODULES[name], [*argv_, *dev], logs,
                                args.redo, env=child_env, run_cmd=run_cmd)

            ok = True
            ok = ok and step("stage1", [
                "-s", src, "-m", s1_dir,
                "--iterations", str(args.s1_iterations),
                "-r", str(args.resolution),
                *shlex.split(args.s1_args)])
            ok = ok and step("stage2", [
                "-s", src, "-m", s2_dir,
                "--start_checkpoint_refgs", s1_dir,
                "--iterations", str(args.s2_iterations),
                "-r", str(args.resolution),
                "--diffuse_sample_num", str(args.diffuse_sample_num),
                # the reference's train_stage2_spec_v5.sh:21-28 defaults
                "--lambda_base_color_smooth", "2",
                "--lambda_roughness_smooth", "2",
                "--lambda_light_smooth", "0.0005",
                "--lambda_light", "0.1",
                "--init_roughness_value", "0.6",
                "--train_ray",
                *shlex.split(args.s2_args)])
            ok = ok and step("nvs", [
                "-m", s2_dir,
                "--diffuse_sample_num", str(args.nvs_diffuse_sample_num)])
            ok = ok and step("material", ["-m", s2_dir, "--compute_scale"])
            if args.relight_envmaps:
                ok = ok and step("relight", [
                    "-m", s2_dir, "--envmaps", *args.relight_envmaps])
            if not ok:
                failures.append(tag)
                if not args.keep_going:
                    break
        else:
            continue
        break

    # aggregate whatever exists (≙ the reference's collect_nvs*.py)
    model_dirs = [os.path.join(args.out, s) if e is None
                  else os.path.join(args.out, s, e)
                  for s in args.scenes for e in args.envmaps]
    model_dirs = [os.path.join(m, "irgs") for m in model_dirs]
    for kind in ("nvs", "material", "relight"):
        subprocess.run([sys.executable, COLLECT, "--kind", kind,
                        *model_dirs], cwd=REPO)
    if failures:
        print(f"FAILED cells: {failures}", file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"grid": "ok", "cells": len(args.scenes) *
                      len(args.envmaps)}))


if __name__ == "__main__":
    main()
