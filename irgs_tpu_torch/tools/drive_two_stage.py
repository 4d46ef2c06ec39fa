"""End-to-end two-stage toy drive through the CLIs
(≙ tools/drive_two_stage.py): stage-1 geometry training -> checkpoint ->
stage-2 material training from it -> stage-2 PLY.

    python -m irgs_tpu_torch.tools.drive_two_stage [--s1_iters 200]
        [--s2_iters 100] [--root <dir>] [--device cuda]

Runs ``python -m irgs_tpu_torch.train_refgaussian --toy -m <root>/stage1
--iterations <s1_iters> --mesh_interval 100``, asserts a stage-1
checkpoint, runs ``python -m irgs_tpu_torch.train --toy -m <root>/stage2
--iterations <s2_iters> --vis_interval 0 --start_checkpoint <root>/stage1``,
asserts a stage-2 PLY, and prints the first and last ray PSNR of the
stage-2 log, which must be positive. `--device` is passed to both CLIs.
The JAX script's root is /tmp/two_stage_drive; the port's default is
two_stage_drive/ under the working directory.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_subprocess(module: str, argv: list[str]) -> str:
    """`python -m irgs_tpu_torch.<module> argv` -> its standard output; a
    failure raises SystemExit with its error output's end."""
    cmd = [sys.executable, "-m", f"irgs_tpu_torch.{module}", *argv]
    print("+ " + " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, cwd=REPO, text=True, capture_output=True,
                          timeout=3000)
    sys.stdout.write(proc.stdout[-3000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"command failed: {cmd}")
    return proc.stdout


def main(argv=None, run=run_subprocess):
    """`run(module, argv)` runs each CLI (a test passes a recorder)."""
    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.drive_two_stage",
        description=__doc__.splitlines()[0])
    ap.add_argument("--s1_iters", type=int, default=200)
    ap.add_argument("--s2_iters", type=int, default=100)
    ap.add_argument("--root", default="two_stage_drive")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.root = os.path.abspath(args.root)    # the CLIs run from REPO
    s1_dir = os.path.join(args.root, "stage1")
    s2_dir = os.path.join(args.root, "stage2")
    os.makedirs(args.root, exist_ok=True)

    run("train_refgaussian", ["--toy", "-m", s1_dir, "--iterations",
                              str(args.s1_iters), "--mesh_interval", "100",
                              "--device", args.device])
    ckpts = glob.glob(os.path.join(s1_dir, "chkpnt*.ckpt"))
    assert ckpts, f"stage-1 produced no checkpoint in {s1_dir}"
    print(f"stage-1 checkpoint: {ckpts}", flush=True)

    run("train", ["--toy", "-m", s2_dir, "--iterations", str(args.s2_iters),
                  "--vis_interval", "0", "--start_checkpoint", s1_dir,
                  "--device", args.device])
    plys = glob.glob(os.path.join(s2_dir, "point_cloud", "iteration_*",
                                  "point_cloud.ply"))
    assert plys, f"stage-2 produced no PLY in {s2_dir}"

    with open(os.path.join(s2_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    first, last = rows[0], rows[-1]
    summary = {"stage1_ckpt": sorted(ckpts)[0], "stage2_ply": sorted(plys)[-1],
               "s2_first_psnr": first.get("ray_psnr"),
               "s2_last_psnr": last.get("ray_psnr")}
    print(json.dumps(summary), flush=True)
    assert last.get("ray_psnr", 0) > 0
    print("two-stage drive OK", flush=True)
    return summary


if __name__ == "__main__":
    main()
