"""The two-stage pipeline end to end, on the analytic dataset
(≙ tools/run_e2e.py).

    python -m irgs_tpu_torch.tools.run_e2e --root <work dir> [--name e2e]
        [--results <dir>] [--device cuda]

Runs the reference workflow (README.md: train_refgaussian -> train ->
render -> eval_relighting / eval_material), each stage a subprocess of this
package's CLIs:

  dataset       python -m irgs_tpu_torch.tools.make_dataset
  stage1        python -m irgs_tpu_torch.train_refgaussian, the reference's
                50k-iteration phase and densification schedule scaled to
                --s1_iters
  stage2        python -m irgs_tpu_torch.train --start_checkpoint <stage1>
  nvs           python -m irgs_tpu_torch.render
  albedo_scale  python -m irgs_tpu_torch.eval.material --compute_scale
  relight       python -m irgs_tpu_torch.eval.relighting, the dataset's
                sunset.exr and sun.exr
  material      python -m irgs_tpu_torch.eval.material

and writes each stage's wall time and return code, the metric JSONs and the
dataset's meta into ``<results>/summary.json`` (default ``results/<name>/``
under the repository root). `--device` goes to every stage. `--stage_args
STAGE=ARGS` appends arguments to one stage's command (repeatable), e.g.
``--stage_args "stage2=--trace_num_rays 1024"``, which is how a run is cut
below the defaults. From Python, ``main(argv, run_stage=...)`` takes
another runner ``run_stage(tag, module, argv, timeout) -> exit code``,
such as `run_in_process`, which calls the stage's ``main(argv)`` in the
calling process.

The iteration counts are scaled down from the reference's 50k/20k; the
dataset at 400², the stage-2 eval at the dataset's resolution and the eval
samples (512 + 256) are the reference's values.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = ("dataset", "stage1", "stage2", "nvs", "albedo_scale", "relight",
          "material")


def _parser():
    ap = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.tools.run_e2e",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="work directory of the dataset and both runs "
                         "(default: a new temporary directory)")
    ap.add_argument("--name", default="e2e_shadow_torch")
    ap.add_argument("--results", default=None,
                    help="where summary.json and the metric JSONs go "
                         "(default results/<name> under the repository)")
    ap.add_argument("--img", type=int, default=400,
                    help="dataset resolution (≙ the reference's 800 at -r 2)")
    ap.add_argument("--ss", type=int, default=1,
                    help="dataset supersampling")
    ap.add_argument("--ds_spp", type=int, nargs=2, default=(256, 128),
                    metavar=("DIFFUSE", "LIGHT"),
                    help="dataset GT sample counts")
    ap.add_argument("--ds_grid", type=int, nargs=2, default=None,
                    metavar=("GROUND", "SPHERE_H"),
                    help="dataset radiosity textures (make_dataset --grid)")
    ap.add_argument("--ds_rad_spp", type=int, nargs=2, default=None,
                    metavar=("DIFFUSE", "LIGHT"),
                    help="dataset radiosity samples (make_dataset --rad_spp)")
    ap.add_argument("--n_train", type=int, default=64)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--s1_iters", type=int, default=3000)
    ap.add_argument("--s1_indirect_tail", type=int, default=0,
                    help=">0: run the indirect + TSDF surfel phase for the "
                         "last N iterations only")
    ap.add_argument("--s2_iters", type=int, default=1500)
    ap.add_argument("--resolution", type=int, default=1,
                    help="stage-2 and eval resolution divisor on --img")
    ap.add_argument("--eval_spp", type=int, nargs=2, default=(512, 256),
                    metavar=("DIFFUSE", "LIGHT"),
                    help="NVS and relighting eval sample counts")
    ap.add_argument("--skip_dataset", action="store_true")
    ap.add_argument("--skip_stage1", action="store_true")
    ap.add_argument("--skip_stage2", action="store_true")
    ap.add_argument("--skip_eval", action="store_true",
                    help="train only (schedules and curves, no metrics)")
    ap.add_argument("--max_eval_images", type=int, default=4)
    ap.add_argument("--relight_images", type=int, default=4)
    ap.add_argument("--stage_args", action="append", default=[],
                    metavar="STAGE=ARGS",
                    help="extra arguments of one stage (" + ", ".join(STAGES)
                         + ")")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (cuda, or cpu)")
    return ap


def stage1_schedule(s1_iters: int, indirect_tail: int = 0) -> dict:
    """The reference's 50k-iteration schedule (arguments/refgs.py defaults)
    scaled to `s1_iters`, so a short run still passes initial -> volume ->
    surfel and the densify/reset cadence."""
    f = s1_iters / 50_000.0
    return {
        "volume_render_until_iter": round(18_000 * f),
        "normal_smooth_until_iter": round(18_000 * f),
        "indirect_from_iter": (s1_iters - indirect_tail if indirect_tail > 0
                               else round(20_000 * f)),
        "feature_rest_from_iter": round(5_000 * f),
        "normal_prop_until_iter": round(25_000 * f),
        "densify_until_iter": round(25_000 * f),
        "densify_from_iter": max(100, round(500 * f)),
        "opacity_reset_interval": max(500, round(3_000 * f)),
        "dist_loss_start": round(3_000 * f),
        "position_lr_max_steps": s1_iters,
    }


def run_subprocess(tag, module, argv, timeout):
    """`python -m irgs_tpu_torch.<module> argv` -> its exit code (-9 when it
    ran past `timeout` seconds)."""
    try:
        return subprocess.run(
            [sys.executable, "-m", f"irgs_tpu_torch.{module}", *argv],
            cwd=REPO, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        return -9


def run_in_process(tag, module, argv, timeout):
    """The stage's main(argv) in this process -> its exit code (1 on an
    exception, whose traceback is printed; `timeout` is not enforced)."""
    from .common import run_module_main
    return run_module_main(module, argv)


def main(argv=None, run_stage=run_subprocess):
    args = _parser().parse_args(argv)
    extra = {s: [] for s in STAGES}
    for item in args.stage_args:
        stage, _, rest = item.partition("=")
        if stage not in extra:
            raise SystemExit(f"--stage_args: unknown stage {stage!r} "
                             f"(one of {', '.join(STAGES)})")
        extra[stage] += shlex.split(rest)

    if args.root is None:
        import tempfile
        args.root = tempfile.mkdtemp(prefix="irgs_e2e_")
    ds = os.path.join(args.root, "dataset")
    s1 = os.path.join(args.root, "stage1")
    s2 = os.path.join(args.root, "stage2")
    os.makedirs(args.root, exist_ok=True)
    out = args.results or os.path.join(REPO, "results", args.name)
    timings, rcs = {}, {}
    dev = ["--device", args.device]

    def run(tag, module, cmd, required=True, timeout=14400):
        """required=False: a failed stage is recorded and the rest go on
        (a failed eval must not void what the earlier stages produced).
        `timeout`: seconds the stage may take, the reference's."""
        full = [*cmd, *dev, *extra[tag]]
        print(f"+ [{tag}] python -m irgs_tpu_torch.{module} {' '.join(full)}",
              flush=True)
        t0 = time.time()
        rc = run_stage(tag, module, full, timeout)
        timings[tag] = time.time() - t0
        rcs[tag] = rc
        if rc != 0:
            if required:
                _write_summary(out, args, timings, rcs, ds, s2)
                raise SystemExit(f"[{tag}] failed rc={rc}")
            print(f"[{tag}] FAILED rc={rc} (continuing)", flush=True)
            return
        print(f"[{tag}] done in {timings[tag]:.1f}s", flush=True)

    if not args.skip_dataset:
        cmd = ["--out", ds, "--img", str(args.img), "--n_train",
               str(args.n_train), "--n_test", str(args.n_test), "--ss",
               str(args.ss), "--spp", *map(str, args.ds_spp)]
        if args.ds_grid:
            cmd += ["--grid", *map(str, args.ds_grid)]
        if args.ds_rad_spp:
            cmd += ["--rad_spp", *map(str, args.ds_rad_spp)]
        run("dataset", "tools.make_dataset", cmd)

    if not args.skip_stage1:
        sch = stage1_schedule(args.s1_iters, args.s1_indirect_tail)
        sch_flags = [x for k, v in sch.items() for x in (f"--{k}", str(v))]
        # 2^21 duplicate capacity: the 100k-point init at 400² overflows
        # the 2^20 default
        run("stage1", "train_refgaussian",
            ["-s", ds, "-m", s1, "--iterations", str(args.s1_iters),
             "--dup_capacity", str(2 ** 21), "--white_background", "--eval",
             *sch_flags])

    if not args.skip_stage2:
        run("stage2", "train",
            ["-s", ds, "-m", s2, "--start_checkpoint", s1,
             "--iterations", str(args.s2_iters),
             "--resolution", str(args.resolution), "--white_background",
             "--eval", "--vis_interval", "0"])

    if args.skip_eval:
        print("skip_eval: stopping after training", flush=True)
    else:
        spp = ["--diffuse_sample_num", str(args.eval_spp[0]),
               "--light_sample_num", str(args.eval_spp[1])]
        run("nvs", "render",
            ["-m", s2, "--max_images", str(args.max_eval_images), *spp],
            required=False)
        run("albedo_scale", "eval.material", ["-m", s2, "--compute_scale"],
            required=False)
        run("relight", "eval.relighting",
            ["-m", s2, "--max_images", str(args.relight_images), *spp,
             "--envmaps", os.path.join(ds, "sunset.exr"),
             os.path.join(ds, "sun.exr")], required=False, timeout=7200)
        run("material", "eval.material", ["-m", s2], required=False,
            timeout=7200)
    summary = _write_summary(out, args, timings, rcs, ds, s2)
    print(json.dumps(summary.get("nvs_results", {}), indent=2))
    print("summary written to", out, flush=True)


def _write_summary(out, args, timings, rcs, ds, s2):
    os.makedirs(out, exist_ok=True)
    summary = {"config": vars(args), "timings_s": timings, "rc": rcs}
    for src, dst in [
            (os.path.join(s2, "test", "nvs_results.json"), "nvs_results.json"),
            (os.path.join(s2, "nvs_results.json"), "nvs_results.json"),
            (os.path.join(s2, "relighting_results.json"),
             "relighting_results.json"),
            (os.path.join(s2, "material_results.json"),
             "material_results.json"),
            (os.path.join(ds, "dataset_meta.json"), "dataset_meta.json")]:
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out, dst))
            with open(src) as f:
                summary[dst.replace(".json", "")] = json.load(f)
    log = os.path.join(s2, "train_log.jsonl")
    if os.path.exists(log):
        with open(log) as f:
            summary["stage2_log"] = [json.loads(line) for line in f]
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
