"""The port's end-to-end tool (irgs_tpu_torch.tools.run_e2e) on the CPU at
toy scale: a 16² analytic dataset of 2 + 1 views with a 2000-point init
cloud, 10 stage-1 and 3 stage-2 iterations, and the NVS, material and
relighting evals at 8 + 8 samples. The dataset stage runs as
`python -m irgs_tpu_torch.tools.make_dataset` (run_e2e's default
runner); the others run each CLI's main(argv) in this process
(`run_e2e.run_in_process`) with the sizes the stage-1 CLI's CPU toy uses
(16² cubemaps, a 32² FG table of 64 samples) and relighting chunks of 256
pixels patched in. Every stage's return code is 0 and the summary holds
each stage's time, the three metric JSONs with finite PSNR, the dataset's
meta and the stage-2 log."""

import json
import math
import os

import pytest
import torch

from irgs_tpu_torch.eval import relighting
from irgs_tpu_torch.ops import gather_rows as gr
from irgs_tpu_torch.ops import raster_blend as rb
from irgs_tpu_torch.ops import segment_sum as ss
from irgs_tpu_torch.tools import run_e2e
from irgs_tpu_torch.train_refgaussian import __main__ as s1_cli

STAGES = ("dataset", "stage1", "stage2", "nvs", "albedo_scale", "relight",
          "material")
MODULES = ("tools.make_dataset", "train_refgaussian", "train", "render",
           "eval.material", "eval.relighting", "eval.material")
# the eval tracer at the CPU tests' budgets (tests/test_torch_eval_cli.py)
EVAL_TRACER = (" --tracer_max_cells_eval 8 --tracer_max_hits_eval 16"
               " --tracer_select_tiles_eval 4"
               " --tracer_retrace_select_tiles_eval 4"
               " --tracer_hit_budget_eval 8 --tracer_max_crossings_eval 12")
TOY = ["--device", "cpu", "--img", "16", "--n_train", "2", "--n_test", "1",
       "--ds_spp", "8", "8", "--ds_grid", "8", "4", "--ds_rad_spp", "8", "8",
       "--s1_iters", "10", "--s2_iters", "3", "--eval_spp", "8", "8",
       "--max_eval_images", "1", "--relight_images", "1",
       "--stage_args", "dataset=--env_res 8 --points 2000",
       "--stage_args", "stage1=--max_gaussians 4096 --mesh_res 24 "
                       "--dup_capacity 65536",
       "--stage_args", "stage2=--trace_num_rays 1024 --diffuse_sample_num 8 "
                       "--tracer_grid_res 16 --tracer_max_cells 8 "
                       "--tracer_max_hits 16 --tracer_hit_budget 8 "
                       "--tracer_max_crossings 12 --dup_capacity 65536 "
                       "--envmap_resolution 16",
       "--stage_args", "nvs=--eval_chunk_point_samples 2048" + EVAL_TRACER]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    base = tmp_path_factory.mktemp("e2e")
    res = base / "results"
    calls = []

    def run_stage(tag, module, argv, timeout):
        calls.append((tag, module))
        if tag == "dataset":
            return run_e2e.run_subprocess(tag, module, argv, timeout)
        return run_e2e.run_in_process(tag, module, argv, timeout)

    for mod in (rb, gr, ss):
        mod.reset_launches()
    n = torch.get_num_threads()
    exit_msg = None
    # two torch threads: the test runner's other workers share the cores
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.setattr(s1_cli, "ENV_RES", s1_cli.CPU_TOY_ENV_RES)
        mp.setattr(s1_cli, "FG_LUT", s1_cli.CPU_TOY_FG_LUT)
        mp.setattr(relighting, "pixel_chunk", lambda d, l: 256)
        torch.set_num_threads(2)
        try:
            run_e2e.main(["--root", str(base / "work"), "--results",
                          str(res), *TOY], run_stage=run_stage)
        except SystemExit as e:
            exit_msg = str(e)
        finally:
            torch.set_num_threads(n)
    summary = json.load(open(res / "summary.json"))
    return dict(exit_msg=exit_msg, calls=calls, summary=summary, res=res,
                work=base / "work",
                launches={**rb.LAUNCHES, **gr.LAUNCHES, **ss.LAUNCHES})


def test_every_stage_ran(e2e):
    assert e2e["exit_msg"] is None, e2e["exit_msg"]
    s = e2e["summary"]
    assert s["rc"] == {k: 0 for k in STAGES}
    assert set(s["timings_s"]) == set(STAGES)
    assert all(t > 0 for t in s["timings_s"].values())
    assert s["config"]["device"] == "cpu"


@pytest.mark.parametrize("name", ["nvs_results", "material_results",
                                  "relighting_results"])
def test_metric_jsons(e2e, name):
    assert os.path.exists(e2e["res"] / f"{name}.json")
    res = e2e["summary"][name]
    psnr = [v for k, v in res.items() if "psnr" in k
            and isinstance(v, (int, float))]
    assert psnr and all(math.isfinite(v) for v in psnr), res


def test_dataset_and_stage2_log(e2e):
    meta = e2e["summary"]["dataset_meta"]
    assert (meta["img"], meta["n_train"], meta["n_test"]) == (16, 2, 1)
    log = e2e["summary"]["stage2_log"]
    assert log and log[0]["iter"] == 1
    assert all(math.isfinite(m["loss"]) and m["raster_overflow"] == 0
               for m in log)
    work = e2e["work"]
    assert os.path.exists(work / "stage1" / "chkpnt10.ckpt")
    assert os.listdir(work / "stage2" / "point_cloud")


def test_each_stage_ran_its_cli(e2e):
    """The stages in the reference's order, each through its CLI module; on
    the CPU every kernel wrapper took its plain version, so no launch was
    counted."""
    assert e2e["calls"] == list(zip(STAGES, MODULES))
    assert set(e2e["launches"]) == {"blend_fwd", "blend_bwd", "gather_rows",
                                    "segment_sum"}
    assert all(v == 0 for v in e2e["launches"].values())


def test_a_failed_stage_is_recorded(tmp_path):
    """A required stage that fails stops the run with its rc in the
    summary; run_in_process returns a CLI's SystemExit code (argparse's 2
    here)."""
    res = tmp_path / "results"

    def run_stage(tag, module, argv, timeout):
        return run_e2e.run_in_process(tag, "tools.make_dataset",
                                      ["--no_such_flag"], timeout)

    with pytest.raises(SystemExit, match=r"\[dataset\] failed rc=2"):
        run_e2e.main(["--root", str(tmp_path / "w"), "--results", str(res),
                      "--device", "cpu"], run_stage=run_stage)
    s = json.load(open(res / "summary.json"))
    assert s["rc"] == {"dataset": 2} and set(s["timings_s"]) == {"dataset"}
