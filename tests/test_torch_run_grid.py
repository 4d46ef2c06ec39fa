"""The port's grid script (python -m irgs_tpu_torch.tools.run_grid) against
the JAX package's run_grid.py, and the port's copy of collect_results
against the root script.

With subprocess.run recording commands instead of running them, both
scripts walk the same scene x envmap grid: the port issues the JAX
script's command list, each root script mapped to its `python -m
irgs_tpu_torch.*` module (collect_results.py the port's copy) and
`--device` added to each child, with the same
DATA_SUBDIR in the children's environment; the `.done` markers skip steps
and `--redo` runs them again in both. Then the port's run_grid runs a real
one-step grid on the CPU through its in-process runner (a stage-1 CLI run,
its marker and log). collect_results' copy prints what the root script
prints on the same JSON files.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from irgs_tpu_torch.tools import collect_results as tcollect
from irgs_tpu_torch.tools import run_grid as trun
from test_torch_mis import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE_OF = {"train_refgaussian.py": "irgs_tpu_torch.train_refgaussian",
             "train.py": "irgs_tpu_torch.train",
             "render.py": "irgs_tpu_torch.render",
             "eval_material.py": "irgs_tpu_torch.eval.material",
             "eval_relighting.py": "irgs_tpu_torch.eval.relighting"}


def _load_root(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """subprocess.run stand-in: records (argv, DATA_SUBDIR) and succeeds."""

    def __init__(self):
        self.calls = []

    def __call__(self, cmd, cwd=None, env=None, **kw):
        self.calls.append((list(cmd), (env or {}).get("DATA_SUBDIR")))
        return subprocess.CompletedProcess(cmd, 0)


def _grid_args(out):
    return ["--data_root", "/data", "--scenes", "hook", "mouse",
            "--envmaps", "dam", "chapel", "--out", out,
            "--s1_iterations", "30", "--s2_iterations", "20",
            "--relight_envmaps", "/env/a.exr", "/env/b.exr",
            "--s2_args", "--lambda_light 0.2"]


def _jax_calls(monkeypatch, out, *extra):
    rec = Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    monkeypatch.setattr(sys, "argv", ["run_grid.py", *_grid_args(out),
                                      *extra])
    _load_root("run_grid").main()
    return [(_as_module(c, out), env) for c, env in rec.calls]


def _port_calls(monkeypatch, out, *extra):
    rec = Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    trun.main([*_grid_args(out), *extra, "--device", "cpu"])
    calls = []
    for cmd, env in rec.calls:
        cmd = [c.replace(out, "<out>") for c in cmd]
        if cmd[-2:] == ["--device", "cpu"]:      # a child of the grid
            cmd = cmd[:-2]
        calls.append((cmd, env))
    return calls


def _as_module(cmd, out):
    """The JAX script's command with its root script as the port's module,
    and collect_results.py as the port's copy of it."""
    py, script, *rest = cmd
    rest = [c.replace(out, "<out>") for c in rest]
    if script == "collect_results.py":
        return [py, trun.COLLECT, *rest]
    return [py, "-m", MODULE_OF[script], *rest]


def test_command_list_matches_jax(monkeypatch, tmp_path):
    jax_calls = _jax_calls(monkeypatch, str(tmp_path / "jax"))
    port_calls = _port_calls(monkeypatch, str(tmp_path / "port"))
    # 4 cells x 5 steps, then collect_results for nvs, material, relight
    assert len(jax_calls) == 4 * 5 + 3
    assert port_calls == jax_calls
    assert [env for _, env in port_calls[:5]] == ["dam"] * 5


def test_done_markers_skip_and_redo_reruns(monkeypatch, tmp_path):
    for name, calls_of in (("jax", _jax_calls), ("port", _port_calls)):
        out = str(tmp_path / name)
        first = calls_of(monkeypatch, out)
        again = calls_of(monkeypatch, out)
        redo = calls_of(monkeypatch, out, "--redo")
        # every step left its marker: a second run only aggregates
        assert len(again) == 3 and again == first[-3:], name
        assert redo == first, name
        logs = os.path.join(out, "hook", "dam", "logs")
        assert sorted(os.listdir(logs)) == sorted(
            f"{s}.{x}" for s in trun.ALL_STEPS for x in ("done", "log"))


def test_steps_subset_and_keep_going(monkeypatch, tmp_path):
    """--steps picks steps; a failed cell stops the grid unless
    --keep_going, and run_grid exits 1 after aggregating."""
    calls = _port_calls(monkeypatch, str(tmp_path / "a"), "--steps", "nvs",
                        "material")
    assert [c[2] for c, _ in calls[:2]] == ["irgs_tpu_torch.render",
                                            "irgs_tpu_torch.eval.material"]
    assert len(calls) == 4 * 2 + 3
    for extra, n_cells in (((), 1), (("--keep_going",), 4)):
        ran = []

        def fail_stage1(module, argv, log_file, env):
            ran.append(module)
            return 1 if module == "train_refgaussian" else 0
        monkeypatch.setattr(subprocess, "run", Recorder())
        with pytest.raises(SystemExit) as exc:
            trun.main([*_grid_args(str(tmp_path / f"f{n_cells}")), *extra,
                       "--device", "cpu"], run_cmd=fail_stage1)
        assert exc.value.code == 1 and ran == ["train_refgaussian"] * n_cells


def test_in_process_grid_runs_a_stage1_step(tmp_path, capsys):
    """A real one-step grid (the stage-1 CLI's CPU toy through the
    in-process runner): the step's marker, its log, and a second run that
    skips it by the marker."""
    data = tmp_path / "data"
    (data / "toy").mkdir(parents=True)
    argv = ["--data_root", str(data), "--scenes", "toy", "--out",
            str(tmp_path / "out"), "--steps", "stage1", "--s1_iterations",
            "2", "--s1_args=--toy", "--device", "cpu"]
    trun.main(argv, run_cmd=trun.run_in_process)
    logs = tmp_path / "out" / "toy" / "logs"
    assert (logs / "stage1.done").exists()
    assert "train_refgaussian" in (logs / "stage1.log").read_text()
    assert os.path.isdir(tmp_path / "out" / "toy" / "refgs")
    trun.main(argv, run_cmd=trun.run_in_process)
    out = capsys.readouterr().out
    assert "[skip] stage1 (marker exists)" in out
    assert json.loads(out.strip().splitlines()[-1]) == {"grid": "ok",
                                                        "cells": 1}


def _write_results(base):
    """Two runs' metric JSONs as the eval CLIs write them."""
    runs = []
    for i, name in enumerate(("hook", "mouse")):
        run = base / name
        (run / "test").mkdir(parents=True)
        json.dump({"psnr": 25.0 + i, "ssim": 0.9 - 0.1 * i, "lpips": None},
                  open(run / "test" / "nvs_results.json", "w"))
        json.dump({"psnr_albedo": 20.5 + 2 * i, "ssim_albedo": 0.8,
                   "psnr_roughness": 17.0 - i},
                  open(run / "material_results.json", "w"))
        json.dump({"a": {"psnr_pbr": 20.0}, "average": {
            "psnr_pbr": 21.0 + i, "ssim_pbr": 0.7, "lpips_pbr": None}},
            open(run / "relighting_results.json", "w"))
        runs.append(str(run))
    runs.append(str(base / "missing"))
    return runs


@pytest.mark.parametrize("kind", ["nvs", "material", "relight"])
def test_collect_results_copy_matches_root_script(kind, tmp_path, capsys,
                                                  monkeypatch):
    runs = _write_results(tmp_path)
    root = _load_root("collect_results")
    monkeypatch.setattr(sys, "argv", ["collect_results.py", *runs,
                                      "--kind", kind])
    root.main()
    want = capsys.readouterr()
    tcollect.main([*runs, "--kind", kind])
    got = capsys.readouterr()
    assert got.out == want.out and "(n=2)" in got.out
    assert got.err == want.err
