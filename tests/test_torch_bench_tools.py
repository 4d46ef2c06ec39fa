"""The port's bench tools (python -m irgs_tpu_torch.bench,
.tools.bench_stage1, .tools.bench_frame, .tools.bench_variant with each of
its tracer variants) on the CPU, each shrunk through a parameter of its
main: each prints its last line as one JSON object with the key set of its
JAX script (read from the script's source: bench.py, tools/bench_stage1.py,
tools/bench_frame.py, tools/bench_variant.py), finite numbers where the JAX
script prints numbers, and the fields the port cannot fill as null. Times
are not compared. The bench refuses a workload whose dup capacity drops
splats, as bench.py's honesty check does.
"""

import ast
import json
import math
import os

import pytest
import torch

from irgs_tpu_torch import bench
from irgs_tpu_torch.tools import bench_frame, bench_stage1, bench_variant
from test_torch_eval import TRACER
from test_torch_mis import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_surface=512, n_capacity=1024, img=32, spp=8, rays=2048,
            dup=2 ** 14)


def jax_json_keys(script):
    """The keys of the JSON line a JAX bench script prints last: the keys of
    the dict literal passed to json.dumps, or assigned into the dict it
    dumps (f-string keys expanded over the tuple the loop iterates)."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "dumps"]
    arg = dumps[-1].args[0]
    if isinstance(arg, ast.Dict):
        return {k.value for k in arg.keys}
    name, keys = arg.id, set()
    for n in ast.walk(tree):                 # name = {...}
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and getattr(n.targets[0], "id", "") == name):
            keys |= {k.value for k in n.value.keys}
    loops = {n.target.id: [e.value for e in n.iter.elts]
             for n in ast.walk(tree) if isinstance(n, ast.For)
             and isinstance(n.iter, ast.Tuple)}
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Subscript)
                and getattr(n.targets[0].value, "id", "") == name):
            continue
        key = n.targets[0].slice
        if isinstance(key, ast.Constant):
            keys.add(key.value)
        else:                                # f"prefix_{var}_suffix"
            parts = key.values
            var = parts[1].value.id
            keys |= {parts[0].value + v + parts[2].value for v in loops[var]}
    return keys


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_prints_bench_py_keys(capsys):
    bench.main(["--device", "cpu"], workload=TINY, n_rounds=2, n_iters=1)
    out = last_json(capsys)
    assert set(out) == jax_json_keys("bench.py")
    assert out["metric"] == "stage2_train_iters_per_sec"
    assert math.isfinite(out["value"]) and out["value"] > 0
    # no cross-device baseline and no cost model: null, not a guess
    for k in ("vs_baseline", "mfu", "hbm_util", "flops_per_step",
              "bytes_per_step"):
        assert out[k] is None, k


def test_bench_raises_on_raster_overflow():
    with pytest.raises(RuntimeError, match="dup overflow"):
        bench.main(["--device", "cpu"], workload=dict(TINY, dup=64),
                   n_rounds=1, n_iters=1)


def test_bench_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([], workload=TINY)


@pytest.mark.parametrize("name", sorted(bench_variant.VARIANTS))
def test_bench_variant_prints_script_keys(capsys, name):
    out = bench_variant.main([name, "--device", "cpu"], workload=dict(
        TINY, n_surface=128, n_capacity=256, img=16, spp=4, rays=256,
        dup=2 ** 12), n_rounds=1, n_iters=1)
    assert last_json(capsys) == out
    assert set(out) == jax_json_keys("tools/bench_variant.py")
    assert out["variant"] == name
    assert math.isfinite(out["iters_per_sec"]) and out["iters_per_sec"] > 0


def test_bench_stage1_prints_script_keys(capsys):
    bench_stage1.main(["--device", "cpu", "--img", "32", "--n", "400",
                       "--iters", "1"], n_capacity=512, n_cams=2, env_res=16,
                      fg_lut=dict(res=32, samples=64))
    out = last_json(capsys)
    assert set(out) == jax_json_keys("tools/bench_stage1.py") == {
        "stage1_initial_iters_per_sec", "stage1_volume_iters_per_sec",
        "stage1_surfel_iters_per_sec", "stage1_densify_ms",
        "stage1_tsdf_refresh_s"}
    assert all(math.isfinite(v) and v > 0 for v in out.values())


def test_bench_frame_prints_script_keys(capsys):
    bench_frame.main(["--device", "cpu", "--img", "32", "--n", "400",
                      "--spp", "4", "2"], n_capacity=512,
                     tracer=TRACER,
                     dup_capacity=2 ** 14)
    text = capsys.readouterr().out
    assert "grid built, overflow: 0" in text
    out = json.loads(text.strip().splitlines()[-1])
    assert set(out) == jax_json_keys("tools/bench_frame.py")
    assert out["frame_img"] == 32 and out["fg_pixels"] > 0
    assert out["rays_per_frame"] == out["fg_pixels"] * 6
    assert all(math.isfinite(v) for v in out.values())
