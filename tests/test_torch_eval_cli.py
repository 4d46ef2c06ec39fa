"""The port's three eval CLIs (`python -m irgs_tpu_torch.render`,
`.eval.material`, `.eval.relighting`, run in-process through `main(argv)`
with `--device cpu`) on a 16x16, 2-view Blender folder and a trained-model
folder (a 512-surfel PLY and its cfg.json at small tracer budgets): the
files and JSON keys the JAX CLIs write, the render CLI at 0 light samples
against `render.py` run on the same folders, and `collect_results.py` on the
three JSON files.

Tolerances: the render CLI against render.py, PSNR within 0.1 dB (the port's
parity budget) and SSIM within 1e-3; its 8-bit PNGs within one level except
for at most 1 % of the elements, each within 255/S + 1 (a sample whose hit
flips moves a pixel by at most 1/S, as in tests/test_torch_eval.py).
"""

import json
import math
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from irgs_tpu_torch.config import Config as TConfig
from irgs_tpu_torch.eval import material, relighting
from irgs_tpu_torch.render import __main__ as render_cli
from irgs_tpu_torch.scene import cubemap as tcm
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.utils import exr, png
from test_torch_mis import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, ITER, S = 16, 3, 8
# the eval tracer at the CPU tests' budgets (tests/test_torch_eval.py)
PIPE = dict(tracer_grid_res=16, tracer_max_cells_eval=8,
            tracer_max_hits_eval=24, tracer_select_tiles_eval=4,
            tracer_retrace_select_tiles_eval=8, tracer_hit_budget_eval=8,
            tracer_retrace_hit_budget_eval=12, tracer_max_crossings_eval=12,
            tracer_retrace_max_crossings_eval=16,
            tracer_retrace_max_cells_eval=12, tracer_retrace_max_hits_eval=48,
            diffuse_sample_num=S, light_sample_num=0)
AOV_FILES = ("render", "base_color", "roughness", "diffuse", "specular",
             "visibility", "light_indirect")


def _write_blender(root, rng):
    os.makedirs(os.path.join(root, "train"))
    yy, xx = np.mgrid[:RES, :RES]
    alpha = (np.hypot(xx - 7.5, yy - 7.5) < 6) * 255
    frames = []
    for i, cam in enumerate(ttoy.make_ring_cameras(2, width=RES,
                                                   height_px=RES)):
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = cam.R, cam.cam_pos
        c2w[:3, 1:3] *= -1                  # COLMAP -> Blender axes
        rgba = np.concatenate([rng.integers(0, 256, (RES, RES, 3)),
                               alpha[..., None]], -1).astype(np.uint8)
        png.write_png(os.path.join(root, "train", f"r_{i}.png"), rgba)
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def _sky(h, w):
    """A linear-radiance lat-long map: a sky gradient and a bright blob."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    sky = 0.2 + 0.6 * (1 - v)[..., None] * np.array([0.6, 0.8, 1.0])
    blob = 20.0 * np.exp(-((u - 0.3) ** 2 + (v - 0.3) ** 2) / 0.005)
    return (sky + blob[..., None] * np.array([1.0, 0.9, 0.7])).astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("evalcli")
    rng = np.random.default_rng(0)
    scene = str(base / "lego")
    _write_blender(scene, rng)

    # the trained model: the toy sphere (half its surfel scale, so that no
    # surfel spans more than span_cap cells of the grid-16 tracer)
    params, aux = ttoy.make_sphere_scene(512, n_capacity=512, env_resolution=16,
                                         device="cpu")
    with torch.no_grad():
        params.scaling -= math.log(2.0)
    run = str(base / "run")
    cfg = TConfig()
    cfg.model.source_path, cfg.model.model_path = scene, run
    cfg.model.max_gaussians, cfg.model.envmap_resolution = 512, 16
    for k, v in PIPE.items():
        setattr(cfg.pipe, k, v)
    cfg.save()
    ply_dir = os.path.join(run, "point_cloud", f"iteration_{ITER}")
    os.makedirs(ply_dir)
    tgs.save_ply(os.path.join(ply_dir, "point_cloud.ply"), params, aux)

    # GT material maps of view r_0 only: the model's own G-buffer (sRGB
    # albedo, roughness as a grey RGB image)
    cam = ttoy.make_ring_cameras(2, width=RES, height_px=RES)[0]
    base_c, rough, _ = material.material_maps(params, aux, cam.params("cpu"),
                                              RES, RES, 3)
    from irgs_tpu_torch.utils.math3d import rgb_to_srgb
    for sub, img in (("albedo", rgb_to_srgb(base_c)),
                     ("roughness", rough.expand(-1, -1, 3))):
        os.makedirs(os.path.join(scene, sub))
        png.write_png(os.path.join(scene, sub, "r_0.png"),
                      (img.numpy() * 255 + 0.5).astype(np.uint8))

    # two envmaps: a Radiance .hdr (cv2 writes BGR) with relit GT frames,
    # and an EXR without
    envs = [str(base / "sky.hdr"), str(base / "blob.exr")]
    cv2.imwrite(envs[0], _sky(16, 32)[..., ::-1].copy())
    exr.write_exr(envs[1], np.exp(ttoy.make_blob_env(16, 32)))
    os.makedirs(os.path.join(scene, "sky"))
    for i in range(2):
        rgba = rng.integers(0, 256, (RES, RES, 4)).astype(np.uint8)
        png.write_png(os.path.join(scene, "sky", f"r_{i}.png"), rgba)
    return dict(base=base, scene=scene, run=run, envs=envs)


def _copy_run(data, name):
    dst = str(data["base"] / name)
    shutil.copytree(data["run"], dst)
    return dst


@pytest.fixture(scope="module")
def ran(data):
    """Each CLI once, on its own copy of the run: the material CLI's two
    passes, the render CLI with MIS (4 + 4 samples, one view) and the
    relighting CLI on both envmaps (4 + 4 samples; the FG table at 32 x 256
    samples, as its default 256 x 8192 takes ~40 s on the CPU)."""
    runs = {k: _copy_run(data, k) for k in ("material", "render", "relight")}
    material.main(["-m", runs["material"], "--compute_scale", "--device",
                   "cpu"])
    material.main(["-m", runs["material"], "--device", "cpu"])
    render_cli.main(["-m", runs["render"], "--device", "cpu",
                     "--diffuse_sample_num", "4", "--light_sample_num", "4",
                     "--max_images", "1"])
    full = tcm.compute_fg_lut
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcm, "compute_fg_lut",
                   lambda device=None: full(32, 256, device=device))
        # 256-pixel chunks: at 4 + 4 samples the CLI's own 2^17 would pad
        # each view's ~230 foreground pixels to 2^17 traced pixels
        mp.setattr(relighting, "pixel_chunk", lambda s_d, s_l: 256)
        relighting.main(["-m", runs["relight"], "--envmaps", *data["envs"],
                         "--device", "cpu", "--diffuse_sample_num", "4",
                         "--light_sample_num", "4", "--save_env_composite"])
    return runs


def test_material_cli(ran):
    run = ran["material"]
    scale = json.load(open(os.path.join(run, "albedo_scale.json")))
    assert sorted(scale) == ["0", "1", "2", "3"]
    # the GT is the model's own albedo, 8-bit: the scale is 1 within 2 %
    assert np.allclose(scale["2"], 1.0, atol=0.02), scale
    res = json.load(open(os.path.join(run, "material_results.json")))
    assert sorted(res) == ["psnr_albedo", "psnr_roughness", "ssim_albedo"]
    assert res["psnr_albedo"] > 35.0 and res["psnr_roughness"] > 35.0


def test_render_cli_mis_writes_views_and_json(ran):
    run = ran["render"]
    out = os.path.join(run, "test", f"ours_{ITER}")
    assert sorted(os.listdir(out)) == sorted(f"r_0_{k}.png" for k in AOV_FILES)
    assert png.read_png(os.path.join(out, "r_0_render.png")).shape == (RES, RES, 3)
    res = json.load(open(os.path.join(run, "test", "nvs_results.json")))
    assert sorted(res) == sorted(["psnr", "ssim", "lpips", "psnr_avg",
                                  "ssim_avg", "lpips_avg", "per_image_psnr"])
    assert math.isfinite(res["psnr"]) and res["lpips"] is None
    assert len(res["per_image_psnr"]) == 1


def test_render_cli_matches_render_py(data):
    """At 0 light samples the port's CLI and the JAX package's render.py
    score the same views alike and write the same PNGs."""
    port, ref = _copy_run(data, "render_port"), _copy_run(data, "render_jax")
    render_cli.main(["-m", port, "--device", "cpu"])
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "render.py"), "-m", ref],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.load(open(os.path.join(port, "test", "nvs_results.json")))
    want = json.load(open(os.path.join(ref, "test", "nvs_results.json")))
    assert sorted(got) == sorted(want)
    assert abs(got["psnr"] - want["psnr"]) <= 0.1
    assert abs(got["ssim"] - want["ssim"]) <= 1e-3
    assert got["lpips"] is None and want["lpips"] is None
    for view in ("r_0", "r_1"):
        for k in AOV_FILES:
            f = os.path.join("test", f"ours_{ITER}", f"{view}_{k}.png")
            a = png.read_png(os.path.join(port, f)).astype(int)
            b = png.read_png(os.path.join(ref, f)).astype(int)
            d = np.abs(a - b)
            assert (d > 1).mean() <= 0.01 and d.max() <= 255 / S + 1, (f, d.max())


def test_relighting_cli(ran):
    """The first envmap has relit GT (`*_pbr`), the second none (the
    training-light fallback, `*_trainlight`)."""
    run = ran["relight"]
    res = json.load(open(os.path.join(run, "relighting_results.json")))
    assert sorted(res) == sorted(["sky", "blob", "psnr_pbr_avg", "ssim_pbr_avg",
                                  "lpips_pbr_avg"])
    assert sorted(res["sky"]) == ["lpips_pbr", "psnr_pbr", "ssim_pbr"]
    assert sorted(res["blob"]) == ["lpips_trainlight", "psnr_trainlight",
                                   "ssim_trainlight"]
    assert res["psnr_pbr_avg"] == res["sky"]["psnr_pbr"]
    assert math.isfinite(res["blob"]["psnr_trainlight"])
    for env in ("sky", "blob"):
        files = sorted(os.listdir(os.path.join(run, "relight", env)))
        assert files == ["gt", "r_0.png", "r_0_env.png", "r_1.png",
                         "r_1_env.png"], files
        img = png.read_png(os.path.join(run, "relight", env, "r_0.png"))
        assert img.shape == (RES, RES, 3) and img.max() > 0


def test_relighting_chunk_is_jax_cli_chunk():
    assert relighting.pixel_chunk(512, 256) == 1365
    assert relighting.pixel_chunk(4, 4) == 2 ** 17
    assert relighting.pixel_chunk(8192, 0) == 128


def test_collect_results_reads_the_three_jsons(ran):
    """collect_results.py (numpy only) reads what the three CLIs wrote."""
    for kind, run, key in (("material", ran["material"], "psnr_albedo"),
                           ("nvs", ran["render"], "psnr"),
                           ("relight", ran["relight"], "psnr_pbr_avg")):
        res = subprocess.run([sys.executable, "collect_results.py", run,
                              "--kind", kind], cwd=ROOT, capture_output=True,
                             text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        assert f"{key}: " in res.stdout and "(n=1)" in res.stdout, res.stdout


def test_train_cli_trains_with_light_samples(data):
    """python -m irgs_tpu_torch.train --light_sample_num 4: two steps of the
    MIS branch on the folder, from the run's PLY."""
    from irgs_tpu_torch.train.__main__ import main as train_main
    run = str(data["base"] / "train_mis")
    ply = os.path.join(data["run"], "point_cloud", f"iteration_{ITER}",
                       "point_cloud.ply")
    train_main(["-s", data["scene"], "-m", run, "--start_ply", ply,
                "--iterations", "2", "--diffuse_sample_num", "4",
                "--light_sample_num", "4", "--trace_num_rays", "256",
                "--tracer_grid_res", "16", "--tracer_max_cells", "8",
                "--tracer_max_hits", "16", "--tracer_hit_budget", "8",
                "--tracer_max_crossings", "12", "--dup_capacity", "65536",
                "--max_gaussians", "512", "--envmap_resolution", "16",
                "--vis_interval", "0", "--checkpoint_interval", "0",
                "--device", "cpu"])
    cfg = json.load(open(os.path.join(run, "cfg.json")))
    assert cfg["pipe"]["light_sample_num"] == 4
    log = [json.loads(line) for line in
           open(os.path.join(run, "train_log.jsonl"))]
    assert [m["iter"] for m in log] == [1] and math.isfinite(log[0]["loss"])
    assert os.path.exists(os.path.join(run, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
