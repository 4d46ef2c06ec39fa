"""The port's stage-2 training CLI (`python -m irgs_tpu_torch.train`, run
in-process through `main(argv)`) on the CPU: a 32x32, 4-view Blender folder
and a 512-surfel PLY, with train.py's shrunk CPU tracer budgets. It trains,
logs, checkpoints, resumes, writes the PLY with its sidecars, switches the
exact oversize merge on by itself on the shadow scene (as the JAX package's
train.py does), dumps a reproducer on a non-finite loss, and raises rather
than fall back to the CPU."""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from irgs_tpu.config import Config as JConfig
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import gaussians as jgs
from irgs_tpu_torch.config import Config as TConfig
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage2 as ts2
from irgs_tpu_torch.train.__main__ import main
from test_torch_mis import one_torch_thread  # noqa: F401

RES = 32
# train.py's CPU shrink (:126-133), at 8 samples per pixel and 128 pixels
SMALL = ["--diffuse_sample_num", "8", "--trace_num_rays", "1024",
         "--tracer_grid_res", "16", "--tracer_max_cells", "8",
         "--tracer_max_hits", "16", "--tracer_hit_budget", "8",
         "--tracer_max_crossings", "12", "--dup_capacity", "65536",
         "--max_gaussians", "1024", "--envmap_resolution", "16",
         "--vis_interval", "0", "--device", "cpu"]


def _write_blender(root):
    os.makedirs(os.path.join(root, "train"))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:RES, :RES]
    alpha = (np.hypot(xx - 15.5, yy - 15.5) < 12) * 255
    frames = []
    for i, cam in enumerate(ttoy.make_ring_cameras(4, width=RES,
                                                   height_px=RES)):
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = cam.R, cam.cam_pos
        c2w[:3, 1:3] *= -1                  # COLMAP -> Blender axes
        rgba = np.concatenate([rng.integers(0, 256, (RES, RES, 3)),
                               alpha[..., None]], -1).astype(np.uint8)
        Image.fromarray(rgba).save(os.path.join(root, "train", f"r_{i}.png"))
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


def _argv(scene, model, ply, *extra):
    return ["-s", scene, "-m", model, "--start_ply", ply, *SMALL, *extra]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    scene = _write_blender(str(base / "lego"))
    # the toy sphere at half its surfel scale: no surfel spans more than
    # span_cap cells of the grid-16 tracer
    params, aux = ttoy.make_sphere_scene(512, n_capacity=512, env_resolution=16,
                                         device="cpu")
    with torch.no_grad():
        params.scaling -= math.log(2.0)
    ply = str(base / "start.ply")
    tgs.save_ply(ply, params, aux)
    run = str(base / "run")
    main(_argv(scene, run, ply, "--iterations", "4",
               "--checkpoint_interval", "2"))
    return dict(base=base, scene=scene, ply=ply, run=run)


def test_cli_run_writes_log_ply_and_checkpoints(data):
    run = data["run"]
    cfg = json.load(open(os.path.join(run, "cfg.json")))
    assert cfg["pipe"]["tracer_grid_res"] == 16
    assert cfg["pipe"]["tracer_oversize_cap"] == 0
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    assert [m["iter"] for m in log] == [1]
    assert math.isfinite(log[0]["loss"]) and log[0]["raster_overflow"] == 0
    assert log[0]["grid_oversize"] == 0
    ply = os.path.join(run, "point_cloud", "iteration_4", "point_cloud.ply")
    for suffix in (".ply", "_env.npy", "1.exr", "1.map"):
        assert os.path.exists(ply.replace(".ply", suffix)), suffix
    # the written PLY loads in the JAX package as in the port
    jp, _ = jgs.load_ply(ply, 1024, 3)
    tp, ta = tgs.load_ply(ply, 1024, 3, device="cpu")
    assert int(ta.alive.sum()) == 512
    for f in tgs.PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for it in (2, 4):
        man = json.load(open(os.path.join(run, f"chkpnt{it}.ckpt.json")))
        assert man == {"iteration": it, "kind": "stage2", "n_capacity": 1024,
                       "sh_degree": 3, "env_shape": [8, 16, 3]}
    # the last checkpoint holds the state the PLY was written from
    ck = torch.load(os.path.join(run, "chkpnt4.ckpt"), weights_only=True)
    assert ck["step"] == 4
    np.testing.assert_array_equal(ck["params"]["base_color"][:512].numpy(),
                                  tp.base_color[:512].numpy())
    assert not torch.equal(ck["params"]["base_color"],
                           torch.load(os.path.join(run, "chkpnt2.ckpt"),
                                      weights_only=True)["params"]["base_color"])


def test_cli_resumes_from_checkpoint(data):
    """The resumed state is what chkpnt2 holds (params, Adam moments,
    step), bit for bit, and the run goes on to write chkpnt4. Like JAX's,
    the resumed run restarts its draws and camera order from --seed, so it
    need not equal the uninterrupted run."""
    ck_path = os.path.join(data["run"], "chkpnt2.ckpt")
    saved = torch.load(ck_path, weights_only=True)
    state, it = ts2.load_stage2_checkpoint(ck_path, TConfig().opt, "cpu")
    assert it == 2 and state.step == saved["step"] == 2
    got = ts2.state_tensors(state)
    for f, v in saved["params"].items():
        assert torch.equal(got["params"][f], v), f
    assert torch.equal(got["alive"], saved["alive"])
    # every group with a gradient has stepped (metallic has none in stage 2)
    assert set(got["optimizer"]) == set(saved["optimizer"]) == {
        "features_dc", "features_rest", "base_color", "roughness", "env"}
    for g, st in saved["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"][g][k], v), (g, k)
    # a run dir resolves to its latest checkpoint
    assert ts2.latest_checkpoint(data["run"]).endswith("chkpnt4.ckpt")

    run2 = str(data["base"] / "resumed")
    main(_argv(data["scene"], run2, data["ply"], "--iterations", "4",
               "--checkpoint_interval", "2", "--start_checkpoint", ck_path))
    assert not os.path.exists(os.path.join(run2, "chkpnt2.ckpt"))
    ck4 = torch.load(os.path.join(run2, "chkpnt4.ckpt"), weights_only=True)
    assert ck4["step"] == 4
    assert all(bool(torch.isfinite(v).all()) for v in ck4["params"].values())


def test_cli_auto_enables_oversize_merge_on_shadow_scene(data):
    """The small shadow scene at grid 16: its ground surfels span more than
    span_cap cells, so the CLI switches the merge on with the reference's
    cap (min(128, the count rounded up to 32)), saves cfg.json again with
    it, and logs the JAX package's grid_oversize for that PLY and config."""
    params, aux = ttoy.make_shadow_scene(n_ground=200, n_sphere=300,
                                         n_capacity=512, env_resolution=16,
                                         device="cpu")
    ply = str(data["base"] / "shadow.ply")
    tgs.save_ply(ply, params, aux)
    run = str(data["base"] / "shadow_run")
    main(_argv(data["scene"], run, ply, "--iterations", "1"))

    jp, ja = jgs.load_ply(ply, 1024, 3)
    jcfg = JConfig()
    jcfg.pipe.tracer_grid_res = 16
    tracer = gt.TracerConfig.from_pipe(jcfg.pipe)
    n_ov = int(gt.build_grid_from_gaussians(jp, ja, tracer).oversize)
    assert n_ov > 0
    cap = min(128, ((n_ov + 31) // 32) * 32)
    cfg = json.load(open(os.path.join(run, "cfg.json")))
    assert cfg["pipe"]["tracer_oversize_cap"] == cap
    import dataclasses
    merged = gt.build_grid_from_gaussians(
        jp, ja, dataclasses.replace(tracer, oversize_cap=cap))
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    assert log[0]["grid_oversize"] == int(merged.oversize) < n_ov
    assert math.isfinite(log[0]["loss"])


def test_cli_nan_dumps_reproducer_and_exits_3(data):
    """--inject_nan_at 2 under --detect_anomaly: exit code 3 and a
    reproducer holding the state from before step 2 (the NaN envmap
    included), i.e. what chkpnt1 saved after step 1."""
    run = str(data["base"] / "nan_run")
    with pytest.raises(SystemExit) as exc:
        main(_argv(data["scene"], run, data["ply"], "--iterations", "3",
                   "--checkpoint_interval", "1", "--inject_nan_at", "2",
                   "--detect_anomaly"))
    assert exc.value.code == 3
    rp = os.path.join(run, "reproducer_000002.ckpt")
    man = json.load(open(rp + ".json"))
    assert man["kind"] == "stage2_nonfinite_loss" and man["iteration"] == 2
    assert not math.isfinite(man["loss"])
    rep = torch.load(rp, weights_only=True)
    ck1 = torch.load(os.path.join(run, "chkpnt1.ckpt"), weights_only=True)
    assert rep["step"] == ck1["step"] == 1
    for f, v in ck1["params"].items():
        if f == "env":
            assert bool(torch.isnan(rep["params"][f]).all())
        else:
            assert torch.equal(rep["params"][f], v), f
    for g, st in ck1["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(rep["optimizer"][g][k], v), (g, k)
    assert not os.path.exists(os.path.join(run, "chkpnt2.ckpt"))


def test_cli_refuses_unported_paths_and_needs_a_card(data, tmp_path):
    scene, ply = data["scene"], data["ply"]
    # no --device: cuda, and no silent CPU run
    argv = [a for a in _argv(scene, str(tmp_path / "a"), ply)
            if a not in ("--device", "cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    # data-parallel ranks on cuda need a card each, as train.py's mesh
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="n_devices 2 but only"):
            main(argv + ["--n_devices", "2"])
    # without --start_ply a dataset run starts from the reader's 100k-point
    # cloud (create_from_pcd), which a capacity of 1024 cannot hold
    with pytest.raises(ValueError, match="capacity 1024"):
        main(["-s", scene, "-m", str(tmp_path / "c"), *SMALL])
    # a --start_checkpoint that is not a stage-2 one is taken as the stage-1
    # bridge, which checks its kind
    stage1 = tmp_path / "chkpnt7.ckpt"
    stage1.write_bytes(b"")
    (tmp_path / "chkpnt7.ckpt.json").write_text('{"iteration": 7}')
    with pytest.raises(ValueError, match="not a stage-1"):
        main(_argv(scene, str(tmp_path / "d"), ply, "--start_checkpoint",
                   str(stage1)))
    with pytest.raises(ValueError, match="not a stage-2"):
        ts2.load_stage2_checkpoint(str(stage1), TConfig().opt, "cpu")


def test_cli_toy_run_on_the_cpu(tmp_path, monkeypatch):
    """--toy: ground truth rendered from the procedural sphere with
    render_ir_eval, then materials and env reset, on train.py's shrunk CPU
    budgets (applied after cfg.json is saved, as there). One GT frame at
    32² instead of the CPU toy's 6 at 64² (CPU_TOY): their number and size
    are not what the test is about, and the six took ~95 % of its time."""
    import irgs_tpu_torch.train.__main__ as cli
    monkeypatch.setitem(cli.CPU_TOY, "res", 32)
    monkeypatch.setitem(cli.CPU_TOY, "cams", 1)
    run = str(tmp_path / "toy")
    main(["--toy", "-m", run, "--iterations", "1", "--vis_interval", "0",
          "--envmap_resolution", "16", "--device", "cpu"])
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    assert math.isfinite(log[0]["loss"]) and log[0]["raster_overflow"] == 0
    ck = torch.load(os.path.join(run, "chkpnt1.ckpt"), weights_only=True)
    # one Adam step of lr 0.1 from the zeroed env, 0.0075 from the reset
    # roughness: both still within a step of their reset values
    assert float(ck["params"]["env"].abs().max()) <= 0.1 + 1e-6
    rough = ck["params"]["roughness"][ck["alive"]]
    assert float((rough - rough.mean()).abs().max()) <= 2 * 0.005 + 1e-6
