"""The port's stage-1 CLI (`python -m irgs_tpu_torch.train_refgaussian`, run
in-process through `main(argv)`) on the CPU, and the bridge into the
stage-2 CLI (mirrors tests/test_train.py:224).

The --toy run (the CLI's CPU shrink: 4 views at 32x32, 2000 start points,
16² cubemaps) takes a compressed schedule that passes through every phase,
a densification that changes the alive count, opacity resets, a material
reset at the volume -> surfel switch, normal-propagation events (one with
dist_color) and TSDF refreshes with indirect steps. A run resumed from its
middle checkpoint ends with the same state, bit for bit. The stage-2 CLI
then starts from the stage-1 checkpoint (--start_checkpoint_refgs) on a
Blender folder of the same views; from_refgs on the checkpoint equals the
JAX package's on the same numbers.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.scene import gaussians as jgs
from irgs_tpu.scene import ref_gaussians as jrgs
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage1_full as ts1
from irgs_tpu_torch.train.__main__ import main as stage2_main
from irgs_tpu_torch.train_refgaussian.__main__ import main
from irgs_tpu_torch.utils import png

# iterations 36: initial to 6, volume to 16, surfel after (material reset at
# 17), densify at 6, opacity resets at 15 and 30, normal propagation at 10
# and 20 (with dist_color), indirect from 25 with TSDF refreshes at 25, 30
# and 36; checkpoints at 18 and 36
SCHEDULE = ["--iterations", "36", "--init_until_iter", "6",
            "--volume_render_until_iter", "16", "--indirect_from_iter", "24",
            "--densify_from_iter", "3", "--densification_interval", "6",
            "--opacity_reset_interval", "15", "--normal_prop_interval", "10",
            "--mesh_interval", "6", "--mesh_res", "24",
            "--densify_grad_threshold", "1e-6", "--checkpoint_interval", "18",
            "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log(run):
    return [json.loads(line)
            for line in open(os.path.join(run, "train_log.jsonl"))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s1") / "toy")
    main(["--toy", "-m", path, *SCHEDULE])
    return path


def test_stage1_cli_runs_every_phase(run):
    files = set(os.listdir(run))
    assert {"cfg.json", "cmd.txt", "train_log.jsonl", "chkpnt18.ckpt",
            "chkpnt18.ckpt.json", "chkpnt36.ckpt",
            "chkpnt36.ckpt.json"} <= files
    log = _log(run)
    steps = [m for m in log if "loss" in m]
    assert [m["iter"] for m in steps] == [1]          # logged at 1 and %50
    assert all(math.isfinite(m["loss"]) for m in steps)
    events = {}
    for m in log:
        if "event" in m:
            events.setdefault(m["event"], []).append(m["iter"])
    assert events["densify"] == [6]
    assert events["opacity_reset"] == [15, 30]
    assert events["normal_prop"] == [10, 20]
    assert events["material_reset"] == [17]
    assert events["tsdf_refresh"] == [25, 30, 36]
    dens = next(m for m in log if m.get("event") == "densify")
    assert dens["n_alive"] != dens["n_alive_before"]
    with open(os.path.join(run, "chkpnt36.ckpt.json")) as f:
        manifest = json.load(f)
    assert manifest == {"iteration": 36, "kind": "stage1", "n_capacity": 4096,
                        "sh_degree": 3, "env_res": 16}


def test_stage1_cli_phases_are_the_schedules(run):
    """Each phase trains its own cubemap: between the checkpoints at 18
    and 36 (surfel steps only) envmap 1 moved and envmap 2, which the
    volume steps 7-16 trained, did not."""
    state18, _ = ts1.load_stage1_checkpoint(run + "/chkpnt18.ckpt",
                                            device="cpu")
    state36, it = ts1.load_stage1_checkpoint(run, device="cpu")
    assert it == 36 and state36.step == 36
    env2_moved = not torch.equal(state18.params.env2, state36.params.env2)
    env1_moved = not torch.equal(state18.params.env1, state36.params.env1)
    assert env1_moved and not env2_moved    # 19-36 are surfel steps
    assert float(state18.params.env2.detach().abs().max()) > 0.0  # volume
    assert state36.optimizer.moments("env1") is not None


def test_stage1_cli_resume_is_bitwise(run, tmp_path):
    resumed = str(tmp_path / "resumed")
    main(["--toy", "-m", resumed, "--start_checkpoint",
          os.path.join(run, "chkpnt18.ckpt"), *SCHEDULE])
    a = torch.load(os.path.join(run, "chkpnt36.ckpt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "chkpnt36.ckpt"), weights_only=True)
    for f, v in a["params"].items():
        assert torch.equal(b["params"][f], v), f
    assert torch.equal(a["alive"], b["alive"])
    for g, st in a["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(b["optimizer"][g][k], v), (g, k)


def _write_blender(root, cams, images):
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for i, (cam, img) in enumerate(zip(cams, images)):
        rgba = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        png.write_png(os.path.join(root, "train", f"r_{i}.png"),
                      (np.clip(rgba, 0, 1) * 255 + 0.5).astype(np.uint8))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = cam.R, cam.cam_pos
        c2w[:3, 1:3] *= -1                  # COLMAP -> Blender axes
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": cams[0].fovx, "frames": frames}, f)


def test_stage2_cli_bridges_from_stage1(run, tmp_path):
    cams = ttoy.make_ring_cameras(4, width=32, height_px=32)
    rng = np.random.default_rng(0)
    _write_blender(str(tmp_path / "scene"), cams,
                   [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
                    for _ in cams])
    s2 = str(tmp_path / "s2")
    stage2_main(["-s", str(tmp_path / "scene"), "-m", s2,
                 "--start_checkpoint_refgs", run, "--iterations", "1",
                 "--diffuse_sample_num", "8", "--trace_num_rays", "1024",
                 "--tracer_grid_res", "16", "--tracer_max_cells", "8",
                 "--tracer_max_hits", "16", "--tracer_hit_budget", "8",
                 "--tracer_max_crossings", "12", "--dup_capacity", "16384",
                 "--envmap_resolution", "16", "--vis_interval", "0",
                 "--device", "cpu"])
    log = _log(s2)
    assert log[0]["iter"] == 1 and math.isfinite(log[0]["loss"])
    ck = torch.load(os.path.join(s2, "chkpnt1.ckpt"), weights_only=True)
    s1, _ = ts1.load_stage1_checkpoint(run, device="cpu")
    assert torch.equal(ck["alive"], s1.aux.alive)
    # the stage-1 geometry went in (then one stage-2 step: geometry frozen)
    for f in ("xyz", "opacity", "scaling", "rotation"):
        assert torch.equal(ck["params"][f], getattr(s1.params, f).detach()), f


def test_from_refgs_matches_jax(run):
    s1, _ = ts1.load_stage1_checkpoint(run, device="cpu")
    fields = {f: getattr(s1.params, f).detach().numpy()
              for f in s1.params.FIELDS}
    jp = jrgs.RefGaussianParams(**{f: jnp.asarray(v)
                                   for f, v in fields.items()})
    ja = jgs.GaussianAux(alive=jnp.asarray(s1.aux.alive.numpy()),
                         max_radii2d=jnp.zeros(jp.n_capacity),
                         xyz_gradient_accum=jnp.zeros(jp.n_capacity),
                         denom=jnp.zeros(jp.n_capacity),
                         active_sh_degree=jnp.int32(0))
    kw = dict(env_resolution=32, init_base_color=0.3, init_metallic=0.2,
              init_roughness=0.7)
    jp2, ja2 = jgs.from_refgs(jp, ja, **kw)
    tp2, ta2 = tgs.from_refgs(s1.params, s1.aux, **kw)
    for f in tgs.PARAM_FIELDS:
        got, want = getattr(tp2, f).numpy(), np.asarray(getattr(jp2, f))
        if f in ("base_color", "metallic", "roughness"):
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(ta2.alive.numpy(), np.asarray(ja2.alive))
    assert tp2.env.shape == (16, 32, 3) and ta2.n_alive == s1.aux.n_alive


def test_stage1_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--toy", "-m", str(tmp_path / "x"), "--iterations", "1"])
