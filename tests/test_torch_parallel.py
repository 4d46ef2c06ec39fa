"""Multi-device parity of the port (irgs_tpu_torch.parallel) at world size 2,
mirroring tests/test_parallel.py: the data-parallel stage-2 step against the
JAX package's shard-mapped one on conftest's virtual CPU devices (with JAX's
parameters and draws fed in) and against the port's single-process mean
step; eval_mc_sharded against the full estimator; the sample-sharded
render_ir_eval against the one-rank frame; and both CLIs with
`--n_devices 2 --device cpu`.

The ranks are gloo CPU processes started with `spawn` and joined through a
file store under the test's temporary directory (parallel.spawn_ranks: each
collective and each join under a timeout, and every child stopped when one
fails). They import only the port (tests/torch_parallel_ranks.py); the JAX
side is computed here, once, and the arrays cross in .npz files."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parallel_ranks as ranks
from irgs_tpu.config import Config as JConfig
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.parallel import dp
from irgs_tpu.scene import toy
from irgs_tpu.scene.cameras import stack_camera_params
from irgs_tpu.train import stage2 as s2
from irgs_tpu_torch.parallel import spawn_ranks
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy

N_RANKS = 2


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's two-device DP step from the toy scene at step 1001,
    and the inputs of the port's ranks: its parameters and its draws."""
    params, aux = toy.make_sphere_scene(n_surface=256, n_capacity=512,
                                        env_resolution=16)
    cams = toy.make_ring_cameras(8, width=32, height_px=32)
    st = s2.Stage2Static(**ranks.STATIC,
                         tracer=gt.TracerConfig(**ranks.TRACER))
    state, optimizer = s2.init_state(params, aux, JConfig().opt)
    state = state._replace(step=jnp.int32(ranks.STEP))
    grid = gt.build_grid_from_gaussians(params, aux, st.tracer)
    keys = jax.random.split(jax.random.PRNGKey(0), N_RANKS)
    gts = jnp.stack([jnp.asarray(ranks.gt_image(r).numpy())
                     for r in range(N_RANKS)])
    step = dp.stage2_dp_step(dp.make_mesh(N_RANKS), st, optimizer)
    new_state, metrics = step(state, grid, stack_camera_params(cams[:N_RANKS]),
                              gts, keys)
    inputs = {f: np.asarray(getattr(params, f)) for f in tgs.PARAM_FIELDS}
    inputs["alive"] = np.asarray(aux.alive)
    p = st.trace_num_rays // st.diffuse_sample_num
    for r in range(N_RANKS):
        k_sel, k_shade = jax.random.split(keys[r])
        inputs[f"pixel_u{r}"] = np.asarray(jax.random.uniform(k_sel, (32 * 32,)))
        inputs[f"theta_u{r}"] = np.asarray(jax.random.uniform(k_shade, (p, 1)))
    path = str(tmp_path_factory.mktemp("parallel") / "inputs.npz")
    np.savez(path, **inputs)
    return dict(inputs=path, params=params,
                new={f: np.asarray(getattr(new_state.params, f))
                     for f in tgs.PARAM_FIELDS},
                loss=float(metrics["loss"]))


@pytest.fixture(scope="module")
def world(jax_side, tmp_path_factory):
    """The ranks' outputs (tests/torch_parallel_ranks.py:world_rank)."""
    out = str(tmp_path_factory.mktemp("world"))
    spawn_ranks(ranks.world_rank, ["cpu"] * N_RANKS, "gloo",
                args=(jax_side["inputs"], out))
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(N_RANKS)]


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_dp_step_matches_jax(jax_side, world, field):
    """The port's DP step updates every parameter as the JAX package's
    shard-mapped step on two devices (the tolerances of
    tests/test_torch_stage2.py), and something moved."""
    got, want = world[0][f"dp_{field}"], jax_side["new"][field]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=field)
    if field == "base_color":
        assert np.abs(got - np.asarray(jax_side["params"].base_color)).max() > 0
    np.testing.assert_allclose(float(world[0]["metric_loss"]),
                               jax_side["loss"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_dp_step_equals_single_process_mean(world, field):
    """The mean over two ranks of their gradients is one process's mean of
    the same two gradients, bit for bit (two-term sums commute), and so is
    the optimizer step; both ranks end with the same parameters."""
    np.testing.assert_array_equal(world[0][f"dp_{field}"],
                                  world[0][f"mean_{field}"])
    np.testing.assert_array_equal(world[1][f"dp_{field}"],
                                  world[0][f"dp_{field}"])
    assert float(world[0]["metric_loss"]) == pytest.approx(
        float(np.mean(world[0]["mean_losses"])), rel=1e-6)


def test_eval_mc_sharded_equals_full_estimator(world):
    pixels = torch.linspace(0.0, 1.0, 16)
    full = torch.stack([ranks.mc_shade(pixels, k)["radiance"]
                        for k in ranks.MC_KEYS]).mean(0)
    for r in range(N_RANKS):
        np.testing.assert_allclose(world[r]["mc_sharded"], full.numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("frame", ranks.FRAMES,
                         ids=[f"{d}+{l}{'-compact' if c else ''}"
                              for d, l, c in ranks.FRAMES])
def test_sample_sharded_eval_matches_one_rank(world, frame):
    """render_ir_eval with each pixel's samples sharded over the two ranks
    against the one-rank frame, at tests/test_parallel.py's tolerance, with
    and without the foreground compaction; both ranks return the frame."""
    d, l, compact = frame
    keys = [k for k in world[0] if k.startswith(f"single_{d}_{l}_{compact}_")]
    assert len(keys) == 18
    single = {k.split("_", 4)[-1]: world[0][k] for k in keys}
    assert single["rend_alpha"].max() > 0.5 and single["rend_alpha"].min() == 0
    for name in ("render", "diffuse", "specular", "visibility", "light",
                 "render_env", "light_indirect"):
        for r in range(N_RANKS):
            np.testing.assert_allclose(
                world[r][f"sharded_{d}_{l}_{compact}_{name}"], single[name],
                rtol=2e-4, atol=2e-5, err_msg=f"rank {r} {name}")


RES = 32
# the trainer CLI's CPU budgets of tests/test_torch_train_cli.py
SMALL = ["--diffuse_sample_num", "8", "--trace_num_rays", "1024",
         "--tracer_grid_res", "16", "--tracer_max_cells", "8",
         "--tracer_max_hits", "16", "--tracer_hit_budget", "8",
         "--tracer_max_crossings", "12", "--dup_capacity", "65536",
         "--max_gaussians", "1024", "--envmap_resolution", "16",
         "--vis_interval", "0"]


def _write_blender(root):
    """tests/test_torch_train_cli.py's 32x32, 4-view Blender folder."""
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


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """python -m irgs_tpu_torch.train --n_devices 2 --device cpu: 2
    iterations on two CPU ranks from a 512-surfel PLY."""
    import math
    from irgs_tpu_torch.train.__main__ import main
    base = tmp_path_factory.mktemp("cli_dp")
    scene = _write_blender(str(base / "lego"))
    params, aux = ttoy.make_sphere_scene(512, n_capacity=512, env_resolution=16,
                                         device="cpu")
    with torch.no_grad():
        params.scaling -= math.log(2.0)
    ply = str(base / "start.ply")
    tgs.save_ply(ply, params, aux)
    run = str(base / "run")
    argv = ["-s", scene, "-m", run, "--start_ply", ply, *SMALL,
            "--iterations", "2", "--checkpoint_interval", "1"]
    main(argv + ["--n_devices", "2", "--device", "cpu"])
    return dict(scene=scene, ply=ply, run=run, argv=argv)


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    """The spawned CPU ranks run one intra-op thread each (they read
    OMP_NUM_THREADS when they import torch), as the test runner's other
    workers share the cores."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = old


def test_train_cli_two_cpu_ranks(cli_run):
    """Two ranks train; rank 0 alone writes: one log line for iteration 1,
    the checkpoints of iterations 1 and 2, the PLY; the steps moved the
    materials."""
    run = cli_run["run"]
    log = [json.loads(line)
           for line in open(os.path.join(run, "train_log.jsonl"))]
    assert [m["iter"] for m in log] == [1]
    assert np.isfinite(log[0]["loss"]) and log[0]["raster_overflow"] == 0
    for it in (1, 2):
        man = json.load(open(os.path.join(run, f"chkpnt{it}.ckpt.json")))
        assert man["iteration"] == it and man["kind"] == "stage2"
    ck = torch.load(os.path.join(run, "chkpnt2.ckpt"), weights_only=True)
    assert ck["step"] == 2
    start, _ = tgs.load_ply(cli_run["ply"], 1024, 3, device="cpu")
    assert not torch.equal(ck["params"]["base_color"], start.base_color)
    ply = os.path.join(run, "point_cloud", "iteration_2", "point_cloud.ply")
    assert os.path.exists(ply)
    assert sorted(os.listdir(run)) == sorted(
        ["cfg.json", "train_log.jsonl", "chkpnt1.ckpt", "chkpnt1.ckpt.json",
         "chkpnt2.ckpt", "chkpnt2.ckpt.json", "point_cloud"])


def test_render_cli_two_cpu_ranks(cli_run):
    """python -m irgs_tpu_torch.render --n_devices 2 --device cpu on that
    run: rank 0 writes each view's PNGs and the metrics."""
    from irgs_tpu_torch.render.__main__ import AOV_PNGS, main
    run = cli_run["run"]
    main(["-m", run, "--max_images", "1", "--diffuse_sample_num", "4",
          "--light_sample_num", "4", "--n_devices", "2", "--device", "cpu"])
    res = json.load(open(os.path.join(run, "test", "nvs_results.json")))
    assert len(res["per_image_psnr"]) == 1 and np.isfinite(res["psnr"])
    pngs = os.listdir(os.path.join(run, "test", "ours_2"))
    assert sorted(pngs) == sorted(["r_0_render.png"]
                                  + [f"r_0_{k}.png" for k in AOV_PNGS])


def test_cli_n_devices_on_cuda_needs_the_cards(cli_run, tmp_path):
    """--n_devices 2 on cuda with fewer than two cards raises, as train.py
    does (the port's CLIs start one rank per card)."""
    from irgs_tpu_torch.render.__main__ import main as render_main
    from irgs_tpu_torch.train.__main__ import main as train_main
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    argv = [a if a != cli_run["run"] else str(tmp_path / "run")
            for a in cli_run["argv"]]
    with pytest.raises(SystemExit, match="n_devices 2 but only"):
        train_main(argv + ["--n_devices", "2"])
    with pytest.raises(SystemExit, match="n_devices 2 but only"):
        render_main(["-m", cli_run["run"], "--n_devices", "2"])
