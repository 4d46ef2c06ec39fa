"""The port's stage-1-lite step (irgs_tpu_torch/train/stage1.py) against
irgs_tpu/train/stage1.py's on the toy sphere (256 surfels, 48x48, a
split target, past normal_loss_start so that the normal term has
gradients): loss and metrics within 1e-4 relative, the parameters after
the Adam step within 1e-6, the radii and visibility counts exactly. The
JAX step rasterizes with its XLA backend and the port with its blend
kernels (the Pallas backend's arithmetic), so the gradients and the
screen-space gradient norms are held to the JAX package's own tolerance
between those two backends (tests/test_raster.py:235: 5e-4 of the largest
entry plus 2e-3 relative). Then the drive tools: drive_overfit for a few CPU steps,
bench_variant's table, and drive_two_stage's CLI chain and assertions."""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.config import Config
from irgs_tpu.scene import toy
from irgs_tpu.train import stage1 as js1
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.tools import bench_variant, drive_overfit, drive_two_stage
from irgs_tpu_torch.train import stage1 as ts1
from test_torch_mis import one_torch_thread  # noqa: F401

RES = 48
STEP = 3


@pytest.fixture(scope="module")
def both():
    jp, ja = toy.make_sphere_scene(n_surface=256, n_capacity=512,
                                   env_resolution=8)
    cfg = Config()
    st = dict(img_w=RES, img_h=RES, active_sh_degree=3,
              white_background=False, dup_capacity=2 ** 13,
              normal_loss_start=1, lambda_dist=0.1, dist_loss_start=1)
    jst = js1.Stage1Static(**st)
    tst = ts1.Stage1Static(**st)
    jcam = toy.make_ring_cameras(3, width=RES, height_px=RES)[1]
    tcam = ttoy.make_ring_cameras(3, width=RES, height_px=RES)[1]
    gt_img = np.full((RES, RES, 3), 0.3, np.float32)
    gt_img[RES // 2:] = 0.7

    jstate, jopt = js1.init_state(jp, ja, cfg.opt)
    jstate = jstate._replace(step=jnp.int32(STEP))
    zeros2d = jnp.zeros((jp.n_capacity, 2))

    def loss_fn(p, m2d):
        return js1.stage1_forward_loss(p, m2d, ja, jcam.params(),
                                       jnp.asarray(gt_img), None,
                                       jstate.step, jst)

    (_, (jm, _)), (jgrads, _) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(jp, zeros2d)
    jnew, jm2 = js1.stage1_step(jstate, jcam.params(), jnp.asarray(gt_img),
                                None, st=jst, optimizer=jopt)

    fields = {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS}
    tp, ta = tgs.params_from_numpy(fields, np.asarray(ja.alive), "cpu")
    tstate = ts1.init_state(tp, ta, cfg.opt)
    tstate.step = STEP
    tstate, tm = ts1.stage1_step(tstate, tcam.params("cpu"),
                                 torch.tensor(gt_img), None, st=tst)
    return dict(jm=jm, jgrads=jgrads, jnew=jnew, tm=tm, tstate=tstate, jp=jp)


def test_stage1_lite_loss_and_metrics_match_jax(both):
    jm, tm = both["jm"], both["tm"]
    assert float(jm["loss_normal"]) > 0.0
    for k in ("loss", "loss_l1", "ssim", "psnr", "loss_normal"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(tm["raster_overflow"]) == 0.0
    assert both["tstate"].step == STEP + 1


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_stage1_lite_gradients_match_jax(both, field):
    jg = np.asarray(getattr(both["jgrads"], field))
    tg = getattr(both["tstate"].params, field).grad
    if tg is None:   # no path from the loss: JAX reports zeros
        tg = torch.zeros(jg.shape)
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, atol=5e-4 * scale, rtol=2e-3,
                               err_msg=field)


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_stage1_lite_updated_params_match_jax(both, field):
    jn = np.asarray(getattr(both["jnew"].params, field))
    tn = getattr(both["tstate"].params, field).detach().numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0, err_msg=field)


def test_stage1_lite_densification_stats_match_jax(both):
    ja, ta = both["jnew"].aux, both["tstate"].aux
    np.testing.assert_array_equal(ta.max_radii2d.numpy(),
                                  np.asarray(ja.max_radii2d))
    np.testing.assert_array_equal(ta.denom.numpy(), np.asarray(ja.denom))
    g = np.asarray(ja.xyz_gradient_accum)
    np.testing.assert_allclose(ta.xyz_gradient_accum.numpy(), g,
                               atol=5e-4 * max(g.max(), 1e-12), rtol=2e-3)


def test_drive_overfit_runs_on_the_cpu(capsys):
    out = drive_overfit.main(["--device", "cpu", "--steps", "6"], res=32,
                             n=256, timing_steps=1)
    rows = out["rows"]
    assert [r["iter"] for r in rows] == [0, 6]
    assert rows[-1]["l1"] < rows[0]["l1"]
    assert all(r["overflow"] == 0 for r in rows)
    assert out["probe_finite"] and out["probe_dead_err"] == 0.0
    assert "ms/step" in capsys.readouterr().out


def test_bench_variant_table_matches_the_jax_script():
    """Every name of the JAX script's table maps onto TracerConfig fields
    of the port; a name the table lacks raises."""
    from irgs_tpu_torch.ops.grid_tracer import TracerConfig
    fields = {f.name for f in dataclasses.fields(TracerConfig)}
    assert sorted(bench_variant.VARIANTS) == sorted(
        ["base", "topk", "t16x48", "t128x8", "seg3", "seg2", "st16"])
    for name in bench_variant.VARIANTS:
        assert set(bench_variant.tracer_fields(name)) <= fields
    with pytest.raises(KeyError, match="selchunk2x"):
        bench_variant.tracer_fields("selchunk2x")


def test_drive_two_stage_chain(tmp_path, monkeypatch):
    """The CLI chain with its arguments and assertions, the CLIs replaced
    by a recorder that leaves their artifacts. No test and no smoke phase
    runs the real chain. A relative --root is resolved against the caller's
    working directory, since the CLIs run from the repository's root."""
    calls = []

    def fake(module, argv):
        calls.append((module, argv))
        out = argv[argv.index("-m") + 1]
        os.makedirs(out, exist_ok=True)
        if module == "train_refgaussian":
            open(os.path.join(out, "chkpnt4.ckpt"), "w").close()
        else:
            ply = os.path.join(out, "point_cloud", "iteration_3")
            os.makedirs(ply)
            open(os.path.join(ply, "point_cloud.ply"), "w").close()
            with open(os.path.join(out, "train_log.jsonl"), "w") as f:
                f.write(json.dumps({"ray_psnr": 9.5}) + "\n")
                f.write(json.dumps({"ray_psnr": 12.0}) + "\n")
        return ""

    monkeypatch.chdir(tmp_path)
    root = os.path.join(os.getcwd(), "r")
    out = drive_two_stage.main(["--s1_iters", "4", "--s2_iters", "3",
                                "--root", "r", "--device", "cpu"], run=fake)
    assert [c[0] for c in calls] == ["train_refgaussian", "train"]
    assert calls[0][1] == ["--toy", "-m", f"{root}/stage1", "--iterations",
                           "4", "--mesh_interval", "100", "--device", "cpu"]
    assert calls[1][1] == ["--toy", "-m", f"{root}/stage2", "--iterations",
                           "3", "--vis_interval", "0", "--start_checkpoint",
                           f"{root}/stage1", "--device", "cpu"]
    assert (out["s2_first_psnr"], out["s2_last_psnr"]) == (9.5, 12.0)
    for f in glob.glob(os.path.join(root, "stage1", "*.ckpt")):
        os.remove(f)
    with pytest.raises(AssertionError, match="no checkpoint"):
        drive_two_stage.main(["--root", str(tmp_path / "q"), "--device",
                              "cpu"], run=lambda m, a: "")
