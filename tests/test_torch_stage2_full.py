"""The port's stage-2 full-image branch (train_ray off: every pixel shaded
in checkpointed chunks, full-image L1 + D-SSIM) against the JAX package's,
at tests/test_train.py:53's scene shrunk to 32x32 (512 surfels, 8 samples,
384-pixel chunks: three, the last padded) with the tiled tracer and a step
past normal_loss_start, seen from ring camera 1. JAX's draws are fed in:
each chunk's rotations from its key of split(k_shade, n_chunks). Loss and
metrics within rtol 1e-5, gradients within 1e-4·max|g| per field (ROADMAP
C). From cameras 0 and 2 the frozen geometry's gradients (xyz, rotation,
scaling) differ from JAX's by up to 2.4e-4·max|g|, where the JAX package's
own two rasters (the Pallas kernel in interpret mode and its XLA
formulation) differ from each other by up to 4.9e-4·max|g|: fp32
cancellation over the full image's pixels, in the reference as much as in
the port. From camera 1 every field holds 1e-4. Then: the checkpointed
chunks give the same bits as the chunks run without checkpoint, the
generator is not drawn from in the backward pass, and the CLI trains with
--no-train_ray and resumes."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.config import Config
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import toy
from irgs_tpu.train import stage2 as s2
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage2 as ts2
from test_torch_extract_mesh_cli import write_blender
from test_torch_mis import one_torch_thread  # noqa: F401

TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8, max_hits=24,
              hit_budget=16, max_crossings=10, select_tiles=4, tile=32,
              tiled_direct=True, n_segments=4, retrace_frac=0.25)
STEP = 1001      # > normal_loss_start
RES, S_D, PC, CAM = 32, 8, 384, 1


def _configs():
    cfg = Config()
    cfg.pipe.diffuse_sample_num = S_D
    cfg.opt.trace_num_rays = S_D * PC
    cfg.opt.train_ray = False
    return cfg


def _port_setup(jp, ja, dev="cpu"):
    cfg = _configs()
    tst = dataclasses.replace(ts2.from_configs(cfg, img_w=RES, img_h=RES),
                              dup_capacity=2 ** 14,
                              tracer=tgt.TracerConfig(**TRACER))
    tp, ta = tgs.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS},
        np.asarray(ja.alive), dev)
    for t in tp.tensors().values():
        t.requires_grad_(True)
    grid = tgt.build_grid_from_gaussians(tp, ta, tst.tracer)
    return cfg, tst, tp, ta, grid


def _gt_image():
    img = np.full((RES, RES, 3), 0.4, np.float32)
    img[:, RES // 2:] = 0.6
    return img


@pytest.fixture(scope="module")
def both():
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    cfg, tst, tp, ta, tgrid = _port_setup(jp, ja)
    assert (tst.chunk_pixels, tst.n_chunks, tst.shaded_rows) == (PC, 3, 3 * PC)
    jst = dataclasses.replace(s2.from_configs(cfg, img_w=RES, img_h=RES),
                              dup_capacity=2 ** 14, raster_backend="pallas",
                              tracer=gt.TracerConfig(**TRACER))
    jcam = toy.make_ring_cameras(3, width=RES, height_px=RES)[CAM]
    tcam = ttoy.make_ring_cameras(3, width=RES, height_px=RES)[CAM]
    gt_img = _gt_image()

    # JAX's draws: the step key splits into the (unused) pixel pick and the
    # shading key, which splits into one key per chunk
    key = jax.random.PRNGKey(0)
    _, k_shade = jax.random.split(key)
    theta = np.concatenate([np.asarray(jax.random.uniform(k, (PC, 1)))
                            for k in jax.random.split(k_shade, 3)])
    draws = ts2.Stage2Draws(pixel_u=torch.zeros(RES * RES),
                            theta_u=torch.tensor(theta))

    from irgs_tpu.ops import raster_pallas as rp
    old, rp.INTERPRET = rp.INTERPRET, True
    try:
        jgrid = gt.build_grid_from_gaussians(jp, ja, jst.tracer)
        (jloss, jm), jgrads = jax.value_and_grad(
            lambda p: s2.stage2_forward_loss(
                p, ja, jgrid, jcam.params(), jnp.asarray(gt_img), None, key,
                jnp.int32(STEP), jst), has_aux=True)(jp)
    finally:
        rp.INTERPRET = old

    loss, tm = ts2.stage2_forward_loss(tp, ta, tgrid, tcam.params("cpu"),
                                       torch.tensor(gt_img), None, draws,
                                       STEP, tst)
    loss.backward()
    return dict(jm=jm, jgrads=jgrads, tm=tm, tp=tp, ta=ta, tgrid=tgrid,
                tst=tst, cam=tcam.params("cpu"), gt=torch.tensor(gt_img),
                draws=draws)


def test_full_image_loss_and_metrics_match_jax(both):
    jm, tm = both["jm"], both["tm"]
    assert "psnr" in tm and "ray_psnr" not in tm
    assert float(jm["loss_normal"]) > 0.0
    for k in ("loss", "loss_l1", "loss_sh", "loss_normal", "psnr",
              "raster_overflow", "grid_overflow", "grid_oversize"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(tm["raster_overflow"]) == 0.0


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_full_image_gradients_match_jax(both, field):
    jg = np.asarray(getattr(both["jgrads"], field))
    tg = getattr(both["tp"], field).grad
    if tg is None:   # no path from the loss: JAX reports zeros
        tg = torch.zeros(jg.shape)
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * scale, rtol=0,
                               err_msg=field)


def test_checkpointed_chunks_match_unchecked_bits(both, monkeypatch):
    """The chunks' recomputation in the backward pass changes no bit of the
    loss or of any gradient."""
    b = both

    def grads():
        for t in b["tp"].tensors().values():
            t.grad = None
        loss, _ = ts2.stage2_forward_loss(b["tp"], b["ta"], b["tgrid"],
                                          b["cam"], b["gt"], None, b["draws"],
                                          STEP, b["tst"])
        loss.backward()
        return loss.detach(), {k: None if t.grad is None else t.grad.clone()
                               for k, t in b["tp"].tensors().items()}

    calls = []
    real = ts2.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ts2, "checkpoint", counted)
    loss_c, g_c = grads()
    assert len(calls) == b["tst"].n_chunks
    monkeypatch.setattr(ts2, "checkpoint", lambda fn, *a, **kw: fn(*a))
    loss_p, g_p = grads()
    assert torch.equal(loss_c, loss_p)
    for k in g_c:
        assert (g_c[k] is None) == (g_p[k] is None), k
        if g_c[k] is not None:
            assert torch.equal(g_c[k], g_p[k]), k


def test_generator_not_drawn_in_backward(both):
    """Every draw of the step is made by draw_stage2 before it runs: the
    forward and the backward pass (whose recomputation replays each chunk)
    leave the generator where draw_stage2 left it."""
    b = both
    gen = torch.Generator().manual_seed(3)
    draws = ts2.draw_stage2(gen, b["tst"], "cpu")
    assert draws.theta_u.shape == (b["tst"].shaded_rows, 1)
    state = gen.get_state()
    loss, _ = ts2.stage2_forward_loss(b["tp"], b["ta"], b["tgrid"], b["cam"],
                                      b["gt"], None, draws, STEP, b["tst"])
    loss.backward()
    assert torch.isfinite(loss)
    assert torch.equal(gen.get_state(), state)


def test_cli_no_train_ray_trains_and_resumes(tmp_path):
    from irgs_tpu_torch.train.__main__ import main
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    write_blender(scene, n=3, res=16)
    params, aux = ttoy.make_sphere_scene(512, n_capacity=512,
                                         env_resolution=16, device="cpu")
    ply = str(tmp_path / "start.ply")
    tgs.save_ply(ply, params, aux)
    small = ["-s", scene, "-m", run, "--no-train_ray",
             "--diffuse_sample_num", "8", "--trace_num_rays", "1024",
             "--tracer_grid_res", "16", "--tracer_max_cells", "8",
             "--tracer_max_hits", "16", "--tracer_hit_budget", "8",
             "--tracer_max_crossings", "12", "--dup_capacity", "65536",
             "--max_gaussians", "512", "--envmap_resolution", "16",
             "--vis_interval", "0", "--device", "cpu"]
    main([*small, "--start_ply", ply, "--iterations", "2",
          "--checkpoint_interval", "1"])
    with open(os.path.join(run, "cfg.json")) as f:
        assert json.load(f)["opt"]["train_ray"] is False
    with open(os.path.join(run, "train_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    assert [m["iter"] for m in log] == [1]
    assert np.isfinite(log[0]["loss"]) and "psnr" in log[0]
    assert "ray_psnr" not in log[0]
    assert os.path.exists(os.path.join(run, "chkpnt2.ckpt"))
    # resume from chkpnt1 in a second run folder: iteration 2 again
    run2 = str(tmp_path / "run2")
    main([*small[:2], "-m", run2, *small[4:], "--start_checkpoint",
          os.path.join(run, "chkpnt1.ckpt"), "--iterations", "2"])
    assert os.path.exists(os.path.join(run2, "chkpnt2.ckpt"))


def test_light_draws_sliced_per_chunk_are_keyed_by_pixel(both):
    """With light samples, draws handed in for every chunk row (as a test
    hands in JAX's) are sliced chunk by chunk: the loss equals the one from
    the step's light key, whose draws are keyed by pixel id (the padding
    rows by pixel 0, as the reference pads them)."""
    from irgs_tpu_torch.scene import envlight
    b = both
    st = dataclasses.replace(b["tst"], light_sample_num=4,
                             trace_num_rays=(S_D + 4) * PC)
    assert (st.chunk_pixels, st.n_chunks) == (PC, 3)
    seed = torch.tensor(5)
    pid = torch.zeros(st.shaded_rows, dtype=torch.int64)
    pid[:RES * RES] = torch.arange(RES * RES)
    pdf = envlight.build_pdf(b["tp"].env.detach(),
                             activation=st.env_activation)
    drawn = envlight.draw_light(pdf, pid, 4, seed=seed, training=True)
    losses = []
    for light in (None, drawn):
        draws = b["draws"]._replace(light_seed=seed, light=light)
        with torch.no_grad():
            loss, _ = ts2.stage2_forward_loss(
                b["tp"], b["ta"], b["tgrid"], b["cam"], b["gt"], None, draws,
                STEP, st)
        losses.append(loss)
    assert torch.isfinite(losses[0])
    assert torch.equal(losses[0], losses[1])
