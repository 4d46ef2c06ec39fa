"""The port's stage-2 step with light samples (the MIS branch in training)
against the JAX package's, at the tests/test_torch_stage2.py scale (512
surfels, 64x64, tiled tracer, a step past normal_loss_start) with 8 diffuse
+ 8 light samples on 128 shaded pixels. The JAX draws are fed in: the pixel
scores, the hemisphere rotations and the light draws of the train_ray
branch (texel indices and jitter from split(k_shade), drawn without pixel
ids, stage2.py:185-187). Tolerances as tests/test_torch_stage2.py: loss and
metrics rtol 1e-4 / atol 1e-6, gradients atol 1e-4·max|g| per field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.config import Config
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import envlight as jenv
from irgs_tpu.scene import toy
from irgs_tpu.train import stage2 as s2
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage2 as ts2
from test_torch_mis import jax_light_draws, one_torch_thread  # noqa: F401

TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8, max_hits=24,
              hit_budget=16, max_crossings=10, select_tiles=4, tile=32,
              tiled_direct=True, n_segments=4, retrace_frac=0.25)
STEP = 1001
S_D, S_L, PIX = 8, 8, 128


@pytest.fixture(scope="module")
def both():
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    cfg = Config()
    cfg.pipe.diffuse_sample_num = S_D
    cfg.pipe.light_sample_num = S_L
    cfg.opt.trace_num_rays = (S_D + S_L) * PIX
    jst = dataclasses.replace(s2.from_configs(cfg, img_w=64, img_h=64),
                              dup_capacity=2 ** 14, raster_backend="pallas",
                              tracer=gt.TracerConfig(**TRACER))
    tst = dataclasses.replace(ts2.from_configs(cfg, img_w=64, img_h=64),
                              dup_capacity=2 ** 14,
                              tracer=tgt.TracerConfig(**TRACER))
    assert tst.num_shaded_pixels == PIX
    jcam = toy.make_ring_cameras(3, width=64, height_px=64)[0]
    tcam = ttoy.make_ring_cameras(3, width=64, height_px=64)[0]
    gt_img = np.full((64, 64, 3), 0.4, np.float32)
    gt_img[:, 32:] = 0.6

    # the JAX step's draws: split(key) into the pixel pick and the shading
    # key, which the MIS branch splits into the rotation and the light draws
    k_sel, k_shade = jax.random.split(jax.random.PRNGKey(0))
    kd, kl = jax.random.split(k_shade)
    jpdf = jenv.build_pdf(jp.env)
    draws = ts2.Stage2Draws(
        pixel_u=torch.tensor(np.asarray(jax.random.uniform(k_sel, (64 * 64,)))),
        theta_u=torch.tensor(np.asarray(jax.random.uniform(kd, (PIX, 1)))),
        light=jax_light_draws(jpdf, S_L, kl, batch=PIX, training=True))

    from irgs_tpu.ops import raster_pallas as rp
    old, rp.INTERPRET = rp.INTERPRET, True
    try:
        jgrid = gt.build_grid_from_gaussians(jp, ja, jst.tracer)

        def loss_fn(p):
            return s2.stage2_forward_loss(p, ja, jgrid, jcam.params(),
                                          jnp.asarray(gt_img), None,
                                          jax.random.PRNGKey(0),
                                          jnp.int32(STEP), jst)

        (_, jm), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    finally:
        rp.INTERPRET = old

    tp, ta = tgs.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS},
        np.asarray(ja.alive), "cpu")
    tgrid = tgt.build_grid_from_gaussians(tp, ta, tst.tracer)
    tstate = ts2.init_state(tp, ta, cfg.opt)
    tstate.step = STEP
    tstate, tm = ts2.stage2_step(tstate, tgrid, tcam.params("cpu"),
                                 torch.tensor(gt_img), None, draws, st=tst)
    return dict(jm=jm, jgrads=jgrads, tm=tm, tparams=tstate.params)


def test_mis_step_loss_and_metrics_match_jax(both):
    jm, tm = both["jm"], both["tm"]
    for k in ("loss", "loss_l1", "loss_sh", "loss_normal", "ray_psnr",
              "raster_overflow", "grid_overflow", "grid_oversize"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_mis_step_gradients_match_jax(both, field):
    jg = np.asarray(getattr(both["jgrads"], field))
    tg = getattr(both["tparams"], field).grad
    if tg is None:
        tg = torch.zeros(jg.shape)
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * scale, rtol=0,
                               err_msg=field)
    if field == "env":
        assert np.abs(jg).max() > 0       # the light samples reach the env


def test_draw_stage2_keys_light_draws_only_with_light_samples():
    from irgs_tpu_torch.config import Config as TConfig
    cfg = TConfig()
    st0 = ts2.from_configs(cfg, img_w=8, img_h=8)
    g = torch.Generator().manual_seed(0)
    d0 = ts2.draw_stage2(g, st0, "cpu")
    assert d0.light_seed is None and d0.light is None
    cfg.pipe.light_sample_num = 4
    st1 = ts2.from_configs(cfg, img_w=8, img_h=8)
    d1 = ts2.draw_stage2(torch.Generator().manual_seed(0), st1, "cpu")
    assert d1.light_seed.dtype == torch.int64 and d1.light_seed.ndim == 0
    moved = d1.to("cpu")
    assert torch.equal(moved.light_seed, d1.light_seed) and moved.light is None
