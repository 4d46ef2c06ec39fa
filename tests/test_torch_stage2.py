"""The port's stage-2 step against the JAX package's, at the tests/test_train.py
scale (512 surfels, 64x64, 8 samples per pixel, 128 shaded pixels) with a
tiled tracer config and the JAX draws fed in, at a step past
normal_loss_start so that every loss term has gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.config import Config
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import toy
from irgs_tpu.train import stage2 as s2
from irgs_tpu_torch import workload
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage2 as ts2
from test_torch_mis import one_torch_thread  # noqa: F401

TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8, max_hits=24,
              hit_budget=16, max_crossings=10, select_tiles=4, tile=32,
              tiled_direct=True, n_segments=4, retrace_frac=0.25)
STEP = 1001  # > normal_loss_start


def _np_fields(params):
    return {f: np.asarray(getattr(params, f)) for f in tgs.PARAM_FIELDS}


def test_toy_scene_matches_jax():
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    tp, ta = ttoy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                    env_resolution=16, device="cpu")
    for f in tgs.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))
    for jc, tc in zip(toy.make_ring_cameras(3, width=64, height_px=64),
                      ttoy.make_ring_cameras(3, width=64, height_px=64)):
        jcp, tcp = jc.params(), tc.params("cpu")
        np.testing.assert_array_equal(np.asarray(jcp.full_proj),
                                      tcp.full_proj.numpy())
        np.testing.assert_array_equal(np.asarray(jcp.w2c), tcp.w2c.numpy())
        np.testing.assert_array_equal(np.asarray(jcp.cam_pos),
                                      tcp.cam_pos.numpy())


@pytest.fixture(scope="module")
def both():
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    cfg = Config()
    cfg.pipe.diffuse_sample_num = 8
    cfg.opt.trace_num_rays = 8 * 128
    jst = dataclasses.replace(s2.from_configs(cfg, img_w=64, img_h=64),
                              dup_capacity=2 ** 14, raster_backend="pallas",
                              tracer=gt.TracerConfig(**TRACER))
    tst = dataclasses.replace(ts2.from_configs(cfg, img_w=64, img_h=64),
                              dup_capacity=2 ** 14,
                              tracer=tgt.TracerConfig(**TRACER))
    # ring camera 0; at camera 1 one rotation-gradient entry lands at
    # 1.02e-4·max|g| through fp32 cancellation of the large ray-origin and
    # -direction gradients (the tracer alone agrees within 1.4e-5·max|g|)
    jcam = toy.make_ring_cameras(3, width=64, height_px=64)[0]
    tcam = ttoy.make_ring_cameras(3, width=64, height_px=64)[0]
    gt_img = np.full((64, 64, 3), 0.4, np.float32)
    gt_img[:, 32:] = 0.6
    k_sel, k_shade = jax.random.split(jax.random.PRNGKey(0))
    draws = ts2.Stage2Draws(
        pixel_u=torch.tensor(np.asarray(jax.random.uniform(k_sel, (64 * 64,)))),
        theta_u=torch.tensor(np.asarray(jax.random.uniform(k_shade, (128, 1)))))

    # JAX: loss, metrics and gradients, then the optimizer step, with the
    # Pallas blend in interpret mode (the kernels the port replaces)
    from irgs_tpu.ops import raster_pallas as rp
    old, rp.INTERPRET = rp.INTERPRET, True
    jgrid = gt.build_grid_from_gaussians(jp, ja, jst.tracer)
    jstate, jopt = s2.init_state(jp, ja, cfg.opt)
    jstate = jstate._replace(step=jnp.int32(STEP))

    def loss_fn(p):
        return s2.stage2_forward_loss(p, ja, jgrid, jcam.params(),
                                      jnp.asarray(gt_img), None,
                                      jax.random.PRNGKey(0), jstate.step, jst)

    (jloss, jm), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    jnew, _ = s2.stage2_step(jstate, jgrid, jcam.params(), jnp.asarray(gt_img),
                             None, jax.random.PRNGKey(0), st=jst,
                             optimizer=jopt)
    rp.INTERPRET = old

    # the port, on the same parameter values
    tp, ta = tgs.params_from_numpy(_np_fields(jp), np.asarray(ja.alive), "cpu")
    tgrid = tgt.build_grid_from_gaussians(tp, ta, tst.tracer)
    tstate = ts2.init_state(tp, ta, cfg.opt)
    tstate.step = STEP
    tstate, tm = ts2.stage2_step(tstate, tgrid, tcam.params("cpu"),
                                 torch.tensor(gt_img), None, draws, st=tst)
    return dict(jloss=jloss, jm=jm, jgrads=jgrads, jnew=jnew.params,
                tm=tm, tparams=tstate.params, jp=jp,
                port_step=dict(alive=np.asarray(ja.alive), opt=cfg.opt,
                               cam=tcam.params("cpu"), gt=gt_img,
                               draws=draws, st=tst))


@pytest.fixture(scope="module")
def degree4(both):
    """The port's step of `both` on a model of SH degree 4 (9 more
    coefficients per channel from a seed), trained at active degree 3 as
    train.py does."""
    a = both["port_step"]
    f4 = workload.extend_sh(_np_fields(both["jp"]), 4)
    tp, ta = tgs.params_from_numpy(f4, a["alive"], "cpu", max_sh_degree=4)
    state = ts2.init_state(tp, ta, a["opt"])
    state.step = STEP
    state, tm = ts2.stage2_step(
        state, tgt.build_grid_from_gaussians(tp, ta, a["st"].tracer),
        a["cam"], torch.tensor(a["gt"]), None, a["draws"], st=a["st"])
    return dict(f4=f4, tm=tm, tparams=state.params)


def test_stage2_loss_and_metrics_match_jax(both):
    jm, tm = both["jm"], both["tm"]
    assert float(jm["loss_normal"]) > 0.0
    for k in ("loss", "loss_l1", "loss_sh", "loss_normal", "ray_psnr",
              "raster_overflow", "grid_overflow", "grid_oversize"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(tm["raster_overflow"]) == 0.0


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_stage2_gradients_match_jax(both, field):
    jg = np.asarray(getattr(both["jgrads"], field))
    tg = getattr(both["tparams"], field).grad
    if tg is None:   # no path from the loss: JAX reports zeros
        tg = torch.zeros(jg.shape)
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * scale, rtol=0,
                               err_msg=field)


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_stage2_updated_params_match_jax(both, field):
    jn = np.asarray(getattr(both["jnew"], field))
    tn = getattr(both["tparams"], field).detach().numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0, err_msg=field)
    if field in ("xyz", "opacity", "scaling", "rotation"):
        # lr_scale = 0 freezes the geometry
        np.testing.assert_array_equal(tn, np.asarray(getattr(both["jp"], field)))


# SH degree 4 in stage 2: JAX's step at active degree 3 reads the first 16
# coefficients per channel of a model of any degree, so the step above is
# its step on the degree-4 model too


def test_stage2_degree4_model_loss_matches_jax(both, degree4):
    jm, tm = both["jm"], degree4["tm"]
    for k in ("loss", "loss_l1", "loss_sh", "loss_normal", "ray_psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_stage2_degree4_model_matches_jax(both, degree4, field):
    """A degree-4 model's gradients and updated parameters equal JAX's at the
    degree-3 tests' tolerances; its 9 coefficients of degree 4 take no
    gradient and keep their values through the Adam step."""
    jg = np.asarray(getattr(both["jgrads"], field))
    jn = np.asarray(getattr(both["jnew"], field))
    p4 = getattr(degree4["tparams"], field)
    tg = np.zeros(p4.shape, np.float32) if p4.grad is None else \
        p4.grad.numpy()
    tn = p4.detach().numpy()
    if field == "features_rest":
        assert tn.shape == (1024, 24, 3)
        assert not tg[:, 15:].any()
        np.testing.assert_array_equal(tn[:, 15:],
                                      degree4["f4"]["features_rest"][:, 15:])
        tg, tn = tg[:, :15], tn[:, :15]
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg, jg, atol=1e-4 * scale, rtol=0,
                               err_msg=field)
    np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0, err_msg=field)
