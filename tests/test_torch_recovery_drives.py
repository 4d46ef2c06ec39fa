"""The port's stage-2 drives (irgs_tpu_torch.tools.drive_stage2 and
drive_parity --train) against the JAX tools' lines on the CPU.

Each drive runs beside the JAX tool's own lines (tools/drive_stage2.py, the
--train block of tools/drive_parity.py) at a shrunk size, on the same scene
(the JAX toy scenes carried across as numpy), with the JAX tool's per-step
keys fed in as Stage2Draws (as tests/test_torch_stage2.py does) and, for
the oracle and production frames, its light draws. What is held: the GT
render, the reset of the materials and the envmap, the chained steps and
the envmap error formula, through the logged metrics they produce.

Tolerances: each logged step's loss and L1 within STEP_RTOL relative and
its ray PSNR within 0.01 dB (one step agrees within 1e-4,
tests/test_torch_stage2.py; chained steps carry each other's float32
rounding); the envmap errors within STEP_RTOL; the recovered views' PSNR
against the oracle GT within RECOVERY_TOL_DB (below).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from irgs_tpu.config import Config as JConfig
from irgs_tpu.ops import grid_tracer as jgt
from irgs_tpu.ops import surfel_raster as jsr
from irgs_tpu.render import ir as jir
from irgs_tpu.scene import envlight as jenv
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.scene.gaussians import inverse_base_color_activation as jinv_bc
from irgs_tpu.train import stage2 as js2
from irgs_tpu.train.losses import psnr as jpsnr
from irgs_tpu.utils import math3d as jm
from irgs_tpu_torch.tools import drive_parity, drive_stage2
from irgs_tpu_torch.train import stage2 as ts2
from test_torch_drive_tools import (_jax_gbuffer, _jax_inputs, _jax_oracle,
                                    shadow)  # noqa: F401
from test_torch_mis import jax_light_draws, one_torch_thread  # noqa: F401

STEP_RTOL = 1e-3

def _jax_step_draws(keys, img):
    """The Stage2Draws of the JAX tools' step keys: stage2_forward_loss
    splits a step's key into the pixel-selection and the shading keys."""
    def draws_fn(i, st):
        k_sel, k_shade = jax.random.split(keys[i])
        return ts2.Stage2Draws(
            pixel_u=torch.tensor(np.asarray(
                jax.random.uniform(k_sel, (img * img,)))),
            theta_u=torch.tensor(np.asarray(
                jax.random.uniform(k_shade, (st.shaded_rows, 1)))))
    return draws_fn


def _step_keys(n):
    """The JAX tools' keys: key, k = jax.random.split(key), once a step."""
    key, keys = jax.random.PRNGKey(0), []
    for _ in range(n):
        key, k = jax.random.split(key)
        keys.append(k)
    return keys


# drive_stage2 shrunk as test_drive_stage2_recovers shrinks it
DS2 = dict(n_surface=512, n_capacity=1024, img=32, iters=9, log_at=(0, 4, 8),
           gt_spp=4, spp=4, n_pixels=128)


def _jax_drive_stage2(n_surface, n_capacity, img, iters, log_at, gt_spp, spp,
                      n_pixels):
    """tools/drive_stage2.py's lines at the given size: its GT render_full,
    the materials and envmap reset to zero, the chained steps and the
    envmap error formula."""
    params, aux = jtoy.make_sphere_scene(n_surface=n_surface,
                                         n_capacity=n_capacity,
                                         env_resolution=32)
    cams = jtoy.make_ring_cameras(4, width=img, height_px=img)
    cfg = JConfig()
    cfg.pipe.diffuse_sample_num = spp
    cfg.pipe.tracer_grid_res = 24
    cfg.opt.trace_num_rays = spp * n_pixels
    st = dataclasses.replace(js2.from_configs(cfg, img_w=img, img_h=img),
                             dup_capacity=2 ** 17)
    grid = jgt.build_grid_from_gaussians(params, aux, st.tracer)

    def render_full(params, grid, cam):
        feats = jnp.concatenate([params.get_base_color(),
                                 params.get_roughness()], -1)
        raster = jsr.rasterize(
            params.xyz, params.get_scaling(), params.rotation,
            params.get_opacity()[:, 0], params.get_features(), feats,
            jnp.zeros((params.n_capacity, 2)), cam, jnp.zeros(3), img_w=img,
            img_h=img, active_sh_degree=3, dup_capacity=2 ** 17,
            alive=aux.alive)
        maps = jir.derive_geometry_maps(raster, cam, img, img)
        flat = lambda x: x.reshape(-1, x.shape[-1])
        shade = jir.ShadeConfig(diffuse_sample_num=gt_spp, training=False)
        tf = jir.make_trace_fn(params, aux, grid, st.tracer, cam.cam_pos, 3)
        re = jir.rendering_equation(
            flat(raster.feature[..., :3]), flat(raster.feature[..., 3:4]),
            flat(maps["normal_map"]), flat(maps["points"]),
            -flat(maps["rays_d"]), params.env, jenv.build_pdf(params.env),
            tf, shade)
        out = jm.rgb_to_srgb(re["diffuse"] + re["specular"])
        return out.reshape(img, img, 3) * maps["alpha"]

    gts = [jax.jit(render_full)(params, grid, c.params()) for c in cams]
    p0 = dataclasses.replace(
        params, base_color=jnp.zeros_like(params.base_color),
        roughness=jnp.zeros_like(params.roughness),
        env=jnp.zeros_like(params.env))
    state, optimizer = js2.init_state(p0, aux, cfg.opt)
    keys, logged = _step_keys(iters), {}
    for i in range(iters):
        state, m = js2.stage2_step(state, grid, cams[i % 4].params(),
                                   gts[i % 4], None, keys[i], st=st,
                                   optimizer=optimizer)
        if i in log_at:
            logged[i] = {k: float(m[k]) for k in ("loss", "loss_l1",
                                                  "ray_psnr")}
    err = float(jnp.abs(jnp.exp(state.params.env) - jnp.exp(params.env)).mean())
    err0 = float(jnp.abs(1.0 - jnp.exp(params.env)).mean())
    return {"logged": logged, "env_err": err, "env_err_init": err0}, keys


def test_drive_stage2_matches_jax():
    """drive_stage2.main at DS2 with the JAX tool's step keys fed in: the
    logged loss, L1 and ray PSNR of each logged step and the envmap errors
    (a wrong reset, GT or error formula moves them all) equal the JAX
    tool's lines run at the same size."""
    ref, keys = _jax_drive_stage2(**DS2)
    res = drive_stage2.main(["--device", "cpu"], **DS2,
                            draws_fn=_jax_step_draws(keys, DS2["img"]))
    assert set(res["logged"]) == set(ref["logged"]) == set(DS2["log_at"])
    for i, row in ref["logged"].items():
        for k in ("loss", "loss_l1"):
            np.testing.assert_allclose(res["logged"][i][k], row[k],
                                       rtol=STEP_RTOL, err_msg=f"{i} {k}")
        assert abs(res["logged"][i]["ray_psnr"] - row["ray_psnr"]) < 0.01, (
            i, res["logged"][i], row)
    for k in ("env_err", "env_err_init"):
        np.testing.assert_allclose(res[k], ref[k], rtol=STEP_RTOL, err_msg=k)
    assert ref["env_err"] < ref["env_err_init"]


# drive_parity --train shrunk: 2 steps at 16², the renders at 8 + 4 samples,
# 4 diffuse samples on 32 pixels a step
RECOVERY = dict(img=16, iters=2, render_spp=(8, 4), spp=4, n_pixels=32)
# the recovered views' PSNR: README.md's 0.1 dB parity budget. Adam's first
# steps move each parameter by about its learning rate whatever the size of
# its gradient, so envmap texels whose gradient is float32 noise around 0
# (the reset envmap is constant) take the learning rate with either sign in
# either package: 0.03-0.06 dB apart on this scene
RECOVERY_TOL_DB = 0.1


def _jax_recovery(jp, ja, img, iters, render_spp, spp, n_pixels):
    """tools/drive_parity.py's --train block at the given size: oracle GT
    in 8 blocks, base colour reset to 0.5, roughness to 0 and the envmap to
    log 1.5, the chained steps, the production frames of the result."""
    cams = jtoy.make_ring_cameras(4, radius=3.4, height=1.6, width=img,
                                  height_px=img)
    cfg = JConfig()
    eval_tracer = jgt.TracerConfig.from_pipe(cfg.pipe, eval=True)
    cfg.pipe.diffuse_sample_num = spp
    cfg.opt.trace_num_rays = spp * n_pixels
    cfg.opt.iterations = iters
    st = dataclasses.replace(js2.from_configs(cfg, img_w=img, img_h=img),
                             dup_capacity=2 ** 19)

    @functools.partial(jax.jit, static_argnums=(3,))
    def shade_block(blk, cam_pos, p, mode, g=None):
        if mode == "oracle":
            inp = _jax_inputs(p, ja, cam_pos)

            def tf(ro, rd):
                shape = ro.shape[:-1]
                out = _jax_oracle(inp, ja.alive,
                                  eval_tracer.transmittance_min,
                                  ro.reshape(-1, 3), rd.reshape(-1, 3))
                return jgt.TraceOut(*[x.reshape(shape + x.shape[1:])
                                      for x in out])
        else:
            tf = jir.make_trace_fn(p, ja, g, eval_tracer, cam_pos, 3)
        shade = jir.ShadeConfig(diffuse_sample_num=render_spp[0],
                                light_sample_num=render_spp[1],
                                training=False)
        re = jir.rendering_equation(*blk, p.env, jenv.build_pdf(p.env), tf,
                                    shade)
        return re["diffuse"] + re["specular"]

    gbuffer = jax.jit(lambda p, cam: _jax_gbuffer(p, ja, cam, img))

    def render(cam, p, g, mode):
        """The tool's _render_blocks: the frame shaded in 8 blocks."""
        px, alpha = gbuffer(p, cam)
        bs = img * img // 8
        outs = [shade_block(tuple(x[b * bs:(b + 1) * bs] for x in px),
                            cam.cam_pos, p, mode, g) for b in range(8)]
        out = jm.rgb_to_srgb(jnp.concatenate(outs)).reshape(img, img, 3)
        return jnp.clip(out * alpha, 0.0, 1.0)

    gts = [render(c.params(), jp, None, "oracle") for c in cams]
    p0 = dataclasses.replace(
        jp, base_color=jnp.full_like(jp.base_color,
                                     float(jinv_bc(jnp.float32(0.5)))),
        roughness=jnp.zeros_like(jp.roughness),
        env=jnp.full_like(jp.env, jnp.log(jnp.float32(1.5))))
    state, optimizer = js2.init_state(p0, ja, cfg.opt)
    tgrid = jgt.build_grid_from_gaussians(p0, ja, st.tracer)
    keys, first = _step_keys(iters), None
    for it in range(1, iters + 1):
        state, m = js2.stage2_step(state, tgrid, cams[it % 4].params(),
                                   gts[it % 4], None, keys[it - 1], st=st,
                                   optimizer=optimizer)
        first = first or {k: float(m[k]) for k in ("loss", "ray_psnr")}
    egrid = jgt.build_grid_from_gaussians(state.params, ja, eval_tracer)
    fin = [float(jpsnr(render(c.params(), state.params, egrid, "prod"), g))
           for c, g in zip(cams, gts)]
    return fin, first, keys


def test_drive_parity_train_matches_jax(shadow, capsys):
    """drive_parity.main with --train (RECOVERY's size, the fixture's
    shadow scene, one parity view) against the JAX tool's --train block:
    the JAX tool's light draws (key 0 over each render block) and step
    keys fed in; the first step's loss and ray PSNR as the drive logs them
    and the four recovered views' PSNR against the oracle GT."""
    jp, ja, tp, ta = shadow
    fin_j, first_j, keys = _jax_recovery(jp, ja, **RECOVERY)

    def draws_fn(pdf, pixel_ids, n):
        return jax_light_draws(jnp.asarray(pdf.numpy()), n,
                               batch=pixel_ids.shape[0])

    kw = {k: v for k, v in RECOVERY.items() if k not in ("img", "iters")}
    drive_parity.main(
        ["--device", "cpu", "--img", str(RECOVERY["img"]), "--spp",
         *map(str, RECOVERY["render_spp"]), "--views", "1", "--train",
         str(RECOVERY["iters"])], scene=(tp, ta),
        recovery_kw=dict(kw, draws_fn=draws_fn, step_draws=lambda it, st:
                         _jax_step_draws(keys, RECOVERY["img"])(it - 1, st)))
    lines = capsys.readouterr().out.strip().splitlines()
    fin_t = json.loads(lines[-1])["recovery_psnr"]
    it1 = next(ln for ln in lines if ln.startswith("iter 1:")).split()
    # the log prints the loss to 4 and the PSNR to 2 decimals
    assert abs(float(it1[3]) - first_j["loss"]) <= 1e-4 + STEP_RTOL * first_j[
        "loss"], (it1, first_j)
    assert abs(float(it1[5]) - first_j["ray_psnr"]) <= 0.01, (it1, first_j)
    assert len(fin_t) == len(fin_j) == 4
    for a, b in zip(fin_t, fin_j):
        assert abs(a - b) < RECOVERY_TOL_DB, (fin_t, fin_j)
