"""Spherical harmonics of degree 4 in the port against the JAX package:
`eval_sh_color` (utils/sh.py) at degrees 0 to 4, values and gradients
within rtol 1e-6 / atol 1e-6 (the same float32 operations in the same
order); the tracer's degree-4 colours (ops/grid_tracer.py's SH basis)
against the JAX brute-force trace (which evaluates utils/sh.py) within
the trace tests' 3e-5 (JAX's own tracer stops at degree 3); Gaussian PLYs
with 72 ``f_rest`` columns written by either package and read by the
other, bit for bit; and one stage-1 step (the surfel phase, active degree
4) against JAX at the degree-3 tests' tolerances: the loss within rtol
1e-5, gradients within 1e-4·max|g|. The JAX side is jitted, as its
trainers run it. The stage-2 step of a degree-4 model is held against
JAX's in test_torch_stage2.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import gaussians as jgs
from irgs_tpu.scene import ref_gaussians as jrgs
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.train import stage1_full as js1
from irgs_tpu.utils import sh as jsh
from irgs_tpu_torch import workload
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import cubemap as tcm
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import ref_gaussians as trgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage1_full as ts1
from irgs_tpu_torch.utils import sh as tsh
from test_torch_mis import one_torch_thread  # noqa: F401

GRAD_REL = 1e-4


def _sh_inputs(seed=0, n=200):
    rng = np.random.default_rng(seed)
    sh = (0.3 * rng.standard_normal((n, 3, 25))).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    w = rng.standard_normal((n, 3)).astype(np.float32)
    return sh, d, w


@pytest.mark.parametrize("deg", range(5))
def test_eval_sh_color_matches_jax(deg):
    sh, d, w = _sh_inputs(deg)

    def jloss(s, dd):
        return jnp.sum(jsh.eval_sh_color(deg, s, dd) * w)

    want = np.asarray(jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(d)))
    jg_sh, jg_d = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sh),
                                                  jnp.asarray(d))
    ts, td = (torch.tensor(sh, requires_grad=True),
              torch.tensor(d, requires_grad=True))
    got = tsh.eval_sh_color(deg, ts, td)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg_sh), rtol=1e-6,
                               atol=1e-6)
    gd = np.zeros(d.shape, np.float32) if td.grad is None else td.grad.numpy()
    np.testing.assert_allclose(gd, np.asarray(jg_d), rtol=1e-6, atol=1e-6)
    if deg < 4:      # coefficients past the degree take no part
        assert float(ts.grad[..., (deg + 1) ** 2:].abs().max()) == 0.0


def test_tracer_degree4_matches_jax_reference():
    from test_torch_tracer_options import FIELDS, oracle_inputs
    arrs, scales, ro, rd = oracle_inputs()
    rng = np.random.default_rng(9)
    arrs = dict(arrs, shs=np.concatenate(
        [arrs["shs"], 0.3 * rng.standard_normal(
            (len(arrs["shs"]), 9, 3))], 1).astype(np.float32))
    t_in = tgt.TraceInputs(*(torch.tensor(arrs[k]) for k in FIELDS))
    cfg = tgt.TracerConfig(grid_res=16, pair_capacity=2 ** 15, max_cells=48,
                           max_hits=192, hit_budget=192, span_cap=8,
                           n_segments=4, retrace_frac=1.0)
    n = len(arrs["shs"])
    t_grid = tgt.build_grid(
        t_in.means3d, tgt.bounding_radius(t_in.opacity, torch.tensor(scales),
                                          1.0 / 255.0),
        torch.ones(n, dtype=torch.bool), grid_res=16, pair_capacity=2 ** 15,
        span_cap=8)
    out = {d: tgt.trace_segments(torch.tensor(ro), torch.tensor(rd), t_grid,
                                 t_in, cfg=cfg, sh_deg=d) for d in (3, 4)}
    j_in = gt.TraceInputs(**{k: jnp.asarray(arrs[k]) for k in FIELDS})
    ref = jax.jit(functools.partial(
        gt.trace_reference, sh_deg=4,
        transmittance_min=cfg.transmittance_min))(
        jnp.asarray(ro), jnp.asarray(rd), j_in, jnp.ones(n, bool))
    assert float(ref.alpha.max()) > 0.5
    for name in ("alpha", "color"):
        np.testing.assert_allclose(getattr(out[4], name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), atol=3e-5,
                                   err_msg=name)
    # the degree-4 terms change the colours
    assert float((out[4].color - out[3].color).abs().max()) > 1e-2


def _degree4_scene():
    """The toy sphere with 9 more SH coefficients per channel, as JAX
    params (made by the port's toy, which equals JAX's within 1e-6
    (test_torch_stage2.py), so that no eager JAX op runs)."""
    tp, ta = ttoy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                    env_resolution=16, device="cpu")
    f = {k: t.detach().numpy() for k, t in tp.tensors().items()}
    rng = np.random.default_rng(4)
    f["features_rest"] = np.concatenate(
        [f["features_rest"], 0.05 * rng.standard_normal((1024, 9, 3))], 1)
    jp = jgs.GaussianParams(**{k: jnp.asarray(v, jnp.float32)
                               for k, v in f.items()}, max_sh_degree=4)
    return jp, _jax_aux(ta.alive.numpy())


def _jax_aux(alive):
    zeros = jnp.zeros(len(alive))
    return jgs.GaussianAux(alive=jnp.asarray(alive), max_radii2d=zeros,
                           xyz_gradient_accum=zeros, denom=zeros,
                           active_sh_degree=jnp.int32(3))


def test_ply_degree4_both_ways(tmp_path):
    jp, ja = _degree4_scene()
    path = str(tmp_path / "a.ply")
    jgs.save_ply(path, jp, ja, env_activation="exp")
    tp, ta = tgs.load_ply(path, 1024, 4, env_activation="exp", device="cpu")
    assert tuple(tp.features_rest.shape) == (1024, 24, 3)
    alive = np.asarray(ja.alive)
    for f in tgs.PARAM_FIELDS:
        if f != "env":
            np.testing.assert_array_equal(getattr(tp, f).numpy()[alive],
                                          np.asarray(getattr(jp, f))[alive],
                                          err_msg=f)
    path2 = str(tmp_path / "b.ply")
    tgs.save_ply(path2, tp, ta, env_activation="exp")
    from irgs_tpu_torch.utils.ply import read_ply
    names = read_ply(path2)["vertex"].data.dtype.names
    assert sum(n.startswith("f_rest_") for n in names) == 72
    jp2, _ = jgs.load_ply(path2, 1024, 4, env_activation="exp")
    for f in tgs.PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jp2, f)),
                                      getattr(tp, f).numpy(), err_msg=f)


def _assert_grad_close(tg, jg, name):
    jg = np.asarray(jg)
    tg = np.zeros(jg.shape, np.float32) if tg is None else tg.numpy()
    scale = max(float(np.abs(jg).max()), 1e-12)
    np.testing.assert_allclose(tg, jg, atol=GRAD_REL * scale, rtol=0,
                               err_msg=name)


def test_stage1_step_degree4_matches_jax():
    """The surfel phase, where the SH degree has reached 4 in training."""
    phase = "surfel"
    import test_torch_stage1 as s1
    # test_torch_stage1's scene size (256 surfels, capacity 512), drawn by
    # the port's workload with 25 coefficients per channel
    fields, alive = workload.stage1_small_fields(256, 512, s1.ENV, seed=7,
                                                 sh_degree=4)
    rp = jrgs.RefGaussianParams(**{f: jnp.asarray(fields[f])
                                   for f in trgs.REF_FIELDS}, max_sh_degree=4)
    ja = _jax_aux(alive)
    n = len(alive)
    kw = dict(img_w=s1.RES, img_h=s1.RES, active_sh_degree=4,
              white_background=False, phase=phase, use_indirect=False,
              dup_capacity=s1.DUP)
    jst, tst = js1.Stage1FullStatic(**kw), ts1.Stage1FullStatic(**kw)
    jcam = jtoy.make_ring_cameras(2, width=s1.RES, height_px=s1.RES)[0]
    tcam = ttoy.make_ring_cameras(2, width=s1.RES, height_px=s1.RES)[0]
    lut = tcm.compute_fg_lut(res=32, samples=64, device="cpu").numpy()
    yy, xx = np.mgrid[:s1.RES, :s1.RES] / s1.RES
    gt_img = np.stack([0.3 + 0.2 * np.sin(6 * xx), 0.4 + 0.1 * yy,
                       0.5 - 0.2 * xx * yy], -1).astype(np.float32)

    def loss_fn(params):
        pkg = s1._jax_render(params, ja, jcam.params(), jnp.asarray(lut),
                             None, jst, jnp.zeros((n, 2)))
        return js1._calc_loss(pkg, jnp.asarray(gt_img), None,
                              jnp.int32(s1.STEP), jst)

    (jloss, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(rp)
    tp, ta = tgs.params_from_numpy(fields, alive, "cpu",
                                   cls=trgs.RefGaussianParams, max_sh_degree=4)
    for t in tp.tensors().values():
        t.requires_grad_(True)
    pkg = ts1.render_phase(tp, ta, tcam.params("cpu"), torch.tensor(lut),
                           None, tst)
    tloss, tm = ts1._calc_loss(pkg, torch.tensor(gt_img), None, s1.STEP, tst)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for f, t in tp.tensors().items():
        _assert_grad_close(t.grad, getattr(jg, f), f)
    # the degree-4 coefficients take part
    assert float(np.abs(np.asarray(jg.features_rest)[:, 15:]).max()) > 0
