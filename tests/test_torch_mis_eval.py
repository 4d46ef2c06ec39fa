"""The port's NVS eval frame with light samples (the MIS branch of
render_ir_eval at EvalConfig's default 512 diffuse + 256 light samples)
against the JAX package's, with JAX's per-pixel light draws fed in through
the frame's `light_draws` hook: the toy sphere (512 surfels) at 16x16, the
eval tracer of tests/test_torch_eval.py (the JAX package's Pallas gather in
interpret mode), 128-pixel chunks of 98,304 rays (the chunked trace path).

Tolerance as tests/test_torch_eval.py: rtol 2e-4 / atol 2e-5 per element,
except for at most 1 % of an AOV's elements, each within 1/S of the value
(S = 768): a sample direction an ulp apart in the two packages can take or
drop a hit in the tracer's discrete tests, which moves one of S samples.
"""

import dataclasses

import jax
import numpy as np
import pytest

import irgs_tpu.ops.gather_pallas as gp
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.render import eval as jev
from irgs_tpu.scene import envlight as jenv
from irgs_tpu.scene import toy
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.render import eval as tev
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from test_torch_eval import AOVS, ATOL, MAX_OUTLIER_SHARE, RTOL, TRACER
from test_torch_mis import jax_light_draws, one_torch_thread  # noqa: F401

IMG = 16


def _ecfg(mod, tcfg):
    # EvalConfig's default samples; 2^17 point samples a chunk: 128 pixels
    return mod.EvalConfig(img_w=IMG, img_h=IMG, active_sh_degree=3,
                          dup_capacity=2 ** 14, chunk_point_samples=2 ** 17,
                          tracer=tcfg)


@pytest.fixture(scope="module")
def frames():
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    # the env's first row equal to its second: at eval the light samples sit
    # on texel centres, and at a first-row centre both packages' bilinear
    # lookup (which takes row y0 + 1 after clamping y0 = -1 to 0) jumps from
    # row 0 to row 1 when v·H - 0.5 rounds an ulp below 0, which XLA's and
    # torch's acos do for different samples
    jp = dataclasses.replace(jp, env=jp.env.at[0].set(jp.env[1]))
    tp, ta = tgs.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS},
        np.asarray(ja.alive), "cpu")
    jcam = toy.make_ring_cameras(1, width=IMG, height_px=IMG)[0].params()
    tcam = ttoy.make_ring_cameras(1, width=IMG, height_px=IMG)[0].params("cpu")
    jcfg = _ecfg(jev, gt.TracerConfig(**TRACER))
    tcfg = _ecfg(tev, tgt.TracerConfig(**TRACER))
    assert (jcfg.diffuse_sample_num, jcfg.light_sample_num) == (512, 256)
    assert tcfg.pixel_chunk == jcfg.pixel_chunk == 128
    jgrid = gt.build_grid_from_gaussians(jp, ja, jcfg.tracer)
    tgrid = tgt.build_grid_from_gaussians(tp, ta, tcfg.tracer)
    jpdf = jenv.build_pdf(jp.env)
    key0 = jax.random.PRNGKey(0)            # the eval frame's key
    hook = lambda pid: jax_light_draws(jpdf, tcfg.light_sample_num, key0,
                                       pixel_ids=pid.numpy())
    orig = gp.gather_rows
    gp.gather_rows = lambda t, i, **kw: orig(t, i, interpret=True)
    try:
        jo = jev.render_ir_eval(jp, ja, jgrid, jcam, jcfg)
    finally:
        gp.gather_rows = orig
    stats = {}
    to = tev.render_ir_eval(tp, ta, tgrid, tcam, tcfg, light_draws=hook,
                            stats_out=stats)
    own = tev.render_ir_eval(tp, ta, tgrid, tcam, tcfg)
    return ({k: np.asarray(v) for k, v in jo.items()},
            {k: v.numpy() for k, v in to.items()},
            {k: v.numpy() for k, v in own.items()}, stats)


@pytest.mark.parametrize("aov", AOVS)
def test_mis_eval_frame_matches_jax(frames, aov):
    j, t, _, _ = frames
    assert t[aov].shape == j[aov].shape and np.isfinite(t[aov]).all()
    d = np.abs(t[aov] - j[aov])
    share = float((d > ATOL + RTOL * np.abs(j[aov])).mean())
    assert share <= MAX_OUTLIER_SHARE, share
    assert float(d.max()) <= 1.0 / 768, float(d.max())


def test_mis_eval_frame_stats_and_own_draws(frames):
    """Two chunks of 128 pixels at 768 rays each; the frame with the port's
    own draws (hash uniforms, inverse CDF) is another MC estimate of the
    same image: its G-buffer AOVs are JAX's, its shading close."""
    j, _, own, st = frames
    n_fg = int((j["rend_alpha"] > 0).sum())
    assert st["shaded_pixels"] == n_fg and st["shaded_rays"] == n_fg * 768
    assert st["traced_rays"] == -(-n_fg // 128) * 128 * 768
    for k in ("base_color", "roughness", "rend_alpha", "surf_depth"):
        np.testing.assert_allclose(own[k], j[k], rtol=RTOL, atol=ATOL)
    fg = j["rend_alpha"][..., 0] > 0
    assert abs(own["render"][fg].mean() - j["render"][fg].mean()) < 0.02
