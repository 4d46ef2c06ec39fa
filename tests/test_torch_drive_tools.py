"""The port's tracer-bias drives (irgs_tpu_torch.tools.drive_parity,
.audit_train_budget, .trace_fidelity, .drive_stage2) and the reproducer
replay (.load_reproducer) on the CPU.

Against the JAX package, on the same scenes (the JAX toy scenes carried
across as numpy) and the same rays (drawn by jax.random as the JAX tools
draw them): at tests/test_parity.py's IMG = 32, the shadow scene's shading inputs, its
production and oracle radiance on the JAX drive's inputs, with JAX's light
draws fed in through envlight.LightDraws, and the PSNR between the two
frames; the audit's |dcolor| /
|dalpha| rows and trace_fidelity's rows against the JAX tools' formulas on
the JAX traces.

Tolerances: the shading inputs 2e-5; the oracle and the production
radiance 2e-5 + 2e-4 relative with at most 1 % of the values outside
(tests/test_torch_eval.py's bounds: a hit near the alpha or transmittance
cut, or a candidate near a budget's cut, may flip with the inputs' last
bits); the PSNR within 0.1 dB; the audit and fidelity
rows' means 2e-5 and percentiles 2e-5 (each ray's trace within the tracer
tests' 1e-5 on both sides), the share above 0.05 within one ray.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.config import Config as JConfig
from irgs_tpu.ops import grid_tracer as jgt
from irgs_tpu.ops import surfel_raster as jsr
from irgs_tpu.render import ir as jir
from irgs_tpu.scene import envlight as jenv
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.train.losses import psnr as jpsnr
from irgs_tpu.utils import math3d as jm
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.render import ir as tir
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.tools import audit_train_budget as audit
from irgs_tpu_torch.tools import drive_parity, drive_stage2, trace_fidelity
from irgs_tpu_torch.tools import load_reproducer
from test_torch_eval import ATOL, MAX_OUTLIER_SHARE, RTOL, TRACER
from test_torch_mis import jax_light_draws, one_torch_thread  # noqa: F401

IMG = 32                       # tests/test_parity.py
SPP = (8, 4)
N_SUB = 128

ROW_TOL = 2e-5


def carry(jparams, jaux):
    """The JAX scene's parameters as the port's, bit for bit."""
    fields = {f: np.asarray(getattr(jparams, f))
              for f in tgs.GaussianParams.FIELDS}
    return tgs.params_from_numpy(fields, np.asarray(jaux.alive), "cpu")


@pytest.fixture(scope="module")
def jax_gbuffer(shadow):
    jp, ja, _, _ = shadow
    return jax.jit(lambda c: _jax_gbuffer(jp, ja, c))(_cams()[0])


@pytest.fixture(scope="module")
def shadow():
    jp, ja = jtoy.make_shadow_scene(n_ground=300, n_sphere=300,
                                    n_capacity=640, env_resolution=16)
    # the env's first row equal to its second: at eval the light samples sit
    # on texel centres, where both packages' bilinear lookup jumps rows for
    # different samples (tests/test_torch_mis_eval.py)
    jp = dataclasses.replace(jp, env=jp.env.at[0].set(jp.env[1]))
    tp, ta = carry(jp, ja)
    return jp, ja, tp, ta


def _close_with_outliers(a, b):
    bad = np.abs(a - b) > ATOL + RTOL * np.abs(b)
    assert bad.mean() <= MAX_OUTLIER_SHARE, (bad.mean(), np.abs(a - b).max())


def _jax_gbuffer(jp, ja, cam, img=IMG):
    """tests/test_parity.py's _render up to the shading inputs."""
    feats = jnp.concatenate([jp.get_base_color(), jp.get_roughness()], -1)
    raster = jsr.rasterize(
        jp.xyz, jp.get_scaling(), jp.rotation, jp.get_opacity()[:, 0],
        jp.get_features(), feats, jnp.zeros((jp.n_capacity, 2)), cam,
        jnp.zeros(3), img_w=img, img_h=img, active_sh_degree=3,
        dup_capacity=2 ** 19, alive=ja.alive)
    maps = jir.derive_geometry_maps(raster, cam, img, img)
    flat = lambda x: x.reshape(-1, x.shape[-1])
    return ((flat(raster.feature[..., :3]), flat(raster.feature[..., 3:4]),
             flat(maps["normal_map"]), flat(maps["points"]),
             -flat(maps["rays_d"])), maps["alpha"])


def _jax_shade(jp, px, trace_fn):
    """tests/test_parity.py's rendering_equation call at SPP."""
    shade = jir.ShadeConfig(diffuse_sample_num=SPP[0],
                            light_sample_num=SPP[1], training=False)
    re = jir.rendering_equation(*px, jp.env, jenv.build_pdf(jp.env),
                                trace_fn, shade)
    return re["diffuse"] + re["specular"]


def _jax_inputs(jp, ja, cam_pos):
    s = jp.get_scaling()
    R = jm.quat_to_rotmat(jp.rotation)
    return jgt.TraceInputs(
        means3d=jp.xyz, opacity=jnp.where(ja.alive, jp.get_opacity()[:, 0], 0.0),
        ru=R[:, :, 0] / s[:, 0:1], rv=R[:, :, 1] / s[:, 1:2],
        normals=jp.world_normals(cam_pos=cam_pos), shs=jp.get_features(),
        features=jnp.zeros((jp.n_capacity, 0), jnp.float32))


def _jax_oracle(inputs, alive, tmin, ro, rd, chunk=2048):
    outs = [jgt.trace_reference(ro[a:a + chunk], rd[a:a + chunk], inputs,
                                alive, sh_deg=3)
            for a in range(0, ro.shape[0], chunk)]
    out = jgt.TraceOut(*[jnp.concatenate(x) for x in zip(*outs)])
    return jgt.normalize_trace(out, tmin)


def test_gbuffer_matches_jax(shadow, jax_gbuffer):
    """The drive's shading inputs (drive_parity.gbuffer) against the JAX
    drive's, within 2e-5 (the raster's float32 sums)."""
    _, _, tp, ta = shadow
    tcam = _cams()[1]
    jpx, jalpha = jax_gbuffer
    with torch.no_grad():
        tpx, talpha = drive_parity.gbuffer(tp, ta, tcam, IMG)
    for a, b in zip((*jpx, jalpha), (*tpx, talpha)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=0)


def _cams():
    kw = dict(radius=3.4, height=1.6, width=IMG, height_px=IMG)
    return (jtoy.make_ring_cameras(4, **kw)[0].params(),
            ttoy.make_ring_cameras(4, **kw)[0].params("cpu"))


def test_parity_shading_and_psnr_match_jax(shadow, jax_gbuffer):
    """On N_SUB foreground pixels of the JAX drive's shading inputs, picked
    as the drive's --subsample picks them (an oracle ray leaves a surface
    0.05 away, so its hits near the alpha and transmittance cuts move with
    the inputs' last bits): the production and the oracle radiance, and the
    PSNR between them. The tracer budgets are tests/test_torch_eval.py's
    small ones (the JAX side runs op by op)."""
    jp, ja, tp, ta = shadow
    # pallas_gather (a field of the JAX package only) off: XLA's gather
    tracer_j = jgt.TracerConfig(**dict(TRACER, pallas_gather=0))
    tracer_t = tgt.TracerConfig(**TRACER)
    jcam, tcam = _cams()
    jgrid = jgt.build_grid_from_gaussians(jp, ja, tracer_j)
    tgrid = tgt.build_grid_from_gaussians(tp, ta, tracer_t)
    assert int(jgrid.overflow) == int(tgrid.overflow) == 0
    jpx, alpha = jax_gbuffer
    fg = np.flatnonzero(np.asarray(alpha[..., 0]).reshape(-1) > 0.5)
    sel = np.sort(np.random.default_rng(17).choice(fg, size=N_SUB,
                                                   replace=False))
    jpx = tuple(x[sel] for x in jpx)
    inputs = _jax_inputs(jp, ja, jcam.cam_pos)

    def jax_oracle_tf(ro, rd):
        shape = ro.shape[:-1]
        out = _jax_oracle(inputs, ja.alive, tracer_j.transmittance_min,
                          ro.reshape(-1, 3), rd.reshape(-1, 3))
        return jgt.TraceOut(*[x.reshape(shape + x.shape[1:]) for x in out])

    # the production shading jitted (op by op it takes a minute), the
    # oracle's op by op (XLA's fusion of it rounds its exponentials
    # otherwise than both its own ops and torch's do)
    prod_j = np.asarray(jax.jit(lambda px: _jax_shade(
        jp, px, jir.make_trace_fn(jp, ja, jgrid, tracer_j, jcam.cam_pos,
                                  3)))(jpx))
    orc_j = np.asarray(_jax_shade(jp, jpx, jax_oracle_tf))

    # JAX's eval draws: one categorical over the batch, key 0
    draws = jax_light_draws(jenv.build_pdf(jp.env), SPP[1], batch=N_SUB)
    px = tuple(torch.tensor(np.asarray(x)) for x in jpx)
    with torch.no_grad():
        prod_t, orc_t = (drive_parity.shade(
            px, torch.tensor(sel), tcam.cam_pos, tp, ta, tgrid, tracer_t,
            *SPP, mode, draws_fn=lambda pdf, i, n: draws).numpy()
            for mode in ("prod", "oracle"))
    # both traces hold a hit near the alpha or transmittance cut on either
    # side by the last bits of its inputs (XLA's fused rounding and torch's)
    _close_with_outliers(orc_t, orc_j)
    _close_with_outliers(prod_t, prod_j)
    srgb = lambda x: np.clip(np.asarray(jm.rgb_to_srgb(jnp.asarray(x))),
                             0.0, 1.0)
    p_j = float(jpsnr(jnp.asarray(srgb(prod_j)), jnp.asarray(srgb(orc_j))))
    p_t = float(-10.0 * np.log10(np.mean((srgb(prod_t) - srgb(orc_t)) ** 2)))
    assert abs(p_t - p_j) < 0.1 and math.isfinite(p_t), (p_t, p_j)


def test_drive_parity_main_prints_psnr(shadow, capsys):
    _, _, tp, ta = shadow
    res = drive_parity.main(["--device", "cpu", "--img", "16", "--spp", "8",
                             "4", "--views", "1"], scene=(tp, ta))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"parity_psnr": res} and set(res) == {"view0_psnr"}
    assert math.isfinite(res["view0_psnr"])


def _jax_rays(jp, n_gauss, n_rays):
    """The JAX tools' rays (audit_train_budget.py, trace_fidelity.py)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    idx = jax.random.randint(k1, (n_rays,), 0, n_gauss)
    ro = jp.xyz[idx] + 0.05 * jax.random.normal(k2, (n_rays, 3))
    rd = jax.random.normal(k3, (n_rays, 3))
    return ro, rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def sphere():
    jp, ja = jtoy.make_sphere_scene(n_surface=2000, n_capacity=4096,
                                    env_resolution=64)
    tp, ta = carry(jp, ja)
    ro, rd = _jax_rays(jp, 2000, 192)
    return jp, ja, tp, ta, ro, rd


def _jax_row(out, ref):
    """audit_train_budget.py's row numbers."""
    d = jnp.abs(out.color - ref.color).max(-1)
    q = np.percentile(np.asarray(d), [50, 90, 99])
    return {"dcolor": float(jnp.abs(out.color - ref.color).mean()),
            "dalpha": float(jnp.abs(out.alpha - ref.alpha).mean()),
            "p50": q[0], "p90": q[1], "p99": q[2],
            "frac_gt_0.05": float((d > 0.05).mean())}


def test_audit_rows_match_jax(sphere):
    jp, ja, tp, ta, ro, rd = sphere
    # one config (its re-trace rounds on); the single-pass variant's rows
    # are test_trace_fidelity_rows_match_jax's
    configs = [("small tiled", dict(TRACER, grid_res=16,
                                    pair_capacity=2 ** 16, pallas_gather=0))]
    ref_j = _jax_oracle(_jax_inputs(jp, ja, jnp.zeros(3)), ja.alive, 0.03,
                        ro, rd, chunk=64)
    rows_t = audit.audit(tp, ta, torch.tensor(np.asarray(ro)),
                         torch.tensor(np.asarray(rd)),
                         [(n, tgt.TracerConfig(**c)) for n, c in configs],
                         print_fn=lambda s: None)
    for (name, cfg), (name_t, row_t) in zip(configs, rows_t):
        tc = jgt.TracerConfig(**cfg)
        grid = jgt.build_grid_from_gaussians(jp, ja, tc)
        out = jax.jit(jir.make_trace_fn(jp, ja, grid, tc, jnp.zeros(3), 3))(
            ro, rd)
        row_j = _jax_row(out, ref_j)
        assert name_t == name
        assert row_j["dalpha"] > 0 or row_j["dcolor"] > 0   # a real bias
        for k in ("dcolor", "dalpha", "p50", "p90", "p99"):
            assert abs(row_t[k] - row_j[k]) <= ROW_TOL, (name, k, row_t,
                                                         row_j)
        assert abs(row_t["frac_gt_0.05"] - row_j["frac_gt_0.05"]) <= 1 / 192


def test_audit_variants_and_flags():
    """The JAX tool's variant lists, each a TracerConfig the port has."""
    pipe = JConfig().pipe
    train = tgt.TracerConfig.from_pipe(pipe)
    ev = tgt.TracerConfig.from_pipe(pipe, eval=True)
    args = audit._parser().parse_args(["--full", "--t32", "--tile64",
                                       "--bf16"])
    names = [n for n, _ in audit.variants(args, train, ev)]
    assert len(names) == 2 + 5 + 14 + 6 + 4 and len(set(names)) == len(names)
    only = audit._parser().parse_args(["--bf16", "--only", "bf16"])
    assert [n for n, _ in audit.variants(only, train, ev)] == [
        "train bf16", "eval bf16", "eval bf16 topk"]


def test_trace_fidelity_rows_match_jax(sphere):
    jp, ja, tp, ta, ro, rd = sphere
    ro_t, rd_t = torch.tensor(np.asarray(ro)), torch.tensor(np.asarray(rd))
    def jax_run(**kw):
        tc = jgt.TracerConfig(grid_res=16, pair_capacity=2 ** 16, **kw)
        grid = jgt.build_grid_from_gaussians(jp, ja, tc)
        return jax.jit(jir.make_trace_fn(jp, ja, grid, tc, jnp.zeros(3),
                                         3))(ro, rd)

    def t_run(**kw):
        cfg = tgt.TracerConfig(grid_res=16, pair_capacity=2 ** 16, **kw)
        grid = tgt.build_grid_from_gaussians(tp, ta, cfg)
        return tir.make_trace_fn(tp, ta, grid, cfg, torch.zeros(3), 3)(
            ro_t, rd_t)

    ref_j = jax_run(**trace_fidelity.REFERENCE)
    ref_t = t_run(**trace_fidelity.REFERENCE)
    for name, kw in trace_fidelity.VARIANTS:
        o_j, o_t = jax_run(**kw), t_run(**kw)
        c_t = trace_fidelity.compare(o_t, ref_t)
        c_j = {"dalpha": float(jnp.abs(o_j.alpha - ref_j.alpha).mean()),
               "dcolor": float(jnp.abs(o_j.color - ref_j.color).mean())}
        for k in c_t:
            assert abs(c_t[k] - c_j[k]) <= ROW_TOL, (name, k, c_t, c_j)


def test_trace_fidelity_main_rows():
    rows = trace_fidelity.main(["--device", "cpu"],
                               densities=[(800, 1024, "tiny")], n_rays=128,
                               grid_res=16)
    assert set(rows["tiny"]) == {"oracle_ms",
                                 *(n for n, _ in trace_fidelity.VARIANTS)}
    for name, _ in trace_fidelity.VARIANTS:
        r = rows["tiny"][name]
        assert all(math.isfinite(r[k]) for k in ("dalpha", "dcolor", "ms"))


def test_drive_stage2_recovers():
    """The drive shrunk (512 surfels, 32², 4 GT samples, 17 steps of 128
    pixels): the ray PSNR rises (steps 0 and 16 see the same camera) and
    the envmap error falls below its initial value."""
    res = drive_stage2.main(["--device", "cpu"], n_surface=512,
                            n_capacity=1024, img=32, iters=17,
                            log_at=(0, 16), gt_spp=4, spp=4, n_pixels=128)
    assert res["logged"][16]["ray_psnr"] > res["logged"][0]["ray_psnr"]
    assert res["env_err"] < res["env_err_init"]


def test_load_reproducer_replay_raises_at_the_dumped_step(tmp_path, capsys):
    """tests/test_torch_train_cli.py's --inject_nan_at dump (step 2 of 3,
    --detect_anomaly): the replay of that step under anomaly detection
    raises on the NaN, as the JAX tool's jax_debug_nans does."""
    from irgs_tpu_torch.train.__main__ import main as train_main
    from test_torch_train_cli import _argv, _write_blender
    params, aux = ttoy.make_sphere_scene(512, n_capacity=512,
                                         env_resolution=16, device="cpu")
    with torch.no_grad():
        params.scaling -= math.log(2.0)
    ply = str(tmp_path / "start.ply")
    tgs.save_ply(ply, params, aux)
    run = str(tmp_path / "nan_run")
    with pytest.raises(SystemExit) as exc:
        train_main(_argv(_write_blender(str(tmp_path / "lego")), run, ply,
                         "--iterations", "3", "--inject_nan_at", "2",
                         "--detect_anomaly"))
    assert exc.value.code == 3
    rp = os.path.join(run, "reproducer_000002.ckpt")
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="nan"):
        load_reproducer.main([rp, "--device", "cpu"])
    assert "replaying iter 2 (cam" in capsys.readouterr().out

