"""The port's stage 1 (Ref-Gaussian) against the JAX package's, on the same
inputs made with numpy from a seed, at test scale (the 256-surfel toy
sphere jittered, 40x40, 16² cubemaps, a 32² FG table).

- Cubemap gradients (scene/cubemap.py): build_specular_mips,
  sample_cubemap_mip and sample_fg_lut, differentiated through a random
  weighted sum, against jax.grad within 1e-4·max|g|.
- `colors_precomp` in the rasterizer: values within the raster tests'
  forward tolerance (atol 5e-5, rtol 1e-4), the colours' gradient within
  5e-4·max|g| (theirs), and no gradient to the SH, as in JAX.
- The renderers (render/ref_gaussian.py): render_initial, render_volume,
  render_surfel (each with and without the indirect TSDF path where it has
  one) and render_surfel2, every output map within atol 5e-5 / rtol 1e-4.
- stage1_full's loss and gradients per phase, against eager JAX: the loss
  within rtol 1e-5, every parameter's gradient and that of the screen-space
  offset within 1e-4·max|g| (the stage-2 bound, ROADMAP C), at a step past
  normal_loss_start so that every loss term has gradients.

The JAX renderers rasterize through the XLA backend (their default); the
port's through the plain blend on the CPU, which computes the same function
(tests/test_torch_raster.py). Gradients are compared, not parameters after
Adam: at eps = 1e-15 Adam turns a gradient near 0 into a ±lr step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import surfel_raster as jsr
from irgs_tpu.render import ref_gaussian as jrg
from irgs_tpu.scene import cubemap as jcm
from irgs_tpu.scene import ref_gaussians as jrgs
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.train import stage1_full as js1
from irgs_tpu_torch.ops import surfel_raster as tsr
from irgs_tpu_torch.ops import tsdf as ttsdf
from irgs_tpu_torch.render import ref_gaussian as trg
from irgs_tpu_torch.scene import cubemap as tcm
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import ref_gaussians as trgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage1_full as ts1

RES = 40
DUP = 2 ** 13
ENV = 16
STEP = 10            # > normal_loss_start (0)
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_REL = 1e-4
PHASES = ["initial", "volume", "surfel", "volume_indirect",
          "surfel_indirect"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weighted_sum_grads(jfn, tfn, x, seed):
    """jax.grad and torch autograd of Σ w·fn(x) for a random w per output."""
    rng = np.random.default_rng(seed)
    jout = jfn(jnp.asarray(x))
    ws = [rng.standard_normal(np.shape(o)).astype(np.float32)
          for o in jax.tree.leaves(jout)]

    def jloss(v):
        return sum(jnp.sum(o * w) for o, w in zip(jax.tree.leaves(jfn(v)), ws))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    outs = tfn(xt)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    flat = []
    for o in outs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    sum((o * torch.tensor(w)).sum() for o, w in zip(flat, ws)).backward()
    return xt.grad.numpy(), jg


def assert_grad_close(tg, jg, name=""):
    scale = max(float(np.abs(jg).max()), 1e-12)
    np.testing.assert_allclose(tg, jg, atol=GRAD_REL * scale, rtol=0,
                               err_msg=name)


# --------------------------------------------------------------------------
# cubemap gradients


def test_build_specular_mips_gradient_matches_jax():
    cube = np.random.default_rng(0).standard_normal(
        (6, 16, 16, 3)).astype(np.float32)

    def jfn(c):
        spec, diff = jcm.build_specular_mips(c, min_res=4)
        return spec + [diff]

    def tfn(c):
        spec, diff = tcm.build_specular_mips(c, min_res=4)
        return spec + [diff]

    tg, jg = weighted_sum_grads(jfn, tfn, cube, 1)
    assert_grad_close(tg, jg)


def test_sample_cubemap_mip_gradient_matches_jax():
    rng = np.random.default_rng(2)
    mips = [rng.standard_normal((6, r, r, 3)).astype(np.float32)
            for r in (16, 8, 4)]
    dirs = rng.standard_normal((500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    level = rng.uniform(0, 2, 500).astype(np.float32)
    flat = np.concatenate([m.reshape(-1) for m in mips])
    sizes = [m.size for m in mips]

    def split(v):
        out, a = [], 0
        for m, s in zip(mips, sizes):
            out.append(v[a:a + s].reshape(m.shape))
            a += s
        return out

    tg, jg = weighted_sum_grads(
        lambda v: jcm.sample_cubemap_mip(split(v), jnp.asarray(dirs),
                                         jnp.asarray(level)),
        lambda v: tcm.sample_cubemap_mip(split(v), torch.tensor(dirs),
                                         torch.tensor(level)), flat, 3)
    assert_grad_close(tg, jg)


def test_sample_fg_lut_gradient_matches_jax():
    rng = np.random.default_rng(4)
    lut = np.asarray(jcm.compute_fg_lut(res=32, samples=64))
    ndv = rng.uniform(0, 1, (400, 1)).astype(np.float32)
    rough = rng.uniform(0, 1, (400, 1)).astype(np.float32)
    # to the lookup coordinates
    tg, jg = weighted_sum_grads(
        lambda v: jcm.sample_fg_lut(jnp.asarray(lut), v[:, :1], v[:, 1:]),
        lambda v: tcm.sample_fg_lut(torch.tensor(lut), v[:, :1], v[:, 1:]),
        np.concatenate([ndv, rough], -1), 5)
    assert_grad_close(tg, jg)
    # and to the table itself
    tg, jg = weighted_sum_grads(
        lambda t: jcm.sample_fg_lut(t, jnp.asarray(ndv), jnp.asarray(rough)),
        lambda t: tcm.sample_fg_lut(t, torch.tensor(ndv), torch.tensor(rough)),
        lut, 6)
    assert_grad_close(tg, jg)


# --------------------------------------------------------------------------
# the scene


def _jax_scene():
    jp, ja = jtoy.make_sphere_scene(n_surface=256, n_capacity=512,
                                    env_resolution=16)
    rng = np.random.default_rng(7)
    n, k = 512, 16
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    rp = jrgs.RefGaussianParams(
        xyz=f32(np.asarray(jp.xyz) + 0.01 * rng.standard_normal((n, 3))),
        base_color=f32(rng.standard_normal((n, 3))),
        metallic=f32(rng.standard_normal((n, 1))),
        roughness=f32(rng.standard_normal((n, 1))),
        features_dc=jp.features_dc,
        features_rest=f32(0.05 * rng.standard_normal((n, k - 1, 3))),
        indirect_dc=f32(0.3 * rng.standard_normal((n, 1, 3))),
        indirect_rest=f32(0.05 * rng.standard_normal((n, k - 1, 3))),
        scaling=jp.scaling, rotation=jp.rotation, opacity=jp.opacity,
        env1=f32(0.5 * rng.standard_normal((6, ENV, ENV, 3))),
        env2=f32(0.5 * rng.standard_normal((6, ENV, ENV, 3))))
    return rp, ja


def to_port(rp, ja):
    fields = {f: np.asarray(getattr(rp, f)) for f in trgs.REF_FIELDS}
    return tgs.params_from_numpy(fields, np.asarray(ja.alive), "cpu",
                                 cls=trgs.RefGaussianParams)


def port_volume(jvol):
    return ttsdf.TSDFVolume(*(torch.tensor(np.asarray(x)) for x in jvol))


@pytest.fixture(scope="module")
def scene():
    rp, ja = _jax_scene()
    jcams = jtoy.make_ring_cameras(2, width=RES, height_px=RES)
    tcams = ttoy.make_ring_cameras(2, width=RES, height_px=RES)
    lut = np.asarray(jcm.compute_fg_lut(res=32, samples=64))
    yy, xx = np.mgrid[:RES, :RES] / RES
    gt = np.stack([0.3 + 0.2 * np.sin(6 * xx), 0.4 + 0.1 * yy,
                   0.5 - 0.2 * xx * yy], -1).astype(np.float32)
    jvol = js1.reconstruct_tsdf(rp, ja, jcams, img_w=RES, img_h=RES,
                                active_sh_degree=3, mesh_res=32,
                                cameras_extent=3.0, dup_capacity=DUP)
    return dict(rp=rp, ja=ja, jcam=jcams[0].params(),
                tcam=tcams[0].params("cpu"), lut=lut, gt=gt, jvol=jvol,
                tvol=port_volume(jvol), tcams=tcams)


def test_reconstruct_tsdf_matches_jax(scene):
    tp, ta = to_port(scene["rp"], scene["ja"])
    tvol = ts1.reconstruct_tsdf(tp, ta, scene["tcams"], img_w=RES, img_h=RES,
                                active_sh_degree=3, mesh_res=32,
                                cameras_extent=3.0, dup_capacity=DUP)
    for name in ("tsdf", "weight", "origin", "voxel"):
        np.testing.assert_allclose(
            getattr(tvol, name).numpy(), np.asarray(getattr(scene["jvol"],
                                                            name)),
            rtol=1e-5, atol=1e-5, err_msg=name)
    assert float(tvol.weight.max()) > 0


def test_colors_precomp_matches_jax(scene):
    rp = scene["rp"]
    n = rp.n_capacity
    rng = np.random.default_rng(8)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    feats = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    cot = rng.standard_normal((RES, RES, 3)).astype(np.float32)

    def jfn(c, shs):
        out = jsr.rasterize(rp.xyz, rp.get_scaling(), rp.rotation,
                            rp.get_opacity()[:, 0], shs, jnp.asarray(feats),
                            jnp.zeros((n, 2)), scene["jcam"], jnp.zeros(3),
                            img_w=RES, img_h=RES, active_sh_degree=3,
                            dup_capacity=DUP, alive=scene["ja"].alive,
                            colors_precomp=c)
        return jnp.sum(out.color * cot), out

    shs = rp.get_features()
    (_, jout), (jgc, jgs) = jax.value_and_grad(jfn, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(colors), shs)
    tp, ta = to_port(rp, scene["ja"])
    c = torch.tensor(colors, requires_grad=True)
    sh = tp.get_features().detach().requires_grad_(True)
    tout = tsr.rasterize(tp.xyz, tp.get_scaling(), tp.rotation,
                         tp.get_opacity()[:, 0], sh, torch.tensor(feats),
                         torch.zeros(n, 2), scene["tcam"], torch.zeros(3),
                         img_w=RES, img_h=RES, active_sh_degree=3,
                         dup_capacity=DUP, alive=ta.alive, colors_precomp=c)
    (tout.color * torch.tensor(cot)).sum().backward()
    for name in ("color", "feature", "alpha", "depth"):
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)),
                                   err_msg=name, **FWD_TOL)
    jgc = np.asarray(jgc)
    np.testing.assert_allclose(c.grad.numpy(), jgc,
                               atol=5e-4 * np.abs(jgc).max(), rtol=0)
    assert float(np.abs(np.asarray(jgs)).max()) == 0.0
    assert sh.grad is None or float(sh.grad.abs().max()) == 0.0


# --------------------------------------------------------------------------
# renderers and the step, per phase


def _static(phase):
    base, ind = phase.split("_")[0], phase.endswith("indirect")
    kw = dict(img_w=RES, img_h=RES, active_sh_degree=3,
              white_background=False, phase=base, use_indirect=ind,
              dup_capacity=DUP)
    return js1.Stage1FullStatic(**kw), ts1.Stage1FullStatic(**kw)


def _jax_render(params, aux, cam, lut, vol, st, m2d):
    bg = jnp.zeros(3)
    kw = dict(img_w=st.img_w, img_h=st.img_h,
              active_sh_degree=st.active_sh_degree,
              dup_capacity=st.dup_capacity, means2d_offset=m2d)
    if st.phase == "initial":
        return jrg.render_initial(params, aux, cam, bg, **kw)
    if st.phase == "volume":
        return jrg.render_volume(params, aux, cam, bg,
                                 jrgs.EnvMips.build(params.env2), lut,
                                 vol=vol, use_indirect=st.use_indirect, **kw)
    return jrg.render_surfel(params, aux, cam, bg,
                             jrgs.EnvMips.build(params.env1), lut, vol=vol,
                             use_indirect=st.use_indirect, **kw)


@pytest.fixture(scope="module", params=PHASES)
def phase_run(request, scene):
    phase = request.param
    jst, tst = _static(phase)
    rp, ja = scene["rp"], scene["ja"]
    jvol = scene["jvol"] if jst.use_indirect else None
    lut = jnp.asarray(scene["lut"])
    gt = jnp.asarray(scene["gt"])

    def loss_fn(params, m2d):
        pkg = _jax_render(params, ja, scene["jcam"], lut, jvol, jst, m2d)
        loss, metrics = js1._calc_loss(pkg, gt, None, jnp.int32(STEP), jst)
        return loss, (metrics, pkg)

    zeros2d = jnp.zeros((rp.n_capacity, 2))
    (jloss, (jm, jpkg)), (jg, jg2d) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(rp, zeros2d)

    tp, ta = to_port(rp, ja)
    for t in tp.tensors().values():
        t.requires_grad_(True)
    m2d = torch.zeros((tp.n_capacity, 2), requires_grad=True)
    tvol = scene["tvol"] if tst.use_indirect else None
    tpkg = ts1.render_phase(tp, ta, scene["tcam"], torch.tensor(scene["lut"]),
                            tvol, tst, means2d_offset=m2d)
    tloss, tm = ts1._calc_loss(tpkg, torch.tensor(scene["gt"]), None, STEP,
                               tst)
    tloss.backward()
    return dict(phase=phase, jloss=jloss, jm=jm, jpkg=jpkg, jg=jg, jg2d=jg2d,
                tloss=tloss, tm=tm, tpkg=tpkg, tp=tp, m2d=m2d)


def test_renderer_outputs_match_jax(phase_run):
    jpkg, tpkg = phase_run["jpkg"], phase_run["tpkg"]
    keys = sorted(k for k in jpkg if k != "raster")
    assert keys == sorted(k for k in tpkg if k != "raster")
    for k in keys:
        np.testing.assert_allclose(tpkg[k].detach().numpy(),
                                   np.asarray(jpkg[k]), err_msg=k, **FWD_TOL)
    np.testing.assert_array_equal(tpkg["raster"].radii.numpy(),
                                  np.asarray(jpkg["raster"].radii))
    if phase_run["phase"].endswith("indirect"):
        # the TSDF occludes some reflected rays and not others
        vis = tpkg["visibility"].detach()[tpkg["alpha"][..., 0] > 0.5]
        assert float(vis.min()) < 0.5 < float(vis.max())


def test_stage1_loss_matches_jax(phase_run):
    jm, tm = phase_run["jm"], phase_run["tm"]
    for k in ("loss", "loss_l1", "psnr", "loss_normal"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("field", list(trgs.REF_FIELDS) + ["means2d"])
def test_stage1_gradients_match_jax(phase_run, field):
    if field == "means2d":
        jg, tg = np.asarray(phase_run["jg2d"]), phase_run["m2d"].grad
    else:
        jg = np.asarray(getattr(phase_run["jg"], field))
        tg = getattr(phase_run["tp"], field).grad
    tg = torch.zeros(jg.shape) if tg is None else tg
    assert_grad_close(tg.numpy(), jg, f"{phase_run['phase']}/{field}")


def test_render_surfel2_matches_jax(scene):
    rp, ja = scene["rp"], scene["ja"]
    jenv = jrgs.EnvMips.build(rp.env1)
    jout = jrg.render_surfel2(rp, ja, scene["jcam"], jnp.zeros(3), jenv,
                              img_w=RES, img_h=RES, active_sh_degree=3,
                              dup_capacity=DUP)
    tp, ta = to_port(rp, ja)
    with torch.no_grad():
        tout = trg.render_surfel2(tp, ta, scene["tcam"], torch.zeros(3),
                                  trgs.EnvMips.build(tp.env1), img_w=RES,
                                  img_h=RES, active_sh_degree=3,
                                  dup_capacity=DUP)
    for k in ("render", "metallic_map", "roughness_map", "base_color_map",
              "diffuse_map", "specular_map", "alpha"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **FWD_TOL)
    assert tout["raster"].feature.shape[-1] == 5


def test_stage1_full_step_updates_in_place(scene):
    """One port step: gradients feed the densification statistics, the
    step counter moves, Adam moves the parameters."""
    from irgs_tpu_torch.config import stage1_config
    tp, ta = to_port(scene["rp"], scene["ja"])
    x0 = tp.xyz.detach().clone()
    state = ts1.init_state(tp, ta, stage1_config().opt)
    _, tst = _static("volume")
    state, m = ts1.stage1_full_step(state, scene["tcam"],
                                    torch.tensor(scene["gt"]), None,
                                    torch.tensor(scene["lut"]), None, st=tst)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert float(state.aux.denom.max()) == 1.0
    assert float(state.aux.xyz_gradient_accum.max()) > 0.0
    assert not torch.equal(state.params.xyz.detach(), x0)
