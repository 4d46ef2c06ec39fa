"""The port's rasterizer (irgs_tpu_torch.ops.surfel_raster / raster_blend)
against the JAX package's, on the same inputs made with numpy from a seed
(n = 48 surfels, 32x32 image, S = 4 features, as the Pallas parity test in
tests/test_raster.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import raster_pallas as rp
from irgs_tpu.ops import surfel_raster as sr
from irgs_tpu.scene.cameras import Camera
from irgs_tpu_torch.ops import raster_blend as trb
from irgs_tpu_torch.ops import surfel_raster as tsr
from irgs_tpu_torch.scene.cameras import Camera as TCamera

W = H = 32
DUP = 2 ** 12
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
NAMES = ("color", "feature", "alpha", "depth", "depth2", "depth_median",
         "normal", "distortion")


def make_scene(seed=5, n=48, s=4):
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1.0, 1.0, (n, 3)),
            np.exp(rng.uniform(-3.0, -1.5, (n, 2))),
            rng.standard_normal((n, 4)),
            1.0 / (1.0 + np.exp(-(rng.standard_normal((n, 1)) + 1.0))),
            0.3 * rng.standard_normal((n, 16, 3)),
            rng.uniform(size=(n, s)))
    return tuple(a.astype(np.float32) for a in arrs)


def cams():
    R, T = np.eye(3), np.array([0.0, 0.0, 4.0])
    return (Camera(0, R, T, fovx=0.8, fovy=0.8, image=None, width=W, height=H),
            TCamera(0, R, T, fovx=0.8, fovy=0.8, width=W, height=H))


@pytest.fixture(scope="module")
def setup():
    scene = make_scene()
    jcam, tcam = cams()
    return scene, jcam.params(), tcam.params("cpu")


@pytest.fixture
def interpret():
    old = rp.INTERPRET
    rp.INTERPRET = True
    yield
    rp.INTERPRET = old


def test_preprocess_and_binning_match_jax(setup):
    (means, scales, quats, opac, shs, feats), jcp, tcp = setup
    jp = sr.preprocess(*map(jnp.asarray, (means, scales, quats, opac, shs)),
                       jcp, W, H, 2)
    tp = tsr.preprocess(*map(torch.tensor, (means, scales, quats, opac, shs)),
                        tcp, W, H, 2)
    assert np.asarray(jp.valid).sum() > 10
    for name in ("valid", "rect_min", "rect_max", "radius"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    for name in ("M", "center", "depth", "normal", "opacity", "rgb"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    jb = sr.bin_and_sort(jp, 2, 2, DUP)
    tb = tsr.bin_and_sort(tp, 2, 2, DUP)
    for name in ("sorted_gauss", "tile_start", "tile_count", "overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


def _slab(setup):
    (means, scales, quats, opac, shs, feats), jcp, tcp = setup
    with torch.no_grad():
        tp = tsr.preprocess(*map(torch.tensor, (means, scales, quats, opac, shs)),
                            tcp, W, H, 2)
        tb = tsr.bin_and_sort(tp, 2, 2, DUP)
        return tsr.build_slab(tp, tb, torch.tensor(feats), 2, 4, DUP)


def test_plain_blend_matches_pallas_interpret(setup, interpret):
    splat, starts, counts = _slab(setup)
    S = 4
    args_j = (jnp.asarray(splat.numpy()), jnp.asarray(starts.numpy()),
              jnp.asarray(counts.numpy()))
    out_j, vjp = jax.vjp(lambda s: rp.blend_tiles(s, *args_j[1:], 2, 4, S),
                         args_j[0])
    sp = splat.clone().requires_grad_(True)
    out_t = trb.blend_tiles_plain(sp, starts, counts, 2, 4, S)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    assert float(out_t.detach()[..., trb.n_attr(S) + 2].max()) > 0.2
    cot = np.random.default_rng(11).standard_normal(out_t.shape).astype(np.float32)
    cot[..., trb.c_out(S) - 2] = 0.0   # med_ord is an index
    (g_j,) = vjp(jnp.asarray(cot))
    (g_t,) = torch.autograd.grad(out_t, sp, torch.tensor(cot))
    g_j = np.asarray(g_j)
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=5e-4 * scale, rtol=0)


def _loss_terms(out, tgt, absf):
    return absf(out.color - tgt).mean() + out.feature.mean() \
        + 0.1 * out.distortion.mean() + out.normal.mean() \
        + 0.01 * out.depth.mean() + 0.01 * out.depth_median.mean()


def test_rasterize_matches_jax_values_and_gradients(setup):
    scene, jcp, tcp = setup
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    tgt = np.random.default_rng(3).uniform(size=(H, W, 3)).astype(np.float32)
    kw = dict(img_w=W, img_h=H, active_sh_degree=2, dup_capacity=DUP)

    def j_out(*a):
        return sr.rasterize(*a, jnp.zeros((48, 2)), jcp, jnp.asarray(bg),
                            chunk=32, block=4, backend="xla", **kw)

    jo = j_out(*map(jnp.asarray, scene))
    leaves = [torch.tensor(a, requires_grad=True) for a in scene]
    to = tsr.rasterize(*leaves, None, tcp, torch.tensor(bg), **kw)
    for name in NAMES:
        np.testing.assert_allclose(getattr(to, name).detach().numpy(),
                                   np.asarray(getattr(jo, name)), **FWD_TOL,
                                   err_msg=name)
    jg = jax.grad(lambda *a: _loss_terms(j_out(*a), jnp.asarray(tgt), jnp.abs),
                  argnums=tuple(range(6)))(*map(jnp.asarray, scene))
    tg = torch.autograd.grad(_loss_terms(to, torch.tensor(tgt), torch.abs), leaves)
    names = ["means", "scales", "quats", "opacity", "shs", "features"]
    for a, b, nm in zip(tg, jg, names):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=5e-4 * np.abs(b).max(),
                                   rtol=0, err_msg=nm)


def test_blend_tiles_cpu_uses_plain_and_cuda_requires_kernel(setup):
    """A CPU tensor takes the plain version; the kernel wrappers refuse
    anything that is not a CUDA tensor instead of falling back."""
    splat, starts, counts = _slab(setup)
    trb.reset_launches()
    out = trb.blend_tiles(splat, starts, counts, 2, 4, 4)
    torch.testing.assert_close(out, trb.blend_tiles_plain(splat, starts,
                                                          counts, 2, 4, 4))
    assert trb.LAUNCHES == {"blend_fwd": 0, "blend_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        trb.blend_fwd_cuda(splat, starts, counts, 2, 4, 4)

