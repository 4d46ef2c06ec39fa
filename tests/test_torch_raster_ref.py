"""The port's brute-force raster oracle (irgs_tpu_torch.ops.surfel_raster_ref)
against the JAX package's on tests/test_raster.py's tiny scene (64 surfels
from jax.random.PRNGKey(0), a 64x64 camera at z = -4, S = 4 features), then
the port's rasterizer against the port's oracle with tests/test_raster.py's
tolerances.

Tolerances: oracle against oracle 1e-5 absolute (the same float32
expressions; the depth moments 1e-4 and the distortion 1e-4 + 1e-4
relative, sums over 64 splats of products of depths near 4);
preprocess_reference against the JAX one 1e-9 (float64 numpy on the same
float32 inputs); rasterize against the oracle exactly the bounds of
tests/test_raster.py (its forward and gradient tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import surfel_raster_ref as jref
from irgs_tpu.scene.cameras import Camera
from irgs_tpu_torch.ops import surfel_raster as tsr
from irgs_tpu_torch.ops import surfel_raster_ref as tref
from irgs_tpu_torch.scene.cameras import Camera as TCamera
from test_torch_mis import one_torch_thread  # noqa: F401

W = H = 64
REF_TOL = {"color": 1e-5, "feature": 1e-5, "alpha": 1e-5, "depth": 1e-4,
           "depth2": 1e-4, "depth_median": 1e-5, "normal": 1e-5,
           "distortion": 1e-4}
NAMES = tuple(REF_TOL)


def make_scene(key, n=64, s=4):
    """tests/test_raster.py's make_scene, as numpy float32 arrays."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    arrs = (jax.random.uniform(k1, (n, 3), minval=-1.0, maxval=1.0),
            jnp.exp(jax.random.uniform(k2, (n, 2), minval=-3.0, maxval=-1.5)),
            jax.random.normal(k3, (n, 4)),
            jax.nn.sigmoid(jax.random.normal(k4, (n, 1)) + 1.0),
            jax.random.normal(k5, (n, 16, 3)) * 0.3,
            jax.random.uniform(k6, (n, s)))
    return tuple(np.asarray(a, np.float32) for a in arrs)


@pytest.fixture(scope="module")
def setup():
    R, T = np.eye(3), np.array([0.0, 0.0, 4.0])
    jcam = Camera(0, R, T, fovx=0.8, fovy=0.8, image=None, width=W, height=H)
    tcam = TCamera(0, R, T, fovx=0.8, fovy=0.8, width=W, height=H)
    return make_scene(jax.random.PRNGKey(0)), jcam.params(), tcam.params("cpu")


BG = np.array([0.1, 0.2, 0.3], np.float32)


def _torch(scene, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in scene]


@pytest.mark.parametrize("deg", [3, 1])
def test_oracle_matches_jax_oracle(setup, deg):
    scene, jcp, tcp = setup
    off = np.zeros((scene[0].shape[0], 2), np.float32)
    kw = dict(img_w=W, img_h=H, active_sh_degree=deg)
    jo = jref.rasterize_reference(*map(jnp.asarray, scene), jcp,
                                  jnp.asarray(BG),
                                  means2d_offset=jnp.asarray(off), **kw)
    to = tref.rasterize_reference(*_torch(scene), tcp, torch.tensor(BG),
                                  means2d_offset=torch.tensor(off), **kw)
    assert float(to.alpha.max()) > 0.3
    for name in NAMES:
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)),
                                   atol=REF_TOL[name],
                                   rtol=1e-4 if name == "distortion" else 0,
                                   err_msg=name)
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))


def test_preprocess_reference_matches_jax(setup):
    scene, jcp, tcp = setup
    means, scales, quats, opac, shs, _ = scene
    jo = jref.preprocess_reference(means, scales, quats, opac, shs, jcp,
                                   W, H, 3, n_boundary=1024)
    to = tref.preprocess_reference(*_torch(scene[:5]), tcp, W, H, 3,
                                   n_boundary=1024)
    for k in ("M", "center", "extent", "depth", "normal", "rgb"):
        np.testing.assert_allclose(to[k], jo[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)


def test_rasterize_matches_oracle(setup):
    """tests/test_raster.py::test_forward_matches_reference on the port."""
    scene, _, tcp = setup
    off = torch.zeros((scene[0].shape[0], 2))
    kw = dict(img_w=W, img_h=H, active_sh_degree=3)
    t = _torch(scene)
    out = tsr.rasterize(*t, off, tcp, torch.tensor(BG), dup_capacity=2 ** 14,
                        **kw)
    ref = tref.rasterize_reference(*t, tcp, torch.tensor(BG),
                                   means2d_offset=off, **kw)
    assert int(out.overflow) == 0
    tol = {"color": dict(atol=2e-5), "feature": dict(atol=2e-5),
           "alpha": dict(atol=2e-5), "depth": dict(atol=1e-4),
           "depth2": dict(atol=5e-4), "depth_median": dict(atol=1e-5),
           "normal": dict(atol=2e-5),
           "distortion": dict(atol=1e-4, rtol=1e-3)}
    for name, kt in tol.items():
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   getattr(ref, name).numpy(), err_msg=name,
                                   **kt)
    assert float(out.alpha.max()) > 0.3
    assert float(ref.depth_median.abs().max()) > 0.1


def test_preprocess_vs_independent_oracle(setup):
    """tests/test_raster.py::test_preprocess_vs_independent_oracle on the
    port's preprocess and oracle."""
    scene, _, tcp = setup
    t = _torch(scene[:5])
    prep = tsr.preprocess(*t, tcp, W, H, 3)
    oracle = tref.preprocess_reference(*t, tcp, W, H, 3)
    valid = prep.valid.numpy()
    assert valid.sum() > 10
    for k, tol in (("M", 2e-4), ("depth", 1e-5), ("normal", 1e-4),
                   ("rgb", 1e-4)):
        np.testing.assert_allclose(getattr(prep, k).numpy()[valid],
                                   oracle[k][valid], rtol=tol, atol=tol,
                                   err_msg=k)
    c_err = np.abs(prep.center.numpy()[valid] - oracle["center"][valid])
    assert c_err.max() < 1.0, f"center err {c_err.max()}"
    ext = oracle["extent"][valid].max(axis=1)
    rad = prep.radius.numpy()[valid]
    assert np.all(rad >= ext - 1e-3)
    assert np.all(rad <= np.ceil(ext) + 1.0)


def _loss(out, tgt):
    return (torch.abs(out.color - tgt).mean() + out.feature.mean()
            + 0.1 * out.distortion.mean() + out.normal.mean()
            + 0.01 * out.depth.mean())


def test_gradients_match_oracle(setup):
    """tests/test_raster.py::test_gradients_match_reference on the port:
    each input's gradient within 2e-4·max|g| + 1e-3 relative."""
    scene, _, tcp = setup
    kw = dict(img_w=W, img_h=H, active_sh_degree=2)
    bg = torch.zeros(3)
    tgt = torch.tensor(np.random.default_rng(7).uniform(
        size=(H, W, 3)).astype(np.float32))
    n = scene[0].shape[0]

    def grads(fn):
        leaves = _torch(scene, grad=True) + [
            torch.zeros((n, 2), requires_grad=True)]
        return torch.autograd.grad(_loss(fn(leaves), tgt), leaves)

    g1 = grads(lambda a: tsr.rasterize(*a[:6], a[6], tcp, bg,
                                       dup_capacity=2 ** 14, **kw))
    g2 = grads(lambda a: tref.rasterize_reference(*a[:6], tcp, bg,
                                                  means2d_offset=a[6], **kw))
    for a, b, nm in zip(g1, g2, ("means", "scales", "quats", "opacity", "shs",
                                 "features", "means2d")):
        scale = max(float(b.abs().max()), 1e-8)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4 * scale,
                                   rtol=1e-3, err_msg=nm)


def test_median_depth_gradient_routing(setup):
    """dL/d(median depth) flows only to the median contributor's depth, in
    the rasterizer as in the oracle (tests/test_raster.py's bound)."""
    scene, _, tcp = setup
    kw = dict(img_w=W, img_h=H, active_sh_degree=1)
    bg = torch.zeros(3)
    off = torch.zeros((scene[0].shape[0], 2))

    def grad(fn):
        t = _torch(scene)
        m = t[0].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(m, t).depth_median.sum(), m)
        return g.numpy()

    g1 = grad(lambda m, t: tsr.rasterize(m, *t[1:], off, tcp, bg,
                                         dup_capacity=2 ** 14, **kw))
    g2 = grad(lambda m, t: tref.rasterize_reference(m, *t[1:], tcp, bg,
                                                    means2d_offset=off, **kw))
    assert np.abs(g2).max() > 1e-6
    scale = max(np.abs(g2).max(), 1e-8)
    np.testing.assert_allclose(g1, g2, atol=2e-4 * scale, rtol=1e-3)
