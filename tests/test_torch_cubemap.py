"""Every function of the port's scene/cubemap.py against the JAX package's
irgs_tpu/scene/cubemap.py, at small resolutions, on inputs from numpy seeds.

Tolerances: lookups, resampling and the mip box filter rtol 1e-5 / atol
1e-6 (the same float32 expressions); the prefilters (diffuse: a product
over all source texels; specular: sums over Hammersley samples) and the FG
table (means over 64 samples) rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.scene import cubemap as jcm
from irgs_tpu_torch.scene import cubemap as tcm
from test_torch_mis import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=1e-4, atol=1e-5)


def _dirs(seed, n):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _cube(seed, res, c=3):
    return np.random.default_rng(seed).uniform(
        0.0, 2.0, (6, res, res, c)).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


# The specular prefilter fetches each Hammersley direction with the clamped
# bilinear lookup, whose face choice and texel are discrete: a direction an
# ulp from a face seam or texel edge (XLA's and torch's products round it
# differently) fetches another texel. Such an element is an outlier; at most
# 1 % of the elements may be one, each within 4 x (the cube's value range)
# / samples (one sample's share of the NdotL-weighted mean).
MAX_OUTLIER_SHARE = 0.01


def _check_flips(got, want, value_range, samples, tol=SUM_TOL):
    got, want = _np(got), np.asarray(want)
    d = np.abs(got - want)
    bad = d > tol["atol"] + tol["rtol"] * np.abs(want)
    assert bad.mean() <= MAX_OUTLIER_SHARE, bad.mean()
    assert d.max() <= 4.0 * value_range / samples, d.max()


@pytest.mark.parametrize("res", [1, 4, 7])
def test_face_dirs_and_solid_angles(res):
    _check(tcm._face_dirs(res), jcm._face_dirs(res))
    _check(tcm._texel_solid_angles(res), jcm._texel_solid_angles(res))


def test_dir_to_cube_uv():
    d = _dirs(0, 2000)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]]
    tf, tu, tv = tcm.dir_to_cube_uv(torch.tensor(d))
    jf, ju, jv = jcm.dir_to_cube_uv(jnp.asarray(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _check(tu, ju)
    _check(tv, jv)


def test_uv_to_dir():
    rng = np.random.default_rng(1)
    face = rng.integers(0, 6, 500)
    u, v = (rng.uniform(-1.3, 1.3, 500).astype(np.float32) for _ in range(2))
    _check(tcm._uv_to_dir(torch.tensor(face), torch.tensor(u), torch.tensor(v)),
           jcm._uv_to_dir(jnp.asarray(face), jnp.asarray(u), jnp.asarray(v)))


@pytest.mark.parametrize("fn", ["sample_cubemap", "sample_cubemap_smooth"])
def test_cube_fetches(fn):
    cube, d = _cube(2, 8), _dirs(3, 3000).reshape(30, 100, 3)
    _check(getattr(tcm, fn)(torch.tensor(cube), torch.tensor(d)),
           getattr(jcm, fn)(jnp.asarray(cube), jnp.asarray(d)))


def test_seam_blend_and_mip():
    cube = _cube(4, 8)
    _check(tcm.seam_blend(torch.tensor(cube)), jcm.seam_blend(jnp.asarray(cube)))
    _check(tcm.cubemap_mip(torch.tensor(cube)), jcm.cubemap_mip(jnp.asarray(cube)))


@pytest.mark.parametrize("smooth", [False, True])
def test_sample_cubemap_mip(smooth):
    mips = [_cube(5 + i, r) for i, r in enumerate((16, 8, 4))]
    d = _dirs(8, 1000)
    lvl = np.random.default_rng(9).uniform(-0.5, 2.5, 1000).astype(np.float32)
    _check(tcm.sample_cubemap_mip([torch.tensor(m) for m in mips],
                                  torch.tensor(d), torch.tensor(lvl), smooth),
           jcm.sample_cubemap_mip([jnp.asarray(m) for m in mips],
                                  jnp.asarray(d), jnp.asarray(lvl), smooth))


def test_latlong_cube_round_trip():
    ll = np.random.default_rng(10).uniform(0, 3, (8, 16, 3)).astype(np.float32)
    _check(tcm.latlong_to_cubemap(torch.tensor(ll), 8),
           jcm.latlong_to_cubemap(jnp.asarray(ll), 8))
    cube = _cube(11, 8)
    _check(tcm.cubemap_to_latlong(torch.tensor(cube), 8, 16),
           jcm.cubemap_to_latlong(jnp.asarray(cube), 8, 16))


@pytest.mark.parametrize("out_res", [None, 4])
def test_diffuse_cubemap(out_res):
    cube = _cube(12, 8)
    _check(tcm.diffuse_cubemap(torch.tensor(cube), out_res),
           jcm.diffuse_cubemap(jnp.asarray(cube), out_res), SUM_TOL)


@pytest.mark.parametrize("n", [16, 100, 4096])
def test_hammersley(n):
    a, b = tcm._hammersley(n)
    ja, jb = jcm._hammersley(n)
    _check(a, ja)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("roughness,samples", [(0.08, 16), (0.5, 64),
                                               (1.0, 32)])
def test_specular_cubemap(roughness, samples):
    """At res 48 the 13,824 texels span four 4096-texel chunks."""
    cube = _cube(13, 48)
    _check_flips(tcm.specular_cubemap(torch.tensor(cube), roughness,
                                      samples=samples),
                 jcm.specular_cubemap(jnp.asarray(cube), roughness,
                                      samples=samples),
                 float(cube.max() - cube.min()), samples)


def test_build_specular_mips():
    ll = np.exp(np.random.default_rng(14).normal(0, 1, (16, 32, 3))
                ).astype(np.float32)
    base_t = tcm.latlong_to_cubemap(torch.tensor(ll), 32)
    base_j = jcm.latlong_to_cubemap(jnp.asarray(ll), 32)
    spec_t, diff_t = tcm.build_specular_mips(base_t, min_res=8)
    spec_j, diff_j = jcm.build_specular_mips(base_j, min_res=8)
    assert [tuple(s.shape) for s in spec_t] == [s.shape for s in spec_j] \
        == [(6, 32, 32, 3), (6, 16, 16, 3), (6, 8, 8, 3)]
    rng_ = float(base_j.max() - base_j.min())
    for s_t, s_j in zip(spec_t, spec_j):       # 16 samples at the least
        _check_flips(s_t, s_j, rng_, 16)
    _check(diff_t, diff_j, SUM_TOL)


def test_roughness_to_mip():
    r = np.linspace(-0.1, 1.1, 301).astype(np.float32)
    _check(tcm.roughness_to_mip(torch.tensor(r), 5),
           jcm.roughness_to_mip(jnp.asarray(r), 5))


def test_fg_lut():
    """compute_fg_lut(16, 64), and bilinear lookups into it."""
    want = jcm.compute_fg_lut(16, 64)
    got = tcm.compute_fg_lut(16, 64)
    _check(got, want, SUM_TOL)
    rng = np.random.default_rng(15)
    nv = rng.uniform(-0.1, 1.1, (200, 1)).astype(np.float32)
    ro = rng.uniform(-0.1, 1.1, (200, 1)).astype(np.float32)
    _check(tcm.sample_fg_lut(torch.tensor(np.asarray(want)), torch.tensor(nv),
                             torch.tensor(ro)),
           jcm.sample_fg_lut(want, jnp.asarray(nv), jnp.asarray(ro)))


def test_fg_lut_in_row_chunks():
    """At 64 x 2048 the port builds the table 32 roughness rows a call."""
    _check(tcm.compute_fg_lut(64, 2048), jcm.compute_fg_lut(64, 2048), SUM_TOL)
