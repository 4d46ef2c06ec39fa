"""The port's TSDF fusion and SDF ray marching (ops/tsdf.py) against the
JAX package's (mirrors tests/test_tsdf.py:24): a unit sphere's analytic
depth maps from 8 ring views fused into a 48³ volume, then 4096 rays
marched through it.

`integrate` within atol 1e-5, except for voxels whose projection lands
within rounding of a pixel edge: the projection (a 3x3 product, a division,
a multiply-add) rounds apart between XLA and torch, and truncation to the
pixel index then reads the neighbouring pixel's depth; at most 0.1 % of the
voxels. `ray_march_visibility`, on the same (JAX's) volume, gives the same
`visible` except for marginal crossings, where a sample within rounding of
the zero level flips the sign test: at most 0.5 % of the rays; the hit
depths of the rays that agree within 1e-4. The sphere itself: rays towards
it are blocked at t ≈ 1, rays away are free.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import tsdf as jtsdf
from irgs_tpu.scene.toy import make_ring_cameras
from irgs_tpu_torch.ops import tsdf as ttsdf
from irgs_tpu_torch.scene.toy import make_ring_cameras as t_ring_cameras

RES = 48
MAX_FLIP_SHARE = 0.005
MAX_EDGE_VOXEL_SHARE = 0.001


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_depth(cam, radius=1.0):
    """Analytic camera-space z of a sphere at the origin (0 = miss)."""
    cp = cam.params()
    rays = np.asarray(cp.ray_dirs(cam.width, cam.height))
    o = np.asarray(cp.cam_pos)
    b = np.sum(rays * o, -1)
    disc = b * b - (np.sum(o * o) - radius ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0))
    z = t * np.asarray(rays @ np.asarray(cp.w2c)[:3, :3].T)[..., 2]
    return np.where((disc > 0) & (t > 0), z, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def volumes():
    jcams = make_ring_cameras(8, radius=3.0, height=0.5, width=64,
                              height_px=64)
    tcams = t_ring_cameras(8, radius=3.0, height=0.5, width=64, height_px=64)
    jvol = jtsdf.init_volume(np.array([-1.4] * 3), np.array([1.4] * 3),
                             res=RES)
    tvol = ttsdf.init_volume(np.array([-1.4] * 3), np.array([1.4] * 3),
                             res=RES)
    for jc, tc in zip(jcams, tcams):
        depth = sphere_depth(jc)
        jp, tp = jc.params(), tc.params("cpu")
        kw = dict(sdf_trunc=0.12, depth_trunc=8.0)
        jvol = jtsdf.integrate(jvol, jnp.asarray(depth), None,
                               jnp.asarray(jc.w2c), jp.fx, jp.fy,
                               jc.width / 2 - 0.5, jc.height / 2 - 0.5, **kw)
        tvol = ttsdf.integrate(tvol, torch.tensor(depth), tp.w2c, tp.fx,
                               tp.fy, tc.width / 2 - 0.5,
                               tc.height / 2 - 0.5, **kw)
    return jvol, tvol


def test_integrate_matches_jax(volumes):
    jvol, tvol = volumes
    for name in ("origin", "voxel"):
        np.testing.assert_allclose(getattr(tvol, name).numpy(),
                                   np.asarray(getattr(jvol, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    # the weight counts the views that saw the voxel: a pixel-edge flip
    # can also move a voxel across a silhouette
    for name in ("tsdf", "weight"):
        off = np.abs(getattr(tvol, name).numpy()
                     - np.asarray(getattr(jvol, name))) > 1e-5
        assert float(off.mean()) <= MAX_EDGE_VOXEL_SHARE, (name, off.mean())
    assert float(tvol.weight.max()) == float(jvol.weight.max()) > 1.0
    assert float(tvol.tsdf.min()) < 0.0 < float(tvol.tsdf.max())


def test_ray_march_visibility_matches_jax(volumes):
    jvol, _ = volumes
    tvol = ttsdf.TSDFVolume(*(torch.tensor(np.asarray(x)) for x in jvol))
    rng = np.random.default_rng(0)
    o = rng.uniform(-1.6, 1.6, (4096, 3)).astype(np.float32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jd, jv = jtsdf.ray_march_visibility(jvol, jnp.asarray(o), jnp.asarray(d))
    td, tv = ttsdf.ray_march_visibility(tvol, torch.tensor(o),
                                        torch.tensor(d))
    jv, jd = np.asarray(jv), np.asarray(jd)
    tv, td = tv.numpy(), td.numpy()
    flips = float((tv != jv).mean())
    assert flips <= MAX_FLIP_SHARE, flips
    assert 0.1 < float(jv.mean()) < 0.9        # both outcomes occur
    same = tv == jv
    np.testing.assert_allclose(td[same], jd[same], atol=1e-4, rtol=0)


def test_ray_march_sees_the_sphere(volumes):
    _, tvol = volumes
    o = torch.tensor([[0.0, 0.0, -2.0]] * 2)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    depth, visible = ttsdf.ray_march_visibility(tvol, o, d)
    assert not bool(visible[0]) and bool(visible[1])
    assert abs(float(depth[0]) - 1.0) < 0.1
