"""The port's mesh extraction (ops/tsdf.py: marching tetrahedra, the weld,
the floater clean-up, the contracted unbounded path) against the JAX
package's, on the same numpy inputs (mirrors tests/test_mesh.py and
tests/test_tsdf.py:24).

Marching tetrahedra gives the same triangles in the same order, vertices
within 1e-6 (the corner positions in float64, the edge weights in float32,
as the reference's numpy); the weld and the clean-up give identical meshes;
the unbounded fusion agrees within 1e-6 and its mesh has the same
triangles, vertices within 1e-5. The SDF ray march agrees with the
Möller–Trumbore oracle on the extracted sphere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import tsdf as J
from irgs_tpu.scene import toy
from irgs_tpu_torch.ops import tsdf as T
from test_mesh import sphere_volume
from test_torch_mis import one_torch_thread  # noqa: F401
from test_tsdf import make_sphere_depth


def _port(vol):
    return T.TSDFVolume(*(torch.tensor(np.asarray(x)) for x in vol))


@pytest.fixture(scope="module")
def fused_sphere():
    """A unit sphere's analytic depth maps from 12 ring views fused into a
    64³ volume by the JAX package (test_tsdf.py:24, at 64³)."""
    cams = toy.make_ring_cameras(12, radius=3.0, height=0.5, width=96,
                                 height_px=96)
    vol = J.init_volume(np.array([-1.4] * 3), np.array([1.4] * 3), res=64)
    for cam in cams:
        cp = cam.params()
        vol = J.integrate(vol, jnp.asarray(make_sphere_depth(cam)), None,
                          jnp.asarray(cam.w2c), cp.fx, cp.fy,
                          cam.width / 2 - 0.5, cam.height / 2 - 0.5,
                          sdf_trunc=0.12, depth_trunc=8.0)
    return vol


VOLUMES = {
    "sphere_48": lambda fused: sphere_volume(res=48, r=0.6),
    "sphere_64_floater": lambda fused: sphere_volume(
        res=64, r=0.55, blob=([0.85, 0.85, 0.85], 0.05)),
    "fused_64": lambda fused: fused,
}


@pytest.fixture(scope="module")
def meshes(fused_sphere):
    out = {}
    for name, make in VOLUMES.items():
        vol = make(fused_sphere)
        out[name] = (vol, J.extract_mesh(vol), T.extract_mesh(_port(vol)))
    return out


@pytest.mark.parametrize("name", VOLUMES)
def test_extract_mesh_matches_jax(meshes, name):
    _, (jv, jf), (tv, tf) = meshes[name]
    assert len(jf) > 1000
    assert tv.dtype == torch.float32 and tf.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), jf)        # count and order
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", VOLUMES)
def test_weld_and_cleanup_match_jax(meshes, name):
    _, (jv, jf), (tv, tf) = meshes[name]
    for fn, kw in ((J.merge_vertices, {}), (J.post_process_mesh,
                                            {"cluster_to_keep": 1})):
        want = fn(jv, jf, **kw)
        got = getattr(T, fn.__name__)(tv, tf, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_cleanup_drops_the_floater(meshes):
    _, _, (tv, tf) = meshes["sphere_64_floater"]
    assert float(tv.norm(dim=-1).max()) > 1.0
    pv, pf = T.post_process_mesh(tv, tf, cluster_to_keep=1)
    assert len(pf) > 100 and np.linalg.norm(pv, axis=-1).max() < 0.7
    assert len(pv) < 0.8 * 3 * len(pf)


def test_fused_sphere_mesh_is_the_unit_sphere(meshes):
    _, _, (tv, _) = meshes["fused_64"]
    r = tv.norm(dim=-1).numpy()
    assert abs(np.median(r) - 1.0) < 0.05
    assert (np.abs(r - 1.0) < 0.15).mean() > 0.95


def test_contract_uncontract_match_jax():
    x = np.random.RandomState(0).uniform(-3, 3, (256, 3)).astype(np.float32)
    for fn, arg in ((("contract"), x), ("uncontract", x / 3.0)):
        np.testing.assert_allclose(
            getattr(T, fn)(torch.tensor(arg)).numpy(),
            np.asarray(getattr(J, fn)(jnp.asarray(arg))), atol=1e-6, rtol=0)
    y = T.contract(torch.tensor(x))
    assert float(y.norm(dim=-1).max()) < 2.0
    np.testing.assert_allclose(T.uncontract(y).numpy(), x, rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def unbounded_scene():
    """tests/test_mesh.py:95's analytic sphere (r 0.6): 12 ring views at
    96², z-depth maps, the camera ring's bounding sphere, 512 centres on
    the surface."""
    r = 0.6
    depths, projs, centers = [], [], []
    for cam in toy.make_ring_cameras(12, radius=3.0, height=0.5, width=96,
                                     height_px=96):
        cp = cam.params()
        dirs = np.asarray(cp.ray_dirs(96, 96, normalize=True))
        o = np.asarray(cp.cam_pos)
        b = dirs @ o
        disc = b ** 2 - (o @ o - r ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0))
        z = t * (dirs @ np.asarray(cam.w2c[2, :3]))
        depths.append(np.where(disc > 0, z, 0.0).astype(np.float32))
        projs.append(np.asarray(cam.full_proj, np.float32))
        centers.append(o)
    centers = np.stack(centers)
    center = centers.mean(0)
    radius = float(np.linalg.norm(centers - center, axis=-1).min())
    xyz = np.random.RandomState(0).normal(size=(512, 3)).astype(np.float32)
    xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True) * r
    return np.stack(depths), np.stack(projs), xyz, center, radius, r


def test_fuse_unbounded_tsdf_matches_jax(unbounded_scene):
    depths, projs, _, center, radius, _ = unbounded_scene
    # a 32³ contracted grid around the sphere (contracted radius 0.2):
    # seen in front of it, behind it and unseen
    ax = np.linspace(-0.35, 0.35, 32, dtype=np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    jt, jw = jax.jit(J.fuse_unbounded_tsdf)(
        jnp.asarray(pts), jnp.asarray(depths), jnp.asarray(projs),
        jnp.asarray(center, jnp.float32), jnp.float32(radius),
        jnp.float32(2.0 / 64))
    tt, tw = T.fuse_unbounded_tsdf(torch.tensor(pts), torch.tensor(depths),
                                   torch.tensor(projs), center, radius,
                                   2.0 / 64)
    assert 0.1 < float((np.asarray(jw) > 1).mean()) < 0.9
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)


def test_extract_mesh_unbounded_matches_jax(unbounded_scene, monkeypatch):
    depths, projs, xyz, center, radius, r = unbounded_scene
    # fused two z slabs a call, as the reference fuses one
    monkeypatch.setattr(T, "SLAB_POINTS", 2 * 48 * 48)
    jv, jf = J.extract_mesh_unbounded(jnp.asarray(depths), jnp.asarray(projs),
                                      xyz, center, radius, resolution=48)
    tv, tf = T.extract_mesh_unbounded(torch.tensor(depths),
                                      torch.tensor(projs), xyz, center,
                                      radius, resolution=48)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5, rtol=0)
    pv, _ = T.post_process_mesh(tv, tf, cluster_to_keep=1)
    rad = np.linalg.norm(pv, axis=-1)
    assert abs(np.median(rad) - r) < 0.05, np.median(rad)


def test_ray_march_matches_triangle_oracle(meshes):
    vol, _, (tv, tf) = meshes["sphere_48"]
    verts, faces = T.merge_vertices(tv, tf)
    rng = np.random.RandomState(1)
    dirs = rng.normal(size=(24, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_o = np.concatenate([-2.0 * dirs, [[2.0, 2.0, 0.0]] * 4])
    rays_d = np.concatenate([dirs, [[0, 0, 1.0], [0, 0, -1], [0, 1, 0],
                                    [1, 0, 0.0]]])
    rays_o, rays_d = rays_o.astype(np.float32), rays_d.astype(np.float32)
    t_oracle = T.ray_triangle_intersect(rays_o, rays_d, verts, faces)
    np.testing.assert_array_equal(
        t_oracle, J.ray_triangle_intersect(rays_o, rays_d, verts, faces))
    depth, visible = T.ray_march_visibility(
        _port(vol), torch.tensor(rays_o), torch.tensor(rays_d), t_max=10.0,
        max_steps=512, t_min=0.05)
    hit = np.isfinite(t_oracle)
    assert 0 < hit.sum() < len(hit)
    np.testing.assert_array_equal(~visible.numpy(), hit)
    err = np.abs(depth.numpy()[hit] - t_oracle[hit])
    assert err.max() < 1.5 * float(vol.voxel)
