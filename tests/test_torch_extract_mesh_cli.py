"""The port's mesh CLI (`python -m irgs_tpu_torch.extract_mesh`, run
in-process through `main(argv)`) on the CPU (mirrors extract_mesh.py).

On a stage-1 checkpoint written directly (init_ref_from_pcd of 2000 points
on the unit sphere, opacities raised to 0.95 so that its surface is opaque)
with a Blender folder of 4 ring views at 32x32, bounded and unbounded at
--mesh_res 32: fuse.ply and fuse_post.ply read back, and their meshes are
the JAX package's (its reconstruct_tsdf, render_initial and mesh functions
on the same parameters and views): the same triangles, in the same order,
at the same places within 2e-5 (the two packages' rasters round the depths
apart by a few ulps, which the fusion carries into the vertices; the
6-decimal weld can then split a vertex where the other welds it, so the
meshes are held as triangles, not as indexed vertex lists). The --toy run,
bounded and unbounded at --mesh_res 24, meshes the unit sphere (the
bounded one within two of its coarse voxels). Without a
card and without --device cpu the CLI raises.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import tsdf as J
from irgs_tpu.render import ref_gaussian as jrg
from irgs_tpu.scene import gaussians as jgs
from irgs_tpu.scene import ref_gaussians as jrgs
from irgs_tpu.scene.datasets import load_scene as j_load_scene
from irgs_tpu.train import stage1_full as js1
from irgs_tpu_torch.config import stage1_config
from irgs_tpu_torch.extract_mesh.__main__ import main
from irgs_tpu_torch.scene import ref_gaussians as trgs
from irgs_tpu_torch.scene import toy as ttoy
from irgs_tpu_torch.train import stage1_full as ts1
from irgs_tpu_torch.utils import ply, png
from test_torch_mis import one_torch_thread  # noqa: F401

RES, MESH_RES, DUP = 32, 32, 2 ** 14
TRI_ATOL = 2e-5


def write_blender(root, n=4, res=RES):
    """A Blender folder of `n` white ring views at res x res."""
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for i, cam in enumerate(ttoy.make_ring_cameras(n, width=res,
                                                   height_px=res)):
        png.write_png(os.path.join(root, "train", f"r_{i}.png"),
                      np.full((res, res, 4), 255, np.uint8))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = cam.R, cam.cam_pos
        c2w[:3, 1:3] *= -1                  # COLMAP -> Blender axes
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": cam.fovx, "frames": frames}, f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_cli")
    scene, run = str(base / "scene"), str(base / "run")
    write_blender(scene)
    cfg = stage1_config()
    cfg.model.source_path, cfg.model.model_path = scene, run
    cfg.pipe.dup_capacity = DUP
    cfg.save()
    pts = np.random.RandomState(0).normal(size=(2000, 3))
    pts = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(
        np.float32)
    params, aux = trgs.init_ref_from_pcd(pts, np.full_like(pts, 0.5), 2048, 3,
                                         env_res=16, device="cpu")
    with torch.no_grad():
        params.opacity.fill_(float(np.log(0.95 / 0.05)))
    state = ts1.init_state(params, aux, cfg.opt)
    ts1.save_stage1_checkpoint(os.path.join(run, "chkpnt10.ckpt"), state, 10)
    return scene, run, params, aux


def _read(path):
    el = ply.read_ply(path)
    v = np.stack([el["vertex"].data[k] for k in "xyz"], -1)
    f = np.asarray(el["face"].lists["vertex_indices"])
    return v, f


def _jax_meshes(scene, params, aux, unbounded):
    """The JAX package's mesh of the same parameters and views, welded and
    post-processed as extract_mesh.py does."""
    jp = jrgs.RefGaussianParams(**{
        f: jnp.asarray(getattr(params, f).detach().numpy())
        for f in params.FIELDS})
    n = jp.n_capacity
    ja = jgs.GaussianAux(alive=jnp.asarray(aux.alive.numpy()),
                         max_radii2d=jnp.zeros(n),
                         xyz_gradient_accum=jnp.zeros(n),
                         denom=jnp.zeros(n), active_sh_degree=jnp.int32(3))
    info = j_load_scene(scene, False, eval_split=False)
    cams = info.train_cameras
    if unbounded:
        render = jax.jit(functools.partial(
            jrg.render_initial, img_w=RES, img_h=RES, active_sh_degree=3,
            dup_capacity=DUP))
        depths = []
        for cam in cams:
            pkg = render(jp, ja, cam.params(), jnp.zeros(3))
            depths.append(pkg["surf_depth"] * (pkg["alpha"][..., 0] > 0.5))
        centers = np.stack([c.cam_pos for c in cams])
        center = centers.mean(0)
        radius = float(np.linalg.norm(centers - center, axis=-1).min())
        verts, faces = J.extract_mesh_unbounded(
            jnp.stack(depths), jnp.stack([jnp.asarray(c.full_proj)
                                          for c in cams]),
            np.asarray(jp.xyz)[np.asarray(ja.alive)], center, radius,
            resolution=MESH_RES)
    else:
        vol = js1.reconstruct_tsdf(
            jp, ja, cams, img_w=RES, img_h=RES, active_sh_degree=3,
            mesh_res=MESH_RES, depth_trunc=info.radius * 2.0,
            cameras_extent=info.radius, dup_capacity=DUP)
        verts, faces = J.extract_mesh(vol)
    return {"fuse": J.merge_vertices(verts, faces),
            "fuse_post": J.post_process_mesh(verts, faces,
                                             cluster_to_keep=50)}


@pytest.mark.parametrize("unbounded", [False, True],
                         ids=["bounded", "unbounded"])
def test_cli_on_a_stage1_checkpoint_matches_jax(run, tmp_path, unbounded):
    scene, run_dir, params, aux = run
    out = str(tmp_path / "out")
    os.makedirs(out)
    for name in ("cfg.json", "chkpnt10.ckpt", "chkpnt10.ckpt.json"):
        with open(os.path.join(run_dir, name), "rb") as f, \
                open(os.path.join(out, name), "wb") as g:
            g.write(f.read())
    # the bounded run names its checkpoint, the unbounded one takes the
    # latest
    main(["-m", out, "--mesh_res", str(MESH_RES), "--device", "cpu",
          *(["--unbounded"] if unbounded else ["--iteration", "10"])])
    want = _jax_meshes(scene, params, aux, unbounded)
    for name in ("fuse", "fuse_post"):
        v, f = _read(os.path.join(out, "mesh", f"{name}.ply"))
        jv, jf = want[name]
        assert len(jf) > 500, (name, len(jf))
        assert f.shape == jf.shape, name
        np.testing.assert_allclose(v[f], jv[jf], atol=TRI_ATOL, rtol=0,
                                   err_msg=name)
        assert abs(len(v) - len(jv)) <= 0.01 * len(jv), name


@pytest.mark.parametrize("unbounded", [False, True],
                         ids=["bounded", "unbounded"])
def test_cli_toy_meshes_the_unit_sphere(tmp_path, unbounded):
    out = str(tmp_path / "toy")
    main(["--toy", "-m", out, "--mesh_res", "24", "--device", "cpu",
          *(["--unbounded"] if unbounded else [])])
    v, f = _read(os.path.join(out, "mesh", "fuse.ply"))
    pv, pf = _read(os.path.join(out, "mesh", "fuse_post.ply"))
    assert len(pf) > 500 and len(pf) <= len(f)
    assert f.max() < len(v) and pf.max() < len(pv)
    r = np.median(np.linalg.norm(pv, axis=-1))
    if unbounded:
        assert abs(r - 1.0) < 0.05, r
    else:
        # the bounded grid's voxel is depth_trunc / mesh_res = 6.6 / 24:
        # at that size the fused surface sits outside the sphere by less
        # than two voxels (1.03 at --mesh_res 64)
        assert 1.0 < r < 1.0 + 2 * 6.6 / 24, r


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--toy", "-m", str(tmp_path / "x")])
