"""The port's COLMAP reader (irgs_tpu_torch/scene/colmap.py) and
`load_scene` against the JAX package's on fake COLMAP folders: every camera
model, `sparse/0` and `sparse`, JPEG and PNG frames (grey ones too), the
llffhold split, `-r -1` on frames wider than 1600 and fractional and
enlarging `-r`. Then a train_ray stage-2 step on cameras whose principal
point is off centre, the first the port takes from a K matrix, against
JAX: loss, metrics and gradients."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from irgs_tpu.config import Config
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import cameras as jcams
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu.scene import toy
from irgs_tpu.train import stage2 as s2
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import cameras as tcams
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.train import stage2 as ts2
from test_torch_mis import one_torch_thread  # noqa: F401

# one camera per model, its parameters [f..., cx, cy, distortion...]
MODELS = {
    "SIMPLE_PINHOLE": [30.0, 17.5, 11.0],
    "PINHOLE": [30.0, 28.0, 16.5, 13.0],
    "SIMPLE_RADIAL": [31.0, 15.0, 12.5, 0.01],
    "RADIAL": [29.0, 16.5, 11.5, 0.01, -0.02],
    "OPENCV": [30.0, 29.0, 15.5, 12.0, 0.01, 0.0, 0.0, 0.0],
    "OPENCV_FISHEYE": [30.0, 30.5, 16.0, 12.0, 0.01, 0.0, 0.0, 0.0],
    "FULL_OPENCV": [30.0, 31.0, 16.0, 12.5] + [0.0] * 8,
    "FOV": [28.0, 16.0, 12.0, 0.9, 0.0],
    "SIMPLE_RADIAL_FISHEYE": [30.0, 16.0, 12.0, 0.02],
    "RADIAL_FISHEYE": [30.0, 16.5, 12.0, 0.01, 0.01],
    "THIN_PRISM_FISHEYE": [30.0, 30.0, 16.0, 12.0] + [0.0] * 8,
}


def _ring_pose(i, n, rng):
    """World-to-camera (qvec, tvec) of a camera on a ring looking at the
    origin, COLMAP's convention."""
    ang = 2 * np.pi * i / n + 0.1 * rng.standard_normal()
    pos = np.array([3 * np.cos(ang), 0.5 + 0.1 * rng.standard_normal(),
                    3 * np.sin(ang)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.stack([right, down, fwd], -1)
    return tcolmap.rotmat2qvec(c2w.T), -c2w.T @ pos


def _save(path, img):
    if path.endswith(".jpg"):
        Image.fromarray(img).save(path, quality=90)
    else:
        Image.fromarray(img).save(path)


def write_colmap(root, models, size=(32, 24), ext=".jpg", nested=True,
                 grey=False, seed=0):
    """A COLMAP folder: one image per camera model, frames of `size`
    written by PIL, 64 random points."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0") if nested else \
        os.path.join(root, "sparse")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    w, h = size
    cams, imgs = [], []
    for i, model in enumerate(models):
        p = list(MODELS[model])
        cams.append(dict(id=i + 1, model=model, width=w, height=h, params=p))
        q, t = _ring_pose(i, len(models), rng)
        # names out of id order: the reader sorts by name
        name = f"img_{(7 * i) % len(models):03d}{ext}"
        imgs.append(dict(id=i + 1, qvec=q, tvec=t, camera_id=i + 1,
                         name=name))
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([(xx * 255 // max(w - 1, 1)),
                        (yy * 255 // max(h - 1, 1)),
                        rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        _save(os.path.join(root, "images", name), img[..., 0] if grey else img)
    xyz = rng.standard_normal((64, 3))
    rgb = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    tcolmap.write_model(sparse, cams, imgs, xyz, rgb)
    return root


def _assert_cameras_equal(jcs, tcs, exact_images=True):
    assert len(jcs) == len(tcs)
    for jc, tc in zip(jcs, tcs):
        assert (tc.image_name, tc.width, tc.height) == \
            (jc.image_name, jc.width, jc.height)
        assert tc.image_path == jc.image_path
        assert (tc.fovx, tc.fovy) == (jc.fovx, jc.fovy)
        for name in ("R", "T", "K", "full_proj", "w2c", "cam_pos"):
            a, b = getattr(jc, name), getattr(tc, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        assert tc.image.dtype == jc.image.dtype == np.float32
        if exact_images:
            np.testing.assert_array_equal(tc.image, jc.image)
        else:
            np.testing.assert_allclose(tc.image, jc.image, atol=2e-7, rtol=0)
        jp, tp = jc.params(), tc.params("cpu")
        for name in jp._fields:
            np.testing.assert_allclose(np.asarray(getattr(tp, name)),
                                       np.asarray(getattr(jp, name)),
                                       atol=1e-6, rtol=0, err_msg=name)


def _assert_info_equal(j, t, exact_images=True):
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.points.dtype == j.points.dtype
    np.testing.assert_array_equal(t.translate, j.translate)
    assert t.radius == j.radius
    assert t.ply_path == j.ply_path and t.light_rotate == j.light_rotate
    _assert_cameras_equal(j.train_cameras, t.train_cameras, exact_images)
    _assert_cameras_equal(j.test_cameras, t.test_cameras, exact_images)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_camera_model_matches_jax(tmp_path, model):
    root = write_colmap(str(tmp_path / "scene"), [model, model], seed=1)
    sparse = os.path.join(root, "sparse", "0")
    jc = jcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    tc = tcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    assert jc.keys() == tc.keys()
    for k in jc:
        assert (tc[k]["model"], tc[k]["width"], tc[k]["height"]) == \
            (jc[k]["model"], jc[k]["width"], jc[k]["height"]) == (model, 32, 24)
        np.testing.assert_array_equal(tc[k]["params"], jc[k]["params"])
    _assert_info_equal(jcolmap.read_colmap_scene(root),
                       tcolmap.read_colmap_scene(root))


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("nested", [True, False], ids=["sparse0", "sparse"])
@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_load_scene_matches_jax(tmp_path, ext, nested, grey):
    root = write_colmap(str(tmp_path / "scene"), sorted(MODELS), ext=ext,
                        nested=nested, grey=grey, seed=2)
    j = jds.load_scene(root, eval_split=True)
    t = tds.load_scene(root, eval_split=True)
    assert len(t.test_cameras) == 2 and len(t.train_cameras) == 9
    _assert_info_equal(j, t)


def _rewrite_frames(root, kind):
    """Each frame of a COLMAP folder rewritten in another PIL mode, under
    its own name (PIL picks the format from the extension)."""
    folder = os.path.join(root, "images")
    for i, name in enumerate(sorted(os.listdir(folder))):
        path = os.path.join(folder, name)
        rgb = np.asarray(Image.open(path).convert("RGB"))
        h, w = rgb.shape[:2]
        if kind == "grey16":     # samples 0, 1000, 2000, ... and 0..255
            vals = (np.arange(h * w).reshape(h, w) * 1000 + 7 * i) % 65536
            vals[::3] %= 256
            im = Image.fromarray(vals.astype(np.uint16))
        elif kind == "palette":
            im = Image.fromarray(rgb).convert(
                "P", palette=Image.Palette.ADAPTIVE, colors=5)
        elif kind == "bilevel":
            im = Image.fromarray(rgb[..., 0] > 100)
        elif kind == "grey_alpha":
            im = Image.fromarray(rgb).convert("LA")
        elif kind == "rgba":
            im = Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1),
                                 "RGBA")
        elif kind == "cmyk":
            im = Image.fromarray(rgb).convert("CMYK")
        else:                      # progressive
            im = Image.fromarray(rgb)
        im.save(path, progressive=kind == "progressive")


def test_grey16_frames_match_jax(tmp_path):
    """16-bit grey PNG frames: ``convert("RGB")`` clamps PIL's I;16 samples
    at 255, so the frames hold 1.0 wherever a sample exceeds 255; the
    port's frames equal the JAX reader's."""
    root = write_colmap(str(tmp_path / "scene"), ["PINHOLE", "OPENCV"],
                        ext=".png", seed=5)
    _rewrite_frames(root, "grey16")
    j = jcolmap.read_colmap_scene(root)
    t = tcolmap.read_colmap_scene(root)
    _assert_info_equal(j, t)
    img = t.train_cameras[0].image
    assert img.max() == 1.0 and 0.0 < img[img < 1].max() < 1.0
    # the frame as read, before the camera clips it to [0, 1]
    for cam in j.train_cameras + j.test_cameras:
        want = np.asarray(Image.open(cam.image_path).convert("RGB"),
                          np.float32) / 255.0
        got = tcolmap._read_rgb(cam.image_path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["palette", "bilevel", "grey_alpha", "rgba",
                                  "cmyk", "progressive"])
def test_frame_modes_match_jax(tmp_path, kind):
    ext = ".jpg" if kind in ("cmyk", "progressive") else ".png"
    root = write_colmap(str(tmp_path / "scene"), ["PINHOLE", "OPENCV"],
                        ext=ext, seed=6)
    _rewrite_frames(root, kind)
    _assert_info_equal(jcolmap.read_colmap_scene(root),
                       tcolmap.read_colmap_scene(root))


@pytest.mark.parametrize("llffhold", [2, 3, 8])
def test_llffhold_split_matches_jax(tmp_path, llffhold):
    root = write_colmap(str(tmp_path / "scene"), ["PINHOLE"] * 9, seed=3)
    for split in (False, True):
        j = jcolmap.read_colmap_scene(root, eval_split=split,
                                      llffhold=llffhold)
        t = tcolmap.read_colmap_scene(root, eval_split=split,
                                      llffhold=llffhold)
        assert len(t.test_cameras) == (-(-9 // llffhold) if split else 0)
        _assert_info_equal(j, t)


@pytest.mark.parametrize("resolution,size,want", [
    (-1, (1700, 12), (1600, 11)),      # the 1600 cap, a fractional shrink
    (-1, (4946, 6), (1600, 1)),        # Mip-NeRF 360's full frame width
    (20, (32, 24), (20, 15)),          # a target width, fractional
    (2, (32, 24), (16, 12)),           # an integer factor
    (48, (32, 24), (48, 36)),          # enlarging: INTER_LINEAR
], ids=["cap_1700", "cap_4946", "width_20", "r2", "enlarge_48"])
def test_resolution_matches_jax(tmp_path, resolution, size, want):
    root = write_colmap(str(tmp_path / "scene"), ["PINHOLE", "OPENCV"],
                        size=size, seed=4)
    j = jds.load_scene(root, eval_split=False, resolution=resolution)
    t = tds.load_scene(root, eval_split=False, resolution=resolution)
    assert (t.train_cameras[0].width, t.train_cameras[0].height) == want
    _assert_info_equal(j, t, exact_images=want[0] <= size[0])


def test_points3d_tracks_are_skipped(tmp_path):
    """points3D.bin records with tracks (the JAX package's writer in
    tests/test_datasets.py writes none)."""
    path = tmp_path / "points3D.bin"
    rng = np.random.default_rng(5)
    with open(path, "wb") as f:
        f.write(np.uint64(4).tobytes())
        for i in range(4):
            f.write(np.uint64(i).tobytes())
            f.write(rng.standard_normal(3).tobytes())
            f.write(rng.integers(0, 256, 3).astype(np.uint8).tobytes())
            f.write(np.float64(0.25).tobytes())
            f.write(np.uint64(i).tobytes())
            f.write(rng.integers(0, 9, 2 * i).astype("<i4").tobytes())
    jx, jr = jcolmap.read_points3d_bin(str(path))
    tx, tr = tcolmap.read_points3d_bin(str(path))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tr, jr)


# --- a stage-2 step on off-centre K cameras ------------------------------

TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8, max_hits=24,
              hit_budget=16, max_crossings=10, select_tiles=4, tile=32,
              tiled_direct=True, n_segments=4, retrace_frac=0.25)
STEP = 1001  # > normal_loss_start
RES = 64


def _k_camera(mod, i, dx, dy):
    """toy.make_ring_cameras' camera i with K: the same focal length, the
    principal point dx, dy pixels off centre."""
    ring = toy.make_ring_cameras(3, width=RES, height_px=RES)[i]
    f = RES / (2 * np.tan(ring.fovx / 2))
    K = np.array([[f, 0, RES / 2 + dx], [0, f, RES / 2 + dy], [0, 0, 1]],
                 np.float32)
    return mod.Camera(i, ring.R, ring.T, fovx=ring.fovx, fovy=ring.fovy,
                      image=None, width=RES, height=RES, K=K)


@pytest.fixture(scope="module", params=[(7.0, -5.0), (-11.5, 3.25)],
                ids=["7_-5", "-11.5_3.25"])
def k_step(request):
    dx, dy = request.param
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    cfg = Config()
    cfg.pipe.diffuse_sample_num = 8
    cfg.opt.trace_num_rays = 8 * 128
    jst = dataclasses.replace(s2.from_configs(cfg, img_w=RES, img_h=RES),
                              dup_capacity=2 ** 14, raster_backend="pallas",
                              tracer=gt.TracerConfig(**TRACER))
    tst = dataclasses.replace(ts2.from_configs(cfg, img_w=RES, img_h=RES),
                              dup_capacity=2 ** 14,
                              tracer=tgt.TracerConfig(**TRACER))
    jcam = _k_camera(jcams, 0, dx, dy)
    tcam = _k_camera(tcams, 0, dx, dy)
    gt_img = np.full((RES, RES, 3), 0.4, np.float32)
    gt_img[:, RES // 2:] = 0.6
    k_sel, k_shade = jax.random.split(jax.random.PRNGKey(0))
    draws = ts2.Stage2Draws(
        pixel_u=torch.tensor(np.asarray(
            jax.random.uniform(k_sel, (RES * RES,)))),
        theta_u=torch.tensor(np.asarray(
            jax.random.uniform(k_shade, (128, 1)))))

    from irgs_tpu.ops import raster_pallas as rp
    old, rp.INTERPRET = rp.INTERPRET, True
    try:
        jgrid = gt.build_grid_from_gaussians(jp, ja, jst.tracer)
        jstate, _ = s2.init_state(jp, ja, cfg.opt)
        jstate = jstate._replace(step=jnp.int32(STEP))

        def loss_fn(p):
            return s2.stage2_forward_loss(p, ja, jgrid, jcam.params(),
                                          jnp.asarray(gt_img), None,
                                          jax.random.PRNGKey(0), jstate.step,
                                          jst)

        (_, jm), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    finally:
        rp.INTERPRET = old

    fields = {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS}
    tp, ta = tgs.params_from_numpy(fields, np.asarray(ja.alive), "cpu")
    tgrid = tgt.build_grid_from_gaussians(tp, ta, tst.tracer)
    tstate = ts2.init_state(tp, ta, cfg.opt)
    tstate.step = STEP
    tstate, tm = ts2.stage2_step(tstate, tgrid, tcam.params("cpu"),
                                 torch.tensor(gt_img), None, draws, st=tst)
    return dict(jm=jm, jgrads=jgrads, tm=tm, tparams=tstate.params,
                jcam=jcam, tcam=tcam)


def test_k_camera_params_match_jax(k_step):
    jp, tp = k_step["jcam"].params(), k_step["tcam"].params("cpu")
    assert float(tp.cx) != RES / 2 and float(tp.cy) != RES / 2
    for name in jp._fields:
        np.testing.assert_allclose(np.asarray(getattr(tp, name)),
                                   np.asarray(getattr(jp, name)), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_k_step_loss_and_metrics_match_jax(k_step):
    jm, tm = k_step["jm"], k_step["tm"]
    assert float(jm["loss_normal"]) > 0.0
    for k in ("loss", "loss_l1", "loss_sh", "loss_normal", "ray_psnr",
              "raster_overflow", "grid_overflow", "grid_oversize"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("field", tgs.PARAM_FIELDS)
def test_k_step_gradients_match_jax(k_step, field):
    jg = np.asarray(getattr(k_step["jgrads"], field))
    tg = getattr(k_step["tparams"], field).grad
    if tg is None:   # no path from the loss: JAX reports zeros
        tg = torch.zeros(jg.shape)
    scale = max(np.abs(jg).max(), 1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * scale, rtol=0,
                               err_msg=field)
