"""The port's dataset readers (irgs_tpu_torch.scene.datasets) against the JAX
package's, on folders written here: a 4-view 32x32 Blender scene (RGBA PNG
frames through PIL, points3d.ply), a Synthetic4Relight scene (EXR train and
PNG test frames), a TensoIR one, and Stanford-ORB scenes (PNG or EXR frames,
grey 8- and 16-bit, RGB and EXR masks or none, resized by cv2's INTER_AREA
to the benchmark size)."""

import json
import os

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from irgs_tpu.scene import datasets as jds
from irgs_tpu.utils import exr as jexr
from irgs_tpu.utils import ply as jply
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils.image import UnreadableImageError

RES, N_VIEWS = 32, 4


def _c2w(i, rng):
    """A camera-to-world matrix in the Blender convention (y up, z back),
    looking roughly at the origin from a ring."""
    ang = 2 * np.pi * i / N_VIEWS + 0.3 * rng.standard_normal()
    pos = np.array([3 * np.cos(ang), 0.8 + 0.2 * rng.standard_normal(),
                    3 * np.sin(ang)])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    m = np.eye(4)
    m[:3, :3] = np.stack([right, up, back], -1)
    m[:3, 3] = pos
    return m


def _write_frames(root, split, frames, ext, rng):
    os.makedirs(os.path.join(root, split), exist_ok=True)
    yy, xx = np.mgrid[:RES, :RES]
    alpha = np.clip(1.5 - np.hypot(xx - 15.5, yy - 15.5) / 8, 0, 1)
    for fr in frames:
        path = os.path.join(root, fr["file_path"] + ext)
        rgb = rng.uniform(size=(RES, RES, 3))
        if ext.endswith(".exr"):
            jexr.write_exr(path, (4 * rgb).astype(np.float32))
        else:
            rgba = np.concatenate([rgb, alpha[..., None]], -1)
            Image.fromarray((rgba * 255).round().astype(np.uint8)).save(path)


def _write_scene(root, train_ext, test_ext, seed=0, points=True):
    rng = np.random.default_rng(seed)
    for split, n, ext in (("train", N_VIEWS, train_ext), ("test", 2, test_ext)):
        frames = [{"file_path": f"./{split}/r_{i}",
                   "transform_matrix": _c2w(i, rng).tolist()} for i in range(n)]
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
        _write_frames(root, split, frames, ext, rng)
    if points:
        v = np.zeros(50, [("x", "f4"), ("y", "f4"), ("z", "f4"),
                          ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        for k in ("x", "y", "z"):
            v[k] = rng.standard_normal(50)
        for k in ("red", "green", "blue"):
            v[k] = rng.integers(0, 256, 50)
        jply.write_ply(os.path.join(root, "points3d.ply"), v)
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")

    def mk(*parts):
        path = base.joinpath(*parts)
        path.mkdir(parents=True)
        return str(path)

    return {
        "blender": _write_scene(mk("nerf_synthetic", "lego"), ".png", ".png"),
        "s4r": _write_scene(mk("Synthetic4Relight", "hotdog"), "_rgb.exr",
                            "_rgba.png", seed=1),
        "tensoir": _write_scene(mk("TensoIR", "armadillo"), ".png", ".png",
                                seed=2, points=False),
    }


def _assert_scene_equal(j, t):
    assert t.light_rotate == j.light_rotate
    assert t.radius == j.radius
    np.testing.assert_array_equal(t.translate, j.translate)
    for name in ("points", "colors"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    assert len(t.train_cameras) == len(j.train_cameras)
    assert len(t.test_cameras) == len(j.test_cameras)
    for jc, tc in zip(j.train_cameras + j.test_cameras,
                      t.train_cameras + t.test_cameras):
        for name in ("R", "T", "image", "full_proj", "w2c", "cam_pos"):
            a, b = getattr(jc, name), getattr(tc, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        if jc.mask is None:
            assert tc.mask is None
        else:
            np.testing.assert_array_equal(tc.mask, jc.mask)
        assert (tc.fovx, tc.fovy, tc.width, tc.height, tc.image_name,
                tc.image_path) == (jc.fovx, jc.fovy, jc.width, jc.height,
                                   jc.image_name, jc.image_path)
        jp, tp = jc.params(), tc.params("cpu")
        for name in jp._fields:
            np.testing.assert_allclose(np.asarray(getattr(tp, name)),
                                       np.asarray(getattr(jp, name)),
                                       atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["blender", "s4r", "tensoir"])
@pytest.mark.parametrize("white", [False, True])
def test_load_scene_matches_jax(scenes, kind, white):
    j = jds.load_scene(scenes[kind], white, eval_split=True)
    t = tds.load_scene(scenes[kind], white, eval_split=True)
    _assert_scene_equal(j, t)
    assert t.light_rotate == (kind != "blender")
    cam = t.train_cameras[0]
    assert cam.image.shape == (RES, RES, 3)
    assert (cam.mask is None) == (kind == "s4r")
    np.testing.assert_array_equal(tds.LIGHT_ROTATE_TRANSFORM,
                                  jds.LIGHT_ROTATE_TRANSFORM)


def test_downscale_r2_matches_cv2_inter_area(scenes):
    """-r 2: the port's box average against the JAX package's cv2
    INTER_AREA, images and intrinsics within 1e-6, masks equal."""
    j = jds.load_scene(scenes["blender"], False, eval_split=True, resolution=2)
    t = tds.load_scene(scenes["blender"], False, eval_split=True, resolution=2)
    for jc, tc in zip(j.train_cameras + j.test_cameras,
                      t.train_cameras + t.test_cameras):
        assert tc.image.shape == jc.image.shape == (RES // 2, RES // 2, 3)
        np.testing.assert_allclose(tc.image, jc.image, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tc.mask, jc.mask)
        jp, tp = jc.params(), tc.params("cpu")
        for name in jp._fields:
            np.testing.assert_allclose(np.asarray(getattr(tp, name)),
                                       np.asarray(getattr(jp, name)),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_unported_inputs_raise(scenes, tmp_path):
    """What the port does not read raises: a folder of no known layout and
    a JPEG frame PIL cannot identify (12-bit samples). A progressive JPEG
    frame, a BMP frame, a WebP frame, a PPM frame and an IM frame, which
    the port once refused, now read as PIL reads them."""
    with pytest.raises(ValueError, match="recognize"):
        tds.load_scene(str(tmp_path))
    img = np.zeros((8, 8, 3), np.uint8)
    img[2:5, 3:7] = (200, 40, 90)
    Image.fromarray(img).save(tmp_path / "p.jpg", progressive=True)
    np.testing.assert_array_equal(
        tds._load_image_any(str(tmp_path / "p.jpg")),
        np.asarray(Image.open(tmp_path / "p.jpg"), np.float32) / 255.0)
    data = (tmp_path / "p.jpg").read_bytes()
    i = data.index(b"\xff\xc2")
    (tmp_path / "t.jpg").write_bytes(data[:i + 4] + bytes([12]) + data[i + 5:])
    # PIL's JPEG plugin refuses 12-bit samples in its _open, and no other
    # plugin takes the file
    with pytest.raises(UnidentifiedImageError):
        Image.open(tmp_path / "t.jpg")
    with pytest.raises(UnreadableImageError, match="cannot identify"):
        tds._load_image_any(str(tmp_path / "t.jpg"))
    Image.fromarray(img).save(tmp_path / "f.bmp")
    np.testing.assert_array_equal(
        tds._load_image_any(str(tmp_path / "f.bmp")),
        np.asarray(Image.open(tmp_path / "f.bmp"), np.float32) / 255.0)
    Image.fromarray(img).save(tmp_path / "f.webp")
    np.testing.assert_array_equal(
        tds._load_image_any(str(tmp_path / "f.webp")),
        np.asarray(Image.open(tmp_path / "f.webp"), np.float32) / 255.0)
    Image.fromarray(img).save(tmp_path / "f.ppm")
    np.testing.assert_array_equal(
        tds._load_image_any(str(tmp_path / "f.ppm")),
        np.asarray(Image.open(tmp_path / "f.ppm"), np.float32) / 255.0)
    Image.fromarray(img).save(tmp_path / "f.im")
    np.testing.assert_array_equal(
        tds._load_image_any(str(tmp_path / "f.im")),
        np.asarray(Image.open(tmp_path / "f.im"), np.float32) / 255.0)


# --- Stanford-ORB ---------------------------------------------------------

ORB_RES = 32


def _write_orb(root, frame_ext=".png", mask="grey8", seed=0, n=(3, 2),
               res=ORB_RES, points=False):
    """A Stanford-ORB layout: transforms_{train,test}.json naming frames
    without extension, frames under {split}/ and masks under
    {split}_mask/ (mask: grey8, grey16, rgb, exr or None)."""
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:res, :res]
    soft = np.clip(1.4 - np.hypot(xx - res / 2 + 0.3, yy - res / 2) /
                   (0.3 * res), 0, 1)
    for split, count in zip(("train", "test"), n):
        frames = [{"file_path": f"./{split}/{i:04d}",
                   "transform_matrix": _c2w(i, rng).tolist()}
                  for i in range(count)]
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.55, "frames": frames}, f)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        os.makedirs(os.path.join(root, split + "_mask"), exist_ok=True)
        for fr in frames:
            base = os.path.join(root, fr["file_path"])
            rgb = rng.uniform(size=(res, res, 3))
            if frame_ext == ".exr":
                jexr.write_exr(base + ".exr", (3 * rgb).astype(np.float32))
            else:
                Image.fromarray((rgb * 255).round().astype(np.uint8)).save(
                    base + ".png")
            mbase = os.path.join(root, fr["file_path"].replace(
                split, split + "_mask"))
            if mask == "grey8":
                Image.fromarray((soft * 255).round().astype(np.uint8)).save(
                    mbase + ".png")
            elif mask == "grey16":
                Image.fromarray((soft * 65535).round().astype(np.uint16)
                                ).save(mbase + ".png")
            elif mask == "rgb":
                m8 = (soft * 255).round().astype(np.uint8)
                Image.fromarray(np.stack([m8, m8 // 2, m8], -1)).save(
                    mbase + ".png")
            elif mask == "exr":
                jexr.write_exr(mbase + ".exr", np.repeat(
                    soft[..., None], 3, -1).astype(np.float32))
    if points:
        v = np.zeros(20, [("x", "f4"), ("y", "f4"), ("z", "f4")])
        for k in ("x", "y", "z"):
            v[k] = rng.standard_normal(20)
        jply.write_ply(os.path.join(root, "points3d.ply"), v)
    return root


ORB_KINDS = {
    "png_grey8": dict(frame_ext=".png", mask="grey8"),
    "png_grey16": dict(frame_ext=".png", mask="grey16"),
    "png_rgb_mask": dict(frame_ext=".png", mask="rgb"),
    "png_no_mask": dict(frame_ext=".png", mask=None),
    "exr_grey8": dict(frame_ext=".exr", mask="grey8"),
    "exr_exr_mask": dict(frame_ext=".exr", mask="exr", points=True),
}
ORB_SIZES = {"int_2x": 16, "frac": 20, "enlarge": 48}


@pytest.mark.parametrize("size", sorted(ORB_SIZES))
@pytest.mark.parametrize("kind", sorted(ORB_KINDS))
def test_stanford_orb_matches_jax(tmp_path, kind, size):
    """read_stanford_orb_scene at a small benchmark_size reached by an
    integer, a fractional and an enlarging INTER_AREA resize: images, masks,
    cameras, points, translate and radius equal the JAX package's."""
    root = _write_orb(str(tmp_path / "StanfordORB" / "cactus"),
                      seed=len(kind), **ORB_KINDS[kind])
    bs = ORB_SIZES[size]
    for white in (False, True):
        j = jds.read_stanford_orb_scene(root, white, True, benchmark_size=bs,
                                        num_init_points=64, seed=3)
        t = tds.read_stanford_orb_scene(root, white, True, benchmark_size=bs,
                                        num_init_points=64, seed=3)
        _assert_scene_equal(j, t)
        assert t.train_cameras[0].image.shape == (bs, bs, 3)
        assert t.points.shape == ((20, 3) if "points" in ORB_KINDS[kind]
                                  else (64, 3))
        if ORB_KINDS[kind]["mask"] is not None:
            assert 0 < t.train_cameras[0].mask.mean() < 1


def test_stanford_orb_load_scene_matches_jax(tmp_path):
    """load_scene sends a stanford_orb folder to the reader at its 512²
    benchmark size."""
    root = _write_orb(str(tmp_path / "stanford_orb" / "gnome"), n=(2, 1))
    j = jds.load_scene(root, True, eval_split=True)
    t = tds.load_scene(root, True, eval_split=True)
    _assert_scene_equal(j, t)
    assert t.train_cameras[0].image.shape == (512, 512, 3)
    assert len(t.test_cameras) == 1
