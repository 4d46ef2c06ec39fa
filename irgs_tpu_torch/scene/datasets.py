"""Dataset readers (≙ irgs_tpu/scene/datasets.py): Blender/TensoIR,
Synthetic4Relight and Stanford-ORB folders, COLMAP captures (scene/
colmap.py), the path sniffing of `load_scene` and the `-r/--resolution`
rescale. Host-side numpy; frames stay in host RAM until the trainer moves
them to the device.

Images are read by the port's own codecs: EXR through utils/exr.py and
.hdr through utils/imread.py (what cv2.imread gives, by content: Radiance,
or PNG, JPEG, TIFF, BMP, WebP, GIF, PNM, PFM and JPEG 2000 under that
name), chosen by the extension as the JAX package chooses; every other file
through utils/image.read_image_like_pil, which picks the reader by the
file's content in PIL's plugin order (PNG, JPEG, TIFF, BMP, DIB, GIF, WebP,
Netpbm, Targa, ICO, CUR, QOI, PCX, SGI, JPEG 2000), as PIL does, and
decodes it to the array PIL gives the JAX package. Resizes are utils/resize.py's ports of cv2.resize.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.math3d import focal2fov, fov2focal
from ..utils.resize import INTER_AREA, INTER_LINEAR, resize
from .cameras import Camera


@dataclass
class SceneInfo:
    train_cameras: list
    test_cameras: list
    points: np.ndarray | None      # [N, 3] init point cloud
    colors: np.ndarray | None      # [N, 3]
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 1.0            # cameras_extent
    light_rotate: bool = False
    ply_path: str = ""


def _nerfpp_norm(cams: list[Camera]):
    """≙ getNerfppNorm (dataset_readers.py:53-75)."""
    centers = np.stack([c.cam_pos for c in cams])
    center = centers.mean(axis=0)
    diagonal = np.max(np.linalg.norm(centers - center, axis=-1))
    return -center, float(diagonal * 1.1)


def _load_image_any(path: str):
    """RGB(A) image -> float [H, W, C]: EXR as stored; a .hdr path as the
    JAX package's cv2.imread(path, IMREAD_UNCHANGED) gives it, whatever its
    content (utils/imread.py: BGR flipped to RGB, the samples' own dtype
    cast to float32 without a division by 255, so a 12- or 16-bit JPEG 2000
    stays in 0..65535; OSError where cv2 gives None); any other file as the
    JAX package's np.asarray(PIL.Image.open(path), float32) / 255 (grey as
    [H, W]; JPEG 2000 in PIL's mode, above 8 bits I;16 or rounded to 8)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from ..utils import exr
        return exr.read_exr_rgb(path)
    if ext == ".hdr":
        from ..utils.imread import imread_unchanged
        img = imread_unchanged(path)
        if img.ndim == 3 and img.shape[-1] >= 3:
            img[..., :3] = img[..., 2::-1]  # BGR -> RGB
        return np.asarray(img, np.float32)
    from ..utils.image import read_image_like_pil
    return np.asarray(read_image_like_pil(path)[0], np.float32) / 255.0


def _blender_frame_to_camera(frame, path, fovx, white_background, extension,
                             uid):
    file_path = frame["file_path"]
    if ".png" not in file_path:
        file_path = file_path + extension
    cam_name = os.path.join(path, file_path)
    c2w = np.array(frame["transform_matrix"], dtype=np.float64)
    # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    R = w2c[:3, :3].T
    T = w2c[:3, 3]

    subdir = os.environ.get("DATA_SUBDIR", "")
    image_path = os.path.join(path, os.path.dirname(file_path), subdir,
                              os.path.basename(cam_name))
    if not os.path.exists(image_path):
        image_path = cam_name
    im = _load_image_any(image_path)

    # composited in float64 onto the background, as the reference
    bg = np.ones(3) if white_background else np.zeros(3)
    mask = None
    if im.ndim == 3 and im.shape[-1] == 4:
        mask = im[:, :, 3] > 0.5
        im = im[:, :, :3] * im[:, :, 3:4] + bg * (1 - im[:, :, 3:4])
    else:
        im = im[..., :3]

    h, w = im.shape[:2]
    fovy = focal2fov(fov2focal(fovx, w), h)
    name = os.path.splitext(os.path.basename(file_path))[0]
    return Camera(uid, R, T, fovx=fovx, fovy=fovy, image=im, mask=mask,
                  image_name=name, image_path=image_path)


def read_transforms_cameras(path, transformsfile, white_background,
                            extension=".png"):
    """≙ readCamerasFromTransforms (dataset_readers.py:242-309)."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    if fovx is None:
        fovx = 2 * math.atan(contents["w"] / (2 * contents["fl_x"]))
    return [
        _blender_frame_to_camera(fr, path, fovx, white_background, extension, i)
        for i, fr in enumerate(contents["frames"])
    ]


def _read_points(ply_path: str, with_colors: bool):
    from ..utils.ply import read_ply
    v = read_ply(ply_path)["vertex"].data
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if with_colors and "red" in (v.dtype.names or ()):
        colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(
            np.float32) / 255.0
    else:
        colors = np.full_like(points, 0.5)
    return points, colors


def read_blender_scene(path, white_background, eval_split, extension=".png",
                       num_init_points: int = 100_000, seed: int = 0) -> SceneInfo:
    """≙ readNerfSyntheticInfo (dataset_readers.py:311-356)."""
    train = read_transforms_cameras(path, "transforms_train.json",
                                    white_background, extension)
    test = (read_transforms_cameras(path, "transforms_test.json",
                                    white_background, extension)
            if eval_split else [])
    translate, radius = _nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        points, colors = _read_points(ply_path, with_colors=True)
    else:
        rng = np.random.RandomState(seed)
        points = (rng.random((num_init_points, 3)) * 2.6 - 1.3).astype(np.float32)
        colors = np.full_like(points, 0.5)
    return SceneInfo(train, test, points, colors, translate, radius,
                     light_rotate=False, ply_path=ply_path)


def read_synthetic4relight_scene(path, white_background, eval_split) -> SceneInfo:
    """≙ readSynthetic4RelightInfo (dataset_readers.py:440-474): HDR EXR
    training frames (`*_rgb.exr`), PNG test frames."""
    train = read_transforms_cameras(path, "transforms_train.json",
                                    white_background, "_rgb.exr")
    test = (read_transforms_cameras(path, "transforms_test.json",
                                    white_background, "_rgba.png")
            if eval_split else [])
    translate, radius = _nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    points = colors = None
    if os.path.exists(ply_path):
        points, colors = _read_points(ply_path, with_colors=False)
    return SceneInfo(train, test, points, colors, translate, radius,
                     light_rotate=True, ply_path=ply_path)


def read_stanford_orb_scene(path, white_background, eval_split,
                            benchmark_size: int = 512,
                            num_init_points: int = 100_000,
                            seed: int = 0) -> SceneInfo:
    """≙ readStanfordORBInfo + readCamerasFromTransforms2
    (dataset_readers.py:476-573): per-frame PNG/EXR images with separate
    `{train,test}_mask` alpha images, resized to `benchmark_size` (cv2's
    INTER_AREA) and composited onto the background colour in float64."""

    def find(base):
        return next((os.path.join(path, base + e) for e in (".png", ".exr")
                     if os.path.exists(os.path.join(path, base + e))), None)

    def read_split(transformsfile):
        with open(os.path.join(path, transformsfile)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        cams = []
        for uid, frame in enumerate(contents["frames"]):
            base = frame["file_path"]
            image_path = find(base)
            mask_path = find(base.replace("test", "test_mask")
                             .replace("train", "train_mask"))
            if image_path is None:
                raise FileNotFoundError(f"{base}.png/.exr not found under {path}")

            c2w = np.array(frame["transform_matrix"], dtype=np.float64)
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]

            im = _load_image_any(image_path)[..., :3]
            mask = (_load_image_any(mask_path) if mask_path
                    else np.ones(im.shape[:2], np.float32))
            if mask.ndim == 3:
                mask = mask[..., 0]
            sz = (benchmark_size, benchmark_size)
            im = resize(im, sz, INTER_AREA)
            mask = resize(mask.astype(np.float32), sz, INTER_AREA)
            bg = np.ones(3) if white_background else np.zeros(3)
            im = im * mask[..., None] + bg * (1 - mask[..., None])

            h, w = im.shape[:2]
            fovy = focal2fov(fov2focal(fovx, w), h)
            cams.append(Camera(uid, R, T, fovx=fovx, fovy=fovy,
                               image=im.astype(np.float32), mask=mask > 0.5,
                               image_name=os.path.basename(base),
                               image_path=image_path))
        return cams

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json") if eval_split else []
    translate, radius = _nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        points, colors = _read_points(ply_path, with_colors=False)
    else:
        rng = np.random.RandomState(seed)
        points = (rng.random((num_init_points, 3)) * 2.6 - 1.3).astype(np.float32)
        colors = np.full_like(points, 0.5)
    return SceneInfo(train, test, points, colors, translate, radius,
                     light_rotate=False, ply_path=ply_path)


def _downscale_camera(cam: Camera, resolution, resolution_scale: float) -> Camera:
    """Resolution-scaled reload of one view (≙ loadCam,
    utils/camera_utils.py:21-71): -r ∈ {1,2,4,8} divides, -r -1 caps width
    at 1600, any other value is a target width; intrinsics K are divided by
    the same scalar scale. Images and masks go through cv2.resize's
    INTER_AREA when shrinking and INTER_LINEAR when enlarging
    (utils/resize.py); masks are thresholded at 0.5 after."""
    orig_w, orig_h = cam.width, cam.height
    if resolution in (1, 2, 4, 8):
        scale = float(resolution_scale * resolution)
        new_w, new_h = round(orig_w / scale), round(orig_h / scale)
    else:
        if resolution == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1.0
        else:
            global_down = orig_w / float(resolution)
        scale = float(global_down) * float(resolution_scale)
        new_w, new_h = int(orig_w / scale), int(orig_h / scale)
    if (new_w, new_h) == (orig_w, orig_h):
        return cam

    interp = INTER_AREA if new_w < orig_w else INTER_LINEAR
    image = None
    if cam.image is not None:
        image = resize(cam.image, (new_w, new_h), interp)
    mask = None
    if cam.mask is not None:
        mask = resize(cam.mask.astype(np.float32), (new_w, new_h),
                      interp) > 0.5
    K = None
    if cam.K is not None:
        K = cam.K.copy()
        K[:2] = K[:2] / scale
    return Camera(cam.uid, cam.R, cam.T, fovx=cam.fovx, fovy=cam.fovy,
                  image=image, image_name=cam.image_name, mask=mask,
                  znear=cam.znear, zfar=cam.zfar,
                  width=new_w, height=new_h, K=K, image_path=cam.image_path)


def apply_resolution(info: SceneInfo, resolution, resolution_scale: float = 1.0) -> SceneInfo:
    """≙ cameraList_from_camInfos over both splits
    (utils/camera_utils.py:73-79). No-op at -r -1 with small images."""
    if resolution == -1:
        if all(c.width <= 1600 for c in info.train_cameras + info.test_cameras):
            return info
    info.train_cameras = [_downscale_camera(c, resolution, resolution_scale)
                          for c in info.train_cameras]
    info.test_cameras = [_downscale_camera(c, resolution, resolution_scale)
                         for c in info.test_cameras]
    return info


def load_scene(source_path: str, white_background: bool = False,
               eval_split: bool = True, resolution: int = -1,
               resolution_scale: float = 1.0) -> SceneInfo:
    """Path-sniffing dispatch (≙ Scene.__init__, scene/__init__.py:49-68),
    plus the reference's `-r/--resolution` camera scaling."""
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        if "Synthetic4Relight" in source_path:
            info = read_synthetic4relight_scene(source_path, white_background,
                                                eval_split)
        elif "StanfordORB" in source_path or "stanford_orb" in source_path:
            info = read_stanford_orb_scene(source_path, white_background,
                                           eval_split)
        else:
            info = read_blender_scene(source_path, white_background, eval_split)
            if "TensoIR" in source_path:
                info.light_rotate = True
    elif os.path.exists(os.path.join(source_path, "sparse")):
        from .colmap import read_colmap_scene
        info = read_colmap_scene(source_path, eval_split=eval_split)
    else:
        raise ValueError(f"Could not recognize scene type at {source_path}")
    return apply_resolution(info, resolution, resolution_scale)


# Envmap world-rotation applied for Synthetic4Relight/TensoIR
# (≙ train.py:75-81)
LIGHT_ROTATE_TRANSFORM = np.array(
    [[0, -1, 0], [0, 0, 1], [-1, 0, 0]], dtype=np.float32)
