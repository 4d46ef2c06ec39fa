"""COLMAP binary model parser and scene reader (≙ irgs_tpu/scene/colmap.py).

cameras.bin, images.bin and points3D.bin as the COLMAP model format
specifies them; the frames are read through utils/image.py (JPEG through
utils/jpeg.py, PNG through utils/png.py) and converted to RGB as the JAX
package's ``PIL.Image.open(path).convert("RGB")`` does for each PIL mode.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..utils.image import read_rgb_like_pil
from ..utils.math3d import focal2fov
from .cameras import Camera
from .datasets import SceneInfo, _nerfpp_norm

# camera_model_id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = _read(f, "<" + "d" * n_params)
            cams[cid] = dict(model=name, width=int(w), height=int(h),
                             params=np.array(params))
    return cams


def read_images_bin(path):
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c in (b"\x00", b""):
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.seek(24 * npts, os.SEEK_CUR)  # 2D points: x, y, point3D id
            imgs[iid] = dict(qvec=qvec, tvec=tvec, camera_id=cam_id,
                             name=name.decode("utf-8"))
    return imgs


def read_points3d_bin(path):
    """-> xyz float32 [N, 3], rgb float32 [N, 3] in [0, 1]. Each record is
    read at once with a structured dtype; the track lengths vary, so the
    records are walked by their offsets."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    head = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                     ("error", "<f8"), ("track_len", "<u8")])
    xyz = np.zeros((n, 3), np.float32)
    rgb = np.zeros((n, 3), np.float32)
    pos = 8
    for i in range(n):
        rec = np.frombuffer(buf, head, 1, pos)[0]
        xyz[i] = rec["xyz"]
        rgb[i] = rec["rgb"]
        pos += head.itemsize + 8 * int(rec["track_len"])
    return xyz, rgb / 255.0


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _read_rgb(path):
    """≙ np.asarray(Image.open(path).convert("RGB"), np.float32) / 255."""
    return read_rgb_like_pil(path).astype(np.float32) / 255.0


def read_colmap_scene(path, images_dir="images", eval_split=False,
                      llffhold: int = 8) -> SceneInfo:
    """≙ readColmapSceneInfo (dataset_readers.py:191-240): every llffhold-th
    image becomes a test view when eval_split."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams_meta = read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    imgs_meta = read_images_bin(os.path.join(sparse, "images.bin"))
    xyz, rgb = read_points3d_bin(os.path.join(sparse, "points3D.bin"))

    cameras = []
    for uid, (iid, im) in enumerate(sorted(imgs_meta.items(),
                                           key=lambda kv: kv[1]["name"])):
        meta = cams_meta[im["camera_id"]]
        R = _qvec2rotmat(im["qvec"]).T        # c2w rotation convention
        T = im["tvec"]
        # intrinsics with the principal point kept in K
        p = meta["params"]
        if meta["model"] == "SIMPLE_PINHOLE":     # [f, cx, cy]
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        elif meta["model"] in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        else:  # radial models [f, cx, cy, k...]: focal and centre, the
            # distortion ignored (the frames are taken as undistorted)
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        img_path = os.path.join(path, images_dir, im["name"])
        img = _read_rgb(img_path)
        h, w = img.shape[:2]
        fovx = focal2fov(fx, w)
        fovy = focal2fov(fy, h)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        name = os.path.splitext(im["name"])[0]
        cameras.append(Camera(uid, R, T, fovx=fovx, fovy=fovy, image=img,
                              image_name=name, image_path=img_path, K=K))

    if eval_split:
        train = [c for i, c in enumerate(cameras) if i % llffhold != 0]
        test = [c for i, c in enumerate(cameras) if i % llffhold == 0]
    else:
        train, test = cameras, []
    translate, radius = _nerfpp_norm(train)
    return SceneInfo(train, test, xyz, rgb, translate, radius,
                     light_rotate=False,
                     ply_path=os.path.join(sparse, "points3D.bin"))


# --- writing (the model format's inverse: test and smoke scenes) ----------

_MODEL_IDS = {name: (mid, n) for mid, (name, n) in _CAMERA_MODELS.items()}


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """World-to-camera rotation -> COLMAP's unit quaternion (w, x, y, z),
    w >= 0, the inverse of _qvec2rotmat."""
    m = np.asarray(R, np.float64)
    t = np.trace(m)
    if t > 0:
        s = 2 * np.sqrt(t + 1)
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2 * np.sqrt(1 + m[i, i] - m[j, j] - m[k, k])
        v = np.zeros(3)
        v[i] = s / 4
        v[j] = (m[j, i] + m[i, j]) / s
        v[k] = (m[k, i] + m[i, k]) / s
        q = [(m[k, j] - m[j, k]) / s, *v]
    q = np.asarray(q)
    return q if q[0] >= 0 else -q


def write_model(sparse: str, cameras, images, xyz, rgb) -> None:
    """cameras.bin, images.bin and points3D.bin under `sparse`.

    cameras: dicts of id, model (a name of _CAMERA_MODELS), width, height,
    params; images: dicts of id, qvec, tvec, camera_id, name (no 2D
    points); xyz [N, 3] and rgb uint8 [N, 3] (error 0, empty tracks)."""
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras:
            mid, n = _MODEL_IDS[c["model"]]
            if len(c["params"]) != n:
                raise ValueError(f"{c['model']} takes {n} parameters")
            f.write(struct.pack("<iiQQ", c["id"], mid, c["width"],
                                c["height"]))
            f.write(struct.pack("<" + "d" * n, *c["params"]))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im["id"]))
            f.write(struct.pack("<dddd", *im["qvec"]))
            f.write(struct.pack("<ddd", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), np.dtype(
        [("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
         ("error", "<f8"), ("track_len", "<u8")]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(rec.tobytes())
