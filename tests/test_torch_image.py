"""The port's image helpers against what the JAX package's CLIs use: the
Radiance .hdr reader (utils/hdr.py) against cv2.imread on files cv2.imwrite
wrote, flat and run-length encoded, and on headers cv2 takes or refuses
(signature, FORMAT line, CRLF, the resolution line as sscanf parses it);
the choice of decoder by content (utils/image.read_image_like_pil) on
files whose extension lies, against the JAX ``_load_image_any`` and its
COLMAP reader (with a TIFF and a BMP frame); and `resize_bilinear`
(utils/image.py) against jax.image.resize(..., "bilinear") at 800 -> 400
(antialiased), at an upscale and at a mixed resize.

Tolerances: the readers bit for bit (both decode the same bytes the same
way); the resize rtol 1e-5 / atol 1e-6 (float32 sums of a few taps).
"""

import io
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene.datasets import _load_image_any
from irgs_tpu_torch.utils import hdr, image
from irgs_tpu_torch.utils.image import resize_bilinear
from test_torch_colmap import _assert_info_equal, write_colmap
from test_torch_mis import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _hdr_image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(0.0, 3.0, (h, w, 3))).astype(np.float32)
    img[0, :2] = 0.0                              # exponent byte 0
    img[1, : w // 2] = img[1, :1]                 # runs for the RLE coder
    img[2, 1] = 6.0e4
    return img


@pytest.mark.parametrize("h,w", [(16, 64), (9, 4), (3, 40000), (5, 300)])
def test_read_hdr_matches_cv2(tmp_path, h, w):
    """cv2 writes widths 8..32767 run-length encoded and others flat."""
    path = str(tmp_path / "env.hdr")
    assert cv2.imwrite(path, _hdr_image(h * w, h, w))
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]      # BGR -> RGB
    got = hdr.read_hdr(path)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_load_image_any(path), want)


def test_read_hdr_flat_scanlines_of_a_wide_image(tmp_path):
    """A file whose scanlines are stored flat although RLE would be allowed
    (other writers do this), built here byte by byte."""
    rgbe = np.random.default_rng(3).integers(0, 256, (4, 12, 4), np.uint8)
    rgbe[0, 0, 0] = 1            # not the RLE marker (2, 2, ...)
    path = tmp_path / "flat.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 12\n"
                     + rgbe.tobytes())
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(hdr.read_hdr(str(path)), want)


def test_read_hdr_rejects_other_files(tmp_path):
    p = tmp_path / "x.hdr"
    p.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(hdr.HdrError):
        hdr.read_hdr(str(p))
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n" + bytes(16))
    with pytest.raises(hdr.HdrError, match="orientation"):
        hdr.read_hdr(str(p))


# .hdr headers: cv2 takes #?RADIANCE and #?RGBE only, needs the FORMAT
# line, reads lines up to "\\n" only, and parses the resolution line with
# sscanf("-Y %d +X %d"), ignoring what follows
HDR_HEADERS = {
    "radiance": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "rgbe": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "other_magic": b"#?FOO\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "no_format": b"#?RADIANCE\nEXPOSURE=1\n\n-Y 5 +X 12\n",
    "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 5 +X 12\r\n",
    "resolution_junk": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                       b"-Y 5 +X 12 junk\n",
    "resolution_no_spaces": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y5+X12\n",
    "resolution_leading_space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                                b" -Y 5 +X 12\n",
    "format_xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 5 +X 12\n",
    "comment_before_format": b"#?RADIANCE\n# by a test\n"
                             b"FORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "format_past_127_bytes": b"#?RADIANCE\n" + b"B" * 126
                             + b"FORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "negative_width": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X -12\n",
}


@pytest.mark.parametrize("case", sorted(HDR_HEADERS))
def test_read_hdr_header_as_cv2(tmp_path, case):
    """Taken or refused as cv2.imread takes or refuses it; what both take
    decodes to the same bits. The JAX reader raises IOError where cv2
    refuses, the port HdrError."""
    rgbe = np.random.default_rng(3).integers(1, 256, (5, 12, 4), np.uint8)
    rgbe[..., 0] = 1                     # flat scanlines, no RLE marker
    path = str(tmp_path / "env.hdr")
    with open(path, "wb") as f:
        f.write(HDR_HEADERS[case] + rgbe.tobytes())
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want is None:
        with pytest.raises(IOError):
            jds._load_image_any(path)
        with pytest.raises(hdr.HdrError):
            hdr.read_hdr(path)
        return
    np.testing.assert_array_equal(hdr.read_hdr(path), want[..., ::-1])
    np.testing.assert_array_equal(_load_image_any(path),
                                  jds._load_image_any(path))


# files whose extension is not their format: PIL, and the port, read them
# by their content
MISLABELLED = {"jpeg_as_png": ("jpeg", ".jpg", ".png"),
               "png_as_jpg": ("png", ".png", ".jpg"),
               "jpeg_as_jfif": ("jpeg", ".jpg", ".jfif"),
               "tiff_as_png": ("tiff", ".tif", ".png"),
               "gif_as_bmp": ("gif", ".gif", ".bmp")}


def _a_fixture(fmt, ext):
    names = sorted(n for n in os.listdir(os.path.join(DATA, fmt))
                   if n.endswith(ext))
    return os.path.join(DATA, fmt, names[len(names) // 2])


@pytest.mark.parametrize("case", sorted(MISLABELLED))
def test_mislabelled_file_reads_as_jax(tmp_path, case):
    fmt, ext, new_ext = MISLABELLED[case]
    path = str(tmp_path / ("frame" + new_ext))
    shutil.copy(_a_fixture(fmt, ext), path)
    want = jds._load_image_any(path)
    got = _load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unidentified_and_queued_files_raise(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(image.UnreadableImageError, match="cannot identify"):
        image.read_image_like_pil(str(p))
    # WebP, once queued, reads as PIL reads it (by content, named .png); a
    # RIFF WEBP file whose first chunk PIL does not know is unidentified
    bio = io.BytesIO()
    Image.new("RGB", (4, 3), (10, 20, 30)).save(bio, "WEBP")
    p.write_bytes(bio.getvalue())
    arr, mode, _ = image.read_image_like_pil(str(p))
    with Image.open(p) as im:
        assert mode == im.mode == "RGB"
        np.testing.assert_array_equal(arr, np.asarray(im))
    data = bio.getvalue()
    p.write_bytes(data[:12] + b"VP9 " + data[16:])
    with pytest.raises(image.UnreadableImageError, match="cannot identify"):
        image.read_image_like_pil(str(p))


def test_colmap_tiff_and_bmp_frames_match_jax(tmp_path):
    """A 2-frame COLMAP scene: an LZW TIFF frame and a BMP frame, both
    named .tif (PIL picks the decoder by content)."""
    root = write_colmap(str(tmp_path / "scene"), ["PINHOLE", "OPENCV"],
                        ext=".tif", seed=14)
    folder = os.path.join(root, "images")
    first, second = sorted(os.listdir(folder))
    rgb = np.asarray(Image.open(os.path.join(folder, first)))
    Image.fromarray(rgb).save(os.path.join(folder, first), "TIFF",
                              compression="tiff_lzw")
    rgb = np.asarray(Image.open(os.path.join(folder, second)))
    Image.fromarray(rgb).save(os.path.join(folder, second), "BMP")
    _assert_info_equal(jcolmap.read_colmap_scene(root),
                       tcolmap.read_colmap_scene(root))


@pytest.mark.parametrize("src,dst,c", [((800, 800), (400, 400), 3),
                                       ((30, 50), (48, 80), 1),
                                       ((64, 40), (32, 100), 4)])
def test_resize_bilinear_matches_jax(src, dst, c):
    img = np.random.default_rng(sum(src)).uniform(
        0, 1, (*src, c)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (*dst, c), "bilinear")
    got = resize_bilinear(torch.tensor(img), *dst)
    assert tuple(got.shape) == (*dst, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
