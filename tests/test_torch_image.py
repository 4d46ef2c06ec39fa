"""The port's image helpers against what the JAX package's CLIs use: the
Radiance .hdr reader (utils/hdr.py) against cv2.imread on files cv2.imwrite
wrote, flat and run-length encoded, and `resize_bilinear` (utils/image.py)
against jax.image.resize(..., "bilinear") at 800 -> 400 (antialiased), at an
upscale and at a mixed resize.

Tolerances: the .hdr reader bit for bit (both decode the same bytes the
same way); the resize rtol 1e-5 / atol 1e-6 (float32 sums of a few taps).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu_torch.scene.datasets import _load_image_any
from irgs_tpu_torch.utils import hdr
from irgs_tpu_torch.utils.image import resize_bilinear
from test_torch_mis import one_torch_thread  # noqa: F401


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
