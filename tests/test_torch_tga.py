"""The port's Targa reader (irgs_tpu_torch/utils/tga.py) against PIL, bit for
bit: every committed fixture of tests/data/tga/ (every image type and depth,
colour maps, RLE; array, mode, palette, as tests/make_small_fixtures.py
recorded them, and as PIL reads them now, with ``convert("RGB")``), every
refused stream refused, and 5 seeded damaged copies of each fixture through
the content-sniffing reader, each decoded to PIL's answer or refused where
PIL refuses it (PIL's plugins tried in a fresh process's order); then the
JAX package's COLMAP loader against the port's on the capture of Targa, Iris
and PPM frames of tests/data/tga/colmap, and its Blender frame reader on
Targa frames named .png."""

import glob
import os
import shutil

import numpy as np
import pytest

import fixture_checks as fc
import image_streams as ims
import make_small_fixtures as mk
from irgs_tpu_torch.utils import image, tga
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from test_torch_colmap import _assert_info_equal
from test_torch_mis import one_torch_thread  # noqa: F401

FMT, EXT = "tga", ".tga"
NAMES = sorted(fc.modes(FMT))
ERRORS = (tga.TgaError, image.NotThisFormat,
                        image.UnreadableImageError)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    variants, refused = mk.VARIANTS[FMT]
    assert names == NAMES == sorted(n for n, _ in variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, tga.read_tga_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    path = os.path.join(fc.DATA, FMT, "refused", name + EXT)
    with pytest.raises(ERRORS):
        tga.read_tga_like_pil(path)
    assert not fc.check_as_pil(path)


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_pil(name, tmp_path):
    fc.check_damaged(FMT, EXT, name, tmp_path, n=5)


CAPTURE = os.path.join(fc.DATA, FMT, "colmap")


def test_capture_is_complete():
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.CAPTURE_FRAMES)


def test_load_scene_capture_matches_jax():
    """The COLMAP capture of Targa RLE RGB, Iris RLE RGB, binary PPM and
    Targa raw RGBA (bottom-left origin) frames: the JAX loaders against the
    port's, bit for bit."""
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    _assert_info_equal(jcolmap.read_colmap_scene(CAPTURE),
                       tcolmap.read_colmap_scene(CAPTURE))


@pytest.mark.parametrize("name", ["rgba32_bottom_plain", "rgb16_type10",
                                  "cmap16_start5_type9"])
def test_blender_frame_named_png_matches_jax(tmp_path, name):
    """A Targa frame named .png through the JAX Blender reader
    (np.asarray(Image.open(p)) / 255) and the port's."""
    path = tmp_path / "r_0.png"
    shutil.copy(os.path.join(fc.DATA, FMT, name + EXT), path)
    want = jds._load_image_any(str(path))
    got = tds._load_image_any(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_16_bit_pixels_equal_pil(tmp_path):
    """Every 16-bit true-colour word as PIL's "BGRA;15Z" reads it: each
    5-bit channel as v * 255 // 31, alpha 255 where the top bit is clear
    (0x7fff white and opaque, 0x001f blue and opaque)."""
    words = np.arange(65536).reshape(256, 256)
    path = tmp_path / "w.tga"
    path.write_bytes(ims.write_tga(words, itype=2, depth=16, top=True))
    arr, mode, _ = tga.read_tga_like_pil(str(path))
    assert mode == "RGBA"
    assert arr[127, 255].tolist() == [255, 255, 255, 255]        # 0x7fff
    assert arr[0, 31].tolist() == [0, 0, 255, 255]               # 0x001f
    assert arr[128, 0].tolist() == [0, 0, 0, 0]                  # 0x8000
    assert fc.check_as_pil(str(path))
