"""The port's DDS and FTEX readers (irgs_tpu_torch/utils/dds.py,
utils/ftex.py, with the block codecs of utils/bcn.py) against PIL, bit for
bit: every committed fixture of tests/data/dds/ and tests/data/ftex/
(Pillow's DXT1/3/5, BC2/3/5 and uncompressed saves; DX10 files of random
BC1-BC7 blocks at 20x12 and 13x9, BC5S, BC6H unsigned and signed, the
typeless and SRGB formats, R8G8B8A8; the FourCCs; RGB masks at 16, 24 and
32 bits, L, LA and P; FTEX DXT1 and raw RGB; as
tests/make_texture_fixtures.py recorded PIL's arrays, and as PIL reads
them now, with ``convert("RGB")``), ``info["gamma"]`` of the SRGB
formats, every refused stream refused, seeded damaged copies of each
fixture read as PIL reads them or refused where PIL refuses them (PIL's
plugins in a fresh process's order), the 1297x840 BC7 frame the chip
smoke times, and the COLMAP capture of texture and Photoshop frames
through the JAX loaders and the port's. Tolerance: none."""

import glob
import hashlib
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_texture_fixtures as mk
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import dds, ftex, image
from test_torch_colmap import _assert_info_equal
from test_torch_mis import one_torch_thread  # noqa: F401

READERS = {"dds": (dds.read_dds_like_pil, dds.DdsError),
           "ftex": (ftex.read_ftex_like_pil, ftex.FtexError)}
CASES = [(fmt, name) for fmt in READERS for name in sorted(fc.modes(fmt))]
REFUSED = [(fmt, name) for fmt in READERS
           for name in sorted(fc.refused(fmt))]


def _ext(fmt):
    return mk.FORMATS[fmt]


@pytest.mark.parametrize("fmt", sorted(READERS))
def test_fixture_set_is_complete(fmt):
    ext = _ext(fmt)
    names = sorted(os.path.basename(p)[:-len(ext)] for p in glob.glob(
        os.path.join(fc.DATA, fmt, "*" + ext)))
    variants, refused = mk.VARIANTS[fmt]
    assert names == sorted(fc.modes(fmt)) == sorted(n for n, _ in variants())
    assert sorted(fc.refused(fmt)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("fmt,name", CASES)
def test_fixture_equals_pil(fmt, name):
    fc.check_fixture(fmt, _ext(fmt), name, READERS[fmt][0])


@pytest.mark.parametrize("fmt,name", CASES)
def test_fixture_equals_pil_now(fmt, name):
    fc.check_fixture_against_pil(fmt, _ext(fmt), name)


@pytest.mark.parametrize("fmt,name", REFUSED)
def test_refused_stream_raises(fmt, name):
    path = os.path.join(fc.DATA, fmt, "refused", name + _ext(fmt))
    with pytest.raises((READERS[fmt][1], image.NotThisFormat,
                        image.UnreadableImageError)):
        READERS[fmt][0](path)
    assert not fc.check_as_pil(path)


def _python_decoded_pixels(data: bytes) -> int:
    """Pixels PIL's Python DdsRgbDecoder would loop over (0 for a file
    that does not reach it)."""
    if len(data) < 128 or data[:4] != b"DDS " or not data[80] & 0x40:
        return 0
    return int.from_bytes(data[12:16], "little") * int.from_bytes(
        data[16:20], "little")


@pytest.mark.parametrize("fmt,name", CASES)
def test_damaged_streams_as_pil(fmt, name, tmp_path):
    """6 seeded damaged copies of each fixture; a copy whose uncompressed
    pixels would take PIL's per-pixel Python decoder over 4,096 pixels (a
    flipped size bit) is left out for time."""
    ext = _ext(fmt)
    with open(os.path.join(fc.DATA, fmt, name + ext), "rb") as f:
        data = f.read()
    rng = np.random.default_rng([0, sorted(fc.modes(fmt)).index(name)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, d in enumerate(fc.damaged(data, rng, 6)):
            if _python_decoded_pixels(d) > 4096:
                continue
            path = tmp_path / f"{i}{ext}"
            path.write_bytes(d)
            fc.check_as_pil(str(path))


@pytest.mark.parametrize("name", ["dx10_bc7_srgb_20x12", "dx10_rgba_srgb",
                                  "dx10_bc7_20x12", "pil_dxt1"])
def test_gamma_equals_pil(name):
    path = os.path.join(fc.DATA, "dds", name + ".dds")
    _, _, info = dds.read_dds_like_pil(path)
    with Image.open(path) as im:
        assert info.get("gamma") == im.info.get("gamma")


def test_large_frame_equals_pil():
    """The 1297x840 BC7 (mode 6) frame the chip smoke times: the SHA-256 of
    PIL's array, as recorded, and PIL's array now."""
    folder = os.path.join(fc.DATA, "dds", "large")
    with open(os.path.join(folder, "large.json")) as f:
        notes = json.load(f)
    assert sorted(notes) == sorted(mk.LARGE)
    for name, want in notes.items():
        path = os.path.join(folder, name)
        arr, mode, _ = image.read_image_like_pil(path)
        assert mode == want["mode"] and list(arr.shape) == want["shape"]
        assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]
        with Image.open(path) as im:
            np.testing.assert_array_equal(arr, np.asarray(im))


CAPTURE = os.path.join(fc.DATA, "texture", "colmap")


def test_capture_is_complete():
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.CAPTURE_FRAMES)


def test_load_scene_capture_matches_jax():
    """The COLMAP capture of texture and Photoshop frames (DXT1 and DXT5
    DDS from Pillow's encoder, an RGB PackBits PSD with one layer, a BLP1
    JPEG): the JAX loaders against the port's, bit for bit."""
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    _assert_info_equal(jcolmap.read_colmap_scene(CAPTURE),
                       tcolmap.read_colmap_scene(CAPTURE))
