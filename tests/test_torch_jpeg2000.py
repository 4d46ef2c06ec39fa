"""The port's JPEG 2000 reader (irgs_tpu_torch/utils/jpeg2000.py with
utils/j2k.py, utils/jp2.py and csrc/j2k_decode.cpp) against both of the
JAX loaders' readers, bit for bit: every committed fixture of
tests/data/jp2/ (5/3 and 9/7, every progression order and POC, tiles and
offsets, quality layers, precincts, every code-block style bit, SOP/EPH,
PLT/TLM, PPT/PPM, ROI, subsampled and signed components, 1 to 16 bits,
L, I;16, LA, RGB, RGBA, CMYK, sYCC, P and PA; as
tests/make_jp2_fixtures.py recorded PIL's arrays, and as PIL reads them
now, with ``convert("RGB")`` and ``info``) against
``np.asarray(PIL.Image.open(p))`` and, through the ``.hdr`` path
(utils/imread.py), against ``cv2.imread(p, IMREAD_UNCHANGED)``; the
refused streams refused where PIL refuses them and, where cv2 reads one,
read as cv2 reads it; seeded damaged copies of each fixture decoded to
each library's answer or refused where it refuses; the COLMAP capture of
JPEG 2000 frames and a Blender frame through the JAX loaders and the
port's. Tolerance: none (equal arrays, modes and dtypes)."""

import glob
import json
import os
import shutil
import warnings

import cv2
import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_jp2_fixtures as mk
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import image, imread, jpeg2000
from test_torch_colmap import _assert_info_equal
from test_torch_mis import one_torch_thread  # noqa: F401

FMT = "jp2"
NAMES = sorted(fc.modes(FMT))
REFUSED = sorted(fc.refused(FMT))
ERRORS = (jpeg2000.Jpeg2000Error, image.NotThisFormat,
          image.UnreadableImageError)
if hasattr(cv2, "setLogLevel"):
    cv2.setLogLevel(0)


def _path(name, refused=False):
    return os.path.join(fc.DATA, FMT, "refused" if refused else "", name)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(fc.DATA, FMT, "*.j[2p][k2]")))
    assert names == NAMES == sorted(n for n, _ in mk.variants())
    assert REFUSED == sorted(n for n, _, _ in mk.refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, "", name, jpeg2000.read_jpeg2000_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, "", name)


@pytest.mark.parametrize("name", ["comment.j2k", "comment.jp2", "dpi.jp2",
                                  "res_box.jp2", "rgb_53.jp2"])
def test_info_equals_pil(name):
    """``im.info``'s dpi (from res/resc) and comment (the first COM)."""
    _, _, info = jpeg2000.read_jpeg2000_like_pil(_path(name))
    with Image.open(_path(name)) as im:
        want = {k: im.info[k] for k in ("dpi", "comment") if k in im.info}
    assert {k: info[k] for k in ("dpi", "comment") if k in info} == want


def _cv2(path):
    """cv2.imread(path, IMREAD_UNCHANGED), None where it fails."""
    try:
        return cv2.imread(path, cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


def check_as_cv2(path) -> bool:
    """The port's .hdr reader on `path` against cv2: both refuse, or equal
    arrays; where cv2 reads what the port does not (Part-2 markers, HTJ2K
    code-blocks), the port names it "not ported". Returns whether cv2
    decoded it."""
    want = _cv2(path)
    if want is None:
        with pytest.raises((OSError, image.UnreadableImageError)):
            imread.imread_unchanged(path)
        return False
    try:
        got = imread.imread_unchanged(path)
    except image.UnreadableImageError as e:
        assert "not ported" in str(e)
        return True
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    return True


@pytest.mark.parametrize("name", NAMES + [f"refused/{n}" for n in REFUSED])
def test_fixture_as_cv2(name):
    check_as_cv2(_path(name))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_stream_raises(name):
    with pytest.raises(ERRORS):
        jpeg2000.read_jpeg2000_like_pil(_path(name, True))
    assert not fc.check_as_pil(_path(name, True))


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_pil(name, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fc.check_damaged(FMT, "", name, tmp_path, n=4)


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_cv2(name, tmp_path):
    with open(_path(name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng([1, NAMES.index(name)])
    for i, d in enumerate(fc.damaged(data, rng, 4, head=200)):
        path = tmp_path / f"{i}.hdr"
        path.write_bytes(d)
        check_as_cv2(str(path))


def test_high_throughput_codeblocks_not_ported(tmp_path):
    """A codestream whose code-blocks are high-throughput (Part 15, COD's
    style bit 0x40) names itself not ported, in both readers."""
    cs = bytearray(mk.codestream_of(mk.pil_save(mk.photo()[..., :3],
                                                no_jp2=True)))
    cod = cs.index(b"\xff\x52")
    cs[cod + 12] |= 0x40
    path = tmp_path / "ht.j2k"
    path.write_bytes(bytes(cs))
    with pytest.raises(image.UnreadableImageError,
                       match="JPEG2000 is not ported"):
        image.read_image_like_pil(str(path))
    with pytest.raises(image.UnreadableImageError, match="not ported"):
        imread.imread_unchanged(str(path))


def test_bgr2gray_equals_cv2():
    """A palette on a grey codestream comes out of cv2 as one channel:
    cvtColor's BGR2GRAY, here at every G and R for a few B."""
    g, r = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for b in (0, 1, 74, 128, 254, 255):
        bgr = np.stack([np.full_like(g, b), g, r], -1).astype(np.uint8)
        np.testing.assert_array_equal(
            jpeg2000._bgr2gray(b, g, r), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_ycbcr_tables_equal_pil():
    """The sYCC unpacker's conversion is PIL's ImagingConvertYCbCr2RGB
    (Image.convert from YCbCr) at every Y, Cb and Cr."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256))
    for y in range(256):
        a = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.frombytes("YCbCr", (256, 256), a.tobytes())
                          .convert("RGB"))
        got = jpeg2000._ycbcr2rgb(np.concatenate(
            [a, np.full_like(a[..., :1], 255)], -1))[..., :3]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [n for n, _ in mk.LARGE])
def test_large_frame_equals_pil(name):
    """The 1297x840 frames the chip smoke times: the SHA-256 of PIL's
    array, as recorded, and PIL's array now."""
    import hashlib
    path = os.path.join(fc.DATA, FMT, "large", name)
    with open(os.path.join(fc.DATA, FMT, "large", "large.json")) as f:
        want = json.load(f)[name]
    arr, mode, _ = image.read_image_like_pil(path)
    assert mode == want["mode"] and list(arr.shape) == want["shape"]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))


CAPTURE = os.path.join(fc.DATA, FMT, "colmap")


def test_capture_is_complete():
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.CAPTURE_FRAMES)


def test_load_scene_capture_matches_jax():
    """The COLMAP capture of JPEG 2000 frames (5/3 JP2, 9/7 JP2 with
    layers, RPCL and 64x64 precincts, a tiled J2K with SOP/EPH and
    BYPASS|TERMALL code-blocks, 12-bit RGB JP2): the JAX loaders against
    the port's, bit for bit."""
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    _assert_info_equal(jcolmap.read_colmap_scene(CAPTURE),
                       tcolmap.read_colmap_scene(CAPTURE))


@pytest.mark.parametrize("name,dst", [("RGBA.jp2", "r_0.png"),
                                      ("rgb_12bit.jp2", "r_0.png"),
                                      ("sop_eph_tiles.j2k", "r_0.hdr"),
                                      ("colr_sycc.jp2", "r_0.hdr")])
def test_blender_frame_matches_jax(tmp_path, name, dst):
    """A JPEG 2000 frame through the JAX Blender reader (PIL, or cv2 for a
    .hdr name) and the port's."""
    path = tmp_path / dst
    shutil.copy(_path(name), path)
    want = jds._load_image_any(str(path))
    got = tds._load_image_any(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_packet_headers_moved_to_ppt_and_ppm(tmp_path):
    """The PPT and PPM fixtures are their SOP/EPH source with the packet
    headers moved out of the data: all three decode to the same pixels,
    in PIL and in the port."""
    rgb = mk.photo(seed=1)[..., :3]
    src = mk.encode([rgb[..., k].astype(np.int32) for k in range(3)],
                    csty=6, layers=[10, 3], tile=(24, 24))
    with open(_path("ppt.j2k"), "rb") as f:
        assert f.read() == mk.packets_to_ppt(src)
    with open(_path("ppm.j2k"), "rb") as f:
        assert f.read() == mk.packets_to_ppt(src, main=True)
    path = tmp_path / "src.j2k"
    path.write_bytes(src)
    want = np.asarray(Image.open(path))
    for name in ("ppt.j2k", "ppm.j2k"):
        np.testing.assert_array_equal(
            jpeg2000.read_jpeg2000_like_pil(_path(name))[0], want)
