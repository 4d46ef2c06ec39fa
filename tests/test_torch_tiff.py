"""The port's TIFF reader (irgs_tpu_torch/utils/tiff.py) against PIL, bit
for bit: every committed fixture of tests/data/tiff/ (array, mode, palette,
as tests/make_tiff_fixtures.py recorded them, and as PIL reads them now,
with ``convert("RGB")``), every refused stream raising TiffError (and the
ones PIL reads that are not ported naming themselves so), the fixture set
against the generator, a 1297x840 frame at each compression, the large
frames the chip smoke times, damaged JPEG, Zstandard, LZMA and CCITT
strips against PIL, the JAX package's ``_load_image_any`` on a handful of
the files and its COLMAP loader on the TIFF capture."""

import glob
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import image_streams as ims
import make_tiff_fixtures as mk
import torch
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import tiff
from test_torch_colmap import _assert_info_equal

FMT, EXT = "tiff", ".tif"
NAMES = sorted(fc.modes(FMT))
LARGE = os.path.join(fc.DATA, FMT, "large")
CAPTURE = os.path.join(fc.DATA, FMT, "colmap")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    assert names == NAMES == sorted(n for n, _ in mk.variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in mk.refused())
    with open(os.path.join(LARGE, "large.json")) as f:
        assert sorted(json.load(f)) == sorted(n for n, _ in
                                              mk.large_frames())
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.CAPTURE_FRAMES)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, tiff.read_tiff_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    why = fc.refused(FMT)[name]
    with pytest.raises(tiff.TiffError) as err:
        tiff.read_tiff_like_pil(os.path.join(fc.DATA, FMT, "refused",
                                             name + EXT))
    if why is not None:          # PIL reads it: the error says not ported
        assert "not ported" in str(err.value)


@pytest.mark.parametrize("comp", ["none", "packbits", "lzw", "adobe_deflate",
                                  "deflate", "zstd", "lzma", "jpeg",
                                  "ycbcr_jpeg", "ycbcr_lzw", "group4"])
def test_full_size_frame_equals_pil(comp):
    """A 1297x840 frame in strips of 8 rows (16 for JPEG), predictor 2
    where the codec takes one; JPEG as PIL writes it and as YCbCr 4:2:0
    with JPEGTables, YCbCr LZW at 2x2, and a bilevel T.6 page."""
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 8, (840, 1297, 3)) * 32).astype(np.uint8)
    img[:, 600:] = img[:, 600:601]
    pred = 2 if comp in ("lzw", "adobe_deflate", "deflate", "zstd",
                         "lzma") else 1
    if comp == "jpeg":
        data = mk.pil_tiff(Image.fromarray(img), compression="jpeg")
    elif comp == "ycbcr_jpeg":
        data = mk.jpeg_tiff(img, ("strips", 16), (2, 2))
    elif comp == "ycbcr_lzw":
        data = ims.write_tiff(np.asarray(Image.fromarray(img).convert(
            "YCbCr")), photometric=6, bits=8, compression="lzw",
            units=(2, 2), layout=("strips", 8))
    elif comp == "group4":
        data = mk.pil_tiff(Image.fromarray(img[..., 0] > 100),
                           compression="group4")
    else:
        data = ims.write_tiff(img, photometric=2, bits=8, compression=comp,
                              predictor=pred, layout=("strips", 8))
    arr, mode, _ = tiff.decode_tiff(data)
    with Image.open(io.BytesIO(data)) as im:
        assert mode == im.mode
        np.testing.assert_array_equal(arr, np.asarray(im))
    if comp in ("none", "packbits", "lzw", "adobe_deflate", "deflate", "zstd",
                "lzma"):
        np.testing.assert_array_equal(arr, img)


@pytest.mark.parametrize("name", ["large_ycbcr_jpeg_420", "large_zstd_p2",
                                  "large_lzma", "large_group4"])
def test_large_frame_equals_pil(name):
    """The frames the chip smoke times (tests/data/tiff/large/), against
    PIL and the SHA-256 the card checks."""
    path = os.path.join(LARGE, name + EXT)
    with open(os.path.join(LARGE, "large.json")) as f:
        want = json.load(f)[name]
    arr, mode, _ = tiff.read_tiff_like_pil(path)
    assert (mode, list(arr.shape)) == (want["mode"], want["shape"])
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))
    assert mk.sha256_of(arr) == want["sha256"]


# fixtures of each codec the damaged-stream test flips bits in
DAMAGED = {
    "ccitt_1d": ["pil_tiff_ccitt", "pil_tiff_ccitt_strips_fill2_minwhite"],
    "group3": ["pil_group3", "pil_group3_strips_fill2_minwhite",
               "pil_group3_t4_1", "pil_group3_t4_5"],
    "group4": ["pil_group4", "pil_group4_strips_fill2_minwhite"],
    "zstd": ["pil_RGB_zstd", "pil_RGB_zstd_p2_strips", "rgba_zstd_p2_tiles",
             "pil_L_zstd"],
    "lzma": ["pil_RGB_lzma", "pil_RGB_lzma_p2_strips", "rgb_lzma_crc64",
             "grey16_lzma_p2_mm"],
    "jpeg": ["ycbcr_jpeg_22_strips", "ycbcr_jpeg_21_tiles", "pil_RGB_jpeg",
             "pil_L_jpeg", "ycbcr_jpeg_22_no_tables"],
}


def _strip_spans(data: bytes):
    """(offset, byte count) of each strip or tile, and of JPEGTables."""
    with Image.open(io.BytesIO(data)) as im:
        t = im.tag_v2
        offs = t.get(273) or t.get(324)
        cnts = t.get(279) or t.get(325)
    spans = list(zip(offs, cnts))
    if 347 in t:
        tables = bytes(t[347])
        spans.append((data.index(tables), len(tables)))
    return spans


@pytest.mark.parametrize("codec", sorted(DAMAGED))
def test_damaged_streams_as_pil(codec):
    """300 seeded one-bit flips in the strips (and JPEGTables) of each
    codec's fixtures: each decodes to PIL's array and mode, or raises where
    PIL raises. Pixels PIL reads from memory libtiff never wrote (rows
    after a T.6 strip that ends early, in the first strip) hold whatever
    PIL's buffer held and are not compared."""
    rng = np.random.default_rng(sorted(DAMAGED).index(codec) + 160)
    files = [open(os.path.join(fc.DATA, FMT, n + EXT), "rb").read()
             for n in DAMAGED[codec]]
    decoded = 0
    for _ in range(300):
        data = files[rng.integers(len(files))]
        spans = _strip_spans(data)
        off, cnt = spans[rng.integers(len(spans))]
        out = bytearray(data)
        out[off + rng.integers(cnt)] ^= 1 << rng.integers(8)
        out = bytes(out)
        try:
            with Image.open(io.BytesIO(out)) as im:
                want, want_mode = np.asarray(im), im.mode
        except Exception:
            with pytest.raises(tiff.TiffError):
                tiff.decode_tiff(out)
            continue
        report = {}
        arr, mode, _ = tiff.decode_tiff(out, report=report)
        keep = ~report["undefined"]
        assert mode == want_mode and arr.shape == want.shape
        np.testing.assert_array_equal(arr[keep], want[keep])
        decoded += 1
    assert decoded > 0


@pytest.mark.parametrize("name", ["grey16_lzw_mm", "rgba_associated",
                                  "palette4", "float32", "bw_minwhite",
                                  "grey16_signed_lzw_mm", "orientation6"])
def test_load_image_any_matches_jax(name):
    path = os.path.join(fc.DATA, FMT, name + EXT)
    want = jds._load_image_any(path)
    got = tds._load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_scene_capture_matches_jax():
    """The COLMAP capture of TIFF frames (YCbCr JPEG 4:2:0 with
    JPEGTables, RGB JPEG, YCbCr LZW 2x2, RGBA Zstandard tiles with
    predictor 2): the JAX loaders against the port's."""
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    jc = jcolmap.read_colmap_scene(CAPTURE)
    tc = tcolmap.read_colmap_scene(CAPTURE)
    _assert_info_equal(jc, tc)
