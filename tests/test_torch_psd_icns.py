"""The port's PSD and ICNS readers (irgs_tpu_torch/utils/psd.py,
utils/icns.py) against PIL, bit for bit: every committed fixture of
tests/data/psd/ (raw and PackBits composites in modes 1, L from grey,
duotone and multichannel, P with and without its palette, RGB, RGBA,
CMYK and LAB; image resources with an ICC profile; two layers under a
composite unlike either; a PackBits run across a row's end and a no-op
byte) and tests/data/icns/ (RLE and uncompressed RGB with and without
masks, it32, the best of three sizes, PNG entries at full and half size,
a PNG beside RLE entries, J2K and JP2 entries converted to RGBA), as
tests/make_texture_fixtures.py recorded PIL's arrays and as PIL reads
them now, with ``convert("RGB")``; ``info["icc_profile"]``; every refused
stream refused; seeded damaged copies of each fixture read as PIL reads
them or refused where PIL refuses them (PIL's plugins in a fresh
process's order); ``np.asarray`` and ``convert("RGB")`` of ICNS images
whose entry is not RGBA, which differ in PIL; Pillow's own ICNS save.
Tolerance: none."""

import glob
import os
import warnings

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_texture_fixtures as mk
from irgs_tpu_torch.utils import icns, image, psd, small_codecs
from test_torch_mis import one_torch_thread  # noqa: F401

READERS = {"psd": (psd.read_psd_like_pil, psd.PsdError),
           "icns": (icns.read_icns_like_pil, icns.IcnsError)}
CASES = [(fmt, name) for fmt in READERS for name in sorted(fc.modes(fmt))]
REFUSED = [(fmt, name) for fmt in READERS
           for name in sorted(fc.refused(fmt))]


def _path(fmt, name, refused=False):
    return os.path.join(fc.DATA, fmt, "refused" if refused else "",
                        name + mk.FORMATS[fmt])


@pytest.mark.parametrize("fmt", sorted(READERS))
def test_fixture_set_is_complete(fmt):
    ext = mk.FORMATS[fmt]
    names = sorted(os.path.basename(p)[:-len(ext)] for p in glob.glob(
        os.path.join(fc.DATA, fmt, "*" + ext)))
    variants, refused = mk.VARIANTS[fmt]
    assert names == sorted(fc.modes(fmt)) == sorted(n for n, _ in variants())
    assert sorted(fc.refused(fmt)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("fmt,name", CASES)
def test_fixture_equals_pil(fmt, name):
    fc.check_fixture(fmt, mk.FORMATS[fmt], name, READERS[fmt][0]
                     if fmt == "psd" else image.read_image_like_pil)


@pytest.mark.parametrize("fmt,name", CASES)
def test_fixture_equals_pil_now(fmt, name):
    fc.check_fixture_against_pil(fmt, mk.FORMATS[fmt], name)


@pytest.mark.parametrize("fmt,name", REFUSED)
def test_refused_stream_raises(fmt, name):
    with pytest.raises((READERS[fmt][1], image.NotThisFormat,
                        image.UnreadableImageError)):
        image.read_image_like_pil(_path(fmt, name, True))
    assert not fc.check_as_pil(_path(fmt, name, True))


@pytest.mark.parametrize("fmt,name", CASES)
def test_damaged_streams_as_pil(fmt, name, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fc.check_damaged(fmt, mk.FORMATS[fmt], name, tmp_path, n=8)


@pytest.mark.parametrize("name", ["rgb_icc_resources", "rgb_packbits"])
def test_icc_profile_equals_pil(name):
    _, _, info = psd.read_psd_like_pil(_path("psd", name))
    with Image.open(_path("psd", name)) as im:
        assert info.get("icc_profile") == im.info.get("icc_profile")


def test_layered_composite_is_neither_layer():
    """PIL's frame number says layer 1, but its tile (and the port's array)
    is the composite, unlike both layers' pixels."""
    arr, mode, _ = psd.read_psd_like_pil(_path("psd", "two_layers"))
    with Image.open(_path("psd", "two_layers")) as im:
        assert im.tell() == 1 and im.n_frames == 2
        np.testing.assert_array_equal(arr, np.asarray(im))
        for k in (2, 1):      # seek(1) from frame 1 would not move
            im.seek(k)
            layer = np.asarray(im)
            assert layer.shape != arr.shape or not np.array_equal(layer, arr)


def test_packbits_differs_from_libtiff_on_a_crossing_run():
    """libImaging's PackBits drops what a run or literal puts past a row's
    end; libtiff's (utils/lzw.py) carries it into the next row."""
    from irgs_tpu_torch.utils import lzw
    stream = bytes([257 - 6, 9, 3, 1, 2, 3, 4])   # a run of 6, 4 literals
    rows = small_codecs.packbits_pil(stream, 4, 2)
    np.testing.assert_array_equal(rows, [[9, 9, 9, 9], [1, 2, 3, 4]])
    assert list(lzw.packbits(stream, 8)) == [9, 9, 9, 9, 9, 9, 1, 2]


@pytest.mark.parametrize("name", ["icp5_png_palette", "icp5_png_grey"])
def test_icns_asarray_refused_convert_read(name):
    """np.asarray of a fresh ICNS image whose entry is not RGBA finds no
    packer in PIL (and in the port); convert("RGB") loads it first and
    reads it."""
    path = _path("icns", name, True)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image.read_rgb_like_pil(path), want)
    with pytest.raises(image.UnreadableImageError, match="No packer"):
        image.read_image_like_pil(path)


@pytest.mark.parametrize("name", ["is32_no_mask", "icp5_png_rgb"])
def test_icns_rgb_asarray_reads_padded_pixels(name):
    """An RGB ICNS image: np.asarray reads its 4-byte pixels as 3-byte
    ones, convert("RGB") its pixels; both as PIL."""
    path = _path("icns", name)
    arr, mode, info = image.read_image_like_pil(path)
    assert mode == "RGB" and not np.array_equal(arr, info["loaded"])
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))
        np.testing.assert_array_equal(info["loaded"],
                                      np.asarray(im.convert("RGB")))


def test_icns_pil_save(tmp_path):
    """Pillow's ICNS save (PNG entries up to 1024x1024): the 1024x1024
    RGBA entry, as PIL reads it."""
    path = tmp_path / "saved.icns"
    path.write_bytes(mk.icns_pil_save())
    assert fc.check_as_pil(str(path))
    assert image.read_image_like_pil(str(path))[0].shape == (1024, 1024, 4)
