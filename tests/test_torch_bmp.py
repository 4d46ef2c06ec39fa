"""The port's BMP reader (irgs_tpu_torch/utils/bmp.py) against PIL, bit for
bit: every committed fixture of tests/data/bmp/ (array, mode, palette, as
tests/make_bmp_fixtures.py recorded them, and as PIL reads them now, with
``convert("RGB")``), every refused stream raising BmpError, the fixture
set against the generator, a 1297x840 24-bit frame, PIL's 16-bit
unpackers on every pixel value, and the JAX package's ``_load_image_any``
on a handful of the files."""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import image_streams as ims
import make_bmp_fixtures as mk
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import bmp

FMT, EXT = "bmp", ".bmp"
NAMES = sorted(fc.modes(FMT))


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    assert names == NAMES == sorted(n for n, _ in mk.variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in mk.refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, bmp.read_bmp_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    with pytest.raises(bmp.BmpError):
        bmp.read_bmp_like_pil(os.path.join(fc.DATA, FMT, "refused",
                                           name + EXT))


@pytest.mark.parametrize("masks", [None, (0xF800, 0x7E0, 0x1F)])
def test_16_bit_pixels_equal_pil(masks):
    """Every 16-bit word, 5-5-5 (BI_RGB) and 5-6-5 (bitfields)."""
    words = np.arange(65536).reshape(256, 256)
    data = ims.write_bmp(words, bits=16, compression=3 if masks else 0,
                         masks=masks)
    arr, mode, _ = bmp.decode_bmp(data)
    np.testing.assert_array_equal(arr, np.asarray(Image.open(io.BytesIO(data))))


def test_full_size_frame_equals_pil():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (840, 1297, 3)).astype(np.uint8)
    data = ims.write_bmp(img, bits=24)
    arr, mode, _ = bmp.decode_bmp(data)
    assert mode == "RGB"
    np.testing.assert_array_equal(arr, img)
    np.testing.assert_array_equal(arr, np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("name", ["pil_RGBA", "rle4", "grey8", "pal1_h12",
                                  "rgb32_bitfields0_v5"])
def test_load_image_any_matches_jax(name):
    path = os.path.join(fc.DATA, FMT, name + EXT)
    want = jds._load_image_any(path)
    got = tds._load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [1, 4, 8, 24])
@pytest.mark.parametrize("cut", [1, 2])
def test_cut_in_the_last_rows_padding_reads_as_pil(bits, cut):
    """PIL's raw decoder skips a row's padding only before the next row:
    a file cut inside the last row's padding reads (7 pixels a row: 3, 0,
    1 and 3 bytes of padding at 1, 4, 8 and 24 bits); one cut into the
    pixels is refused."""
    rng = np.random.default_rng(bits)
    shape = (5, 7, 3) if bits == 24 else (5, 7)
    pal = rng.integers(0, 256, (1 << bits, 3)) if bits <= 8 else None
    data = ims.write_bmp(rng.integers(0, min(256, 1 << bits), shape),
                         bits=bits, palette=pal)[:-cut]
    try:
        with Image.open(io.BytesIO(data)) as im:
            want, want_mode = np.asarray(im), im.mode
    except OSError:                     # the cut reaches the pixels
        with pytest.raises(bmp.BmpError, match="truncated"):
            bmp.decode_bmp(data)
        return
    arr, mode, _ = bmp.decode_bmp(data)
    assert mode == want_mode
    np.testing.assert_array_equal(arr, want)


def test_rle_into_rgb_is_refused():
    """PIL's RLE decoder hands its bytes on as "P" or "L" pixels: a 16-bit
    header with RLE compression is refused, as PIL refuses it."""
    data = bytearray(ims.write_bmp(np.zeros((3, 4), np.uint16), bits=16))
    data[30:34] = struct.pack("<I", 1)
    with pytest.raises(Exception):
        np.asarray(Image.open(io.BytesIO(bytes(data))))
    with pytest.raises(bmp.BmpError, match="RLE"):
        bmp.decode_bmp(bytes(data))
