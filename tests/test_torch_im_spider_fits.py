"""IM, SPIDER and FITS as PIL reads them: the port's readers
(irgs_tpu_torch/utils/im.py, spider.py, fits.py) against Pillow's
ImImagePlugin, SpiderImagePlugin and FitsImagePlugin, bit for bit: every
committed fixture of tests/data/{im,spider,fits}/ (Pillow's IM saves in
each mode it writes and hand-made headers for the rest of the plugin's
OPEN table, LUTs, frame stacks; SPIDER in both byte orders, stacks,
floats out of 0..255 and NaN; FITS at every BITPIX, NAXIS 1, fits_gzip),
array, mode, palette, ``convert("RGB")`` and ``im.format``; the refused
streams refused; damaged copies read or refused as PIL does; the n-bit
IM images of every width through libImaging's bit decoder; the YCbCr to
RGB tables on seeded samples; seeded random IM headers. Tolerance:
none."""

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_im_sun_xpm_fli_fixtures as mk
import raster_suite as rs
from irgs_tpu_torch.utils import image
from irgs_tpu_torch.utils.ycbcr import ycbcr_to_rgb
from test_torch_mis import one_torch_thread  # noqa: F401

FMTS = ["im", "spider", "fits"]
CASES = rs.cases(FMTS)
REFUSED = rs.refused_cases(FMTS)


@pytest.mark.parametrize("fmt", FMTS)
def test_fixture_set_is_complete(fmt):
    rs.check_set_is_complete(fmt)


@pytest.mark.parametrize("fmt,name", CASES)
def test_fixture_equals_pil(fmt, name):
    rs.check_fixture(fmt, name)


@pytest.mark.parametrize("fmt,name", CASES)
def test_fixture_equals_pil_now(fmt, name):
    rs.check_fixture_now(fmt, name)


@pytest.mark.parametrize("fmt,name", REFUSED)
def test_refused_stream_raises(fmt, name):
    rs.check_refused(fmt, name)


@pytest.mark.parametrize("fmt,name", CASES)
def test_damaged_streams_as_pil(fmt, name, tmp_path):
    rs.check_damaged(fmt, name, tmp_path)


@pytest.mark.parametrize("bits", [b for b in range(2, 32)
                                  if b not in (8, 16)])
def test_im_bit_decoder_as_pil(bits, tmp_path):
    """An L*n image of 11x5 n-bit values (random bytes, a few to spare)
    through BitDecode's row padding and bit-buffer quirks, and the same
    bytes cut short."""
    rng = np.random.default_rng(bits)
    data = rng.integers(0, 256, (11 * bits + 7) // 8 * 5 + 6,
                        np.uint8).tobytes()
    for k, d in enumerate((data, data[:len(data) // 2])):
        p = tmp_path / f"{k}.im"
        p.write_bytes(mk.im_file([f"Image type: L*{bits} image",
                                  "Image size (x*y): 11*5"], d))
        assert fc.check_as_pil(str(p)) == (k == 0)


def test_ycbcr_to_rgb_tables_as_pil():
    """ConvertYCbCr.c's fixed-point conversion on seeded YCbCr triples and
    on every (Cb, Cr) pair at three lumas."""
    rng = np.random.default_rng(5)
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    parts = [rng.integers(0, 256, (64, 64, 3), np.uint8)]
    for y in (0, 128, 255):
        parts.append(np.stack([np.full_like(cb, y), cb, cr],
                              -1).astype(np.uint8))
    for ycc in parts:
        want = np.asarray(Image.frombytes("YCbCr", ycc.shape[1::-1],
                                          ycc.tobytes()).convert("RGB"))
        np.testing.assert_array_equal(ycbcr_to_rgb(ycc), want)


KEYS = ["Image type: Greyscale image", "Image type: RGB image",
        "Image type: L 16B image", "Image type: L*12 image",
        "Image type: B4 image", "Image type: foo", "Image type: L 32F image",
        "Image size (x*y): 7*3", "Image size (x*y): 3",
        "Image size (x*y): 0*4", "Image size (x*y): 5*2*1", "Lut: 1",
        "Comment: x", "Name: n", "File size (no of images): 2", "junk",
        "Scale (x,y): 1,1", "Date: today", "Image size (x*y): 2.5*2"]


@pytest.mark.parametrize("seed", range(3))
def test_random_im_headers_as_pil(seed, tmp_path):
    """Seeded IM headers drawn from tags, unknown types, bad sizes and a
    line that is not ``key: value``, over random data of random length:
    read, handed on or refused as PIL does."""
    rng = np.random.default_rng([21, seed])
    for i in range(60):
        lines = [KEYS[k] for k in rng.integers(0, len(KEYS),
                                               int(rng.integers(1, 5)))]
        data = rng.integers(0, 256, int(rng.integers(0, 900)),
                            np.uint8).tobytes()
        p = tmp_path / f"{i}.im"
        p.write_bytes(mk.im_file(lines, data, pad=bool(rng.random() < 0.5),
                                 crlf=bool(rng.random() < 0.5)))
        fc.check_as_pil(str(p))


def test_grey_lut_changes_nothing_pil_shows():
    """A grey LUT that is not the ramp is kept aside by PIL: the pixels
    read as stored, mode L, no palette."""
    arr, mode, info = image.read_image_like_pil(rs.path("im", "grey_lut"))
    assert mode == "L" and "palette" not in info
    with Image.open(rs.path("im", "grey_lut")) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))
