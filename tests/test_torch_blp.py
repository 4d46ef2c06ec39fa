"""The port's BLP reader (irgs_tpu_torch/utils/blp.py) against PIL, bit
for bit: every committed fixture of tests/data/blp/ (Pillow's BLP1 and
BLP2 palette saves; BLP1 JPEG in colour, grey and CMYK, with bytes
skipped before the mipmap, with the alpha flag, under a header smaller
than the JPEG; BLP1 palettes with and without alpha; BLP2 DXT1/3/5 with
and without alpha at 16x8 and at 13x9, whose rows PIL shears; BLP2
palettes; as tests/make_texture_fixtures.py recorded PIL's arrays, and
as PIL reads them now, with ``convert("RGB")``), every refused stream
refused, seeded damaged copies of each fixture read as PIL reads them or
refused where PIL refuses them, and BlpImagePlugin's own DXT decoders
against libImaging's on the same blocks: they differ (5:6:5 shifted, not
widened), and each path follows its own. Tolerance: none."""

import glob
import io
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_texture_fixtures as mk
from irgs_tpu_torch.utils import bcn, blp, image
from test_torch_mis import one_torch_thread  # noqa: F401

FMT, EXT = "blp", ".blp"
NAMES = sorted(fc.modes(FMT))
ERRORS = (blp.BlpError, image.NotThisFormat, image.UnreadableImageError)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    variants, refused = mk.VARIANTS[FMT]
    assert names == NAMES == sorted(n for n, _ in variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, blp.read_blp_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    path = os.path.join(fc.DATA, FMT, "refused", name + EXT)
    with pytest.raises(ERRORS):
        blp.read_blp_like_pil(path)
    assert not fc.check_as_pil(path)


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_pil(name, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fc.check_damaged(FMT, EXT, name, tmp_path, n=8)


@pytest.mark.parametrize("alpha_encoding,n,size", [(0, 1, 8), (1, 2, 16),
                                                   (7, 3, 16)])
def test_blp_dxt_decoders_equal_pil(alpha_encoding, n, size, tmp_path):
    """512 seeded random blocks through BlpImagePlugin's decode_dxt1/3/5
    (Python) and through the port's BLP path; the same blocks through
    libImaging's "bcn" (a DDS) and the port's DDS path; and the two
    decoders differ on them, as their 5:6:5 widening differs."""
    rng = np.random.default_rng(alpha_encoding)
    data = rng.integers(0, 256, 512 * size, np.uint8).tobytes()
    w, h = 64, 32
    path = tmp_path / "a.blp"
    path.write_bytes(mk.blp2(w, h, 2, 1, alpha_encoding, b"\0" * 1024, data))
    got = blp.read_blp_like_pil(str(path))[0]
    with Image.open(path) as im:
        want_blp = np.asarray(im)
    np.testing.assert_array_equal(got, want_blp)
    fourcc = {1: b"DXT1", 2: b"DXT3", 3: b"DXT5"}[n]
    dds_path = tmp_path / "a.dds"
    import image_streams as ims
    dds_path.write_bytes(ims.write_dds(w, h, data, fourcc=fourcc))
    with Image.open(dds_path) as im:
        want_bcn = np.asarray(im)
    np.testing.assert_array_equal(image.read_image_like_pil(
        str(dds_path))[0], want_bcn)
    assert not np.array_equal(want_blp, want_bcn)
    # the plugin's own function, row by row, on the first block row
    # (imported after Image.init, which registers the plugins in
    # Image.OPEN's order: an early import would move BLP to the front)
    Image.init()
    from PIL import BlpImagePlugin
    fn = {1: BlpImagePlugin.decode_dxt1, 2: BlpImagePlugin.decode_dxt3,
          3: BlpImagePlugin.decode_dxt5}[n]
    rows = fn(data[:16 * size], True) if n == 1 else fn(data[:16 * size])
    want_rows = np.frombuffer(b"".join(rows), np.uint8).reshape(4, w, 4)
    np.testing.assert_array_equal(
        bcn.decode_blp_dxt(data[:16 * size], n, 16, 1), want_rows)


def test_blp1_jpeg_swaps_red_and_blue(tmp_path):
    """A colour BLP1 JPEG reads as the JPEG with red and blue traded, in
    PIL and in the port."""
    rgb = mk.photo(16, 24, 30)
    jpg = mk.pil_save(rgb, "JPEG", quality=95)
    path = tmp_path / "c.blp"
    path.write_bytes(mk.blp1_jpeg(jpg, 24, 16))
    decoded = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    got = blp.read_blp_like_pil(str(path))[0]
    np.testing.assert_array_equal(got, decoded[..., ::-1])
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im))


def test_header_cut_hands_on(tmp_path):
    """A BLP header cut before its size is the next plugin's turn: no
    other plugin takes it, so both refuse it as unidentified."""
    data = mk.blp1(8, 8, 1, 4, 0, b"")[:20]
    path = tmp_path / "cut.blp"
    path.write_bytes(data)
    with pytest.raises(image.UnreadableImageError, match="cannot identify"):
        image.read_image_like_pil(str(path))
    assert not fc.check_as_pil(str(path))
    assert struct.unpack_from("<4s", data)[0] == b"BLP1"
