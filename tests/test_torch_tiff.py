"""The port's TIFF reader (irgs_tpu_torch/utils/tiff.py) against PIL, bit
for bit: every committed fixture of tests/data/tiff/ (array, mode, palette,
as tests/make_tiff_fixtures.py recorded them, and as PIL reads them now,
with ``convert("RGB")``), every refused stream raising TiffError (and the
ones PIL reads that are not ported naming themselves so), the fixture set
against the generator, a 1297x840 RGB frame at each compression, and the
JAX package's ``_load_image_any`` on a handful of the files."""

import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import image_streams as ims
import make_tiff_fixtures as mk
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import tiff

FMT, EXT = "tiff", ".tif"
NAMES = sorted(fc.modes(FMT))


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    assert names == NAMES == sorted(n for n, _ in mk.variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in mk.refused())


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
                                  "deflate"])
def test_full_size_frame_equals_pil(comp):
    """A 1297x840 RGB frame in strips of 8 rows, predictor 2 where the
    codec takes one."""
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 8, (840, 1297, 3)) * 32).astype(np.uint8)
    img[:, 600:] = img[:, 600:601]
    pred = 2 if comp in ("lzw", "adobe_deflate", "deflate") else 1
    data = ims.write_tiff(img, photometric=2, bits=8, compression=comp,
                          predictor=pred, layout=("strips", 8))
    arr, mode, _ = tiff.decode_tiff(data)
    assert mode == "RGB"
    np.testing.assert_array_equal(arr, np.asarray(Image.open(io.BytesIO(data))))
    np.testing.assert_array_equal(arr, img)


@pytest.mark.parametrize("name", ["grey16_lzw_mm", "rgba_associated",
                                  "palette4", "float32", "bw_minwhite",
                                  "grey16_signed_lzw_mm", "orientation6"])
def test_load_image_any_matches_jax(name):
    path = os.path.join(fc.DATA, FMT, name + EXT)
    want = jds._load_image_any(path)
    got = tds._load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
