"""The port's GIF reader (irgs_tpu_torch/utils/gif.py) against PIL, bit for
bit: every committed fixture of tests/data/gif/ (indices, mode, palette and
transparency, as tests/make_gif_fixtures.py recorded them, and as PIL
reads them now, with ``convert("RGB")``), every refused stream raising
GifError, the fixture set against the generator, a 1297x840 frame, and
the JAX package's ``_load_image_any`` on a handful of the files."""

import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import image_streams as ims
import make_gif_fixtures as mk
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import gif

FMT, EXT = "gif", ".gif"
NAMES = sorted(fc.modes(FMT))


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    assert names == NAMES == sorted(n for n, _ in mk.variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in mk.refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, gif.read_gif_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    with pytest.raises(gif.GifError):
        gif.read_gif_like_pil(os.path.join(fc.DATA, FMT, "refused",
                                           name + EXT))


def test_full_size_frame_equals_pil():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 256, (840, 1297)).astype(np.uint8)
    idx[:400] //= 16
    data = ims.write_gif(idx, global_palette=rng.integers(0, 256, (256, 3)),
                         interlace=True)
    arr, mode, _ = gif.decode_gif(data)
    assert mode == "P"
    np.testing.assert_array_equal(arr, idx)
    np.testing.assert_array_equal(arr, np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("name", ["global8", "offset_transparent",
                                  "grey_ramp", "animated"])
def test_load_image_any_matches_jax(name):
    path = os.path.join(fc.DATA, FMT, name + EXT)
    want = jds._load_image_any(path)
    got = tds._load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
