"""The port's QOI reader (irgs_tpu_torch/utils/qoi.py) against PIL, bit for
bit: every committed fixture of tests/data/qoi/ (PIL's saves and every op by
hand; array, mode, palette, as tests/make_small_fixtures.py recorded them,
and as PIL reads them now, with ``convert("RGB")``), every refused stream
refused, and 28 seeded damaged copies of each fixture through the content-
sniffing reader, each decoded to PIL's answer or refused where PIL refuses
it (PIL's plugins tried in a fresh process's order); and the JAX package's
Blender frame reader against the port's on QOI frames named .png."""

import glob
import os
import shutil

import numpy as np
import pytest

import fixture_checks as fc
import make_small_fixtures as mk
from irgs_tpu_torch.utils import image, qoi
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import datasets as tds
from test_torch_mis import one_torch_thread  # noqa: F401

FMT, EXT = "qoi", ".qoi"
NAMES = sorted(fc.modes(FMT))
ERRORS = (qoi.QoiError, image.NotThisFormat,
                        image.UnreadableImageError)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    variants, refused = mk.VARIANTS[FMT]
    assert names == NAMES == sorted(n for n, _ in variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, qoi.read_qoi_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    path = os.path.join(fc.DATA, FMT, "refused", name + EXT)
    with pytest.raises(ERRORS):
        qoi.read_qoi_like_pil(path)
    assert not fc.check_as_pil(path)


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_pil(name, tmp_path):
    fc.check_damaged(FMT, EXT, name, tmp_path, n=28)


@pytest.mark.parametrize("name", ["pil_RGBA", "pil_RGB_noise", "ops_rgba"])
def test_blender_frame_named_png_matches_jax(tmp_path, name):
    """A QOI frame named .png through the JAX Blender reader
    (np.asarray(Image.open(p)) / 255) and the port's."""
    path = tmp_path / "r_0.png"
    shutil.copy(os.path.join(fc.DATA, FMT, name + EXT), path)
    want = jds._load_image_any(str(path))
    got = tds._load_image_any(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
