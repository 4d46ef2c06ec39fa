"""The port's icon, cursor and DIB readers (irgs_tpu_torch/utils/ico.py,
bmp.py) against PIL, bit for bit: every committed fixture of tests/data/ico/
(ICO with DIB and PNG frames, CUR, bare DIBs; array, mode, palette, as
tests/make_small_fixtures.py recorded them, and as PIL reads them now, with
``convert("RGB")``), every refused stream refused, and 8 seeded damaged
copies of each fixture through the content-sniffing reader, each decoded to
PIL's answer or refused where PIL refuses it (PIL's plugins tried in a fresh
process's order)."""

import glob
import os

import pytest

import fixture_checks as fc
import make_small_fixtures as mk
from irgs_tpu_torch.utils import image, ico, bmp, png
from test_torch_mis import one_torch_thread  # noqa: F401

FMT, EXT = "ico", ".ico"
NAMES = sorted(fc.modes(FMT))
ERRORS = (ico.IcoError, bmp.BmpError, png.PngError, image.NotThisFormat,
                        image.UnreadableImageError)


def _read(path):
    """The fixture's own reader: ICO, CUR or DIB by its name."""
    name = os.path.basename(path)
    read = (ico.read_cur_like_pil if name.startswith("cur_") else
            bmp.read_dib_like_pil if name.startswith("dib_") else
            ico.read_ico_like_pil)
    return read(path)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    variants, refused = mk.VARIANTS[FMT]
    assert names == NAMES == sorted(n for n, _ in variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, _read)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    path = os.path.join(fc.DATA, FMT, "refused", name + EXT)
    with pytest.raises(ERRORS):
        _read(path)
    assert not fc.check_as_pil(path)


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_pil(name, tmp_path):
    fc.check_damaged(FMT, EXT, name, tmp_path, n=8)
