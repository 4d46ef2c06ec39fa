"""The port's PCX reader (irgs_tpu_torch/utils/pcx.py) against PIL, bit for
bit: every committed fixture of tests/data/pcx/ (1 bit in 1, 2 and 4 planes,
8-bit grey and palette, planar RGB; array, mode, palette, as
tests/make_small_fixtures.py recorded them, and as PIL reads them now, with
``convert("RGB")``), every refused stream refused, and 9 seeded damaged
copies of each fixture through the content-sniffing reader, each decoded to
PIL's answer or refused where PIL refuses it (PIL's plugins tried in a fresh
process's order)."""

import glob
import os

import pytest

import fixture_checks as fc
import make_small_fixtures as mk
from irgs_tpu_torch.utils import image, pcx
from test_torch_mis import one_torch_thread  # noqa: F401

FMT, EXT = "pcx", ".pcx"
NAMES = sorted(fc.modes(FMT))
ERRORS = (pcx.PcxError, image.NotThisFormat,
                        image.UnreadableImageError)


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    variants, refused = mk.VARIANTS[FMT]
    assert names == NAMES == sorted(n for n, _ in variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in refused())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, pcx.read_pcx_like_pil)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    path = os.path.join(fc.DATA, FMT, "refused", name + EXT)
    with pytest.raises(ERRORS):
        pcx.read_pcx_like_pil(path)
    assert not fc.check_as_pil(path)


@pytest.mark.parametrize("name", NAMES)
def test_damaged_streams_as_pil(name, tmp_path):
    fc.check_damaged(FMT, EXT, name, tmp_path, n=9)
