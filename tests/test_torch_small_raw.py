"""PIXAR, GBR, McIdas, IMT, XV thumbnails and IPTC as PIL reads them: the
port's readers (irgs_tpu_torch/utils/pixar.py, gbr.py, mcidas.py,
imt.py, xvthumb.py, iptc.py) against Pillow's plugins, bit for bit:
every committed fixture of tests/data/{pixar,gbr,mcidas,imt,xvthumb,
iptc}/ (GBR versions 1 and 2 in L and RGBA; McIdas L, I;16B and I;32B
with a prefix and a stride; IPTC raw grey, one band of an RGB and of a
CMYK image, JPEG), array, mode, palette, ``info`` (comment, spacing),
``convert("RGB")`` and ``im.format``; the refused streams refused;
damaged copies read or refused as PIL does. Then the whole committed
corpus of tests/data/ (every format's fixtures): the plugin the port's
dispatcher picks is PIL's ``im.format`` for every file, now that the
plugins without a prefix check (IM, IMT, IPTC, PCD, SPIDER) run their
whole _open. Tolerance: none."""

import glob
import json
import os

import pytest
from PIL import Image

import fixture_checks as fc
import raster_suite as rs
from irgs_tpu_torch.utils import image
from test_torch_mis import one_torch_thread  # noqa: F401

FMTS = ["pixar", "gbr", "mcidas", "imt", "xvthumb", "iptc"]
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


@pytest.mark.parametrize("name", ["v1_grey", "v2_rgba"])
def test_gbr_info_equals_pil(name):
    _, _, info = image.read_image_like_pil(rs.path("gbr", name))
    with Image.open(rs.path("gbr", name)) as im:
        for key in ("comment", "spacing"):
            assert info.get(key) == im.info.get(key)


def _folders():
    return sorted(os.path.basename(os.path.dirname(p)) for p in glob.glob(
        os.path.join(fc.DATA, "*", "modes.json")))


@pytest.mark.parametrize("folder", _folders())
def test_corpus_format_is_pils(folder):
    """Every committed fixture of tests/data/<folder>/: the port's
    dispatcher takes it with PIL's plugin (``im.format`` of a fresh
    process's open)."""
    with open(os.path.join(fc.DATA, folder, "modes.json")) as f:
        names = json.load(f)
    files = [p for p in glob.glob(os.path.join(fc.DATA, folder, "*"))
             if os.path.isfile(p) and not p.endswith((".npy", ".json"))]
    assert len(files) == len(names)
    for path in files:
        with Image.open(path, formats=fc.fresh_order()) as im:
            want = im.format
        assert image.format_like_pil(path) == want, path
