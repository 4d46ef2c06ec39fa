"""XBM, XPM and MSP as PIL reads them: the port's readers
(irgs_tpu_torch/utils/xbm.py, xpm.py, msp.py) against Pillow's
XbmImagePlugin, XpmImagePlugin (with its Python XpmDecoder) and
MspImagePlugin (with its Python MspDecoder), bit for bit: every
committed fixture of tests/data/{xbm,xpm,msp}/ (Pillow's XBM and MSP
saves, hotspots, upper-case and odd hex digits; XPM palettes of one and
two characters a pixel, an unused transparent key, more than 256 colours,
rows split unaligned; MSP version 2 RLE with empty rows and a row longer
than a row), array, mode, palette, ``info`` (hotspot, transparency),
``convert("RGB")`` and ``im.format``; the refused streams refused;
damaged copies read or refused as PIL does; seeded random XPM files.
Tolerance: none."""

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_im_sun_xpm_fli_fixtures as mk
import raster_suite as rs
from irgs_tpu_torch.utils import image
from test_torch_mis import one_torch_thread  # noqa: F401

FMTS = ["xbm", "xpm", "msp"]
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


@pytest.mark.parametrize("fmt,name,key", [
    ("xbm", "pil_save_hotspot", "hotspot"),
    ("xpm", "p_unused_none_key", "transparency")])
def test_info_equals_pil(fmt, name, key):
    _, _, info = image.read_image_like_pil(rs.path(fmt, name))
    with Image.open(rs.path(fmt, name)) as im:
        assert info[key] == im.info[key]


@pytest.mark.parametrize("seed", range(3))
def test_random_xpm_as_pil(seed, tmp_path):
    """Seeded XPM files: 1 to 3 characters a pixel, palettes of 1 to 300
    colours (some keys unused, a None key), rows that carry more or fewer
    pixels than the width, and cut copies."""
    rng = np.random.default_rng([23, seed])
    alphabet = b"abcdefghijklmnopqrstuvwxyz0123456789"
    for i in range(12):
        cpp = int(rng.integers(1, 4))
        n = int(rng.integers(1, min(300, len(alphabet) ** cpp)))
        keys = sorted({bytes(alphabet[int(k)] for k in rng.integers(
            0, len(alphabet), cpp)) for _ in range(n)})
        colours = [(k, b"#%06x" % int(rng.integers(0, 1 << 24)))
                   for k in keys]
        if rng.random() < 0.3:
            colours.append((b"~" * cpp, b"None"))
        w, h = int(rng.integers(1, 12)), int(rng.integers(1, 6))
        rows = [b"".join(keys[int(k)] for k in rng.integers(
            0, len(keys), w + int(rng.integers(-1, 2)) * (rng.random() < .2)))
            for _ in range(h)]
        data = mk.xpm_file(w, h, colours, rows, cpp)
        for j, d in enumerate((data, data[:int(rng.integers(9, len(data)))])):
            p = tmp_path / f"{i}_{j}.xpm"
            p.write_bytes(d)
            fc.check_as_pil(str(p))
