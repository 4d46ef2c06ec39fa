"""FLI/FLC, PhotoCD and DCX as PIL reads them, and the COLMAP capture of
IM, Sun, XPM and FLI frames: the port's readers
(irgs_tpu_torch/utils/fli.py, pcd.py, dcx.py) against Pillow's
FliImagePlugin (with FliDecode.c), PcdImagePlugin (PcdDecode.c and
UnpackYCC.c) and DcxImagePlugin, bit for bit: every committed fixture of
tests/data/{fli,pcd,dcx}/ (BRUN, COPY, BLACK, LC, SS2 and PSTAMP chunks,
COLOR_256 and COLOR_64 palettes of partial packets over PIL's grey ramp,
both magics; the 768x512 base image at two orientations; PCX frames of
each mode in a DCX table), array, mode, palette, ``convert("RGB")`` and
``im.format``; the refused streams refused (a cut frame, an unknown
chunk, a prefix chunk, which PIL's load decodes as the frame); damaged
copies read or refused as PIL does; the PhotoYCC tables against PIL's
YCC;P unpacker on seeded samples; and tests/data/im_sun_xpm_fli/colmap
through the JAX loaders and the port's, bit for bit. Tolerance: none."""

import os

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_im_sun_xpm_fli_fixtures as mk
import raster_suite as rs
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import small_codecs
from test_torch_colmap import _assert_info_equal
from test_torch_mis import one_torch_thread  # noqa: F401

FMTS = ["fli", "pcd", "dcx"]
CASES = rs.cases(FMTS)
REFUSED = rs.refused_cases(FMTS)
CAPTURE = os.path.join(fc.DATA, "im_sun_xpm_fli", "colmap")


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
    rs.check_damaged(fmt, name, tmp_path, n=4 if fmt == "pcd" else 8)


def test_photoycc_tables_as_pil():
    """PcdDecode's PhotoYCC conversion (csrc/small_decode.cpp) against
    PIL's YCC;P unpacker: two luma rows over one chroma row pair, on
    seeded samples and every (Cb, Cr) pair."""
    rng = np.random.default_rng(9)
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    luma = rng.integers(0, 256, (2, 65536), np.uint8)
    # PcdDecode reads chroma x at (x + 4w) / 2 and (x + 5w) / 2: pair x
    # with column x // 2 of each chroma plane
    cbp = np.repeat(cb.ravel().astype(np.uint8), 2)[:65536]
    crp = np.repeat(cr.ravel().astype(np.uint8), 2)[:65536]
    w = 65536
    stream = (luma[0].tobytes() + luma[1].tobytes() + cbp[::2].tobytes()
              + crp[::2].tobytes())
    got = small_codecs.pcd(stream, w, 2)
    for row in range(2):
        ycc = np.stack([luma[row], cbp, crp], -1)
        want = np.asarray(Image.frombytes("RGB", (w, 1), ycc.tobytes(),
                                          "raw", "YCC;P"))[0]
        np.testing.assert_array_equal(got[row], want)


def test_capture_is_complete():
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.CAPTURE_FRAMES)


def test_load_scene_capture_matches_jax():
    """The COLMAP capture of an RGB IM (Pillow's encoder), a 24-bit RLE
    Sun raster, a P XPM and an FLI BRUN frame: the JAX loaders against the
    port's, bit for bit."""
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    _assert_info_equal(jcolmap.read_colmap_scene(CAPTURE),
                       tcolmap.read_colmap_scene(CAPTURE))
