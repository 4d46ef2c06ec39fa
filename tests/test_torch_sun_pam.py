"""Sun rasters and PAM: the port's SUN reader (irgs_tpu_torch/utils/sun.py)
against PIL's SunImagePlugin, and the ``.hdr`` path's Sun raster and PAM
decoders (utils/imread.py) against ``cv2.imread(path, IMREAD_UNCHANGED)``.
The two libraries decode Sun rasters differently (OpenCV: types 0 and 1
only, no RLE, grey data without a colour map read as 0, XBGR at 32 bits),
so each path is held against its own library: every committed fixture of
tests/data/sun/ (raw and RLE at depths 1, 4, 8, 24 and 32, colour maps,
type 3, runs across rows and a run of 256 across one) and tests/data/sun/
cv2/ (cv2's own writes and hand-made files), the refused streams, damaged
copies, and seeded random files of each kind through both. Tolerance:
none (bit for bit)."""

import json
import os
import struct
import warnings

import cv2
import numpy as np
import pytest

import fixture_checks as fc
import image_streams as ims
import make_im_sun_xpm_fli_fixtures as mk
import raster_suite as rs
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils.imread import imread_unchanged
from test_torch_mis import one_torch_thread  # noqa: F401

CASES = rs.cases(["sun"])
REFUSED = rs.refused_cases(["sun"])
CV2 = os.path.join(fc.DATA, "sun", "cv2")
with open(os.path.join(CV2, "cv2.json")) as _f:
    CV2_FILES = sorted(json.load(_f))


def test_fixture_set_is_complete():
    rs.check_set_is_complete("sun")
    assert CV2_FILES == sorted(n for n, _ in mk.cv2_files())


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


def _random_sun(rng):
    depth = int(rng.choice([1, 4, 8, 24, 32]))
    ftype = int(rng.choice([0, 1, 2, 3, 4, 5]))
    cmap = b""
    if depth <= 8 and rng.random() < 0.5:
        cmap = rng.integers(0, 256, int(rng.integers(3, 100)),
                            np.uint8).tobytes()
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
    if ftype == 2:
        out = bytearray()
        while len(out) < int(rng.integers(10, 3000)):
            k = rng.integers(0, 4)
            if k == 0:
                out += bytes([0x80, int(rng.integers(1, 256)),
                              int(rng.integers(0, 256))])
            elif k == 1:
                out += b"\x80\x00"
            else:
                out += bytes(int(v) for v in rng.integers(0, 256, 3)
                             if v != 0x80)
        data = bytes(out)
    else:
        data = rng.integers(0, 256, int(rng.integers(10, 6000)),
                            np.uint8).tobytes()
    return ims.write_sun(w, h, depth, data, ftype, cmap)


@pytest.mark.parametrize("seed", range(4))
def test_random_sun_as_pil(seed, tmp_path):
    """Seeded random Sun rasters (every depth and type, colour maps of any
    length, RLE with runs, escapes and literals) and damaged copies: read
    as PIL reads them or refused where PIL refuses them."""
    rng = np.random.default_rng([21, seed])
    decoded = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(40):
            f = _random_sun(rng)
            for j, d in enumerate([f] + fc.damaged(f, rng, 2)):
                p = tmp_path / f"{i}_{j}.ras"
                p.write_bytes(d)
                decoded += fc.check_as_pil(str(p))
    assert decoded > 40


@pytest.mark.parametrize("name", CV2_FILES)
def test_cv2_fixture_equals_cv2(name):
    """A committed Sun raster or PAM named .hdr: the port's decoder equals
    the array cv2 gave when it was written, cv2 now, and the JAX loader."""
    p = os.path.join(CV2, name + ".hdr")
    got = imread_unchanged(p)
    want = np.load(os.path.join(CV2, name + ".npy"))
    now = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    for w in (want, now):
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(tds._load_image_any(p),
                                  jds._load_image_any(p))


def test_cv2_reads_grey_sun_raster_as_zero():
    """OpenCV reads an 8-bit Sun raster without a colour map as zeros (its
    grey palette is left unset): so does the port, on cv2's own write."""
    got = imread_unchanged(os.path.join(CV2, "cv2_grey_reads_zero_ras.hdr"))
    assert got.shape == (mk.H, mk.W) and not got.any()


def _random_cv2(rng):
    if rng.random() < 0.5:
        depth = int(rng.choice([1, 8, 24, 32, 4]))
        ftype = int(rng.choice([0, 1, 1, 2, 3]))
        nmap = 0 if depth > 8 or rng.random() < 0.4 else int(
            rng.integers(1, (1 << depth) * 3 + 2))
        cmap = rng.integers(0, 256, nmap, np.uint8).tobytes()
        if nmap and rng.random() < 0.3:
            v = rng.integers(0, 256, nmap // 3, np.uint8)
            cmap = (bytes(np.concatenate([v, v, v]))
                    + bytes(nmap - 3 * (nmap // 3)))
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 8))
        return ims.write_sun(w, h, depth, rng.integers(
            0, 256, int(rng.integers(0, 4000)), np.uint8).tobytes(), ftype,
            cmap)
    cn = int(rng.integers(1, 5))
    maxval = int(rng.choice([1, 255, 100, 1000, 65535, 300]))
    tupl = str(rng.choice(["", "GRAYSCALE", "RGB", "RGB_ALPHA",
                           "GRAYSCALE_ALPHA", "BLACKANDWHITE"]))
    w, h = int(rng.integers(1, 20)), int(rng.integers(1, 6))
    fields = [f"WIDTH {w}", f"HEIGHT {h}", f"DEPTH {cn}", f"MAXVAL {maxval}"]
    if tupl:
        fields.append(f"TUPLTYPE {tupl}")
    rng.shuffle(fields)
    head = ("P7\n" + "".join(f + "\n" for f in fields) + "ENDHDR\n").encode()
    return head + rng.integers(0, 256, int(rng.integers(
        0, w * h * cn * 2 + 10)), np.uint8).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_random_sun_and_pam_as_cv2(seed, tmp_path):
    """Seeded random Sun rasters and PAM files (and damaged copies of
    each, the header's bytes most of all) named .hdr: the port's array
    equals cv2.imread's bit for bit, and the port raises OSError where
    cv2 gives None (or raises)."""
    rng = np.random.default_rng([22, seed])
    read = 0
    for i in range(60):
        f = _random_cv2(rng)
        for j, d in enumerate([f] + fc.damaged(f, rng, 2, head=48)):
            p = str(tmp_path / f"{i}_{j}.hdr")
            with open(p, "wb") as fh:
                fh.write(d)
            try:
                want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            except cv2.error:
                with pytest.raises((OSError, ValueError)):
                    imread_unchanged(p)
                continue
            if want is None:
                with pytest.raises(OSError):
                    imread_unchanged(p)
                continue
            got = imread_unchanged(p)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            read += 1
    assert read > 20


def test_pam_header_edges_as_cv2(tmp_path):
    """PAM headers at the edges of OpenCV's line reader: comments, blank
    lines, CR line ends, a value after ENDHDR, a TUPLTYPE with trailing
    spaces or none, leading zeros; and ones it refuses: a second WIDTH, a
    sign or trailing text on a number, an identifier of more than 8
    characters, a value on the next line."""
    ok = [b"P7\n# c\n\n  WIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
          b"P7\rWIDTH 3\rHEIGHT 1\rDEPTH 1\rMAXVAL 255\rENDHDR\r",
          b"P7\nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR x\n",
          b"P7\nWIDTH 003\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
          b"TUPLTYPE GRAYSCALE  \nENDHDR\n",
          b"P7\nTUPLTYPE\nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 9\nENDHDR\n"]
    bad = [b"P7\nWIDTH 3\nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           b"P7\nWIDTH +3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           b"P7\nWIDTH 3a\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           b"P7\nWIDTHWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           b"P7\nWIDTH\n3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           b"P7 \nWIDTH 3\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n"]
    for k, head in enumerate(ok + bad):
        p = str(tmp_path / f"{k}.hdr")
        with open(p, "wb") as f:
            f.write(head + bytes(range(7, 40)))
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert (want is not None) == (k < len(ok))
        if want is None:
            with pytest.raises(OSError):
                imread_unchanged(p)
        else:
            np.testing.assert_array_equal(imread_unchanged(p), want)


def test_sun_header_fields_are_big_endian_words():
    """The 32-byte header the fixtures' writer makes is what both readers
    parse: magic, size, depth, length, type, map type, map length."""
    data = ims.write_sun(5, 3, 8, bytes(16), 2, b"abc")
    assert struct.unpack_from(">8I", data) == (0x59A66A95, 5, 3, 8, 16, 2,
                                               1, 3)
