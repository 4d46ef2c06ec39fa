"""The checks every reader of Pillow's last small rasters goes through
(tests/test_torch_{sun_pam,im_spider_fits,xbm_xpm_msp,fli_pcd_dcx,
small_raw}.py): each committed fixture of tests/data/<fmt>/
(tests/make_im_sun_xpm_fli_fixtures.py) against the array (PhotoCD: its
SHA-256), mode, palette and transparency PIL gave when it was written
and against PIL now (with ``convert("RGB")`` and PIL's ``im.format``),
each refused stream refused, and seeded damaged copies of each fixture
read or refused as PIL reads or refuses them, its plugins in a fresh
process's order."""

from __future__ import annotations

import glob
import hashlib
import json
import os
import warnings

import fixture_checks as fc
import make_im_sun_xpm_fli_fixtures as mk
from irgs_tpu_torch.utils import image


def cases(fmts):
    return [(fmt, name) for fmt in fmts for name in sorted(fc.modes(fmt))]


def refused_cases(fmts):
    return [(fmt, name) for fmt in fmts for name in sorted(fc.refused(fmt))]


def path(fmt, name, refused=False):
    return os.path.join(fc.DATA, fmt, "refused" if refused else "",
                        name + mk.FORMATS[fmt])


def check_set_is_complete(fmt):
    ext = mk.FORMATS[fmt]
    names = sorted(os.path.basename(p)[:-len(ext)] for p in glob.glob(
        os.path.join(fc.DATA, fmt, "*" + ext)))
    variants, refused = mk.VARIANTS[fmt]
    assert names == sorted(fc.modes(fmt)) == sorted(n for n, _ in variants())
    assert sorted(fc.refused(fmt)) == sorted(n for n, _, _ in refused())


def check_fixture(fmt, name):
    if fmt != "pcd":
        fc.check_fixture(fmt, mk.FORMATS[fmt], name,
                         image.read_image_like_pil)
        return
    # the PhotoCD arrays (768x512) are kept as PIL's SHA-256
    with open(os.path.join(fc.DATA, "pcd", "large.json")) as f:
        want = json.load(f)[name]
    arr, mode, _ = image.read_image_like_pil(path(fmt, name))
    assert mode == want["mode"] and list(arr.shape) == want["shape"]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]


def check_fixture_now(fmt, name):
    fc.check_fixture_against_pil(fmt, mk.FORMATS[fmt], name)
    p = path(fmt, name)
    assert image.format_like_pil(p) == fc.pil_fresh(p)[4]


def check_refused(fmt, name):
    p = path(fmt, name, True)
    try:
        image.read_image_like_pil(p)
    except ValueError:
        pass
    else:
        raise AssertionError(f"{p}: the port reads it")
    assert not fc.check_as_pil(p)


def check_damaged(fmt, name, tmp_path, n=8):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fc.check_damaged(fmt, mk.FORMATS[fmt], name, tmp_path, n=n)
