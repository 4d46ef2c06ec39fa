"""Checks shared by the TIFF, BMP and GIF reader tests: a committed fixture
of tests/data/<fmt>/ (tests/make_<fmt>_fixtures.py) against the array,
mode, palette and transparency PIL gave when it was written, and against
PIL now; a refused stream against the reader's own error; and
``convert("RGB")`` (utils/image.to_rgb_like_pil) against PIL's."""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from irgs_tpu_torch.utils import image

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def modes(fmt: str) -> dict:
    with open(os.path.join(DATA, fmt, "modes.json")) as f:
        return json.load(f)


def refused(fmt: str) -> dict:
    with open(os.path.join(DATA, fmt, "refused", "refused.json")) as f:
        return json.load(f)


def check_fixture(fmt: str, ext: str, name: str, read) -> None:
    """The reader `read` on the fixture `name` equals PIL bit for bit:
    array (dtype, shape, values), mode, palette and transparency."""
    path = os.path.join(DATA, fmt, name + ext)
    want = modes(fmt)[name]
    arr, mode, info = read(path)
    npy = np.load(os.path.join(DATA, fmt, name + ".npy"))
    assert mode == want["mode"]
    assert arr.dtype == npy.dtype and arr.shape == npy.shape
    np.testing.assert_array_equal(arr, npy)
    if want["palette"] is not None and mode in ("P", "PA"):
        pal = np.asarray(want["palette"]).reshape(-1, 3)
        got = np.asarray(info["palette"])
        np.testing.assert_array_equal(got, pal[:len(got)])
    assert info.get("transparency") == want["transparency"]
    # the same file through the content-sniffing entry point
    arr2, mode2, _ = image.read_image_like_pil(path)
    assert mode2 == mode and np.array_equal(arr2, arr, equal_nan=True)


def check_fixture_against_pil(fmt: str, ext: str, name: str) -> None:
    """The fixture read now by PIL and by the port, array and
    ``convert("RGB")`` where PIL converts the mode."""
    path = os.path.join(DATA, fmt, name + ext)
    arr, mode, info = image.read_image_like_pil(path)
    with Image.open(path) as im:
        want = np.asarray(im)
        assert im.mode == mode
        np.testing.assert_array_equal(arr, want)
        if mode == "LAB":
            return                      # PIL converts it; the port does not
        rgb = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(
        image.to_rgb_like_pil(arr, mode, info.get("palette")), rgb)
