"""Checks shared by the image reader tests: a committed fixture of
tests/data/<fmt>/ (tests/make_<fmt>_fixtures.py) against the array, mode,
palette and transparency PIL gave when it was written, and against PIL
now; a refused stream against the reader's own error; ``convert("RGB")``
(utils/image.to_rgb_like_pil) against PIL's; and any file, damaged ones
too, through the content-sniffing reader against PIL with its plugins in
a fresh process's order."""

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
    t = info.get("transparency")
    assert (list(t) if isinstance(t, bytes) else t) == want["transparency"]
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
    # convert loads the image first (ICNS: its pixels, not np.asarray's)
    np.testing.assert_array_equal(image.to_rgb_like_pil(
        info.get("loaded", arr), mode, info.get("palette")), rgb)


def fresh_order() -> list:
    """The formats in the order ``Image.open`` tries them in a fresh
    process: Image.preinit's plugins, then the rest of Image.OPEN."""
    Image.init()
    first = ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG"]
    return first + [f for f in Image.OPEN if f not in first]


def pil_fresh(path: str):
    """(array, mode, palette, convert("RGB") or None) of PIL's read of
    `path`, its plugins tried in the fresh-process order; raises where PIL
    raises."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(path, formats=fresh_order()) as im:
            arr, mode = np.asarray(im), im.mode
            pal = im.getpalette() if mode in ("P", "PA") else None
            try:
                rgb = np.asarray(im.convert("RGB"))
            except (ValueError, OSError):
                rgb = None
            return arr, mode, pal, rgb, im.format


def check_as_pil(path: str) -> bool:
    """The content-sniffing reader on `path` against PIL in the
    fresh-process order: both raise (the port may name a format PIL reads
    and the port does not), or array, mode, palette and convert("RGB")
    are equal. Returns whether PIL decoded it."""
    try:
        want = pil_fresh(path)
    except Exception:
        try:
            image.read_image_like_pil(path)
        except ValueError:
            return False
        raise AssertionError(f"{path}: PIL refuses it, the port reads it")
    try:
        arr, mode, info = image.read_image_like_pil(path)
    except image.UnreadableImageError as e:
        if f"{want[4]} is not ported" in str(e):
            return True
        raise
    assert mode == want[1], (mode, want[1])
    assert arr.dtype == want[0].dtype and arr.shape == want[0].shape
    np.testing.assert_array_equal(arr, want[0])
    if want[2] is not None:
        np.testing.assert_array_equal(np.asarray(info["palette"]).reshape(
            -1, 3), np.asarray(want[2]).reshape(-1, 3))
    if want[3] is not None and mode != "LAB":  # PIL converts LAB; the port
        np.testing.assert_array_equal(image.to_rgb_like_pil(  # does not
            info.get("loaded", arr), mode, info.get("palette")), want[3])
    return True


def damaged(data: bytes, rng, n: int, head: int = 64) -> list:
    """n seeded damaged copies of `data`: a cut at a random length, or one
    to three bit flips, half of them in the first `head` bytes."""
    out = []
    for _ in range(n):
        d = bytearray(data)
        k = int(rng.integers(0, 4))
        if k == 0:
            d = d[:int(rng.integers(0, len(d)))]
        else:
            for _ in range(k):
                lim = min(head, len(d)) if rng.random() < 0.5 else len(d)
                d[int(rng.integers(0, lim))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(d))
    return out


def check_damaged(fmt: str, ext: str, name: str, tmp_path, n: int = 8,
                  seed: int = 0) -> int:
    """`n` damaged copies of the fixture `name` through `check_as_pil`;
    returns how many PIL decoded."""
    with open(os.path.join(DATA, fmt, name + ext), "rb") as f:
        data = f.read()
    rng = np.random.default_rng([seed, sorted(modes(fmt)).index(name)])
    decoded = 0
    for i, d in enumerate(damaged(data, rng, n)):
        path = tmp_path / f"{i}{ext}"
        path.write_bytes(d)
        decoded += check_as_pil(str(path))
    return decoded
