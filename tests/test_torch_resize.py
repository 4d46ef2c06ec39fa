"""The port's cv2.resize (irgs_tpu_torch/utils/resize.py) against cv2 on
float32 and float64 images of 1 and 3 channels (and [H, W]): INTER_AREA at
an integer factor, a fractional factor and enlarging equal cv2 bit for bit;
INTER_LINEAR (IPP's arithmetic in cv2's default build) within 2e-7 on
[0, 1] data for float32 and 1e-12 for float64. Masks thresholded at 0.5
after either resize are equal."""

import cv2
import numpy as np
import pytest

from irgs_tpu_torch.utils import resize as R

LINEAR_ATOL = {np.float32: 2e-7, np.float64: 1e-12}

AREA_CASES = {
    "int_2x": (64, 48, 32, 24),
    "int_3x": (60, 45, 20, 15),
    "int_4x_2048_to_512": (2048, 32, 512, 8),
    "frac_1600_cap": (4946, 6, 1600, 1),
    "frac_600_to_400": (600, 450, 400, 300),
    "frac_odd": (100, 80, 37, 29),
    "frac_x_int_y": (99, 64, 40, 32),
    "enlarge": (37, 29, 64, 48),
    "enlarge_x_shrink_y": (30, 40, 45, 20),
}
LINEAR_CASES = {
    "enlarge_1p1": (100, 80, 110, 88),
    "enlarge_odd": (37, 29, 64, 48),
    "enlarge_large": (400, 300, 600, 450),
    "shrink_2x": (64, 48, 32, 24),
    "shrink_frac": (100, 80, 37, 29),
}
CHANNELS = {"hw": None, "hw1": 1, "hw3": 3}
DTYPES = {"f32": np.float32, "f64": np.float64}


def _image(sw, sh, ch, dt, seed):
    shape = (sh, sw) if ch is None else (sh, sw, ch)
    return np.random.RandomState(seed).rand(*shape).astype(dt)


def _cv2(x, dsize, interp):
    out = cv2.resize(x, dsize, interpolation=interp)
    return out.reshape(out.shape[:2] + x.shape[2:])   # cv2 drops a 1 channel


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("ch", sorted(CHANNELS))
@pytest.mark.parametrize("case", sorted(AREA_CASES))
def test_inter_area_bit_for_bit(case, ch, dt):
    sw, sh, dw, dh = AREA_CASES[case]
    x = _image(sw, sh, CHANNELS[ch], DTYPES[dt], seed=len(case))
    got = R.resize(x, (dw, dh), R.INTER_AREA)
    want = _cv2(x, (dw, dh), cv2.INTER_AREA)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("ch", sorted(CHANNELS))
@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_inter_linear_matches_cv2(case, ch, dt):
    sw, sh, dw, dh = LINEAR_CASES[case]
    x = _image(sw, sh, CHANNELS[ch], DTYPES[dt], seed=len(case))
    got = R.resize(x, (dw, dh), R.INTER_LINEAR)
    want = _cv2(x, (dw, dh), cv2.INTER_LINEAR)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LINEAR_ATOL[DTYPES[dt]],
                               rtol=0)


@pytest.mark.parametrize("interp", ["area", "linear"])
@pytest.mark.parametrize("case", ["frac_600_to_400", "enlarge"])
def test_thresholded_masks_equal(case, interp):
    sw, sh, dw, dh = AREA_CASES[case]
    yy, xx = np.mgrid[:sh, :sw]
    mask = (np.hypot(xx - sw / 2, yy - sh / 2) < 0.35 * min(sw, sh))
    mode = R.INTER_AREA if interp == "area" else R.INTER_LINEAR
    got = R.resize(mask.astype(np.float32), (dw, dh), mode) > 0.5
    want = cv2.resize(mask.astype(np.float32), (dw, dh),
                      interpolation=mode) > 0.5
    np.testing.assert_array_equal(got, want)


def test_same_size_is_a_copy():
    x = _image(7, 5, 3, np.float32, 0)
    y = R.resize(x, (7, 5), R.INTER_AREA)
    np.testing.assert_array_equal(y, x)
    assert y is not x
    with pytest.raises(TypeError):
        R.resize(x.astype(np.uint8), (3, 3), R.INTER_AREA)


# --- PIL's Image.resize(..., LANCZOS) -------------------------------------

from PIL import Image  # noqa: E402

LANCZOS_MODES = {"L": 1, "RGB": 3, "CMYK": 4, "LA": 2, "RGBA": 4,
                 "I;16": 1, "P": 1, "1": 1}
LANCZOS_SIZES = {
    "down4": lambda w, h: (w // 4, h // 4),
    "down_frac": lambda w, h: (int(w / 2.7), int(h / 1.6)),
    "up": lambda w, h: (2 * w + 1, h + 5),
    "x_only": lambda w, h: (w // 3, h),
    "y_only": lambda w, h: (w, h // 3),
    "to_1x1": lambda w, h: (1, 1),
}


def _pil_image(mode, rng, w=57, h=43):
    c = LANCZOS_MODES[mode]
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w)).astype(
            np.uint16))
    a = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    if mode in ("LA", "RGBA"):     # alphas 0, 255 and between
        a[..., -1] = rng.choice([0, 1, 7, 128, 254, 255], (h, w))
    im = Image.fromarray(a[..., 0] if c == 1 else a,
                         "L" if mode == "P" else mode)
    if mode == "P":
        im = im.convert("P")
    return im


@pytest.mark.parametrize("size", sorted(LANCZOS_SIZES))
@pytest.mark.parametrize("mode", sorted(LANCZOS_MODES))
def test_lanczos_equals_pil(mode, size):
    """resize_lanczos_like_pil equals PIL's resize(..., LANCZOS) bit for
    bit (NEAREST for P and 1, as PIL picks it)."""
    im = _pil_image(mode, np.random.default_rng(len(mode) + len(size)))
    wh = LANCZOS_SIZES[size](*im.size)
    want = np.asarray(im.resize(wh, Image.LANCZOS))
    got = R.resize_lanczos_like_pil(np.asarray(im), mode, wh)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_lanczos_large_frame_equals_pil():
    """The smoke's frame size: 1600² RGB to 400²."""
    a = np.random.default_rng(9).integers(0, 256, (1600, 1600, 3)).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(a).resize((400, 400), Image.LANCZOS))
    np.testing.assert_array_equal(
        R.resize_lanczos_like_pil(a, "RGB", (400, 400)), want)
