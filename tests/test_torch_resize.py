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
