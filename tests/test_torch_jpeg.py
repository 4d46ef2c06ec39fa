"""The port's JPEG decoder (irgs_tpu_torch/utils/jpeg.py) against PIL, bit
for bit: on streams PIL writes here (sizes 1x1 to 33x47, 4:4:4, 4:2:2,
4:2:0, 4:4:0 and 4:1:1, grey, qualities 50/95/100, optimised Huffman
tables, restart intervals, Adobe APP14 and RGB component ids, 16-bit
quantisation tables), and on the committed fixtures of tests/data/jpeg/
(tests/make_jpeg_fixtures.py), which is how a machine without PIL checks
it. Streams the port does not decode must raise NotImplementedError."""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import make_jpeg_fixtures as fx
from irgs_tpu_torch.utils import jpeg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
FIXTURES = sorted(os.path.basename(p)[:-4]
                  for p in glob.glob(os.path.join(DATA, "*.jpg")))


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_fixture_set_is_complete():
    assert set(FIXTURES) == set(fx.variants()) | {"large_1297x840_q95"}
    for name in FIXTURES:
        assert os.path.exists(os.path.join(DATA, name + ".npy"))
        size = os.path.getsize(os.path.join(DATA, name + ".jpg"))
        assert size < (400_000 if name.startswith("large") else 8192), name


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_equals_committed_array(name):
    got = jpeg.read_jpeg(os.path.join(DATA, name + ".jpg"))
    want = np.load(os.path.join(DATA, name + ".npy"))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(fx.variants()))
def test_fixture_variant_equals_pil(name):
    data = fx.variants()[name]
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))
    rgb = jpeg.decode_jpeg(data)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, -1)
    np.testing.assert_array_equal(rgb, _pil_rgb(data))


SIZES = [(1, 1), (17, 9), (33, 47)]
SAMPLINGS = {"444": dict(subsampling=0), "422": dict(subsampling=1),
             "420": dict(subsampling=2)}


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_stream_bit_for_bit(size, sampling, quality):
    img = fx.pattern(*size, seed=size[0] * 100 + quality)
    data = fx.encode(img, quality=quality, **SAMPLINGS[sampling])
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


def _mcus(w, h, hmax, vmax):
    return -(-w // (8 * hmax)) * -(-h // (8 * vmax))


@pytest.mark.parametrize("size", [(3, 5), (16, 16), (29, 43), (64, 32)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_relabelled_sampling_bit_for_bit(size):
    """4:4:0 (h1v2 fancy) and 4:1:1 (int_upsample) streams from relabelled
    PIL files, at sizes where both labels give the same MCU count."""
    w, h = size
    img = fx.pattern(w, h, seed=w + h)
    ran = 0
    if _mcus(w, h, 2, 1) == _mcus(w, h, 1, 2):       # 4:2:2 -> 4:4:0
        data = fx.set_sampling(fx.encode(img, quality=90, subsampling=1),
                               {0: 0x12})
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))
        ran += 1
    if _mcus(w, h, 2, 2) == _mcus(w, h, 4, 1):       # 4:2:0 -> 4:1:1
        data = fx.set_sampling(fx.encode(img, quality=90, subsampling=2),
                               {0: 0x41})
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))
        ran += 1
    assert ran


@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_restart_intervals_bit_for_bit(blocks, opt):
    img = fx.pattern(33, 47, seed=blocks)
    data = fx.encode(img, quality=85, subsampling=2, optimize=opt,
                     restart_marker_blocks=blocks)
    assert b"\xff\xdd" in data
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_bit_for_bit(size, tmp_path):
    data = fx.encode(fx.pattern(*size, seed=5)[..., 0], quality=75)
    got = jpeg.decode_jpeg(data)
    assert got.ndim == 2
    np.testing.assert_array_equal(got, _pil(data))
    path = tmp_path / "g.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(jpeg.read_jpeg_rgb(str(path)),
                                  _pil_rgb(data))


def _set_marker(data: bytes, old: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def _cmyk() -> bytes:
    bio = io.BytesIO()
    Image.fromarray(fx.pattern(16, 16)).convert("CMYK").save(bio, "JPEG")
    return bio.getvalue()


def _twelve_bit() -> bytes:
    data = fx.encode(fx.pattern(16, 16), quality=90)
    i = data.index(b"\xff\xc0")
    return data[:i + 4] + bytes([12]) + data[i + 5:]


UNPORTED = {
    "progressive": (lambda: fx.encode(fx.pattern(16, 16), quality=90,
                                      progressive=True), "SOF2"),
    "arithmetic": (lambda: _set_marker(fx.encode(fx.pattern(16, 16)),
                                       0xC0, 0xC9), "SOF9"),
    "lossless": (lambda: _set_marker(fx.encode(fx.pattern(16, 16)),
                                     0xC0, 0xC3), "SOF3"),
    "twelve_bit": (_twelve_bit, "12-bit"),
    "cmyk": (_cmyk, "CMYK"),
}


@pytest.mark.parametrize("kind", sorted(UNPORTED))
def test_unported_streams_raise(kind):
    make, what = UNPORTED[kind]
    with pytest.raises(NotImplementedError, match=what) as e:
        jpeg.decode_jpeg(make())
    assert "ROADMAP.md A6" in str(e.value)


def test_corrupt_streams_raise():
    data = fx.encode(fx.pattern(16, 16), quality=90)
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(b"\x89PNG" + data[4:])
    no_dht = data
    while b"\xff\xc4" in no_dht:
        i = no_dht.index(b"\xff\xc4")
        (n,) = struct.unpack_from(">H", no_dht, i + 2)
        no_dht = no_dht[:i] + no_dht[i + 2 + n:]
    with pytest.raises(jpeg.JpegError, match="Huffman table"):
        jpeg.decode_jpeg(no_dht)
