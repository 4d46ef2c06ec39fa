"""The port's JPEG decoder (irgs_tpu_torch/utils/jpeg.py) against PIL, bit
for bit: on streams PIL writes here (sizes 1x1 to 33x47, 4:4:4, 4:2:2,
4:2:0, 4:4:0 and 4:1:1, grey, qualities 50/95/100, optimised Huffman
tables, restart intervals, Adobe APP14 and RGB component ids, 16-bit
quantisation tables, progressive, CMYK), on streams the test-side encoders
of tests/jpeg_streams.py write (arithmetic, lossless), on incomplete
progressive files (block smoothing), on lossless frames with subsampled
components or without a colour marker, and on the committed fixtures of
tests/data/jpeg/ (tests/make_jpeg_fixtures.py), which is how a machine
without PIL checks it. Streams PIL refuses, the port refuses."""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import jpeg_streams as js
import make_jpeg_fixtures as fx
from irgs_tpu_torch.utils import image, jpeg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
FIXTURES = sorted(os.path.basename(p)[:-4]
                  for p in glob.glob(os.path.join(DATA, "*.jpg")))
REFUSED = sorted(os.path.basename(p)[:-4]
                 for p in glob.glob(os.path.join(DATA, "refused", "*.jpg")))
VARIANTS = fx.variants()        # name -> stream, written once (pure Python)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_fixture_set_is_complete():
    assert set(FIXTURES) == (set(VARIANTS) | {"large_1297x840_q95"}
                             | set(fx.ARRAY_OF))
    assert set(REFUSED) == set(fx.refused()) | set(fx.LARGE_REFUSED)
    for name in FIXTURES:
        assert os.path.exists(os.path.join(
            DATA, fx.ARRAY_OF.get(name, name) + ".npy"))
        size = os.path.getsize(os.path.join(DATA, name + ".jpg"))
        assert size < (400_000 if name.startswith("large") else 8192), name
    new = [n for n in FIXTURES if n.startswith(("prog", "cmyk", "ycck",
                                                "arith", "lossless"))]
    new += list(fx.ARRAY_OF) + [f"refused/{n}" for n in REFUSED]
    assert sum(os.path.getsize(os.path.join(DATA, n + ".jpg"))
               + (os.path.getsize(os.path.join(DATA, n + ".npy"))
                  if os.path.exists(os.path.join(DATA, n + ".npy"))
                  and n not in fx.ARRAY_OF else 0)
               for n in new) < 1_000_000


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_equals_committed_array(name):
    got = jpeg.read_jpeg(os.path.join(DATA, name + ".jpg"))
    want = np.load(os.path.join(DATA, fx.ARRAY_OF.get(name, name) + ".npy"))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_fixture_variant_equals_pil(name):
    data = VARIANTS[name]
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))
    arr, mode, _ = jpeg.decode_jpeg_like_pil(data)
    np.testing.assert_array_equal(image.to_rgb_like_pil(arr, mode),
                                  _pil_rgb(data))


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
    np.testing.assert_array_equal(image.read_rgb_like_pil(str(path)),
                                  _pil_rgb(data))


def _set_marker(data: bytes, old: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def _pil_or_error(data: bytes):
    try:
        return _pil(data)
    except (OSError, SyntaxError, ValueError) as e:
        return e


# a baseline stream relabelled as another process: what PIL makes of it
# (garbage, or an error), the port makes too
UNPORTED = {
    "progressive": 0xC2,
    "arithmetic": 0xC9,
    "lossless": 0xC3,
    "arithmetic_progressive": 0xCA,
    "hierarchical": 0xC5,
}


@pytest.mark.parametrize("kind", sorted(UNPORTED))
def test_unported_streams_raise(kind):
    """A stream relabelled to another frame type: the port raises exactly
    where PIL does, and otherwise decodes PIL's array."""
    data = _set_marker(fx.encode(fx.pattern(16, 16), quality=90), 0xC0,
                       UNPORTED[kind])
    want = _pil_or_error(data)
    if isinstance(want, Exception):
        with pytest.raises((jpeg.JpegError, NotImplementedError)):
            jpeg.decode_jpeg(data)
    else:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixture_raises_in_both(name):
    data = open(os.path.join(DATA, "refused", name + ".jpg"), "rb").read()
    assert isinstance(_pil_or_error(data), Exception)
    with pytest.raises(jpeg.JpegError, match="PIL does not read"):
        jpeg.decode_jpeg(data)


def _modes(data):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im), im.mode, np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_mode_and_rgb_equal_pil(name):
    """Mode ("L", "RGB", "CMYK") and ``convert("RGB")`` as PIL gives them."""
    data = VARIANTS[name]
    arr, mode, _ = jpeg.decode_jpeg_like_pil(data)
    want, want_mode, want_rgb = _modes(data)
    assert mode == want_mode
    np.testing.assert_array_equal(arr, want)
    np.testing.assert_array_equal(image.to_rgb_like_pil(arr, mode), want_rgb)


@pytest.mark.parametrize("sampling", [0, 1, 2])
@pytest.mark.parametrize("restart", [0, 2])
def test_progressive_bit_for_bit(sampling, restart):
    img = fx.pattern(41, 27, seed=30 + sampling)
    data = fx.encode(img, quality=80, subsampling=sampling, progressive=True,
                     restart_marker_blocks=restart)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("keep", range(1, 10))
def test_incomplete_progressive_smoothed_bit_for_bit(keep):
    """The first `keep` scans of a progressive file: libjpeg-turbo's block
    smoothing (DC interpolation with DC alone, AC estimates after) is
    reproduced bit for bit, and it does change the image."""
    data = fx.drop_scans(fx.encode(fx.pattern(61, 45, seed=15), quality=75,
                                   progressive=True), keep)
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil(data))
    if keep < 9:
        old = jpeg._smoothing_ok
        jpeg._smoothing_ok = lambda frame: False
        try:
            plain = jpeg.decode_jpeg(data)
        finally:
            jpeg._smoothing_ok = old
        assert not np.array_equal(plain, got)


def _arith_coefs():
    coefs, samp, q, tq, size = fx._arith_source(53, 35, seed=31)
    return coefs, samp, q, tq, size


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [0, 4])
@pytest.mark.parametrize("dac", [False, True])
def test_arithmetic_bit_for_bit(progressive, restart, dac):
    coefs, samp, q, tq, size = _arith_coefs()
    kw = dict(dc_l=(2, 1, 0, 0), dc_u=(5, 3, 1, 1), ac_k=(2, 12, 5, 5)) \
        if dac else {}
    data = js.write_arith(coefs, samp, q, tq, size,
                          progressive=progressive, restart=restart, dac=dac,
                          **kw)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt,restart_rows", [(0, 0), (1, 3), (3, 1)])
def test_lossless_bit_for_bit(predictor, pt, restart_rows):
    img = fx.pattern(23, 19, seed=predictor)
    data = js.write_lossless(img, predictor, pt, restart_rows)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))
    grey = js.write_lossless(img[..., 1], predictor, pt, restart_rows)
    np.testing.assert_array_equal(jpeg.decode_jpeg(grey), _pil(grey))


SUBSAMPLED = {"s21": [(2, 1), (1, 1), (1, 1)], "s22": [(2, 2), (1, 1), (1, 1)],
              "s12": [(1, 2), (1, 1), (1, 1)], "chroma22": [(1, 1), (2, 2),
                                                            (1, 1)],
              "s41_21": [(4, 1), (1, 1), (2, 1)],
              "s14_12": [(1, 4), (1, 2), (1, 1)]}


@pytest.mark.parametrize("size", [(36, 29), (37, 31), (5, 3), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SUBSAMPLED))
def test_lossless_subsampled_bit_for_bit(sampling, size):
    """Lossless frames with subsampled components, even and odd sizes:
    one interleaved scan with restarts every 2 MCU rows, and one scan per
    component (restarts every row where the components are equally wide):
    PIL's array, and it is the component planes replicated."""
    w, h = size
    samp = SUBSAMPLED[sampling]
    img = fx.pattern(w, h, seed=w + 3 * h)
    hmax = max(a for a, _ in samp)
    vmax = max(b for _, b in samp)
    widths = {-(-w * a // hmax) for a, _ in samp}
    streams = [js.write_lossless(img, 4, header=b"", sampling=samp,
                                 restart_rows=2),
               js.write_lossless(img, 7, pt=1, header=b"", sampling=samp,
                                 interleaved=False,
                                 restart=widths.pop() if len(widths) == 1
                                 else 0)]
    for data in streams:
        got = jpeg.decode_jpeg(data)
        np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(got, np.stack([np.repeat(np.repeat(
        img[::vmax // b, ::hmax // a, c] >> 1 << 1, vmax // b, 0),
        hmax // a, 1)[:h, :w] for c, (a, b) in enumerate(samp)], -1))


@pytest.mark.parametrize("ids", [(1, 2, 3), (0, 1, 2), (5, 9, 7),
                                 (82, 71, 66)])
def test_lossless_without_marker_is_rgb(ids):
    """libjpeg-turbo takes a 3-component lossless frame with no JFIF or
    Adobe marker as RGB whatever its ids (a JFIF marker makes it YCbCr,
    which lossless cannot convert: refused, as lossless_ycbcr)."""
    img = fx.pattern(13, 11, seed=sum(ids))
    data = js.write_lossless(img, 1, header=b"", ids=list(ids))
    arr, mode, _ = jpeg.decode_jpeg_like_pil(data)
    assert mode == Image.open(io.BytesIO(data)).mode == "RGB"
    np.testing.assert_array_equal(arr, _pil(data))
    np.testing.assert_array_equal(arr, img)
    with pytest.raises(jpeg.JpegError, match="PIL does not read"):
        jpeg.decode_jpeg(js.write_lossless(img, 1, header=js.JFIF,
                                           ids=list(ids)))


@pytest.mark.parametrize("interval", [7, 16, 22, 33])
def test_lossless_restart_not_whole_rows(interval):
    """A lossless restart interval of whole MCU rows (22, 33 on an 11-wide
    frame) decodes; any other PIL refuses, and the port raises JpegError."""
    img = fx.pattern(11, 9, seed=interval)[..., 0]
    data = js.write_lossless(img, 1, restart=interval)
    want = _pil_or_error(data)
    if interval % 11:
        assert isinstance(want, Exception)
        with pytest.raises(jpeg.JpegError, match="whole number of MCU rows"):
            jpeg.decode_jpeg(data)
    else:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)


def test_fractional_sampling_raises():
    data = fx.arith_fractional()
    assert isinstance(_pil_or_error(data), Exception)
    with pytest.raises(jpeg.JpegError, match="fractional sampling"):
        jpeg.decode_jpeg(data)


@pytest.mark.parametrize("transform", [0, 1, 2, None])
def test_four_components_bit_for_bit(transform):
    data = fx.cmyk(fx.pattern(29, 21, seed=40))
    data = (fx.drop_adobe(data) if transform is None
            else fx.set_adobe_transform(data, transform))
    arr, mode, _ = jpeg.decode_jpeg_like_pil(data)
    want, want_mode, want_rgb = _modes(data)
    assert mode == want_mode == "CMYK"
    np.testing.assert_array_equal(arr, want)
    np.testing.assert_array_equal(image.to_rgb_like_pil(arr, mode), want_rgb)


def test_large_arithmetic_file_is_read_as_pil_reads_it():
    """PIL feeds libjpeg-turbo 64 KiB at a time and its arithmetic decoder
    cannot suspend: PIL reads the large arithmetic fixture, whose scans
    start past each 64 KiB read, and raises on the same stream without the
    COM segments that move them there. The port does both."""
    data = open(os.path.join(DATA, "large_1297x840_q95_arith.jpg"),
                "rb").read()
    want = np.load(os.path.join(DATA, "large_1297x840_q95.npy"))
    np.testing.assert_array_equal(_pil(data), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    packed = open(os.path.join(DATA, "refused",
                               "arith_scan_past_64k_read.jpg"), "rb").read()
    assert fx.pad_scans_past_reads(packed) == data
    assert isinstance(_pil_or_error(packed), OSError)
    with pytest.raises(jpeg.JpegError, match="64 KiB"):
        jpeg.decode_jpeg(packed)


@pytest.mark.parametrize("name", ["arith_seq_37x29",
                                  "arith_prog_dac_restart_37x29"])
def test_arithmetic_refusals_follow_pil_reads(name):
    """The fixture shifted by a COM segment so that PIL's first 64 KiB read
    ends at each of its bytes in turn: the port raises where PIL raises (a
    read that ends inside a scan's data, restart markers included) and
    else gives PIL's array."""
    data = open(os.path.join(DATA, name + ".jpg"), "rb").read()
    want = np.load(os.path.join(DATA, name + ".npy"))
    refusals = 0
    for at in range(2, len(data)):
        pad = 65536 - at                   # one COM segment of pad bytes
        shifted = (data[:2] + b"\xff\xfe" + struct.pack(">H", pad - 2)
                   + b"\0" * (pad - 4) + data[2:])
        pil = _pil_or_error(shifted)
        if isinstance(pil, Exception):
            refusals += 1
            with pytest.raises(jpeg.JpegError, match="64 KiB"):
                jpeg.decode_jpeg(shifted)
        else:
            np.testing.assert_array_equal(pil, want)
            np.testing.assert_array_equal(jpeg.decode_jpeg(shifted), want)
    assert 0 < refusals < len(data)


def test_comment_is_read_as_pil_reads_it():
    bio = io.BytesIO()
    Image.fromarray(fx.pattern(9, 7)).save(bio, "JPEG", comment=b"hi there")
    data = bio.getvalue()
    assert jpeg.decode_jpeg_like_pil(data)[2] == {
        "comment": Image.open(io.BytesIO(data)).info["comment"]}


def test_corrupt_streams_raise():
    data = fx.encode(fx.pattern(16, 16), quality=90)
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(b"\x89PNG" + data[4:])
    no_dht = data
    while b"\xff\xc4" in no_dht:
        i = no_dht.index(b"\xff\xc4")
        (n,) = struct.unpack_from(">H", no_dht, i + 2)
        no_dht = no_dht[:i] + no_dht[i + 2 + n:]
    # libjpeg-turbo fills the DC and AC slots 0 and 1 that no DHT defines
    # with T.81's standard tables (std_huff_tables), and PIL reads the
    # stream with them
    np.testing.assert_array_equal(jpeg.decode_jpeg(no_dht),
                                  np.asarray(Image.open(io.BytesIO(no_dht))))
    # a scan naming slot 2, which nothing defines, is refused by both
    i = no_dht.index(b"\xff\xda")
    slot2 = no_dht[:i + 6] + b"\x22" + no_dht[i + 7:]
    assert isinstance(_pil_or_error(slot2), Exception)
    with pytest.raises(jpeg.JpegError, match="Huffman table"):
        jpeg.decode_jpeg(slot2)
