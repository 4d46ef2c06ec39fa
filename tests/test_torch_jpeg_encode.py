"""The port's JPEG encoder (irgs_tpu_torch/utils/jpeg_encode.py) against
PIL's default ``save``: the files are equal byte for byte, for grey, 1-bit,
colour (4:2:0) and CMYK images of sizes 1x1 to 70x45 (partial MCUs,
dummy blocks at both edges), with and without a carried COM comment; the
quality-75 tables and the Huffman tables are PIL's."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import make_jpeg_fixtures as fx
from irgs_tpu_torch.utils import jpeg, jpeg_encode as E

SIZES = [(1, 1), (7, 3), (16, 16), (17, 9), (33, 47), (70, 45)]


def _pil_save(img, mode, comment=None):
    im = Image.fromarray(img) if mode == "1" else Image.fromarray(img, mode)
    if comment is not None:
        im.info["comment"] = comment
    bio = io.BytesIO()
    im.save(bio, "JPEG")
    return bio.getvalue()


def _img(mode, w, h, seed):
    a = fx.pattern(w, h, seed=seed)
    if mode == "L":
        return a[..., 1]
    if mode == "1":
        return a[..., 0] > 128
    if mode == "CMYK":
        return np.concatenate([a, a[..., 2:]], -1)
    return a


@pytest.mark.parametrize("mode", ["RGB", "L", "1", "CMYK"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bytes_equal_pil(mode, size):
    img = _img(mode, *size, seed=size[0] * 7 + size[1])
    assert E.encode_jpeg(img, mode) == _pil_save(img, mode)


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK"])
def test_comment_carried_as_pil_carries_it(mode):
    img = _img(mode, 21, 13, seed=3)
    got = E.encode_jpeg(img, mode, comment=b"from the source")
    assert got == _pil_save(img, mode, comment=b"from the source")
    assert jpeg.decode_jpeg_like_pil(got)[2]["comment"] == b"from the source"


def test_tables_equal_pil():
    data = _pil_save(fx.pattern(16, 16), "RGB")
    im = Image.open(io.BytesIO(data))
    assert list(E.quality_table(E.STD_LUMINANCE)) == list(
        im.quantization[0])             # both in natural order
    assert list(E.quality_table(E.STD_CHROMINANCE)) == list(
        im.quantization[1])
    for name, table, index in (("DC_LUM", E.DC_LUM, 0x00),
                               ("AC_LUM", E.AC_LUM, 0x10),
                               ("DC_CHROM", E.DC_CHROM, 0x01),
                               ("AC_CHROM", E.AC_CHROM, 0x11)):
        seg = bytes([index]) + bytes(table[0]) + bytes(table[1])
        assert b"\xff\xc4" + struct.pack(">H", len(seg) + 2) + seg in data, \
            name


def test_write_jpeg_round_trips_through_the_decoder(tmp_path):
    img = fx.pattern(45, 31, seed=4)
    path = str(tmp_path / "a.jpg")
    E.write_jpeg(path, img, "RGB", {"comment": b"c"})
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  np.asarray(Image.open(path)))


@pytest.mark.parametrize("mode", ["RGBA", "P", "LA", "I;16"])
def test_modes_pil_cannot_save_raise(mode):
    with pytest.raises(OSError, match=f"cannot write mode {mode}"):
        E.encode_jpeg(np.zeros((4, 4), np.uint8), mode)
