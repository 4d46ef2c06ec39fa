"""The port's PNG reader and writer (irgs_tpu_torch/utils/png.py) and PIL's
mode conversions (irgs_tpu_torch/utils/image.py) against PIL: every PNG
image type at every bit depth, plain and Adam7-interlaced, palettes and
their tRNS, on the committed fixtures of tests/data/png/
(tests/make_png_fixtures.py, which is how a machine without PIL checks
them) and on files written here; ``convert("RGB")`` of every mode the
readers return; what PIL's save writes for each mode; and the ICC profile
(iCCP) PIL carries from a source to its save."""

import glob
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import make_png_fixtures as mk
from irgs_tpu_torch.utils import image, png

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "png")
MODES = json.load(open(os.path.join(DATA, "modes.json")))


def _info(arr, mode, info):
    t = info.get("transparency")
    pal = info.get("palette")
    return {"mode": mode,
            "palette": None if pal is None else np.asarray(pal).tolist(),
            "transparency": list(t) if isinstance(t, (bytes, tuple)) else t}


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-4]
                   for p in glob.glob(os.path.join(DATA, "*.png")))
    assert names == sorted(MODES) == sorted(mk.png_variants())
    for n in names:
        assert os.path.exists(os.path.join(DATA, n + ".npy"))


@pytest.mark.parametrize("name", sorted(MODES))
def test_fixture_equals_committed_array(name):
    arr, mode, info = png.read_png_like_pil(os.path.join(DATA, name + ".png"))
    want = np.load(os.path.join(DATA, name + ".npy"))
    assert arr.dtype == want.dtype and arr.shape == want.shape
    np.testing.assert_array_equal(arr, want)
    assert _info(arr, mode, info) == MODES[name]


@pytest.mark.parametrize("name", sorted(mk.png_variants()))
def test_variant_equals_pil(name, tmp_path):
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(mk.png_variants()[name])
    arr, mode, info = png.read_png_like_pil(path)
    im = Image.open(path)
    want = np.asarray(im)
    assert arr.dtype == want.dtype
    np.testing.assert_array_equal(arr, want)
    assert _info(arr, mode, info) == mk.pil_info(im)
    np.testing.assert_array_equal(
        image.to_rgb_like_pil(arr, mode, info.get("palette")),
        np.asarray(im.convert("RGB")))


def _image(mode, rng, w=11, h=9):
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w)).astype(
            np.uint16))
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 7, (h, w)).astype(np.uint8),
                             "P")
        im.putpalette(rng.integers(0, 256, 21).tolist())
        return im
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    a = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    return Image.fromarray(a[..., 0] if c == 1 else a, mode)


CONVERT_MODES = ["1", "L", "I;16", "LA", "P", "RGB", "RGBA", "CMYK"]


@pytest.mark.parametrize("mode", CONVERT_MODES)
def test_to_rgb_equals_pil_convert(mode):
    im = _image(mode, np.random.default_rng(5))
    pal = (np.asarray(im.getpalette()).reshape(-1, 3) if mode == "P"
           else None)
    if mode == "I;16":                 # samples above 255 clamp
        assert np.asarray(im).max() > 255
    np.testing.assert_array_equal(
        image.to_rgb_like_pil(np.asarray(im), mode, pal),
        np.asarray(im.convert("RGB")))


WRITER_MODES = ["1", "L", "LA", "RGB", "RGBA", "I;16", "P", "P_trns_index",
                "P_trns_bytes", "P_256", "RGB_icc", "P_icc", "1_trns",
                "L_trns", "L_trns_0", "I;16_trns", "RGB_trns"]
# the transparency PIL keeps for each mode (tRNS of grey and RGB images)
TRNS = {"P_trns_index": 2, "P_trns_bytes": bytes([0, 128, 255, 7]),
        "1_trns": 255, "L_trns": 7, "L_trns_0": 0, "I;16_trns": 40000,
        "RGB_trns": (10, 20, 300)}


def _write_both(mode, tmp_path):
    """The same image saved by PIL and by write_png_like_pil -> (ours,
    theirs) paths."""
    rng = np.random.default_rng(6)
    base = mode.split("_")[0]
    im = _image(base, rng)
    if mode == "P_256":
        im.putpalette(rng.integers(0, 256, 768).tolist())
    if mode in TRNS:
        im.info["transparency"] = TRNS[mode]
    if mode.endswith("_icc"):
        im.info["icc_profile"] = ICC
    ours, theirs = str(tmp_path / "o.png"), str(tmp_path / "t.png")
    im.save(theirs)
    info = {"icc_profile": im.info.get("icc_profile")}
    if base == "P":
        info["palette"] = np.asarray(im.getpalette()).reshape(-1, 3)
    if "transparency" in im.info:
        info["transparency"] = im.info["transparency"]
    png.write_png_like_pil(ours, np.asarray(im), base, info)
    return ours, theirs


@pytest.mark.parametrize("mode", WRITER_MODES)
def test_writer_equals_pil_save(mode, tmp_path):
    """write_png_like_pil: PIL decodes the port's file to what it decodes
    from its own save of the same image (array, mode, palette, tRNS, ICC
    profile), and the bit depth is PIL's."""
    base = mode.split("_")[0]
    ours, theirs = _write_both(mode, tmp_path)
    a, b = Image.open(ours), Image.open(theirs)
    assert a.mode == b.mode == base
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mk.pil_info(a) == mk.pil_info(b)
    assert a.info.get("icc_profile") == b.info.get("icc_profile")
    assert open(ours, "rb").read()[24] == open(theirs, "rb").read()[24]
    assert _chunk_of(ours, b"iCCP") == _chunk_of(theirs, b"iCCP")


@pytest.mark.parametrize("mode", WRITER_MODES)
def test_writer_bytes_equal_pil_save(mode, tmp_path):
    """write_png_like_pil writes PIL's file byte for byte: its chunks, its
    row filters and its deflate settings (Python's zlib deflates as the
    zlib PIL was built with does, here)."""
    ours, theirs = _write_both(mode, tmp_path)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("shape", [(3, 20000), (150, 200), (1, 1)],
                         ids=["wide", "two_idat_chunks", "one_pixel"])
@pytest.mark.parametrize("mode", ["1", "L", "RGB", "RGBA", "I;16", "P"])
def test_writer_bytes_equal_pil_save_at_sizes(mode, shape, tmp_path):
    """Byte for byte at widths past ImageFile's 64 KiB buffer, with image
    data that spans several IDAT chunks, and at one pixel."""
    h, w = shape
    rng = np.random.default_rng(9)
    im = _image(mode, rng, w, h)
    if mode == "P" and w > 1:
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8)).convert("P", palette=Image.Palette.ADAPTIVE, colors=11)
    theirs, ours = str(tmp_path / "t.png"), str(tmp_path / "o.png")
    im.save(theirs)
    arr, m, info = png.read_png_like_pil(theirs)
    png.write_png_like_pil(ours, arr, m, info)
    Image.open(theirs).save(str(tmp_path / "t2.png"))
    assert open(ours, "rb").read() == open(tmp_path / "t2.png", "rb").read()


# the start of an ICC profile header and some tag bytes
ICC = b"\0\0\2\x0cADBE\2\x10\0\0mntrRGB XYZ " + bytes(range(200))


def _chunk_of(path, kind):
    """The payload of the first `kind` chunk of a PNG file, or None."""
    buf = open(path, "rb").read()
    i = buf.find(kind)
    if i < 0:
        return None
    n = int.from_bytes(buf[i - 4:i], "big")
    return buf[i + 4:i + 4 + n]


@pytest.mark.parametrize("where", ["before_idat", "after_idat", "two",
                                   "bad_zlib"])
def test_icc_profile_is_read_as_pil_reads_it(where, tmp_path):
    """The iCCP chunk's profile as PIL's info holds it once the image is
    loaded: the last chunk's, one after the image data too, and None where
    zlib fails."""
    bio = io.BytesIO()
    _image("RGB", np.random.default_rng(8)).save(bio, "PNG")
    buf = bio.getvalue()
    idat, iend = buf.index(b"IDAT") - 4, buf.index(b"IEND") - 4
    good = _png_chunk(b"iCCP", b"a\0\0" + zlib.compress(ICC))
    buf = {"before_idat": buf[:idat] + good + buf[idat:],
           "after_idat": buf[:iend] + good + buf[iend:],
           "two": buf[:idat] + _png_chunk(b"iCCP", b"b\0\0" + zlib.compress(
               b"first")) + good + buf[idat:],
           "bad_zlib": buf[:idat] + _png_chunk(b"iCCP", b"c\0\0 no zlib")
           + buf[idat:]}[where]
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(buf)
    im = Image.open(path)
    im.load()
    want = im.info["icc_profile"]
    assert want == (None if where == "bad_zlib" else ICC)
    assert png.read_png_like_pil(path)[2]["icc_profile"] == want


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _damaged_after_data(kind):
    """A PNG whose bytes after the image data are damaged as PIL's load
    never reads them: an IDAT CRC, the IEND chunk, the zlib stream's
    Adler-32, data past the last row."""
    rng = np.random.default_rng(len(kind))
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "PNG")
    data = bytearray(bio.getvalue())
    i = data.index(b"IDAT")
    (n,) = struct.unpack_from(">I", data, i - 4)
    if kind == "idat_crc":
        data[i + 4 + n] ^= 1
    elif kind == "no_iend":
        data = data[:-12]
    elif kind == "iend_cut":
        data = data[:-5]
    elif kind in ("adler32", "past_last_row"):
        raw = zlib.decompress(bytes(data[i + 4:i + 4 + n]))
        if kind == "past_last_row":
            raw += bytes(20)
        z = bytearray(zlib.compress(raw))
        if kind == "adler32":
            z[-1] ^= 0x40
        chunk = struct.pack(">I", len(z)) + b"IDAT" + bytes(z)
        chunk += struct.pack(">I", zlib.crc32(b"IDAT" + bytes(z)))
        data = data[:i - 4] + chunk + data[i + 8 + n:]
    return bytes(data)


@pytest.mark.parametrize("kind", ["idat_crc", "no_iend", "iend_cut",
                                  "adler32", "past_last_row"])
def test_damage_after_the_image_data_reads_as_pil(kind, tmp_path):
    """What PIL's load never reads (PngImagePlugin checks CRCs only of the
    chunks before the first IDAT; its ZIP decoder stops at the last row)
    does not stop the port either; a bad Adler-32 in the IDAT chunk that
    ends the rows is refused by both."""
    path = tmp_path / "f.png"
    path.write_bytes(_damaged_after_data(kind))
    try:
        with Image.open(path) as im:
            want, mode = np.asarray(im), im.mode
    except OSError:     # a bad Adler-32 in the chunk that ends the rows
        with pytest.raises(png.PngError, match="broken data stream"):
            png.read_png_like_pil(str(path))
        return
    arr, got_mode, _ = png.read_png_like_pil(str(path))
    assert got_mode == mode
    np.testing.assert_array_equal(arr, want)
